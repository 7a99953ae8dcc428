"""Caption-serving CLI of the port (counterpart of ``scripts/serve.py``).

    python -m cst_captioning_tpu_torch.serve --serve_demo 1 \\
        --decode_kernel fused --beam_size 1 < requests.jsonl

Three backends.  The first two serve a seeded feature table (ids ``v0``
.. ``v{N-1}``, ``--serve_videos``) at ``--feat_shapes``:

- **demo mode** (``--serve_demo 1``): a seeded untrained model at the
  widths ``--rnn_size/--input_encoding_size/--att_size/--vocab_size``
  with ``--serve_demo_eos_bias`` added to the EOS logit, and a vocabulary
  of made-up words.  Captions are gibberish; admission, slot recycling,
  backpressure and drain are the real ones.
- **converted weights** (``--params_npz`` + ``--vocab_json``): a flat
  ``"a/b/c"``-keyed npz of the reference's Flax parameter tree and its
  ``{id: word}`` vocabulary.  Widths come from the weights; the feature
  dims of ``--feat_shapes`` must match them.
- **a trained checkpoint** (``--checkpoint_path``): the best step of
  a directory the train CLI wrote, rebuilt as ``eval.py`` rebuilds it (the
  architecture from the checkpoint's saved options; ``--decode_kernel``
  and ``--pallas_attention`` from this CLI).  Video ids are those of the
  checkpoint's synthetic val split (``val_video{i}``) with that split's
  features, and ``--max_length`` defaults to the checkpoint's, so the
  captions equal the eval CLI's predictions at the same beam and decode
  settings.

Protocol and shutdown: ``serving/server.py`` (stdin EOF exits 0, SIGTERM
drains and exits 75).  Engine stats go to stderr as one JSON line.
Runs on the CUDA device unless ``--device cpu`` is given; without a GPU
it exits with an error instead of running on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from . import default_device
from .data.shapes import parse_feat_shapes
from .data.vocab import Vocab
from .eval import load_checkpoint_model
from .models import CaptionModel
from .serving.buckets import parse_buckets
from .serving.engine import ServingEngine
from .serving.server import CaptionServer, PreemptionHandler
from .weights import init_random_, load_params_npz, model_from_flax


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--serve_demo", type=int, default=0)
    p.add_argument("--checkpoint_path", default="",
                   help="serve the best step of a train-CLI directory on its val "
                        "split's videos")
    p.add_argument("--params_npz", default="")
    p.add_argument("--vocab_json", default="")
    p.add_argument("--rnn_size", type=int, default=512)
    p.add_argument("--input_encoding_size", type=int, default=512)
    p.add_argument("--att_size", type=int, default=512)
    p.add_argument("--vocab_size", type=int, default=8000,
                   help="embedding rows: the words plus id 0 (PAD/EOS)")
    p.add_argument("--feat_shapes", default="28x2048,1x4096")
    p.add_argument("--serve_videos", type=int, default=16)
    p.add_argument("--serve_demo_eos_bias", type=float, default=0.2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--decode_kernel", choices=("reference", "fused", "bf16"),
                   default="fused",
                   help="decode cell: the model's cell, the K2 kernel, or "
                        "the model's cell in bfloat16 over float32 "
                        "parameters (float32 carry and logits at the "
                        "step's boundary; parity-gated by "
                        "tools/bf16_parity.py)")
    p.add_argument("--use_bfloat16", type=int, default=0,
                   help="1 = the model computes in bfloat16 over float32 "
                        "parameters (the reference's --use_bfloat16); with "
                        "--decode_kernel fused K2 runs in bfloat16 storage")
    p.add_argument("--pallas_attention", type=int, default=0,
                   help="reference cell: run attention on the K1 kernel")
    p.add_argument("--beam_size", type=int, default=5)
    p.add_argument("--max_length", type=int, default=None,
                   help="decode length; default: the checkpoint's, else 30")
    p.add_argument("--length_norm", type=float, default=0.0)
    p.add_argument("--decode_chunk", type=int, default=8)
    p.add_argument("--serve_buckets", default="1,4,8")
    p.add_argument("--serve_queue_limit", type=int, default=64)
    p.add_argument("--device", default=None,
                   help="torch device; default cuda (raises without a GPU)")
    opt = p.parse_args(argv)
    if not (opt.serve_demo or opt.checkpoint_path
            or (opt.params_npz and opt.vocab_json)):
        p.error("pass --serve_demo 1, --checkpoint_path, or --params_npz "
                "and --vocab_json")
    return opt


def build_backend(opt):
    """-> (model, vocab, feat_shapes, feats_for) on the chosen device;
    sets ``opt.max_length`` where it was left to the backend."""
    device = default_device(opt.device)
    if opt.checkpoint_path:
        model, vocab, val, saved = load_checkpoint_model(
            opt.checkpoint_path, device, opt.decode_kernel,
            opt.pallas_attention)
        if opt.max_length is None:
            opt.max_length = saved.max_length
        index = {vid: i for i, vid in enumerate(val.video_ids)}

        def split_feats(video_id):
            i = index.get(str(video_id))
            return None if i is None else [f[i] for f in val.feats]

        return (model, vocab, [f.shape[1:] for f in val.feats],
                split_feats)
    if opt.max_length is None:
        opt.max_length = 30
    feat_shapes = parse_feat_shapes(opt.feat_shapes)
    kw = dict(decode_kernel=opt.decode_kernel,
              use_kernel_attention=bool(opt.pallas_attention),
              dtype=torch.bfloat16 if opt.use_bfloat16 else torch.float32)
    if opt.serve_demo:
        vocab = Vocab({i: f"w{i}" for i in range(1, opt.vocab_size)})
        model = CaptionModel(
            vocab.size_with_pad, [d for _, d in feat_shapes],
            embed_size=opt.input_encoding_size, hidden_size=opt.rnn_size,
            attn_size=opt.att_size, **kw)
        init_random_(model, opt.seed, eos_bias=opt.serve_demo_eos_bias)
        model = model.eval().to(device)
    else:
        with open(opt.vocab_json) as f:
            vocab = Vocab.from_json(json.load(f))
        model = model_from_flax(load_params_npz(opt.params_npz),
                                device=device, **kw)
        if model.feat_dims != tuple(d for _, d in feat_shapes):
            raise ValueError(f"--feat_shapes dims {feat_shapes} do not match "
                             f"the weights' {model.feat_dims}")
    rng = np.random.default_rng(opt.seed)
    table = [rng.standard_normal((opt.serve_videos,) + s, dtype=np.float32)
             for s in feat_shapes]

    def feats_for(video_id):
        try:
            ix = int(str(video_id).lstrip("v"))
        except ValueError:
            return None
        if not 0 <= ix < opt.serve_videos:
            return None
        return [t[ix] for t in table]

    return model, vocab, feat_shapes, feats_for


def main(argv=None) -> int:
    opt = parse_args(argv)
    model, vocab, feat_shapes, feats_for = build_backend(opt)
    engine = ServingEngine(
        model, feat_shapes, max_len=opt.max_length,
        beam_size=opt.beam_size, length_norm=opt.length_norm,
        decode_chunk=opt.decode_chunk,
        bucket_sizes=parse_buckets(opt.serve_buckets),
        queue_limit=opt.serve_queue_limit)
    server = CaptionServer(engine, vocab, feats_for,
                           handler=PreemptionHandler().install())
    print(f"serve: ready on {model.device} (decode_kernel="
          f"{opt.decode_kernel}, compute {model.dtype}, beam "
          f"{engine.beam_size}, buckets "
          f"{engine.buckets})", file=sys.stderr, flush=True)
    try:
        return server.run_stdin()
    finally:
        print("serve: " + json.dumps(engine.stats()), file=sys.stderr)


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # The stdin reader thread may still be blocked in a read; leave
    # without the interpreter's teardown, which can abort under it.
    os._exit(code)
