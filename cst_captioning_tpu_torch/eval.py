"""Evaluation CLI of the port (counterpart of the root ``eval.py``).

    python -m cst_captioning_tpu_torch.eval --checkpoint_path ck/cst \\
        --test_feat_npy test_feat0.npy test_feat1.npy \\
        --test_label_npz test_label.npz --test_info_json test_info.json \\
        --test_cocofmt_file test_cocofmt.json \\
        --beam_size 5 --result_file scores.json

``--checkpoint_path`` is the best verified step of a directory the train
CLI wrote, or an exported checkpoint (``weights.py``; the reference's
checkpoints through ``export_for_torch.py checkpoint``).  The model is
rebuilt from the options saved in it: the architecture comes from the
checkpoint (``--model_type``, ``--fusion_type``, the widths and depths;
``weights.MODEL_OPT_KEYS``), and of this CLI's flags only
``--max_length`` overrides it (the decode length).  The data are the ``--test_*`` files
(``data/dataset.py``; the vocabulary is the test split's info json, as
the reference's ``eval.py`` reads it); without them, the val split the
checkpoint was trained with (its files, or its synthetic spec and seed
rebuilt; the train split is built for its vocabulary alone).  An
exported checkpoint needs the ``--test_*`` files.  Every video is
decoded (``--beam_size``, 1 = greedy) in batches of ``--eval_batch_size``
(0 = ``--batch_size``) and scored by ``language_eval``: BLEU-1..4,
METEOR_approx, ROUGE-L and CIDEr.  ``--engine serving`` decodes the split
through the serving engine as well and raises unless every caption equals
the offline decode's; the scores are then the engine's.

``--result_file`` gets ``{"scores", "predictions"}``, written to a
temporary file and renamed.  The last line of standard output is the
scores JSON.  Runs on the CUDA device unless ``--device cpu``; without a
GPU it raises instead of running on the CPU.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from typing import Any, Dict, List, Tuple

import torch

from . import default_device
from .data.dataset import (CaptionDataset, SplitData, add_split_args,
                           paths_from_opt, refuse_h5_flags)
from .data.loader import CaptionLoader
from .data.vocab import Vocab
from .metrics.coco_eval import language_eval
from .serving.buckets import parse_buckets
from .serving.engine import serve_decode_split
from .train import parse_args as train_args
from .training import checkpoint
from .training.evaluation import decode_split
from .training.trainer import build_model, build_splits
from .weights import (exported_model_opts, from_flax, is_exported_checkpoint,
                      load_exported_checkpoint)

log = logging.getLogger("cst_captioning_tpu_torch.eval")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint_path", required=True,
                   help="a directory the train CLI wrote (its best step), "
                        "or an exported checkpoint")
    add_split_args(p.add_argument_group("data (default: the checkpoint's "
                                        "val split)"), "test")
    p.add_argument("--beam_size", type=int, default=5)
    p.add_argument("--length_norm", type=float, default=0.0)
    p.add_argument("--decode_chunk", type=int, default=8)
    p.add_argument("--max_length", type=int, default=None,
                   help="decode length; default: the checkpoint's")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--eval_batch_size", type=int, default=0,
                   help="decode batch; 0 = --batch_size")
    p.add_argument("--decode_kernel", choices=("reference", "fused", "bf16"),
                   default="reference",
                   help="decode cell: the model's cell, the K2 kernel, or "
                        "the model's cell in bfloat16")
    p.add_argument("--pallas_attention", type=int, default=0,
                   help="1 = the reference cell's attention on K1")
    p.add_argument("--engine", choices=("legacy", "serving"),
                   default="legacy",
                   help="serving = decode through the serving engine too "
                        "and hold it caption for caption to the offline "
                        "decode")
    p.add_argument("--serve_buckets", default="1,4,8")
    p.add_argument("--result_file", default=None)
    p.add_argument("--device", default=None,
                   help="torch device; default cuda (raises without a GPU)")
    raw = sys.argv[1:] if argv is None else list(argv)
    refuse_h5_flags(p, raw)
    return p.parse_args(raw)


def load_checkpoint_model(checkpoint_path: str, device: torch.device,
                          decode_kernel: str = "reference",
                          pallas_attention: int = 0, test_paths=None
                          ) -> Tuple[Any, Vocab, SplitData,
                                     argparse.Namespace]:
    """Rebuild the best step of a train-CLI directory, or an exported
    checkpoint -> (model in eval mode on ``device``, vocabulary, the data
    split, the training options).  The architecture comes from the
    options saved in the checkpoint, the decode cell from the arguments.
    The split is ``test_paths``' (a ``SplitPaths``) with its vocabulary
    when given, else the checkpoint's val split with its train split's
    vocabulary (an exported checkpoint has no split of its own)."""
    opt = train_args([])
    exported = is_exported_checkpoint(checkpoint_path)
    if exported:
        params, saved_opt, _ = load_exported_checkpoint(checkpoint_path)
        vars(opt).update(exported_model_opts(saved_opt))
        state = from_flax(params)
    else:
        saved = checkpoint.load(checkpoint_path)
        vars(opt).update(saved["opt"])
        state = saved["model"]
    opt.use_consensus_weights, opt.use_rl = 0, 0     # no consensus scores
    opt.decode_kernel, opt.pallas_attention = decode_kernel, pallas_attention
    if test_paths is not None:
        split = CaptionDataset(test_paths)
        vocab = split.vocab
    elif exported:
        raise ValueError(f"{checkpoint_path} is an exported checkpoint, "
                         "which holds no data: pass the --test_* files")
    else:
        train, split = build_splits(opt, train_features=False)
        vocab = train.vocab
    pos = state.get("tx.pos_embed")
    model = build_model(opt, vocab.size_with_pad, split.feat_dims,
                        split.seq_length,
                        tx_max_len=None if pos is None else pos.shape[0])
    model.load_state_dict(state)
    return model.eval().to(device), vocab, split, opt


def eval_via_serving_engine(model, loader, vocab: Vocab, max_len: int,
                            beam_size: int, length_norm: float,
                            decode_chunk: int, bucket_sizes,
                            offline: List[Dict[str, str]]
                            ) -> List[Dict[str, str]]:
    """The split through the serving engine, held caption for caption to
    the offline decode ``offline``: a difference raises (the engine
    changes scheduling, never captions)."""
    serving = serve_decode_split(
        model, loader, vocab, max_len, beam_size=beam_size,
        length_norm=length_norm, decode_chunk=decode_chunk,
        bucket_sizes=bucket_sizes)
    by_id = {p["image_id"]: p["caption"] for p in offline}
    mismatch = [(p["image_id"], by_id.get(p["image_id"]), p["caption"])
                for p in serving if by_id.get(p["image_id"]) != p["caption"]]
    if len(serving) != len(offline) or mismatch:
        detail = "; ".join(f"{vid}: offline={a!r} serving={b!r}"
                           for vid, a, b in mismatch[:5])
        raise RuntimeError(
            f"serving-engine parity FAILED: {len(mismatch)} of "
            f"{len(offline)} captions differ from the offline decode "
            f"({detail})")
    log.info("serving-engine parity: %d captions equal to the offline "
             "decode", len(serving))
    return serving


def evaluate(args: argparse.Namespace) -> Dict[str, Any]:
    """Run one evaluation -> {"scores", "predictions", "videos",
    "decode_steps", "decode_s", "serving_s", "score_s"}."""
    device = default_device(args.device)
    model, vocab, val, opt = load_checkpoint_model(
        args.checkpoint_path, device, args.decode_kernel,
        args.pallas_attention, test_paths=paths_from_opt(args, "test"))
    max_len = args.max_length or opt.max_length
    loader = CaptionLoader(val, args.eval_batch_size or args.batch_size,
                           seq_per_img=1, shuffle=False)
    kw = dict(beam_size=args.beam_size, length_norm=args.length_norm,
              decode_chunk=args.decode_chunk)
    stats: Dict[str, int] = {}
    t0 = time.perf_counter()
    preds = decode_split(model, loader, vocab, max_len, stats=stats, **kw)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    decode_s = time.perf_counter() - t0
    serving_s = None
    if args.engine == "serving":
        t0 = time.perf_counter()
        preds = eval_via_serving_engine(
            model, loader, vocab, max_len, **kw,
            bucket_sizes=parse_buckets(args.serve_buckets), offline=preds)
        serving_s = time.perf_counter() - t0
        log.info("serving engine: %d videos in %.3f s (%.1f videos/s)",
                 len(preds), serving_s, len(preds) / serving_s)
    t0 = time.perf_counter()
    scores = language_eval(preds, val.refs)
    score_s = time.perf_counter() - t0
    log.info("eval: %d videos decoded in %.3f s (%.1f videos/s, %d decode "
             "steps in %d batches, beam %d, decode_kernel %s); scored in "
             "%.3f s", len(preds), decode_s, len(preds) / decode_s,
             stats["decode_steps"], stats["batches"], args.beam_size,
             args.decode_kernel, score_s)
    return {"scores": scores, "predictions": preds, "videos": len(preds),
            "decode_steps": stats["decode_steps"], "decode_s": decode_s,
            "serving_s": serving_s, "score_s": score_s}


def write_json_atomic(path: str, obj) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=2)
    os.replace(tmp, path)


def main(argv=None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(name)s: %(message)s")
    out = evaluate(args)
    log.info("scores: %s", {k: round(v, 4) for k, v in out["scores"].items()})
    if args.result_file:
        write_json_atomic(args.result_file,
                          {"scores": out["scores"],
                           "predictions": out["predictions"]})
        log.info("wrote %s", args.result_file)
    print(json.dumps(out["scores"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
