"""The parity gate of the bfloat16 decode variant (counterpart of the
reference's ``scripts/bf16_parity.py``).

    python -m cst_captioning_tpu_torch.tools.bf16_parity \\
        --checkpoint_path ck/cst [--beam_size 1] [--use_bfloat16 0]

Loads the best step of one of the port's training runs and rebuilds the
synthetic val split of its options (``eval.load_checkpoint_model``: the
same spec and seed), decodes every val video with the model's float32 cell
(``--decode_kernel reference``) and with the bfloat16 variant
(``--decode_kernel bf16``) over the same float32 parameters, scores both
with the port's CIDEr-D, and prints one JSON line: ``parity_gate``'s
verdict (``cider_fp32``, ``cider_bf16``, ``delta``, ``bound``,
``within_bound``, ``kernel_recommendation``), the caption agreement and
the number of videos.  Exits 0 within the bound, 1 outside it (the
recommendation is then the bit-exact ``reference``), 2 on bad usage.

The model computes in the dtype the checkpoint trained in unless
``--use_bfloat16`` says otherwise; a model that already computes in
bfloat16 has nothing to gate (the variant is its own cell): the line
says ``"supported": false`` and the exit code is 0, as the reference's.
Runs on the CUDA device unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from .. import default_device
from ..data.loader import CaptionLoader
from ..eval import load_checkpoint_model
from ..metrics.coco_eval import language_eval
from ..ops.bf16_decode import (DEFAULT_CIDER_DELTA_BOUND,
                               bf16_decode_supported, parity_gate)
from ..training.evaluation import decode_split

EXIT_OK, EXIT_OUTSIDE, EXIT_USAGE = 0, 1, 2


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint_path", required=True,
                   help="a directory the train CLI wrote (its best step)")
    p.add_argument("--beam_size", type=int, default=1)
    p.add_argument("--length_norm", type=float, default=0.0)
    p.add_argument("--decode_chunk", type=int, default=8)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--use_bfloat16", type=int, default=None,
                   help="the model's compute dtype; default: the "
                        "checkpoint's")
    p.add_argument("--cider_delta_bound", type=float,
                   default=DEFAULT_CIDER_DELTA_BOUND)
    p.add_argument("--device", default=None,
                   help="torch device; default cuda (raises without a GPU)")
    args = p.parse_args(argv)
    device = default_device(args.device)
    try:
        model, vocab, val, opt = load_checkpoint_model(args.checkpoint_path,
                                                       device)
    except FileNotFoundError as e:
        print(f"bf16_parity: {e}", file=sys.stderr)
        return EXIT_USAGE
    if args.use_bfloat16 is not None:
        model = model.clone(dtype=torch.bfloat16 if args.use_bfloat16
                            else torch.float32)
    ok, reason = bf16_decode_supported(model)
    if not ok:
        print(json.dumps({"supported": False, "reason": reason,
                          "kernel_recommendation": "reference"}))
        return EXIT_OK
    loader = CaptionLoader(val, args.batch_size, seq_per_img=1,
                           shuffle=False)
    preds, scores = {}, {}
    with torch.no_grad():
        for kernel in ("reference", "bf16"):
            preds[kernel] = decode_split(
                model.clone(decode_kernel=kernel), loader, vocab,
                opt.max_length, beam_size=args.beam_size,
                length_norm=args.length_norm,
                decode_chunk=args.decode_chunk)
            scores[kernel] = language_eval(preds[kernel], val.refs,
                                           scorers=("CIDEr",))["CIDEr"]
    agree = sum(a["caption"] == b["caption"] for a, b in
                zip(preds["reference"], preds["bf16"]))
    out = {"supported": True,
           **parity_gate(scores["reference"], scores["bf16"],
                         args.cider_delta_bound),
           "caption_agreement": agree / len(preds["reference"]),
           "num_videos": len(preds["reference"]),
           "beam_size": args.beam_size}
    print(json.dumps(out))
    if not out["within_bound"]:
        print(f"bf16_parity: CIDEr-D delta {out['delta']:+.4f} exceeds the "
              f"bound {args.cider_delta_bound:g}; the recommendation stays "
              "the bit-exact 'reference' cell", file=sys.stderr)
        return EXIT_OUTSIDE
    return EXIT_OK


if __name__ == "__main__":
    sys.exit(main())
