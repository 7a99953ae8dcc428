"""Timed training steps and beam-5 evaluation at full width, for
comparing checkouts on one card: ``chip_smoke.py`` phase 8's
configuration (64 videos x 20 captions, E = H = A = 512, features 28 x
2048 + 1 x 4096 resident on the card, ``--use_bfloat16 1 --device_feats
1``, K1 and K2 in bfloat16) with more timed steps than the smoke takes.

    python cst_captioning_tpu_torch/tools/train_steps.py --root CHECKOUT
    python cst_captioning_tpu_torch/tools/train_steps.py \\
        --roots PARENT CHANGE CHANGE PARENT

With ``--root`` it imports ``cst_captioning_tpu_torch`` from ``CHECKOUT``
(default: the checkout this file lies in), builds the synthetic
MSR-VTT-size split, runs XE (``--xe_warmup`` + ``--xe_steps``) and then
the fused CST step (``--cst_warmup`` + ``--cst_steps``) from XE's
weights, each step synchronised and timed on the host clock, then
decodes the 497 val videos at beam 5 with the CST model on K2 (batches of
64, as ``chip_smoke.py`` phase 9; one untimed pass, ``--eval_passes``
timed), and prints one JSON line: the per-step milliseconds, their
median and mean, the captions/s at the median, and the eval's videos/s
per pass and at the median.  ``--use_bfloat16 0`` runs in float32 (phase
7 and 9's precision), ``--device_feats 0`` streams the features from the
host.  A checkout whose train CLI has ``--remat_cell`` runs with
``--remat_cell 0``, the step of the checkouts before it.  With
``--roots`` it runs one such process per root, in the order given,
prints each line, and last a summary line of the medians by root.
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.abspath(__file__)
#: ``resilience/exitcodes.py``'s failure code, spelled here: the package
#: is imported from each ``--root`` only after the CUDA check.
EXIT_FAILURE = 1
BATCH, SEQ, MAX_LEN = 64, 20, 30


def stage_args(device_feats: int, use_bfloat16: int, *extra) -> list:
    return ["--synthetic_videos", "6513", "--synthetic_val_videos", "497",
            "--synthetic_rich_vocab", "8000", "--captions_per_video", "20",
            "--feat_shapes", "28x2048,1x4096", "--synthetic_seed", "0",
            "--max_length", str(MAX_LEN), "--rnn_size", "512",
            "--input_encoding_size", "512", "--att_size", "512",
            "--drop_prob", "0.5", "--pallas_attention", "1",
            "--decode_kernel", "fused", "--batch_size", str(BATCH),
            "--seq_per_img", str(SEQ), "--optim", "adam",
            "--learning_rate", "2e-4", "--grad_clip", "10",
            "--decode_chunk", "8", "--seed", "0",
            "--use_bfloat16", str(use_bfloat16),
            "--device_feats", str(device_feats), *extra]


def one_root(args) -> dict:
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("train_steps: needs a CUDA device", file=sys.stderr)
        raise SystemExit(EXIT_FAILURE)
    from cst_captioning_tpu_torch import train
    from cst_captioning_tpu_torch.data.loader import CaptionLoader
    from cst_captioning_tpu_torch.ops import _cuda
    from cst_captioning_tpu_torch.training.evaluation import decode_split
    from cst_captioning_tpu_torch.training.trainer import (Trainer,
                                                           build_splits)

    # The step of the checkouts before --remat_cell (an older parser has
    # no such flag).
    remat = (("--remat_cell", "0")
             if hasattr(train.parse_args([]), "remat_cell") else ())

    def opts(*extra):
        return train.parse_args(stage_args(
            args.device_feats, args.use_bfloat16, *remat, *extra))

    _cuda.build()
    t0 = time.perf_counter()
    splits = build_splits(opts("--use_consensus_weights", "1"))
    split_s = time.perf_counter() - t0
    ck = os.path.join(args.scratch, f"train_steps_{os.getpid()}")

    def steps(trainer, warmup: int, n: int) -> list:
        out = []
        for i in range(warmup + n):
            t0 = time.perf_counter()
            trainer.iteration()
            torch.cuda.synchronize()
            if i >= warmup:
                out.append((time.perf_counter() - t0) * 1e3)
        return out

    def summary(ms: list) -> dict:
        med = float(np.median(ms))
        return {"ms": [round(m, 3) for m in ms], "median_ms": round(med, 3),
                "mean_ms": round(float(np.mean(ms)), 3),
                "captions_per_sec": round(BATCH * SEQ / med * 1e3, 1)}

    xe = Trainer(opts("--checkpoint_path", ck + "_xe"), splits)
    xe_ms = steps(xe, args.xe_warmup, args.xe_steps)
    cst = Trainer(opts("--use_rl", "1", "--rl_baseline", "greedy",
                       "--learning_rate", "2e-5",
                       "--checkpoint_path", ck + "_cst"), splits)
    cst.model.load_state_dict(xe.model.state_dict())
    getattr(xe, "close", lambda: None)()        # an older Trainer has none
    del xe
    cst_ms = steps(cst, args.cst_warmup, args.cst_steps)
    getattr(cst, "close", lambda: None)()
    model, val = cst.model.eval(), splits[1]
    eval_vps = []
    with torch.no_grad():
        for i in range(1 + args.eval_passes):
            loader = CaptionLoader(val, BATCH, seq_per_img=1, shuffle=False)
            t0 = time.perf_counter()
            preds = decode_split(model, loader, cst.vocab, MAX_LEN,
                                 beam_size=5, decode_chunk=8)
            torch.cuda.synchronize()
            if i:
                eval_vps.append(len(preds) / (time.perf_counter() - t0))
    for suffix in ("_xe", "_cst"):
        shutil.rmtree(ck + suffix, ignore_errors=True)
    return {"root": args.root, "device": torch.cuda.get_device_name(0),
            "device_feats": args.device_feats,
            "use_bfloat16": args.use_bfloat16,
            "split_build_s": round(split_s, 1), "xe": summary(xe_ms),
            "cst_fused": summary(cst_ms),
            "eval_beam5": {"videos": val.num_videos,
                           "videos_per_sec": [round(v, 1) for v in eval_vps],
                           "median": round(float(np.median(eval_vps)), 1)}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(HERE))))
    p.add_argument("--roots", nargs="+", default=None,
                   help="one process per root, in this order")
    p.add_argument("--device_feats", type=int, default=1)
    p.add_argument("--use_bfloat16", type=int, default=1)
    p.add_argument("--eval_passes", type=int, default=3)
    p.add_argument("--xe_warmup", type=int, default=3)
    p.add_argument("--xe_steps", type=int, default=12)
    p.add_argument("--cst_warmup", type=int, default=2)
    p.add_argument("--cst_steps", type=int, default=8)
    p.add_argument("--scratch", default="checkpoints",
                   help="directory of the trainers' checkpoint paths "
                        "(nothing is saved there)")
    args = p.parse_args(argv)
    if args.roots is None:
        print(json.dumps(one_root(args)), flush=True)
        return 0
    medians = []
    for root in args.roots:
        cmd = [sys.executable, HERE, "--root", root, *(
            f"--{k}={getattr(args, k)}" for k in (
                "device_feats", "use_bfloat16", "xe_warmup", "xe_steps",
                "cst_warmup", "cst_steps", "eval_passes", "scratch"))]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=900)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(rec), flush=True)
        medians.append([root, rec["xe"]["median_ms"],
                        rec["cst_fused"]["median_ms"],
                        rec["eval_beam5"]["median"]])
    print(json.dumps({"order": [m[0] for m in medians],
                      "xe_median_ms": [m[1] for m in medians],
                      "cst_fused_median_ms": [m[2] for m in medians],
                      "eval_beam5_videos_per_sec": [m[3] for m in medians]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
