"""XE -> WXE -> CST as three separate train-CLI processes chained by
``--start_from``: the learning check of the port's training path.

    python -m cst_captioning_tpu_torch.tools.stage_chain --out_dir runs/chain

The spec and hyperparameters are those of the reference's recorded chain
``artifacts/cpu512_healthy`` (``scripts/scale_chain.py`` with 512 + 128
videos, rich vocabulary 400, width 192, batch 32 x 20; XE 100 epochs at
2e-4, WXE 20 at 1e-4, CST with the scb-sample baseline 12 at 2e-5; XE and
WXE halve the rate every 30 epochs with patience 25, XE not stopping
before epoch 30).  The reference ran bfloat16 logits with on-device
rewards (``device_rewards 1``: strictly on-policy, float32 CIDEr-D) and
device-resident features; the port runs float32 logits, and CST on the
fused on-device path by default (``--cst_device_rewards 1``) or on the
host reward (``0``, the pipeline at its default depth 2).  Each stage's
best validation CIDEr-D is printed beside the reference's, then one JSON
line with all three.  Every stage runs K1 in teacher forcing and K2 in
rollouts and validation.  ``--stages cst`` with ``--cst_baseline`` /
``--cst_temperature`` / ``--cst_noise_dtype`` / ``--cst_device_rewards``
runs another CST stage from the same WXE checkpoint, into its own
directory.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

#: Best val CIDEr-D per stage of the reference's chain
#: (artifacts/cpu512_healthy/report.md).
REFERENCE = {"xe": 2.5352, "wxe": 2.8277, "cst": 3.1096}


def stage_argv(out_dir: str, xe_patience: int = 25,
               cst_baseline: str = "scb-sample",
               cst_temperature: float = 1.0,
               cst_noise_dtype: str = "float32",
               cst_device_rewards: int = 1) -> dict:
    common = ["--synthetic_videos", "512", "--synthetic_val_videos", "128",
              "--synthetic_rich_vocab", "400", "--captions_per_video", "20",
              "--feat_shapes", "28x2048,1x4096", "--synthetic_seed", "0",
              "--batch_size", "32", "--seq_per_img", "20",
              "--rnn_size", "192", "--input_encoding_size", "192",
              "--att_size", "192", "--max_length", "30", "--seed", "123",
              "--decode_chunk", "8", "--log_every", "50",
              "--pallas_attention", "1", "--decode_kernel", "fused"]
    sched = ["--learning_rate_decay_every", "30",
             "--learning_rate_decay_rate", "0.5"]
    ck = os.path.join(out_dir, "checkpoints")
    cst_dir = ("cst" if (cst_baseline, cst_temperature, cst_noise_dtype)
               == ("scb-sample", 1.0, "float32")
               else f"cst_{cst_baseline}_T{cst_temperature:g}"
               + ("" if cst_noise_dtype == "float32"
                  else f"_{cst_noise_dtype}"))
    if not cst_device_rewards:
        cst_dir += "_host"
    return {
        "xe": common + sched + [
            "--max_patience", str(xe_patience),
            "--min_epochs", "30", "--max_epochs", "100",
            "--learning_rate", "2e-4", "--checkpoint_path", f"{ck}/xe"],
        "wxe": common + sched + [
            "--max_patience", "25", "--use_consensus_weights", "1",
            "--max_epochs", "20",
            "--learning_rate", "1e-4", "--start_from", f"{ck}/xe",
            "--checkpoint_path", f"{ck}/wxe"],
        "cst": common + [
            "--use_rl", "1", "--rl_baseline", cst_baseline,
            "--temperature", str(cst_temperature),
            "--noise_dtype", cst_noise_dtype,
            "--device_rewards", str(cst_device_rewards),
            "--max_patience", "0", "--max_epochs", "12",
            "--learning_rate", "2e-5", "--start_from", f"{ck}/wxe",
            "--checkpoint_path", f"{ck}/{cst_dir}"],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out_dir", required=True)
    p.add_argument("--xe_max_patience", type=int, default=25,
                   help="XE's early-stop patience in epochs (0 = the full "
                        "100 epochs); the reference's chain used 25")
    p.add_argument("--stages", default="xe,wxe,cst")
    p.add_argument("--cst_baseline", default="scb-sample",
                   choices=("greedy", "scb-sample", "scb-gt"),
                   help="CST's baseline; the reference's chain used "
                        "scb-sample")
    p.add_argument("--cst_temperature", type=float, default=1.0,
                   help="CST's sampling temperature")
    p.add_argument("--cst_noise_dtype", default="float32",
                   choices=("float32", "bfloat16"),
                   help="dtype of CST's Gumbel noise; the reference's chain "
                        "drew it in bfloat16")
    p.add_argument("--cst_device_rewards", type=int, default=1,
                   choices=(0, 1),
                   help="CST's reward: 1 = the fused on-device CIDEr-D "
                        "step (the reference chain's device_rewards 1), "
                        "0 = the host reward pipeline")
    args = p.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    stages = stage_argv(args.out_dir, args.xe_max_patience,
                        args.cst_baseline, args.cst_temperature,
                        args.cst_noise_dtype, args.cst_device_rewards)
    results = {}
    for name in args.stages.split(","):
        t0 = time.perf_counter()
        ck_dir = stages[name][stages[name].index("--checkpoint_path") + 1]
        log_path = os.path.join(args.out_dir,
                                f"{os.path.basename(ck_dir)}.log")
        with open(log_path, "w") as log:
            proc = subprocess.run(
                [sys.executable, "-m", "cst_captioning_tpu_torch.train",
                 *stages[name]], stdout=subprocess.PIPE, stderr=log,
                text=True, check=False)
        if proc.returncode != 0:
            print(f"stage {name} failed with exit code {proc.returncode}; "
                  f"see {log_path}", file=sys.stderr)
            return proc.returncode
        summary = json.loads(proc.stdout.strip().splitlines()[-1])
        with open(os.path.join(summary["checkpoint_path"],
                               "infos.json")) as f:
            history = json.load(f)["history"]
        results[name] = {**summary, "seconds": time.perf_counter() - t0,
                         "epochs": len(history),
                         "val_cider": [h["CIDEr"] for h in history]}
        print(f"stage {name}: best val CIDEr-D {summary['best_score']} at "
              f"step {summary['best_step']} of {summary['last_step']} "
              f"({len(history)} epochs, {results[name]['seconds']:.1f} s); "
              f"the reference's chain: {REFERENCE[name]}", flush=True)
    best = [results[s]["best_score"] for s in ("xe", "wxe", "cst")
            if s in results]
    print(json.dumps({"stages": results,
                      "ordered": all(a < b for a, b in zip(best, best[1:])),
                      "reference": REFERENCE}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
