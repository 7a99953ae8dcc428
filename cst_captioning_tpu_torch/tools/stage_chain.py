"""XE -> WXE -> CST as three separate train-CLI processes chained by
``--start_from``: the learning check of the port's training path.

    python -m cst_captioning_tpu_torch.tools.stage_chain --out_dir runs/chain

The spec and hyperparameters are those of the reference's recorded chain
``artifacts/cpu512_healthy`` (``scripts/scale_chain.py`` with 512 + 128
videos, rich vocabulary 400, width 192, batch 32 x 20; XE 100 epochs at
2e-4, WXE 20 at 1e-4, CST with the scb-sample baseline 12 at 2e-5; XE and
WXE halve the rate every 30 epochs with patience 25, XE not stopping
before epoch 30).  The reference ran every stage in bfloat16
(``use_bfloat16 1``, features in bfloat16) with device-resident features
and on-device rewards (``device_rewards 1``: strictly on-policy, float32
CIDEr-D).  ``--use_bfloat16 1`` runs the port so: every stage at
``--use_bfloat16 1`` (bfloat16 features follow) with ``--device_feats
1``; 0 (the default) runs it in float32.  CST runs on the fused on-device
path by default (``--cst_device_rewards 1``) or on the host reward
(``0``, the pipeline at its default depth 2).  Each stage's best
validation CIDEr-D is printed beside the reference's, then one JSON line
with all three.  Every stage runs K1 in teacher forcing and K2 in
rollouts and validation, in the stages' storage dtype.  Validation scores
CIDEr only and selects on it (``--fast_val 1 --eval_metric CIDEr``), as
the reference's chain ran.  ``--stages cst`` with ``--cst_baseline`` /
``--cst_temperature`` / ``--cst_device_rewards`` runs another CST stage
from the same WXE checkpoint, into its own directory.

Each stage logs a train record every 10 steps and a val record per
epoch to ``metrics.jsonl`` in its checkpoint directory, as the
reference's chain did (``artifacts/cpu512_healthy/*/metrics.jsonl``).  A
stage that exits resumable (75, preempted after a verified save) or
wedged (124, the watchdog of ``--wedge_timeout``) is run again and
resumes from its newest verified checkpoint, after the reference's
``scripts/scale_chain.py`` ``run_stage`` (without its device probe);
``MAX_STAGE_ATTEMPTS`` consecutive attempts that leave the stage's
checkpoints where they were abort the chain.

The ``eval`` stage (on by default, after ``cst``) runs the eval CLI at
beam 5, batch 32 and max_length 30 (K2 at 160 rows) on the best step of
every stage directory this chain has written (the CST directory of the
``--cst_*`` options), writes ``{stage}_beam5.json`` into ``--out_dir``
and prints Bleu_1-4, METEOR_approx, ROUGE_L and CIDEr beside the
reference chain's beam-5 scores.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from ..resilience import exitcodes

#: Consecutive resumable or wedged attempts of a stage that move none of
#: its checkpoints before the chain gives up (the reference harness's
#: ``--max_stage_attempts`` default).
MAX_STAGE_ATTEMPTS = 4

#: Best val CIDEr-D per stage of the reference's chain
#: (artifacts/cpu512_healthy/report.md).
REFERENCE = {"xe": 2.5352, "wxe": 2.8277, "cst": 3.1096}

#: Beam-5 val scores of the reference chain's best checkpoints
#: (artifacts/cpu512_healthy/{xe,wxe,cst_scb_sample}_beam5.json).
REFERENCE_BEAM5 = {
    "xe": {"Bleu_1": 0.7302064851022512, "Bleu_2": 0.5751567926535752,
           "Bleu_3": 0.45067834859006706, "Bleu_4": 0.35367761981008455,
           "METEOR_approx": 0.6462826840569083, "ROUGE_L": 0.705581509496305,
           "CIDEr": 2.3032758102796835},
    "wxe": {"Bleu_1": 0.7789581784305578, "Bleu_2": 0.6462953580235381,
            "Bleu_3": 0.5338678901925413, "Bleu_4": 0.44091924261731685,
            "METEOR_approx": 0.7087670023310043,
            "ROUGE_L": 0.7377759639303482, "CIDEr": 2.9372583081366423},
    "cst": {"Bleu_1": 0.7924027707734712, "Bleu_2": 0.6694180582896315,
            "Bleu_3": 0.5589803269360998, "Bleu_4": 0.4636369384193793,
            "METEOR_approx": 0.7243445407697031,
            "ROUGE_L": 0.7488783759772564, "CIDEr": 3.108681281479171},
}


def stage_argv(out_dir: str, xe_patience: int = 25,
               cst_baseline: str = "scb-sample",
               cst_temperature: float = 1.0,
               cst_device_rewards: int = 1, use_bfloat16: int = 0) -> dict:
    common = ["--synthetic_videos", "512", "--synthetic_val_videos", "128",
              "--synthetic_rich_vocab", "400", "--captions_per_video", "20",
              "--feat_shapes", "28x2048,1x4096", "--synthetic_seed", "0",
              "--batch_size", "32", "--seq_per_img", "20",
              "--rnn_size", "192", "--input_encoding_size", "192",
              "--att_size", "192", "--max_length", "30", "--seed", "123",
              "--decode_chunk", "8", "--log_every", "10",
              "--fast_val", "1", "--eval_metric", "CIDEr",
              "--pallas_attention", "1", "--decode_kernel", "fused",
              "--use_bfloat16", str(use_bfloat16)]
    if use_bfloat16:
        common += ["--device_feats", "1"]
    sched = ["--learning_rate_decay_every", "30",
             "--learning_rate_decay_rate", "0.5"]
    ck = os.path.join(out_dir, "checkpoints")
    cst_dir = ("cst" if (cst_baseline, cst_temperature)
               == ("scb-sample", 1.0)
               else f"cst_{cst_baseline}_T{cst_temperature:g}")
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
            "--device_rewards", str(cst_device_rewards),
            "--max_patience", "0", "--max_epochs", "12",
            "--learning_rate", "2e-5", "--start_from", f"{ck}/wxe",
            "--checkpoint_path", f"{ck}/{cst_dir}"],
    }


def stage_fingerprint(stage_dir: str) -> tuple:
    """The stage's progress on disk: ``infos.json``'s last and best step
    and the checkpoint steps of both sets.  Not ``metrics.jsonl``: a
    resume re-logs the steps it replays, which is no progress."""
    marks = []
    try:
        with open(os.path.join(stage_dir, "infos.json")) as f:
            infos = json.load(f)
        marks.append(("infos", infos.get("last_step"),
                      infos.get("best_step")))
    except (OSError, ValueError):
        pass
    for sub in (".", "recovery"):
        try:
            steps = sorted(e for e in os.listdir(os.path.join(stage_dir, sub))
                           if e.isdigit())
        except OSError:
            steps = []
        marks.append((sub, tuple(steps)))
    return tuple(marks)


def run_stage(name: str, cmd: list, stage_dir: str, log_path: str,
              max_attempts: int) -> subprocess.CompletedProcess:
    """Run one stage to its end, running it again after a resumable
    (75) or wedge (124) exit; it resumes from its newest verified
    checkpoint.  Gives up after ``max_attempts`` consecutive attempts
    that did not move the stage's checkpoints, and on any other exit.
    -> the last attempt (stderr of every attempt in ``log_path``)."""
    no_progress, last_fp, attempt = 0, stage_fingerprint(stage_dir), 0
    with open(log_path, "w") as log:
        while True:
            attempt += 1
            proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=log,
                                  text=True, check=False)
            kind = exitcodes.classify(proc.returncode)
            if proc.returncode == 0 or kind not in (exitcodes.RESUMABLE,
                                                    exitcodes.WEDGE):
                return proc
            fp = stage_fingerprint(stage_dir)
            no_progress = 0 if fp != last_fp else no_progress + 1
            last_fp = fp
            print(f"stage {name}: attempt {attempt} exited "
                  f"{proc.returncode} ({exitcodes.describe(proc.returncode)})"
                  f"; {'progress' if no_progress == 0 else 'no progress'}, "
                  "running it again", flush=True)
            if no_progress >= max_attempts:
                print(f"stage {name}: {no_progress} consecutive attempts "
                      "made no progress on disk; giving up",
                      file=sys.stderr)
                return proc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out_dir", required=True)
    p.add_argument("--xe_max_patience", type=int, default=25,
                   help="XE's early-stop patience in epochs (0 = the full "
                        "100 epochs); the reference's chain used 25")
    p.add_argument("--stages", default="xe,wxe,cst,eval")
    p.add_argument("--cst_baseline", default="scb-sample",
                   choices=("greedy", "scb-sample", "scb-gt"),
                   help="CST's baseline; the reference's chain used "
                        "scb-sample")
    p.add_argument("--cst_temperature", type=float, default=1.0,
                   help="CST's sampling temperature")
    p.add_argument("--use_bfloat16", type=int, default=0, choices=(0, 1),
                   help="1 = every stage in bfloat16 with bfloat16 "
                        "features resident on the device, as the "
                        "reference's chain ran; 0 = float32")
    p.add_argument("--cst_device_rewards", type=int, default=1,
                   choices=(0, 1),
                   help="CST's reward: 1 = the fused on-device CIDEr-D "
                        "step (the reference chain's device_rewards 1), "
                        "0 = the host reward pipeline")
    p.add_argument("--wedge_timeout", type=float, default=0.0,
                   help="each train stage's --wedge_timeout (exit 124 and "
                        "a resumed attempt after that many seconds without "
                        "progress); 0 = off")
    args = p.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    stages = stage_argv(args.out_dir, args.xe_max_patience,
                        args.cst_baseline, args.cst_temperature,
                        args.cst_device_rewards, args.use_bfloat16)
    results = {}
    for name in args.stages.split(","):
        if name == "eval":
            results["eval"] = eval_stage(args.out_dir, stages)
            if results["eval"] is None:
                return 1
            continue
        t0 = time.perf_counter()
        ck_dir = stages[name][stages[name].index("--checkpoint_path") + 1]
        log_path = os.path.join(args.out_dir,
                                f"{os.path.basename(ck_dir)}.log")
        proc = run_stage(
            name, [sys.executable, "-m", "cst_captioning_tpu_torch.train",
                   *stages[name], "--wedge_timeout",
                   str(args.wedge_timeout)],
            ck_dir, log_path, MAX_STAGE_ATTEMPTS)
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
                      "reference": REFERENCE,
                      "reference_beam5": REFERENCE_BEAM5}))
    return 0


def eval_stage(out_dir: str, stages: dict):
    """Beam-5 eval of each stage's best step -> {stage: scores}, or None
    when an eval failed."""
    scores = {}
    for name in ("xe", "wxe", "cst"):
        argv = stages[name]
        ck_dir = argv[argv.index("--checkpoint_path") + 1]
        if not os.path.exists(os.path.join(ck_dir, "infos.json")):
            continue
        result = os.path.join(out_dir, f"{name}_beam5.json")
        t0 = time.perf_counter()
        with open(os.path.join(out_dir, f"eval_{name}.log"), "w") as log:
            proc = subprocess.run(
                [sys.executable, "-m", "cst_captioning_tpu_torch.eval",
                 "--checkpoint_path", ck_dir, "--beam_size", "5",
                 "--batch_size", "32", "--max_length", "30",
                 "--decode_kernel", "fused", "--result_file", result],
                stdout=subprocess.PIPE, stderr=log, text=True, check=False)
        if proc.returncode != 0:
            print(f"eval of {ck_dir} failed with exit code "
                  f"{proc.returncode}", file=sys.stderr)
            return None
        scores[name] = json.loads(proc.stdout.strip().splitlines()[-1])
        ref = REFERENCE_BEAM5[name]
        print(f"eval {name} (beam 5, {time.perf_counter() - t0:.1f} s): "
              + ", ".join(f"{k} {v:.4f} (reference {ref[k]:.4f})"
                          for k, v in scores[name].items()), flush=True)
    return scores


if __name__ == "__main__":
    sys.exit(main())
