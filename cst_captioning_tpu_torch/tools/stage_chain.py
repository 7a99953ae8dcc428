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
``scripts/scale_chain.py`` ``run_stage``; ``MAX_STAGE_ATTEMPTS``
consecutive attempts that leave the stage's checkpoints where they were
abort the chain.  Before each rerun a fresh process probes the card
(``probe_device``: ``import torch``, one CUDA op and a synchronize):
``ok`` reruns, ``wedged`` (the op hung or failed while the import works)
waits for the card, probing every ``WEDGE_POLL_S`` seconds for up to
``--max_wedge_wait_s``, and ``broken`` (the import fails) stops the
chain with the probe's error.  The chain's lifecycle goes to
``chain_events.jsonl`` in ``--out_dir`` (the reference harness's events:
stage starts, attempts, exits, probes, wedges, heals, aborts, each
stage's best), which the reference's ``scripts/chain_report.py`` reads
beside each stage's ``metrics.jsonl`` and ``{stage}_beam5.json``.

The ``eval`` stage (on by default, after ``cst``) runs the eval CLI at
beam 5, batch 32 and max_length 30 (K2 at 160 rows) on the best step of
every stage directory this chain has written (the CST directory of the
``--cst_*`` options), writes ``{stage}_beam5.json`` into ``--out_dir``
and prints Bleu_1-4, METEOR_approx, ROUGE_L and CIDEr beside the
reference chain's beam-5 scores.

``--data_dir DIR`` runs the chain on the split files in ``DIR``
(``data/dataset.py``: ``train_*`` and ``val_*``, as the port's prepro,
``synthetic.write_split`` or ``export_for_torch.py data`` write them) in
place of the synthetic spec: every stage reads ``train_feat<m>.npy``,
``train_label.npz``, ``train_info.json`` and ``train_cocofmt.json`` (and
the ``val_*`` files), with ``train_ciderdf.pkl`` as
``--train_cached_tokens`` and ``train_consensus.pkl`` as
``--train_bcmrscores_pkl`` where they exist; the eval stage decodes the
val files through ``--test_*``.  ``--start_from DIR`` starts CST from
``DIR`` (a train-CLI directory or an exported checkpoint, e.g. the
reference chain's WXE stage through ``export_for_torch.py checkpoint``)
in place of this chain's WXE stage.

``--seed N`` is every train stage's ``--seed`` (default 123, the
reference chain's).  Another seed runs into ``OUT_DIR/seed<N>``, so the
five-seed spread of one CST stage is five commands with one
``--start_from``, none overwriting another's checkpoints or results:

    python -m cst_captioning_tpu_torch.tools.stage_chain --out_dir runs/c \\
        --stages cst,eval --start_from runs/wxe --seed 1
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Optional, Tuple

from ..data.dataset import split_files
from ..resilience import exitcodes
from ..utils.platform import run_in_group

#: Consecutive resumable or wedged attempts of a stage that move none of
#: its checkpoints before the chain gives up (the reference harness's
#: ``--max_stage_attempts`` default).
MAX_STAGE_ATTEMPTS = 4

#: Seconds a fresh probe of the card may take before it counts as hung,
#: and between two probes of a wedged card.
PROBE_TIMEOUT_S = 120.0
WEDGE_POLL_S = 30.0

#: The package's checkout: probes and stages import it from here.
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

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


def data_argv(data_dir: str, split: str,
              as_split: Optional[str] = None) -> list:
    """The file flags of ``split``'s files in ``data_dir`` (named
    ``--{as_split}_*``)."""
    files = split_files(data_dir, split)
    name = as_split or split
    out = [f"--{name}_feat_npy", *files["feat_npy"],
           f"--{name}_label_npz", files["label_npz"],
           f"--{name}_info_json", files["info_json"]]
    if "cocofmt_json" in files:
        out += [f"--{name}_cocofmt_file", files["cocofmt_json"]]
    if name == "train":
        for flag, key in (("--train_cached_tokens", "cached_tokens"),
                          ("--train_bcmrscores_pkl", "consensus_pkl")):
            if key in files:
                out += [flag, files[key]]
    return out


#: The training seed of the reference's recorded chain.
DEFAULT_SEED = 123


def seed_dir(out_dir: str, seed: int) -> str:
    """The chain's directory for ``seed``: ``out_dir`` itself for the
    reference chain's seed, ``out_dir/seed<N>`` for any other, so that
    runs at several seeds (from one ``--start_from``) never share a
    checkpoint, log or result file."""
    return out_dir if seed == DEFAULT_SEED else os.path.join(
        out_dir, f"seed{seed}")


def stage_argv(out_dir: str, xe_patience: int = 25,
               cst_baseline: str = "scb-sample",
               cst_temperature: float = 1.0,
               cst_device_rewards: int = 1, use_bfloat16: int = 0,
               data_dir: Optional[str] = None,
               start_from: Optional[str] = None,
               seed: int = DEFAULT_SEED) -> dict:
    if data_dir:
        data = data_argv(data_dir, "train") + data_argv(data_dir, "val")
    else:
        data = ["--synthetic_videos", "512", "--synthetic_val_videos", "128",
                "--synthetic_rich_vocab", "400", "--captions_per_video",
                "20", "--feat_shapes", "28x2048,1x4096",
                "--synthetic_seed", "0"]
    common = data + [
        "--batch_size", "32", "--seq_per_img", "20",
        "--rnn_size", "192", "--input_encoding_size", "192",
        "--att_size", "192", "--max_length", "30", "--seed", str(seed),
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
            "--learning_rate", "2e-5",
            "--start_from", start_from or f"{ck}/wxe",
            "--checkpoint_path", f"{ck}/{cst_dir}"],
    }


class EventLog:
    """Append-only ``chain_events.jsonl``: the chain's lifecycle as the
    reference harness records it (``{"ts", "event", ...}``).  A write
    that fails is dropped: the log never stops the chain."""

    def __init__(self, path: Optional[str]):
        self.path = path

    def emit(self, event: str, **fields) -> None:
        if not self.path:
            return
        rec = {"ts": time.time(), "event": event, **fields}
        try:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        except OSError:
            pass


def probe_device(timeout_s: float = PROBE_TIMEOUT_S, device: str = "cuda",
                 python: Optional[str] = None) -> Tuple[str, str]:
    """Can a fresh process use the card now?  (The reference's
    ``probe_device``.)  A new process under ``run_in_group`` with a
    timeout runs ``import torch``, one tensor op on ``device`` and, on
    CUDA, a synchronize; a wedged card must not hang this process.
    -> (verdict, detail): ``ok``; ``wedged`` (the op hung or failed while
    ``import torch`` works: waiting may heal it); ``broken`` (the import
    fails: no wait helps)."""
    import tempfile

    python = python or sys.executable

    def run(code: str) -> Tuple[int, bool, str]:
        with tempfile.TemporaryFile(mode="w+") as err:
            info: dict = {}
            rc = run_in_group([python, "-c", code], cwd=REPO,
                              timeout=timeout_s, stdout=subprocess.DEVNULL,
                              stderr=err, timeout_info=info)
            err.seek(0)
            return rc, info["timed_out"], err.read().strip()[-2000:]

    op = (f"import torch; x = torch.ones(1024, device={device!r}); "
          "assert float((x * 2).sum()) == 2048.0")
    if device.startswith("cuda"):
        op += "; torch.cuda.synchronize()"
    rc, timed_out, detail = run(op)
    if rc == 0:
        return "ok", ""
    if timed_out:
        return "wedged", f"device probe timed out after {timeout_s:.0f}s"
    rc2, timed_out2, detail2 = run("import torch")
    if rc2 == 0 or timed_out2:
        return "wedged", detail
    return "broken", detail2 or detail


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
              max_attempts: int, events: Optional[EventLog] = None,
              max_wedge_wait_s: float = 600.0
              ) -> subprocess.CompletedProcess:
    """Run one stage to its end, running it again after a resumable
    (75) or wedge (124) exit; it resumes from its newest verified
    checkpoint.  Before a rerun the card is probed (``probe_device``):
    ``ok`` reruns, ``wedged`` waits for the card to heal (up to
    ``max_wedge_wait_s``), ``broken`` stops.  Gives up after
    ``max_attempts`` consecutive attempts that did not move the stage's
    checkpoints, on a card that does not heal or is broken, and on any
    other exit.  -> the last attempt (stderr of every attempt in
    ``log_path``)."""
    events = events or EventLog(None)
    no_progress, last_fp, attempt = 0, stage_fingerprint(stage_dir), 0
    with open(log_path, "w") as log:
        while True:
            attempt += 1
            events.emit("attempt_start", tag=name, attempt=attempt,
                        no_progress=no_progress)
            proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=log,
                                  text=True, check=False)
            rc = proc.returncode
            kind = exitcodes.classify(rc)
            if rc == 0:
                events.emit("stage_done", tag=name, attempts=attempt)
                return proc
            fp = stage_fingerprint(stage_dir)
            progressed = fp != last_fp
            no_progress = 0 if progressed else no_progress + 1
            last_fp = fp
            events.emit("attempt_exit", tag=name, attempt=attempt, rc=rc,
                        timed_out=False, progressed=progressed)
            if kind not in (exitcodes.RESUMABLE, exitcodes.WEDGE):
                events.emit("stage_abort", tag=name, reason="real_failure")
                return proc
            if no_progress >= max_attempts:
                print(f"stage {name}: {no_progress} consecutive attempts "
                      "made no progress on disk; giving up",
                      file=sys.stderr)
                events.emit("stage_abort", tag=name,
                            reason="no_progress_cap")
                return proc
            if kind == exitcodes.RESUMABLE:
                events.emit("resumable_exit", tag=name, rc=rc,
                            preempted=(exitcodes.normalize(rc)
                                       == exitcodes.EXIT_PREEMPTED),
                            progressed=progressed)
            else:
                events.emit("wedge", tag=name, rc=rc, attempt=attempt)
            verdict = _await_card(name, events, max_wedge_wait_s)
            if verdict != "ok":
                return proc
            print(f"stage {name}: attempt {attempt} exited {rc} "
                  f"({exitcodes.describe(rc)}); "
                  f"{'progress' if no_progress == 0 else 'no progress'}, "
                  "the card probed ok, running it again", flush=True)


def _await_card(name: str, events: EventLog, max_wait_s: float) -> str:
    """Probe the card before a rerun -> "ok", or the verdict that stops
    the stage ("broken", or "wedged" after ``max_wait_s`` of probes)."""
    t0 = time.monotonic()
    wedged = False
    while True:
        verdict, detail = probe_device()
        events.emit("probe", tag=name, verdict=verdict)
        if verdict == "ok":
            if wedged:
                events.emit("healed", tag=name,
                            waited_s=round(time.monotonic() - t0, 1))
            return verdict
        if verdict == "broken":
            print(f"stage {name}: the stage environment cannot import "
                  f"torch; not a wedge, stopping:\n{detail}",
                  file=sys.stderr)
            events.emit("stage_abort", tag=name, reason="broken_env")
            return verdict
        if not wedged:
            one_line = " | ".join(x.strip() for x in detail.splitlines()
                                  if x.strip())
            print(f"stage {name}: the card probed wedged ({one_line}); "
                  f"probing every {WEDGE_POLL_S:.0f} s", file=sys.stderr)
        wedged = True
        if time.monotonic() - t0 >= max_wait_s:
            print(f"stage {name}: the card did not heal within "
                  f"{max_wait_s:.0f} s; stopping", file=sys.stderr)
            events.emit("stage_abort", tag=name,
                        reason="heal_wait_exhausted")
            return verdict
        time.sleep(WEDGE_POLL_S)


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
    p.add_argument("--data_dir", default=None,
                   help="run on the train_*/val_* split files in this "
                        "directory instead of the synthetic spec")
    p.add_argument("--start_from", default=None,
                   help="CST starts from this directory (a train-CLI "
                        "directory or an exported checkpoint) instead of "
                        "this chain's WXE stage")
    p.add_argument("--wedge_timeout", type=float, default=0.0,
                   help="each train stage's --wedge_timeout (exit 124 and "
                        "a resumed attempt after that many seconds without "
                        "progress); 0 = off")
    p.add_argument("--max_wedge_wait_s", type=float, default=600.0,
                   help="how long a stage waits for a card that probes "
                        "wedged before the chain stops")
    p.add_argument("--seed", type=int, default=DEFAULT_SEED,
                   help="every train stage's --seed; a seed other than "
                        f"the reference chain's {DEFAULT_SEED} runs into "
                        "OUT_DIR/seed<N>")
    args = p.parse_args(argv)
    args.out_dir = seed_dir(args.out_dir, args.seed)
    os.makedirs(args.out_dir, exist_ok=True)
    events = EventLog(os.path.join(args.out_dir, "chain_events.jsonl"))
    events.emit("chain_start", argv=list(sys.argv[1:] if argv is None
                                         else argv), pid=os.getpid(),
                stages=args.stages)
    stages = stage_argv(args.out_dir, args.xe_max_patience,
                        args.cst_baseline, args.cst_temperature,
                        args.cst_device_rewards, args.use_bfloat16,
                        args.data_dir, args.start_from, args.seed)
    results = {}
    for name in args.stages.split(","):
        if name == "eval":
            results["eval"] = eval_stage(
                args.out_dir, stages,
                data_argv(args.data_dir, "val", "test")
                if args.data_dir else [], events)
            if results["eval"] is None:
                return 1
            continue
        t0 = time.perf_counter()
        ck_dir = stages[name][stages[name].index("--checkpoint_path") + 1]
        log_path = os.path.join(args.out_dir,
                                f"{os.path.basename(ck_dir)}.log")
        events.emit("stage_start", tag=name, stage_dir=ck_dir)
        proc = run_stage(
            name, [sys.executable, "-m", "cst_captioning_tpu_torch.train",
                   *stages[name], "--wedge_timeout",
                   str(args.wedge_timeout)],
            ck_dir, log_path, MAX_STAGE_ATTEMPTS, events=events,
            max_wedge_wait_s=args.max_wedge_wait_s)
        if proc.returncode != 0:
            print(f"stage {name} failed with exit code {proc.returncode}; "
                  f"see {log_path}", file=sys.stderr)
            return proc.returncode
        summary = json.loads(proc.stdout.strip().splitlines()[-1])
        events.emit("stage_best", tag=name,
                    best_score=summary["best_score"],
                    best_step=summary["best_step"])
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
    events.emit("chain_done", stages=args.stages)
    best = [results[s]["best_score"] for s in ("xe", "wxe", "cst")
            if s in results]
    print(json.dumps({"stages": results,
                      "ordered": all(a < b for a, b in zip(best, best[1:])),
                      "reference": REFERENCE,
                      "reference_beam5": REFERENCE_BEAM5}))
    return 0


def eval_stage(out_dir: str, stages: dict, data: list,
               events: Optional[EventLog] = None):
    """Beam-5 eval of each stage's best step on ``data`` (``--test_*``
    flags; none: the stage's own val split) -> {stage: scores}, or None
    when an eval failed."""
    events = events or EventLog(None)
    scores = {}
    for name in ("xe", "wxe", "cst"):
        argv = stages[name]
        ck_dir = argv[argv.index("--checkpoint_path") + 1]
        if not os.path.exists(os.path.join(ck_dir, "infos.json")):
            continue
        result = os.path.join(out_dir, f"{name}_beam5.json")
        events.emit("stage_start", tag=f"eval:{name}", stage_dir=ck_dir)
        t0 = time.perf_counter()
        with open(os.path.join(out_dir, f"eval_{name}.log"), "w") as log:
            proc = subprocess.run(
                [sys.executable, "-m", "cst_captioning_tpu_torch.eval",
                 "--checkpoint_path", ck_dir, "--beam_size", "5",
                 "--batch_size", "32", "--max_length", "30",
                 "--decode_kernel", "fused", "--result_file", result,
                 *data],
                stdout=subprocess.PIPE, stderr=log, text=True, check=False)
        if proc.returncode != 0:
            print(f"eval of {ck_dir} failed with exit code "
                  f"{proc.returncode}", file=sys.stderr)
            events.emit("stage_abort", tag=f"eval:{name}",
                        reason="real_failure")
            return None
        events.emit("stage_done", tag=f"eval:{name}", attempts=1)
        scores[name] = json.loads(proc.stdout.strip().splitlines()[-1])
        ref = REFERENCE_BEAM5[name]
        print(f"eval {name} (beam 5, {time.perf_counter() - t0:.1f} s): "
              + ", ".join(f"{k} {v:.4f} (reference {ref[k]:.4f})"
                          for k, v in scores[name].items()), flush=True)
    return scores


if __name__ == "__main__":
    sys.exit(main())
