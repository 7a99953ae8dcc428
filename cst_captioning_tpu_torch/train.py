"""Training CLI of the port (counterpart of the reference's ``train.py``):
one stage per run, as the reference runs them.

    XE:   python -m cst_captioning_tpu_torch.train --checkpoint_path ck/xe
    WXE:  ... --use_consensus_weights 1 --start_from ck/xe \\
              --checkpoint_path ck/wxe
    CST:  ... --use_rl 1 --rl_baseline greedy|scb-sample|scb-gt \\
              --start_from ck/wxe --checkpoint_path ck/cst

CST runs the fused on-device step by default (``--device_rewards 1``:
rollout, on-device CIDEr-D, REINFORCE gradient and the guarded update,
strictly on-policy); ``--device_rewards 0`` scores on the host through a
pipeline ``--overlap_rewards`` rollouts deep, with the native C++ CIDEr-D
(``--native_cider 1``, the default; the Python scorer, with a warning,
where it cannot be built).  ``--loader_workers`` threads assemble the
batches ahead of the step, in the loader's own order.  The divergence guard
(``--divergence_guard 1``) skips non-finite updates on the device and
rolls back after ``--divergence_max_bad`` in a row.

Flags keep the reference's names (its ``opts.py``).  The data are
synthetic splits built in memory from ``--synthetic_seed``
(``--synthetic_videos``, ``--synthetic_val_videos``,
``--synthetic_rich_vocab``, ``--captions_per_video``, ``--feat_shapes``,
``--max_length``), the generator of the reference's ``data/synthetic.py``.
Runs on the CUDA device unless ``--device cpu`` is given; without a GPU
it raises instead of running on the CPU.  Validation scores the val split
with ``language_eval`` (``--fast_val 1``: CIDEr and the selection metric
only) and ``--eval_metric`` picks the best checkpoint.  The last line of
standard output is a JSON summary: best score, its step, the last step,
the metric and the checkpoint directory.

A run into a ``--checkpoint_path`` that holds checkpoints resumes from
its newest verified step and ends bit-identical to an uninterrupted run
(``training/trainer.py``).  Resilience flags, with the reference's names
and defaults: ``--max_checkpoints``, ``--save_every_steps``,
``--save_interval_secs``, ``--wedge_timeout``, ``--fault_plan`` (or
``CST_FAULT_PLAN``) and ``--abort_on_negative_advantage_window``.  Exit
codes (``resilience/exitcodes.py``): 0 done; 2 a usage error (a malformed
fault plan too); 4 the negative-advantage abort, with one JSON line
``{"aborted", "detail"}``; 75 preempted by SIGTERM or a first SIGINT
after a verified save, with one JSON line ``{"preempted", "step",
"saved", "checkpoint_path"}``; 124 the watchdog saw no progress for
``--wedge_timeout`` seconds.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

from .metrics.coco_eval import KNOWN_EVAL_METRICS
from .resilience.exitcodes import EXIT_ADVANTAGE_ABORT, EXIT_OK, EXIT_PREEMPTED
from .resilience.faults import FaultPlan
from .resilience.preemption import PreemptedExit, PreemptionHandler
from .training.state import OPTIMIZERS
from .training.trainer import NegativeAdvantageAbort, Trainer


def _fault_plan(text: str) -> str:
    """argparse type of ``--fault_plan``: a malformed plan is a usage
    error (exit 2) naming the bad spec, not a start-up traceback."""
    try:
        FaultPlan.parse(text)
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e)) from None
    return text


def positive_int(text: str) -> int:
    """argparse type of a count that must be at least 1."""
    value = int(text)
    if value < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {value}")
    return value


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    g = p.add_argument_group("data (synthetic, in memory)")
    g.add_argument("--synthetic_videos", type=int, default=512)
    g.add_argument("--synthetic_val_videos", type=int, default=128)
    g.add_argument("--synthetic_rich_vocab", type=int, default=0,
                   help="> 0: the rich grammar with word pools of about "
                        "this many words; 0: the 15-word grammar")
    g.add_argument("--captions_per_video", type=int, default=20)
    g.add_argument("--feat_shapes", default="28x2048,1x4096")
    g.add_argument("--synthetic_seed", type=int, default=0)
    g.add_argument("--loader_workers", type=positive_int, default=1,
                   help="prefetch threads assembling batches ahead of the "
                        "step; the batch order is the same at any count")
    g = p.add_argument_group("model")
    g.add_argument("--rnn_size", type=int, default=512)
    g.add_argument("--input_encoding_size", type=int, default=512)
    g.add_argument("--att_size", type=int, default=512)
    g.add_argument("--drop_prob", type=float, default=0.5)
    g.add_argument("--pallas_attention", type=int, default=0,
                   help="1 = the decoder's attention on the K1 kernel")
    g.add_argument("--decode_kernel", choices=("reference", "fused", "bf16"),
                   default="reference",
                   help="decode cell of rollouts and validation: the "
                        "model's cell, the K2 kernel, or the model's cell "
                        "in bfloat16 (float32 carry and logits at the "
                        "step's boundary)")
    g.add_argument("--use_bfloat16", type=int, default=0,
                   help="1 = compute in bfloat16 over float32 parameters, "
                        "gradients and optimizer state: every Dense, the "
                        "embedding, the LSTM cell, the logits, log-softmax "
                        "and the Gumbel noise, as the reference's flax "
                        "dtype; both kernels in bfloat16 storage")
    g.add_argument("--bf16_feats", type=int, default=None,
                   help="1 = features cast to bfloat16 on the host before "
                        "the copy (and the --device_feats table held in "
                        "bfloat16); 0 = float32; default: follow "
                        "--use_bfloat16")
    g = p.add_argument_group("optimisation")
    g.add_argument("--batch_size", type=int, default=64)
    g.add_argument("--seq_per_img", type=int, default=20)
    g.add_argument("--optim", choices=OPTIMIZERS, default="adam",
                   help="optax's update rules and defaults")
    g.add_argument("--learning_rate", type=float, default=2e-4)
    g.add_argument("--grad_clip", type=float, default=10.0)
    g.add_argument("--learning_rate_decay_rate", type=float, default=0.8)
    g.add_argument("--learning_rate_decay_every", type=int, default=3,
                   help="epochs between staircase decays; 0 disables")
    g.add_argument("--max_epochs", type=int, default=50)
    g.add_argument("--max_patience", type=int, default=5,
                   help="early stop after this many epochs without a "
                        "better val score; 0 = off")
    g.add_argument("--min_epochs", type=int, default=0)
    g.add_argument("--seed", type=int, default=123)
    g = p.add_argument_group("WXE and CST")
    g.add_argument("--use_consensus_weights", type=int, default=0)
    g.add_argument("--consensus_temperature", type=float, default=1.0)
    g.add_argument("--use_rl", type=int, default=0)
    g.add_argument("--rl_baseline", default="greedy",
                   choices=("greedy", "scb-sample", "scb-gt"))
    g.add_argument("--scb_captions", type=int, default=0)
    g.add_argument("--temperature", type=float, default=1.0)
    g.add_argument("--device_rewards", type=int, default=1,
                   help="1 = CIDEr-D on the device and the whole CST "
                        "iteration in one fused step (strictly on-policy); "
                        "0 = the host reward path")
    g.add_argument("--native_cider", type=int, default=1,
                   help="host reward path: 1 = the C++ CIDEr-D scorer "
                        "(built with g++ at first use; the Python scorer "
                        "with a warning when it cannot be); 0 = the "
                        "Python scorer")
    g.add_argument("--device_cider_chunk_mb", type=float, default=256,
                   help="budget of the on-device reward's hyp-ref match "
                        "tensor; over it the match is chunked over the "
                        "references")
    g.add_argument("--overlap_rewards", type=int, default=2,
                   help="host-path (--device_rewards 0) pipeline depth: "
                        "rollouts in flight while the host scores; 0 = "
                        "serial, k >= 1 = samples up to k updates stale. "
                        "Ignored under --device_rewards 1")
    g.add_argument("--device_feats", type=int, default=0,
                   help="1 = every training video's features resident on "
                        "the device, gathered by video index")
    g.add_argument("--device_feats_max_gb", type=float, default=8.0,
                   help="refuse --device_feats over this many GB")
    g = p.add_argument_group("resilience")
    g.add_argument("--divergence_guard", type=int, default=1,
                   help="1 = skip a step with a non-finite loss or gradient "
                        "norm on the device, and roll back after "
                        "--divergence_max_bad in a row")
    g.add_argument("--divergence_max_bad", type=int, default=3,
                   help="consecutive non-finite steps before a rollback")
    g.add_argument("--divergence_max_rollbacks", type=int, default=2,
                   help="rollbacks before the run aborts as unrecoverable")
    g.add_argument("--max_checkpoints", type=int, default=2,
                   help="scored checkpoints kept, by score (the best one "
                        "always among them)")
    g.add_argument("--save_every_steps", type=int, default=0,
                   help="a recovery checkpoint every N steps between epoch "
                        "boundaries (0 = epoch boundaries only)")
    g.add_argument("--save_interval_secs", type=float, default=0.0,
                   help="a recovery checkpoint once this many seconds have "
                        "passed since the last save, checked at step "
                        "boundaries; 0 disables")
    g.add_argument("--wedge_timeout", type=float, default=0.0,
                   help="seconds without training-loop progress before the "
                        "process exits 124 for a checkpointed resume; set "
                        "above the longest legitimate gap (start-up, one "
                        "epoch's validation); 0 disables")
    g.add_argument("--abort_on_negative_advantage_window", type=int,
                   default=0,
                   help="1 = exit 4 when every logged advantage of a "
                        "five-step window is negative with mean < -0.05; "
                        "0 = warn once and continue")
    # The environment's plan is the default, so argparse validates it
    # like a flag's.
    g.add_argument("--fault_plan",
                   default=os.environ.get("CST_FAULT_PLAN") or None,
                   type=_fault_plan,
                   help="drills only: comma-separated fault specs, e.g. "
                        "'preempt@step=3,wedge@step=5,nan_grad@step=2*3,"
                        "ckpt_torn@step=4' (kind@step=N, kind@batch=N, "
                        "kind@step=N*K); default: $CST_FAULT_PLAN")
    g = p.add_argument_group("validation and run")
    g.add_argument("--max_length", type=int, default=30,
                   help="label length and decode length")
    g.add_argument("--val_beam_size", type=int, default=1)
    g.add_argument("--eval_batch_size", type=int, default=0,
                   help="validation batch; 0 = --batch_size")
    g.add_argument("--eval_metric", default="CIDEr",
                   help="the validation score that picks the best "
                        "checkpoint: one of " + ", ".join(KNOWN_EVAL_METRICS)
                   + " (METEOR selects METEOR_approx)")
    g.add_argument("--fast_val", type=int, default=0,
                   help="1 = validation scores CIDEr and --eval_metric only")
    g.add_argument("--length_norm", type=float, default=0.0)
    g.add_argument("--decode_chunk", type=int, default=8)
    g.add_argument("--checkpoint_path", default="checkpoints/run")
    g.add_argument("--start_from", default=None,
                   help="warm-start the parameters from the best "
                        "verified step of DIR")
    g.add_argument("--log_every", type=int, default=20)
    g.add_argument("--device", default=None,
                   help="torch device; default cuda (raises without a GPU)")
    opt = p.parse_args(argv)
    _warn_overlap_under_device_rewards(
        opt, sys.argv[1:] if argv is None else argv)
    return opt


def _warn_overlap_under_device_rewards(opt, argv) -> None:
    """``--overlap_rewards`` set explicitly under ``--device_rewards 1``
    is ignored (the fused step has no host boundary): one line on
    stderr."""
    if opt.device_rewards and any(
            a == "--overlap_rewards" or a.startswith("--overlap_rewards=")
            for a in argv):
        print("warning: --overlap_rewards is ignored under "
              "--device_rewards 1 (the fused step has no host reward "
              "boundary to overlap); pass --device_rewards 0 to use the "
              "host pipeline", file=sys.stderr)


def main(argv=None) -> int:
    opt = parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(name)s: %(message)s")
    # Before the Trainer's slow start-up: a SIGTERM during it is honored
    # at the first step boundary.
    preemption = PreemptionHandler().install()
    try:
        trainer = Trainer(opt, preemption=preemption)
        try:
            result = trainer.train()
        except NegativeAdvantageAbort as e:
            print(json.dumps({"aborted": "negative_advantage_window",
                              "detail": str(e)}))
            return EXIT_ADVANTAGE_ABORT
        except PreemptedExit as e:
            print(json.dumps({"preempted": e.signal_name, "step": e.step,
                              "saved": e.saved,
                              "checkpoint_path": opt.checkpoint_path}))
            return EXIT_PREEMPTED
        finally:
            trainer.close()
    finally:
        preemption.uninstall()
    print(json.dumps({"best_score": result["best_score"],
                      "best_step": result["best_step"],
                      "last_step": result["last_step"],
                      "eval_metric": opt.eval_metric,
                      "checkpoint_path": opt.checkpoint_path}))
    return EXIT_OK


if __name__ == "__main__":
    sys.exit(main())
