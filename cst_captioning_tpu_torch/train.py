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

The model is the reference's: ``--model_type lstm|transformer``,
``--fusion_type temporal|manet``, ``--num_layers``, ``--use_attention``,
``--num_heads``, ``--num_tx_layers`` and ``--remat_cell`` (default 1:
each LSTM step recomputed in the backward, the same gradients).
Flags keep the reference's names (its ``opts.py``).  The data are the
files of a prepro'd split (``data/dataset.py``): ``--train_feat_npy``
(one ``.npy`` per modality), ``--train_label_npz``, ``--train_info_json``,
``--train_cocofmt_file`` and the same for ``--val_*``, read from the
memory map or preloaded (``--preload_feats 1``), with the reference's
pickles ``--train_cached_tokens`` (the CST reward's corpus df) and
``--train_bcmrscores_pkl`` (consensus scores: the WXE weights at
``--consensus_temperature`` and the scb-gt baseline).  The reference's
``--*_feat_h5``/``--*_label_h5`` are a usage error: convert the files
once with ``export_for_torch.py data``.  Without files the splits are
synthetic, built in memory from ``--synthetic_seed``
(``--synthetic_videos``, ``--synthetic_val_videos``,
``--synthetic_rich_vocab``, ``--captions_per_video``, ``--feat_shapes``,
``--max_length``), the generator of the reference's ``data/synthetic.py``.
``--start_from`` takes a train-CLI directory or an exported checkpoint
(``export_for_torch.py checkpoint``).
Runs on the CUDA device unless ``--device cpu`` is given; without a GPU
it raises instead of running on the CPU.  Validation scores the val split
with ``language_eval`` (``--fast_val 1``: CIDEr and the selection metric
only) and ``--eval_metric`` picks the best checkpoint.  The last line of
standard output is a JSON summary: best score, its step, the last step,
the metric and the checkpoint directory.

Data parallelism over ``torch.distributed`` (``parallel/``), one process
per device: start N processes, each with ``--num_processes N
--process_id i --coordinator_address host:port`` (the same address for
all); CUDA ranks join over NCCL (rank i binds GPU ``i %`` the visible
count), ``--device cpu`` ranks over gloo.  ``--batch_size`` is the
global batch (a multiple of N), and the run gives world size 1's losses,
tokens and parameters (``training/trainer.py``).  ``--num_devices`` 0
means the world size; any other value must equal it.  ``--num_processes
1`` with an address starts a one-rank group (its collectives are
copies); without an address, or at 0, no group is started.  The group
starts under a watchdog of ``--wedge_timeout`` seconds (exit 124 when a
peer never comes).  ``--data_shards``/``--data_shard_id`` (fallbacks
``CST_DATA_SHARDS``/``CST_DATA_SHARD_ID``) make one process's training
stream its shard of each epoch's global shuffle (``data/sharding.py``);
refused under more than one process, as the reference refuses it.

Telemetry, with the reference's flags (``training/trainer.py``):
``--trace_dir`` (host spans as Chrome traces; implies ``--step_timing``),
``--step_timing`` (per-interval ``data_wait_ms``/``compute_ms``/
``score_ms``/``ckpt_ms`` and the MFU fields in ``metrics.jsonl``),
``--profile_dir``/``--profile_start``/``--profile_steps``
(``torch.profiler`` over a window of loop steps, a Chrome trace),
``--tensorboard 1`` (scalars under ``<checkpoint_path>/tb``),
``--debug_nans 1`` (raise at the first non-finite value; turns the
divergence guard off) and ``--loglevel``.  ``--scan_unroll`` takes 1
only: eager PyTorch has no scan to unroll.

Tuned defaults (``tuning/record.py``): ``--decode_chunk``,
``--scan_unroll``, ``--overlap_rewards``, ``--device_rewards`` and
``--decode_kernel`` come from the platform's entry of the tuning record
(``TUNED_CONFIGS_TORCH.json`` or ``$CST_TUNED_CONFIGS_TORCH``; ``''``
turns it off) where the command line does not set them: explicit flag >
record > built-in default.  The outcome, ``tuned_provenance``, rides
into ``infos.json`` and ``telemetry.json``.

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
import os
import sys

import torch.distributed as dist

from .data.dataset import add_split_args, refuse_h5_flags
from .data.sharding import add_shard_args, check_shard_args
from .metrics.coco_eval import KNOWN_EVAL_METRICS
from .resilience.exitcodes import EXIT_ADVANTAGE_ABORT, EXIT_OK, EXIT_PREEMPTED
from .resilience.faults import FaultPlan, fault_plan_arg
from .parallel.dp import distributed_init
from .resilience.preemption import PreemptedExit, PreemptionHandler
from .training.state import OPTIMIZERS
from .training.trainer import (DATA_SHARDS_REFUSAL, NegativeAdvantageAbort,
                               Trainer)
from .tuning.record import apply_tuned_defaults
from .utils.watchdog import ProgressWatchdog
from .utils.platform import configure_cli_logging
from .weights import FUSION_TYPES, MODEL_TYPES

#: Built-in defaults of the tunable axes (a tuning record's winner takes
#: their place where the command line does not set them).
DEFAULT_DECODE_CHUNK = 8
DEFAULT_SCAN_UNROLL = 1
DEFAULT_OVERLAP_REWARDS = 2
DEFAULT_DEVICE_REWARDS = 1
DEFAULT_DECODE_KERNEL = "reference"


def positive_int(text: str) -> int:
    """argparse type of a count that must be at least 1."""
    value = int(text)
    if value < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {value}")
    return value


def scan_unroll_arg(text: str) -> int:
    """argparse type of ``--scan_unroll``: 1 only.  The reference unrolls
    its decoder's ``lax.scan``; eager PyTorch runs one step at a time and
    has no scan to unroll, so another value is refused, never ignored."""
    value = int(text)
    if value != 1:
        raise argparse.ArgumentTypeError(
            f"{value} is not supported: the port's decoder runs eagerly, "
            "one step at a time, and has no scan to unroll (1 is the "
            "reference's default)")
    return value


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    g = p.add_argument_group("data (files)")
    for split in ("train", "val"):
        add_split_args(g, split)
    g.add_argument("--train_cached_tokens", default=None,
                   help="the corpus-df pickle of the CST reward (prepro's "
                        "<split>_ciderdf.pkl); default: the df of the "
                        "training references")
    g.add_argument("--train_bcmrscores_pkl", default=None,
                   help="the consensus-score pickle (prepro's "
                        "<split>_consensus.pkl): WXE weights and the "
                        "scb-gt baseline")
    g.add_argument("--preload_feats", type=int, default=0,
                   help="1 = read every feature file into host RAM at "
                        "start-up; 0 = read batches from the memory map")
    g = p.add_argument_group("data (synthetic, in memory; without files)")
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
    add_shard_args(g)
    g = p.add_argument_group("model")
    g.add_argument("--model_type", default="lstm", choices=MODEL_TYPES,
                   help="decoder: the attention-LSTM or the Transformer")
    g.add_argument("--fusion_type", default="temporal",
                   choices=FUSION_TYPES,
                   help="attention memory: the frames of every modality "
                        "(temporal) or one token per modality (manet)")
    g.add_argument("--rnn_size", type=int, default=512,
                   help="LSTM hidden size / transformer model width")
    g.add_argument("--input_encoding_size", type=int, default=512,
                   help="word embedding size (the LSTM's; the "
                        "transformer's is --rnn_size)")
    g.add_argument("--num_layers", type=int, default=1,
                   help="LSTM layers")
    g.add_argument("--att_size", type=int, default=512)
    g.add_argument("--use_attention", type=int, default=1,
                   help="1 = attention-LSTM; 0 = the pooled model (the "
                        "fused feature is every step's context)")
    g.add_argument("--num_heads", type=int, default=8, help="transformer")
    g.add_argument("--num_tx_layers", type=int, default=2,
                   help="transformer")
    g.add_argument("--drop_prob", type=float, default=0.5)
    g.add_argument("--remat_cell", type=int, default=1,
                   help="1 = recompute each LSTM step in the backward "
                        "instead of keeping its activations (the same "
                        "gradients); 0 = keep them")
    g.add_argument("--pallas_attention", type=int, default=0,
                   help="1 = the decoder's attention on the K1 kernel")
    g.add_argument("--decode_kernel", choices=("reference", "fused", "bf16"),
                   default=DEFAULT_DECODE_KERNEL,
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
    g.add_argument("--device_rewards", type=int,
                   default=DEFAULT_DEVICE_REWARDS,
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
    g.add_argument("--overlap_rewards", type=int,
                   default=DEFAULT_OVERLAP_REWARDS,
                   help="host-path (--device_rewards 0) pipeline depth: "
                        "rollouts in flight while the host scores; 0 = "
                        "serial, k >= 1 = samples up to k updates stale. "
                        "Ignored under --device_rewards 1")
    g.add_argument("--device_feats", type=int, default=0,
                   help="1 = every training video's features resident on "
                        "the device, gathered by video index")
    g.add_argument("--device_feats_max_gb", type=float, default=8.0,
                   help="refuse --device_feats over this many GB")
    g.add_argument("--device_feats_upload_mb", type=float, default=64.0,
                   help="--device_feats uploads the table in row chunks of "
                        "at most this many MB per modality (host memory "
                        "holds one chunk)")
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
                   type=fault_plan_arg,
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
    g.add_argument("--decode_chunk", type=int, default=DEFAULT_DECODE_CHUNK)
    g.add_argument("--scan_unroll", type=scan_unroll_arg,
                   default=DEFAULT_SCAN_UNROLL,
                   help="the reference's decoder-scan unroll; the port "
                        "takes 1 only (eager PyTorch has no scan)")
    g.add_argument("--checkpoint_path", default="checkpoints/run")
    g.add_argument("--start_from", default=None,
                   help="warm-start the parameters from the best "
                        "verified step of DIR")
    g.add_argument("--log_every", type=int, default=20)
    g.add_argument("--device", default=None,
                   help="torch device; default cuda (raises without a GPU)")
    g.add_argument("--loglevel", default="INFO")
    g = p.add_argument_group("parallelism (one process per device)")
    g.add_argument("--num_devices", type=int, default=0,
                   help="devices of the data-parallel run; 0 = the world "
                        "size (--num_processes), the only other value "
                        "allowed")
    g.add_argument("--coordinator_address", default=None,
                   help="host:port of the process group's rendezvous")
    g.add_argument("--num_processes", type=int, default=0,
                   help="processes (one device each); 0 = one process, no "
                        "process group")
    g.add_argument("--process_id", type=int, default=0)
    g = p.add_argument_group("telemetry")
    g.add_argument("--trace_dir", default=None,
                   help="host span traces (data_wait, compute, score, "
                        "ckpt, fetch_wait, prefetch_assemble, ckpt_commit) "
                        "as Chrome-trace JSON in this directory (Perfetto, "
                        "chrome://tracing); implies --step_timing")
    g.add_argument("--step_timing", type=int, default=None,
                   help="1 = per-interval step-phase gauges (data_wait_ms, "
                        "compute_ms, score_ms, ckpt_ms) and the MFU fields "
                        "in metrics.jsonl; default: on under --trace_dir")
    g.add_argument("--profile_dir", default=None,
                   help="torch.profiler (CPU and CUDA) over a window of "
                        "loop steps, written here as a Chrome trace")
    g.add_argument("--profile_start", type=int, default=10,
                   help="the loop step the profiler window starts at")
    g.add_argument("--profile_steps", default="10",
                   help="a step count from --profile_start, or 'A:B' for "
                        "loop steps A..B-1")
    g.add_argument("--tensorboard", type=int, default=0,
                   help="1 = TensorBoard scalars under "
                        "<checkpoint_path>/tb (metrics.jsonl is always "
                        "written)")
    g.add_argument("--debug_nans", type=int, default=0,
                   help="1 = raise at the first non-finite value (anomaly "
                        "mode names the backward's operation; every step's "
                        "loss is checked); debugging only, and it turns "
                        "--divergence_guard off")
    raw = sys.argv[1:] if argv is None else list(argv)
    refuse_h5_flags(p, raw)
    opt = p.parse_args(raw)
    check_shard_args(p, opt)
    world = max(1, opt.num_processes)
    if opt.num_devices not in (0, world):
        p.error(f"--num_devices {opt.num_devices}: the port drives one "
                f"device per process, so it must be 0 or the world size "
                f"(--num_processes {opt.num_processes}, i.e. {world})")
    if world > 1 and opt.data_shards:
        p.error(DATA_SHARDS_REFUSAL.format(n=world, k=opt.data_shard_id))
    apply_tuned_defaults(opt, raw, p, device=opt.device)
    _warn_overlap_under_device_rewards(opt, raw)
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
    configure_cli_logging(opt.loglevel)
    # Before the Trainer's slow start-up: a SIGTERM during it is honored
    # at the first step boundary.
    preemption = PreemptionHandler().install()
    try:
        # A peer that never comes must still end in 124, not a hang.
        with ProgressWatchdog(opt.wedge_timeout,
                              describe=lambda: "during distributed_init"):
            distributed_init(
                opt.coordinator_address, opt.num_processes, opt.process_id,
                device=opt.device or "cuda")
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
        if dist.is_initialized():
            dist.destroy_process_group()
    print(json.dumps({"best_score": result["best_score"],
                      "best_step": result["best_step"],
                      "last_step": result["last_step"],
                      "eval_metric": opt.eval_metric,
                      "checkpoint_path": opt.checkpoint_path}))
    return EXIT_OK


if __name__ == "__main__":
    sys.exit(main())
