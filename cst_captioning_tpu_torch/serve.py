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
  a directory the train CLI wrote, or an exported checkpoint (the
  reference's, through ``export_for_torch.py checkpoint``), rebuilt as
  ``eval.py`` rebuilds it (the architecture from the checkpoint's saved
  options; ``--decode_kernel`` and ``--pallas_attention`` from this CLI).
  Video ids and features are those of the ``--test_*`` files
  (``data/dataset.py``), as the reference's ``scripts/serve.py`` serves
  them, or without them those of the checkpoint's val split (an exported
  checkpoint needs the files); ``--max_length`` defaults to the
  checkpoint's, so the captions equal the eval CLI's predictions at the
  same beam and decode settings.  Every LSTM variant serves (manet,
  multi-layer, pooled); a transformer checkpoint is refused (exit 1, the
  reason on stderr): its carry's position is shared by the batch, so a
  slot admitted mid-flight cannot start at position 0.

Protocol and shutdown: ``serving/server.py``.  Requests come on stdin,
or with ``--serve_port`` on a localhost socket (``-1``: an ephemeral
port, announced on stderr as ``serve: listening on 127.0.0.1:<port>``).
Stdin EOF exits 0; SIGTERM drains and exits 75, a second signal during
the drain exits 143.

Faults and latency (``serving/engine.py``): ``--serve_deadline_ms`` (a
default deadline; a request's ``deadline_ms`` overrides it),
``--serve_recover`` with ``--serve_retry_limit`` and
``--serve_rebuild_limit`` (the ladder; when it is exhausted the process
exits 124), ``--serve_step_budget_ms`` (slow chunks mark health
degraded), ``--serve_cache`` (the exact-result cache's capacity; 0 turns
it off) and ``--fault_plan`` (``serve_wedge|serve_garble|admit_err|
serve_cache@req=N``, drills only).  ``--serve_heartbeat_file`` writes the
health payload once a second; ``--wedge_timeout`` exits 124 when the
scheduler loop stops beating; ``--serve_telemetry_file`` gets the
registry's counters at exit.

Tracing (``telemetry/``): ``--serve_lifecycle`` (1, the default) records
every request's lifecycle in a flight recorder of
``--serve_lifecycle_events`` events; the ``stats`` op then carries the
latency attribution, and ``--serve_blackbox`` (``blackbox.json``; empty:
never) is written on the ``dump`` op, on an aborted drain and before an
exit 124.  ``--trace_dir`` writes host spans (admission, each decode
chunk) and the lifecycle as Chrome traces.  ``--result_file`` gets the
exit stats, health and counters.

Engine stats go to stderr as one JSON line.  Runs on the CUDA device
unless ``--device cpu`` is given; without a GPU it exits with an error
instead of running on the CPU.  The helpers here (``parse_args``,
``build_backend``, ``engine_kwargs``, ``make_tracers``, ``serve_until_exit``)
are shared with the fleet CLI, ``serve_fleet.py``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import traceback
from typing import Callable, Optional

import numpy as np
import torch

from . import default_device
from .data.dataset import add_split_args, paths_from_opt, refuse_h5_flags
from .data.shapes import parse_feat_shapes
from .data.vocab import Vocab
from .eval import load_checkpoint_model
from .models import CaptionModel
from .resilience.exitcodes import EXIT_FAILURE, EXIT_WEDGE, describe
from .resilience.faults import FaultPlan, fault_plan_arg
from .ops import kernel_state
from .resilience.integrity import atomic_json_write
from .resilience.preemption import PreemptionHandler
from .serving.buckets import parse_buckets
from .serving.cache import ResultCache
from .serving.engine import (ServingEngine, ServingRefused,
                             ServingUnrecoverable, refuse_unservable)
from .serving.server import CaptionServer
from .telemetry.lifecycle import DEFAULT_EVENTS, LifecycleTracer
from .telemetry.registry import MetricsRegistry
from .telemetry.spans import SpanTracer
from .utils.watchdog import ProgressWatchdog
from .weights import init_random_, load_params_npz, model_from_flax


def nonneg_int(text: str) -> int:
    """argparse type of a count that may be 0."""
    value = int(text)
    if value < 0:
        raise argparse.ArgumentTypeError(f"must be >= 0, got {value}")
    return value


def positive_int(text: str) -> int:
    """argparse type of a count that must be at least 1."""
    value = int(text)
    if value < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {value}")
    return value


def configure_cli_logging(loglevel: str) -> None:
    """The CLI's root logging config at ``--loglevel``; replaces any
    handler installed before it (``force=True``)."""
    logging.basicConfig(
        level=getattr(logging, str(loglevel).upper(), logging.INFO),
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
        force=True)


def parse_args(argv=None, fleet: bool = False,
               description: Optional[str] = None,
               extend: Optional[Callable[[argparse.ArgumentParser], None]]
               = None) -> argparse.Namespace:
    """The serve CLI's flags; ``fleet`` adds ``serve_fleet.py``'s
    ``--serve_replicas`` and ``--serve_restart_limit``; ``extend`` adds a
    front end's own flags (``serve_supervisor.py``'s)."""
    p = argparse.ArgumentParser(
        description=description or __doc__.splitlines()[0])
    p.add_argument("--serve_demo", type=int, default=0)
    p.add_argument("--checkpoint_path", default="",
                   help="serve the best step of a train-CLI directory, or "
                        "an exported checkpoint, on the --test_* split's "
                        "videos (default: the checkpoint's val split)")
    add_split_args(p.add_argument_group("data of --checkpoint_path"),
                   "test")
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
    p.add_argument("--serve_port", type=int, default=0,
                   help="0 (default): JSONL on stdin/stdout; N > 0: listen "
                        "on 127.0.0.1:N; -1: an ephemeral port, announced "
                        "on stderr")
    g = p.add_argument_group("faults and latency")
    g.add_argument("--serve_deadline_ms", type=nonneg_int, default=0,
                   help="default request deadline (0: none); a request's "
                        "deadline_ms overrides it")
    g.add_argument("--serve_recover", type=int, default=1,
                   help="1 (default): a failed or garbled chunk re-runs "
                        "from its pre-chunk state, then the engine "
                        "rebuilds, then the process exits 124")
    g.add_argument("--serve_retry_limit", type=nonneg_int, default=2,
                   help="chunk re-runs (and admission retries) before a "
                        "rebuild")
    g.add_argument("--serve_rebuild_limit", type=nonneg_int, default=2,
                   help="failed rebuilds before the process exits 124")
    g.add_argument("--serve_step_budget_ms", type=float, default=0.0,
                   help="a slower chunk marks health degraded and counts "
                        "serve_slow_chunks (0: off)")
    g.add_argument("--serve_cache", type=nonneg_int, default=256,
                   help="exact-result cache entries (0: off)")
    g.add_argument("--serve_heartbeat_file", default=None,
                   help="write heartbeat.json (the health payload and the "
                        "counters) here once a second")
    g.add_argument("--wedge_timeout", type=float, default=0.0,
                   help="seconds without a scheduler-loop beat before the "
                        "process exits 124 (0: off)")
    g.add_argument("--serve_telemetry_file", default=None,
                   help="write the registry's telemetry.json here at exit")
    g.add_argument("--fault_plan",
                   default=os.environ.get("CST_FAULT_PLAN") or None,
                   type=fault_plan_arg,
                   help="drills only: e.g. 'serve_wedge@req=1,"
                        "serve_garble@req=3,admit_err@req=4,"
                        "serve_cache@req=5' (a fleet: 'serve_wedge@"
                        "replica=K'); default: $CST_FAULT_PLAN")
    g = p.add_argument_group("tracing")
    g.add_argument("--serve_lifecycle", type=int, default=1,
                   help="1 (default): record every request's lifecycle in "
                        "a bounded flight recorder; the stats op carries "
                        "the latency attribution, and the blackbox is "
                        "written on the dump op, an aborted drain and exit "
                        "124.  0: every hook off")
    g.add_argument("--serve_lifecycle_events", type=positive_int,
                   default=DEFAULT_EVENTS,
                   help="the flight recorder's capacity, events")
    g.add_argument("--serve_blackbox", default="blackbox.json",
                   help="where the flight recorder writes blackbox.json "
                        "(empty: never)")
    g.add_argument("--trace_dir", default=None,
                   help="write host spans and the request lifecycle here "
                        "as Chrome-trace JSON (Perfetto, chrome://tracing)")
    g.add_argument("--result_file", default=None,
                   help="write the exit stats, health and counters here "
                        "(JSON)")
    if fleet:
        g = p.add_argument_group("fleet")
        g.add_argument("--serve_replicas", type=positive_int,
                       default=int(os.environ.get("CST_SERVE_REPLICAS")
                                   or 2),
                       help="engine replicas behind the fleet router; one "
                            "result cache across them.  Default: "
                            "$CST_SERVE_REPLICAS, else 2")
        g.add_argument("--serve_restart_limit", type=nonneg_int, default=3,
                       help="unplanned restarts (an exhausted ladder or a "
                            "kill) each replica may take before it is "
                            "removed; with none left the process exits "
                            "124.  Rotations are free")
    p.add_argument("--device", default=None,
                   help="torch device; default cuda (raises without a GPU)")
    p.add_argument("--loglevel", default="INFO",
                   help="the root logger's level (DEBUG, INFO, WARNING, "
                        "ERROR)")
    if extend is not None:
        extend(p)
    raw = sys.argv[1:] if argv is None else list(argv)
    refuse_h5_flags(p, raw)
    opt = p.parse_args(raw)
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
        # Built on the reference cell, refused, then given the asked
        # cell: a transformer is refused before the fused cell's own
        # refusal of it.
        model, vocab, split, saved = load_checkpoint_model(
            opt.checkpoint_path, device, "reference", opt.pallas_attention,
            test_paths=paths_from_opt(opt, "test"))
        refuse_unservable(model.decoder_type)
        model = model.clone(decode_kernel=opt.decode_kernel)
        if opt.max_length is None:
            opt.max_length = saved.max_length
        index = {vid: i for i, vid in enumerate(split.video_ids)}

        def split_feats(video_id):
            i = index.get(str(video_id))
            return (None if i is None
                    else [f[0] for f in split.features(np.asarray([i]))])

        return (model, vocab, list(zip(split.feat_times, split.feat_dims)),
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
        refuse_unservable(model.decoder_type)
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


_warned_serve_deadline = False


def warn_serve_deadline(opt) -> None:
    """Once per process: a default deadline below the per-chunk budget
    can never be met (one chunk over the slot batch is the smallest unit
    of service).  The server still runs, with the deadline as given."""
    global _warned_serve_deadline
    if _warned_serve_deadline:
        return
    deadline = float(opt.serve_deadline_ms or 0)
    budget = float(opt.serve_step_budget_ms or 0)
    if 0 < deadline < budget:
        _warned_serve_deadline = True
        try:
            bucket = (f"the largest serve bucket "
                      f"({parse_buckets(opt.serve_buckets)[-1]} slots)")
        except ValueError:
            bucket = "the largest serve bucket"
        print(f"warning: --serve_deadline_ms {deadline:g} is below one "
              f"decode-chunk budget (--serve_step_budget_ms {budget:g}) "
              f"for {bucket}: such a deadline can never be met; every "
              "request will expire or be shed before completing",
              file=sys.stderr)


def engine_kwargs(opt) -> dict:
    """The ``ServingEngine`` arguments the serve flags set, less the
    model, the fault plan, the result cache and the tracers."""
    return dict(max_len=opt.max_length, beam_size=opt.beam_size,
                length_norm=opt.length_norm, decode_chunk=opt.decode_chunk,
                bucket_sizes=parse_buckets(opt.serve_buckets),
                queue_limit=opt.serve_queue_limit,
                deadline_ms=opt.serve_deadline_ms,
                recover=bool(opt.serve_recover),
                retry_limit=opt.serve_retry_limit,
                rebuild_limit=opt.serve_rebuild_limit,
                step_budget_ms=opt.serve_step_budget_ms)


def make_tracers(opt, registry):
    """-> (span tracer or None, the base lifecycle tracer or None), as
    ``--trace_dir`` and ``--serve_lifecycle`` ask."""
    tracer = SpanTracer(opt.trace_dir) if opt.trace_dir else None
    lifecycle = (LifecycleTracer(opt.serve_lifecycle_events, tracer=tracer,
                                 registry=registry)
                 if opt.serve_lifecycle else None)
    return tracer, lifecycle


def serve_until_exit(name: str, opt, server: CaptionServer, registry,
                     tracer, lifecycle, fatal) -> int:
    """Run ``server`` on stdin or the socket until it exits, with the
    heartbeat and wedge watchdog.  ``fatal`` (an exception class) is the
    supervised-restart signal: the blackbox is written, then the exit
    is 124.  At exit: the stats line on stderr (``<name>: {...}``), the
    ``--result_file``, the telemetry snapshot, the trace's last part."""
    if lifecycle is not None:
        lifecycle.attach(
            health=server.health_payload,
            counters=lambda: registry.snapshot().get("counters"),
            kernels=kernel_state)
    watchdog = None
    if opt.serve_heartbeat_file or opt.wedge_timeout > 0:
        watchdog = ProgressWatchdog(
            opt.wedge_timeout, describe=lambda: f"{name} scheduler loop",
            heartbeat_path=opt.serve_heartbeat_file,
            payload=lambda: {"serving": server.published_health(),
                             **registry.heartbeat_payload()},
            heartbeat_interval_s=1.0).start()
        server.watchdog = watchdog
    try:
        try:
            if opt.serve_port:
                rc = server.run_socket(max(opt.serve_port, 0))
            else:
                rc = server.run_stdin()
        except fatal as e:
            print(f"{name}: UNRECOVERABLE: {e}; exiting {EXIT_WEDGE} "
                  f"({describe(EXIT_WEDGE)})", file=sys.stderr)
            if lifecycle is not None and opt.serve_blackbox:
                # Written before the exit: the evidence outlives it.
                try:
                    lifecycle.dump(opt.serve_blackbox, reason="unrecoverable")
                    print(f"{name}: blackbox written to "
                          f"{opt.serve_blackbox}", file=sys.stderr)
                except OSError as werr:
                    print(f"{name}: blackbox write failed: {werr}",
                          file=sys.stderr)
            rc = EXIT_WEDGE
    finally:
        if watchdog is not None:
            watchdog.stop()
        stats = server.engine.stats()
        print(f"{name}: " + json.dumps(stats), file=sys.stderr)
        if opt.result_file:
            atomic_json_write(opt.result_file,
                              {"stats": stats,
                               "health": server.health_payload(),
                               "telemetry": registry.snapshot()},
                              indent=2, default=str)
        if opt.serve_telemetry_file:
            registry.write_snapshot(opt.serve_telemetry_file)
        if tracer is not None:
            tracer.close()
    return rc


def main(argv=None) -> int:
    opt = parse_args(argv)
    configure_cli_logging(opt.loglevel)
    warn_serve_deadline(opt)
    handler = PreemptionHandler().install()
    registry = MetricsRegistry()
    plan = FaultPlan.parse(opt.fault_plan)
    if plan is not None:
        plan.bind_metrics(registry)
    try:
        model, vocab, feat_shapes, feats_for = build_backend(opt)
    except ServingRefused as e:
        handler.uninstall()
        print(f"serve: refused: {e}", file=sys.stderr, flush=True)
        return EXIT_FAILURE
    tracer, lifecycle = make_tracers(opt, registry)
    engine = ServingEngine(
        model, feat_shapes, **engine_kwargs(opt), fault_plan=plan,
        result_cache=ResultCache(opt.serve_cache) if opt.serve_cache
        else None,
        registry=registry, tracer=tracer, lifecycle=lifecycle)
    engine.warm()
    server = CaptionServer(engine, vocab, feats_for, handler=handler,
                           registry=registry, lifecycle=lifecycle,
                           blackbox_path=opt.serve_blackbox or None)
    print(f"serve: ready on {model.device} (decode_kernel="
          f"{opt.decode_kernel}, compute {model.dtype}, beam "
          f"{engine.beam_size}, buckets {engine.buckets}, cache "
          f"{opt.serve_cache}, recover {int(engine.recover)}, lifecycle "
          f"{int(lifecycle is not None)})", file=sys.stderr, flush=True)
    if plan is not None:
        print(f"serve: CHAOS: fault plan armed: {plan}", file=sys.stderr,
              flush=True)
    return serve_until_exit("serve", opt, server, registry, tracer,
                            lifecycle, ServingUnrecoverable)


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        # An unhandled error exits 1 (fatal in the exit taxonomy), never
        # through a teardown that could abort and read as a signal death.
        traceback.print_exc()
        code = EXIT_FAILURE
    sys.stdout.flush()
    sys.stderr.flush()
    # A reader thread may still be blocked in a read; leave without the
    # interpreter's teardown, which can abort under it.
    os._exit(code)
