"""Process-fleet serving CLI of the port (counterpart of
``scripts/serve_supervisor.py``): N serve-CLI child processes under a
supervisor.

The fleet CLI (``serve_fleet.py``) heals N engine replicas inside one
process; this front end moves the failure domain to the OS process.  A
``serving.supervisor.ProcessFleetSupervisor`` owns
``--supervise_replicas`` real ``python -m cst_captioning_tpu_torch.serve``
child processes (each on its own localhost socket, with its own workdir
for the blackbox, heartbeat, telemetry, result file, trace and stderr)
and proxies the same JSONL wire through a
``serving.supervisor.SupervisorServer``: the wire format, streaming,
deadlines and result semantics are the serve CLI's.

    # a process fleet of 3 children on the card:
    python -m cst_captioning_tpu_torch.serve_supervisor --serve_demo 1 \\
        --supervise_replicas 3 --serve_port -1

    # the seeded process-chaos drill (SIGKILL replica 1 mid-stream; every
    # request answered, captions bit-identical to a fault-free
    # single-engine child, the dead child's blackbox harvested):
    python -m cst_captioning_tpu_torch.serve_supervisor --serve_demo 1 \\
        --supervise_probe 1

    # the supervisor-death drill (SIGKILL the supervisor's process group
    # mid-storm, relaunch on the same --journal_dir):
    python -m cst_captioning_tpu_torch.serve_supervisor --serve_demo 1 \\
        --journal_probe 1

    # the 3-phase autoscale drill (idle, a standing storm, idle):
    python -m cst_captioning_tpu_torch.serve_supervisor --serve_demo 1 \\
        --autoscale_probe 1 --autoscale_min 1 --autoscale_max 3

Supervisor specifics:

- Child lifecycle is the exit taxonomy (``resilience/exitcodes.py``):
  resumable (75/137/143) and wedge (124) exits restart free with bounded
  backoff and their in-flight requests requeued (arrival clocks kept,
  streams prefix-consistent through supervisor watermarks); fatal exits
  spend ``--supervise_restart_limit``; when every replica is dead this
  process exits 124.
- Every child death leaves an incident bundle under
  ``<--supervise_dir>/incidents/``; ``{"op": "dump"}`` is issued before
  a deliberate kill so the child's blackbox.json exists to harvest.
- ``--fault_plan 'proc_kill@replica=K'`` / ``proc_wedge`` /
  ``proc_preempt`` act on child K's process; serving kinds
  (``serve_*@replica=K``) are forwarded into child K's own
  ``--fault_plan``.
- ``--journal_dir`` arms the durable intake journal; ``--autoscale_max``
  arms the autoscaler; the fleet observability plane (the scrape into
  ``fleet_metrics.jsonl``, ``clock_sync.json``, the SLO monitor and its
  ``slo_alerts.jsonl``) is always on.

This process imports torch (the package does) but never initialises
CUDA: only the children touch the card.  Each child runs on the CUDA
device unless ``--device cpu`` is given, and a child without a GPU
raises (a fatal exit, never a fallback).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import sys
import tempfile
import time
import traceback

from .resilience.exitcodes import EXIT_FAILURE, EXIT_PREEMPTED, EXIT_WEDGE, \
    describe
from .resilience.faults import FaultPlan
from .resilience.integrity import atomic_json_write
from .resilience.preemption import PreemptionHandler
from .serve import configure_cli_logging, nonneg_int, parse_args, \
    positive_int
from .serving.autoscale import Autoscaler
from .serving.journal import IntakeJournal
from .serving.supervisor import (ProcessFleetSupervisor, SupervisorServer,
                                 SupervisorUnrecoverable, spawn_serve_child)
from .telemetry.fleetobs import FleetObs, SLOMonitor
from .telemetry.lifecycle import LifecycleTracer
from .telemetry.registry import MetricsRegistry
from .telemetry.spans import SpanTracer
from .utils.watchdog import ProgressWatchdog

log = logging.getLogger(__name__)

#: The directory that holds the package: children import it from here.
PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVE_METRIC = "serve_captions_per_sec_per_chip"


def _env_default(name: str, default):
    return os.environ.get(name) or default


def _ratio(text: str) -> float:
    """argparse type of an SLO target or tolerated fraction: [0, 1)."""
    value = float(text)
    if not 0.0 <= value < 1.0:
        raise argparse.ArgumentTypeError(
            f"must be in [0, 1) (0 = disabled), got {value}")
    return value


def add_supervise_args(p: argparse.ArgumentParser) -> None:
    """The process fleet's flags: the reference's names, defaults and
    ``CST_*`` environment fallbacks (``cst_captioning_tpu/opts.py``)."""
    g = p.add_argument_group("process fleet")
    g.add_argument("--supervise_replicas", type=positive_int,
                   default=_env_default("CST_SUPERVISE_REPLICAS", 3),
                   help="serve-CLI child processes under the supervisor.  "
                        "Default: $CST_SUPERVISE_REPLICAS, else 3")
    g.add_argument("--supervise_restart_limit", type=nonneg_int,
                   default=_env_default("CST_SUPERVISE_RESTART_LIMIT", 3),
                   help="fatal child exits (1, 130, uncatalogued) each "
                        "replica may spend before it is dead; resumable "
                        "(75/137/143) and wedge (124) exits restart free.  "
                        "Every replica dead: this process exits 124.  "
                        "Default: $CST_SUPERVISE_RESTART_LIMIT, else 3")
    g.add_argument("--supervise_backoff_ms", type=nonneg_int,
                   default=_env_default("CST_SUPERVISE_BACKOFF_MS", 200),
                   help="base restart backoff (ms), doubling per "
                        "consecutive death, reset by the replica's next "
                        "completion.  Default: $CST_SUPERVISE_BACKOFF_MS, "
                        "else 200")
    g.add_argument("--supervise_dir", default=None,
                   help="root of the replica<K>/ child workdirs, the "
                        "incidents/ bundles, the fleet plane's files and "
                        "the supervisor's trace.  Default: a fresh temp dir")
    g.add_argument("--supervise_probe", type=int, default=0,
                   help="1 = run the seeded process-chaos drill instead of "
                        "serving (proc_kill@replica=1 unless --fault_plan "
                        "says otherwise) and print its record line")
    g.add_argument("--journal_dir",
                   default=os.environ.get("CST_JOURNAL_DIR") or None,
                   help="arm the durable intake journal here: accepts are "
                        "fsync'd before placement, stream chunks and "
                        "terminals at send time; a relaunch on the same "
                        "directory replays what was unanswered.  Default: "
                        "$CST_JOURNAL_DIR, else off")
    g.add_argument("--journal_segment_bytes", type=positive_int,
                   default=_env_default("CST_JOURNAL_SEGMENT_BYTES",
                                        1048576),
                   help="rotate the journal's active segment past this many "
                        "bytes.  Default: $CST_JOURNAL_SEGMENT_BYTES, else "
                        "1048576")
    g.add_argument("--journal_compact", type=nonneg_int,
                   default=_env_default("CST_JOURNAL_COMPACT", 1),
                   help="1 = fold sealed segments into one compact file at "
                        "every rotation; 0 = keep every segment.  Default: "
                        "$CST_JOURNAL_COMPACT, else 1")
    g.add_argument("--journal_probe", type=int, default=0,
                   help="1 = run the supervisor-death drill instead of "
                        "serving and print its record line")
    g = p.add_argument_group("fleet observability and autoscaling")
    g.add_argument("--fleet_scrape_ms", type=positive_int,
                   default=_env_default("CST_FLEET_SCRAPE_MS", 1000),
                   help="scrape cadence (ms) of fleet_metrics.jsonl, the "
                        "children's stats and the clock-sync pings.  "
                        "Default: $CST_FLEET_SCRAPE_MS, else 1000")
    g.add_argument("--slo_p99_ms", type=nonneg_int,
                   default=_env_default("CST_SLO_P99_MS", 0),
                   help="SLO: p99 latency target (ms), 1%% of requests may "
                        "exceed it; 0 = off.  Default: $CST_SLO_P99_MS")
    g.add_argument("--slo_availability", type=_ratio,
                   default=_env_default("CST_SLO_AVAILABILITY", 0.0),
                   help="SLO: success fraction target in [0, 1); 0 = off.  "
                        "Default: $CST_SLO_AVAILABILITY")
    g.add_argument("--slo_error_rate", type=_ratio,
                   default=_env_default("CST_SLO_ERROR_RATE", 0.0),
                   help="SLO: tolerated error fraction in [0, 1); 0 = off.  "
                        "Default: $CST_SLO_ERROR_RATE")
    g.add_argument("--autoscale_min", type=positive_int,
                   default=_env_default("CST_AUTOSCALE_MIN", 1),
                   help="the autoscaled fleet's floor, and its size at "
                        "start.  Default: $CST_AUTOSCALE_MIN, else 1")
    g.add_argument("--autoscale_max", type=nonneg_int,
                   default=_env_default("CST_AUTOSCALE_MAX", 0),
                   help="0 = a fixed --supervise_replicas fleet; N = grow "
                        "and shrink between --autoscale_min and N from "
                        "the children's latency attribution, with the "
                        "brownout ladder at N.  Default: $CST_AUTOSCALE_MAX")
    g.add_argument("--autoscale_queue_hi_ms", type=positive_int,
                   default=_env_default("CST_AUTOSCALE_QUEUE_HI_MS", 50),
                   help="queue_wait p99 (ms) over which the up-signal "
                        "burns; the quiet threshold is a tenth of it.  "
                        "Default: $CST_AUTOSCALE_QUEUE_HI_MS, else 50")
    g.add_argument("--autoscale_up_cooldown_s", type=nonneg_int,
                   default=_env_default("CST_AUTOSCALE_UP_COOLDOWN_S", 2),
                   help="seconds between scale-ups.  Default: "
                        "$CST_AUTOSCALE_UP_COOLDOWN_S, else 2")
    g.add_argument("--autoscale_down_cooldown_s", type=nonneg_int,
                   default=_env_default("CST_AUTOSCALE_DOWN_COOLDOWN_S", 10),
                   help="seconds between scale-downs.  Default: "
                        "$CST_AUTOSCALE_DOWN_COOLDOWN_S, else 10")
    g.add_argument("--autoscale_probe", type=int, default=0,
                   help="1 = run the 3-phase autoscale drill instead of "
                        "serving and print its record line")


def parse_supervisor_args(argv=None) -> argparse.Namespace:
    return parse_args(argv, description=__doc__.splitlines()[0],
                      extend=add_supervise_args)


def _forwarded(opt) -> list:
    """The serving-shape flags a child (or a relaunched supervisor) gets,
    named one by one: the serve CLI's own flags only, never raw argv."""
    argv = []
    forward = [("--serve_demo", opt.serve_demo),
               ("--serve_demo_eos_bias", opt.serve_demo_eos_bias),
               ("--rnn_size", opt.rnn_size),
               ("--input_encoding_size", opt.input_encoding_size),
               ("--att_size", opt.att_size),
               ("--vocab_size", opt.vocab_size),
               ("--feat_shapes", opt.feat_shapes),
               ("--serve_videos", opt.serve_videos),
               ("--seed", opt.seed),
               ("--decode_kernel", opt.decode_kernel),
               ("--use_bfloat16", opt.use_bfloat16),
               ("--pallas_attention", opt.pallas_attention),
               ("--beam_size", opt.beam_size),
               ("--length_norm", opt.length_norm),
               ("--decode_chunk", opt.decode_chunk),
               ("--serve_buckets", opt.serve_buckets),
               ("--serve_queue_limit", opt.serve_queue_limit),
               ("--serve_deadline_ms", opt.serve_deadline_ms),
               ("--serve_cache", opt.serve_cache),
               ("--serve_recover", opt.serve_recover),
               ("--serve_retry_limit", opt.serve_retry_limit),
               ("--serve_rebuild_limit", opt.serve_rebuild_limit),
               ("--serve_step_budget_ms", opt.serve_step_budget_ms),
               ("--serve_lifecycle", opt.serve_lifecycle),
               ("--serve_lifecycle_events", opt.serve_lifecycle_events),
               ("--wedge_timeout", opt.wedge_timeout)]
    if opt.max_length is not None:
        forward.append(("--max_length", opt.max_length))
    if opt.device is not None:
        forward.append(("--device", opt.device))
    for flag, val in forward:
        argv += [flag, str(val)]
    if opt.checkpoint_path:
        argv += ["--checkpoint_path", opt.checkpoint_path]
    if opt.params_npz:
        argv += ["--params_npz", opt.params_npz,
                 "--vocab_json", opt.vocab_json]
    if opt.test_feat_npy:
        argv += ["--test_feat_npy"] + [str(p) for p in opt.test_feat_npy]
    for flag in ("test_label_npz", "test_info_json", "test_cocofmt_file"):
        if getattr(opt, flag):
            argv += [f"--{flag}", str(getattr(opt, flag))]
    return argv


def child_argv(opt, workdir: str, replica: int, plan=None) -> list:
    """One child's command line: ``python -m cst_captioning_tpu_torch.serve``
    in socket mode on an ephemeral port, every durable file in the child's
    own workdir, the parent's serving flags forwarded one by one, and
    child K's slice of the fault plan (``FaultPlan.cli_for_child``)."""
    argv = [sys.executable, "-m", "cst_captioning_tpu_torch.serve",
            "--serve_port", "-1",
            "--serve_blackbox", os.path.join(workdir, "blackbox.json"),
            "--serve_heartbeat_file",
            os.path.join(workdir, "heartbeat.json"),
            "--serve_telemetry_file",
            os.path.join(workdir, "telemetry.json"),
            "--result_file", os.path.join(workdir, "result.json"),
            "--trace_dir", os.path.join(workdir, "trace"),
            "--loglevel", "WARNING"] + _forwarded(opt)
    if plan is not None:
        child_plan = plan.cli_for_child(replica)
        if child_plan:
            argv += ["--fault_plan", child_plan]
    return argv


def child_env() -> dict:
    """The children's environment: this one, with the package's root first
    on ``PYTHONPATH`` so ``-m`` finds the same package wherever the
    supervisor was started from."""
    env = dict(os.environ)
    parts = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    if PKG_ROOT not in parts:
        env["PYTHONPATH"] = os.pathsep.join([PKG_ROOT] + parts)
    return env


def make_launcher(opt, root: str, plan=None):
    """The supervisor's child factory: replica K lives in
    ``<root>/replica<K>/``; a restart reuses the workdir (the incident
    harvest already copied the previous life's evidence)."""

    def launcher(replica: int):
        workdir = os.path.join(root, f"replica{replica}")
        os.makedirs(workdir, exist_ok=True)
        return spawn_serve_child(child_argv(opt, workdir, replica, plan=plan),
                                 workdir, replica, env=child_env())

    return launcher


def build_autoscaler(opt, root: str, fleet_obs, *, registry=None,
                     lifecycle=None):
    """The attribution-driven autoscaler, armed by ``--autoscale_max > 0``
    (None otherwise).  Its decisions log lands beside
    fleet_metrics.jsonl."""
    if opt.autoscale_max <= 0:
        return None
    hi = float(opt.autoscale_queue_hi_ms)
    return Autoscaler(
        fleet_obs, min_replicas=opt.autoscale_min,
        max_replicas=max(opt.autoscale_max, opt.autoscale_min),
        queue_hi_ms=hi, queue_lo_ms=hi / 10.0,
        up_cooldown_s=float(opt.autoscale_up_cooldown_s),
        down_cooldown_s=float(opt.autoscale_down_cooldown_s),
        out_dir=root, registry=registry, lifecycle=lifecycle)


def build_journal(opt):
    """The durable intake journal, armed by ``--journal_dir``."""
    if not opt.journal_dir:
        return None
    return IntakeJournal(opt.journal_dir,
                         segment_bytes=opt.journal_segment_bytes,
                         compact=bool(opt.journal_compact))


def build_supervisor(opt, root: str, *, plan=None, registry=None,
                     lifecycle=None, fleet_obs=None, autoscaler=None,
                     journal=None):
    # An armed autoscaler owns the fleet's size: it starts at the floor.
    replicas = (opt.autoscale_min if autoscaler is not None
                else opt.supervise_replicas)
    return ProcessFleetSupervisor(
        make_launcher(opt, root, plan=plan), replicas,
        restart_limit=opt.supervise_restart_limit,
        backoff_ms=opt.supervise_backoff_ms,
        wedge_timeout_s=opt.wedge_timeout,
        incident_dir=os.path.join(root, "incidents"),
        fault_plan=plan, registry=registry, lifecycle=lifecycle,
        fleet_obs=fleet_obs, autoscaler=autoscaler, journal=journal)


def replay_and_ledger(sup, root: str) -> dict:
    """Replay the journal into the new supervisor and write the recovery
    ledger (``recovery_ledger.json``) beside the incidents."""
    ledger = sup.replay_journal()
    if not ledger.get("enabled"):
        return ledger
    try:
        atomic_json_write(os.path.join(root, "recovery_ledger.json"),
                          ledger, indent=2)
    except OSError as e:
        print(f"serve_supervisor: recovery ledger write failed: {e}",
              file=sys.stderr)
    n = len(ledger.get("replayed") or [])
    if n or ledger.get("torn_records"):
        print(f"serve_supervisor: journal replay: {n} request(s) "
              f"re-entered, {ledger.get('recovered_terminals', 0)} "
              f"already terminal, {ledger.get('torn_records', 0)} torn "
              "record(s) dropped", file=sys.stderr)
    return ledger


def build_observability(opt, root: str, registry):
    """The supervisor's own telemetry: the span tracer (``<root>/trace/``),
    the lifecycle flight recorder (both off under ``--serve_lifecycle 0``)
    and the fleet plane (always on; an SLO objective of 0 is off).
    -> (tracer, lifecycle, fleet_obs)."""
    tracer = lifecycle = None
    if opt.serve_lifecycle:
        tracer = SpanTracer(os.path.join(root, "trace"))
        lifecycle = LifecycleTracer(opt.serve_lifecycle_events,
                                    tracer=tracer, registry=registry)
    slo = SLOMonitor(p99_ms=opt.slo_p99_ms,
                     availability=opt.slo_availability,
                     error_rate=opt.slo_error_rate,
                     lifecycle=lifecycle, registry=registry)
    fleet_obs = FleetObs(root, scrape_interval_s=opt.fleet_scrape_ms / 1000.0,
                         slo=slo, registry=registry, lifecycle=lifecycle)
    return tracer, lifecycle, fleet_obs


def close_observability(tracer, fleet_obs) -> None:
    """Flush the plane's files (final fsync, clock_sync.json, the trace's
    last part); safe on any exit path."""
    try:
        fleet_obs.close()
    except OSError as e:
        print(f"serve_supervisor: fleet_obs close failed: {e}",
              file=sys.stderr)
    if tracer is not None:
        try:
            tracer.close()
        except OSError as e:
            print(f"serve_supervisor: tracer close failed: {e}",
                  file=sys.stderr)


def parent_cuda_initialized() -> bool:
    """Whether this (the supervisor's) process created a CUDA context: it
    never should; only the children touch the card."""
    torch = sys.modules.get("torch")
    return bool(torch is not None and torch.cuda.is_initialized())


def write_supervisor_exit(root: str, rc: int, sup, registry) -> None:
    """The supervisor's exit snapshot, ``supervisor_exit.json``: stats,
    fleet health, the registry's telemetry and, with the journal armed,
    its durable high-water mark (the report's coverage cross-check)."""
    doc = {"rc": rc, "stats": sup.stats(), "health": sup.health_payload(),
           "telemetry": registry.snapshot(),
           "parent_cuda_initialized": parent_cuda_initialized()}
    journal = getattr(sup, "_journal", None)
    if journal is not None:
        doc["journal"] = journal.stats()
    try:
        atomic_json_write(os.path.join(root, "supervisor_exit.json"), doc,
                          indent=2)
    except OSError as e:
        print(f"serve_supervisor: exit snapshot write failed: {e}",
              file=sys.stderr)


def _platform(opt) -> str:
    return "cpu" if opt.device == "cpu" else "supervised"


def _wait_warm(sup, timeout_s: float = 300.0) -> None:
    """Tick until every live child has answered a health poll (its
    post-warm compile baseline)."""
    deadline = time.monotonic() + timeout_s
    while any(r.live and r.compiles0 is None for r in sup._replicas):
        sup.tick()
        if time.monotonic() > deadline:
            raise RuntimeError("children never answered health")
        time.sleep(0.01)


def _recompiles(sup) -> tuple:
    """Ask every live child for stats; -> (post-warm compiles summed over
    the live children, each live child's nvcc builds)."""
    for k, rep in enumerate(sup._replicas):
        rep.last_stats = None
        if rep.live:
            sup.request_stats(k)
    settle = time.monotonic() + 30.0
    while time.monotonic() < settle and any(
            r.live and r.last_stats is None for r in sup._replicas):
        sup.tick()
        time.sleep(0.01)
    recompiles = 0
    builds = {}
    for rep in sup._replicas:
        if not rep.live or rep.compiles0 is None:
            continue
        now_c = (rep.last_stats or rep.health or {}).get("compiles")
        if now_c is not None:
            recompiles += max(0, int(now_c) - int(rep.compiles0))
        builds[rep.index] = (rep.last_stats or {}).get("library_builds")
    return recompiles, builds


def _streams_check(answers: dict, ids) -> tuple:
    """-> ({id: final caption}, prefix_ok, chunks): exactly one terminal
    each (asserted), stream chunks in seq order spelling the caption."""
    finals = {}
    prefix_ok = True
    chunks_total = 0
    for i in ids:
        terminal = [a for a in answers[i] if a.get("final") or "error" in a]
        assert len(terminal) == 1, (
            f"request {i} got {len(terminal)} terminals: {answers[i]}")
        fin = terminal[0]
        if "caption" not in fin:
            continue
        finals[i] = fin["caption"]
        chunks = [a for a in answers[i]
                  if a.get("stream") and not a.get("final")]
        chunks_total += len(chunks)
        seqs = [c["seq"] for c in chunks]
        text = " ".join(c["text"] for c in chunks if c["text"]).strip()
        if seqs != list(range(len(seqs))) or text != fin["caption"]:
            prefix_ok = False
    return finals, prefix_ok, chunks_total


def _slo_block(slo_status: dict) -> dict:
    return {"enabled": slo_status.get("enabled", False),
            "firing": slo_status.get("firing", []),
            "alerts_fired": slo_status.get("alerts_fired", 0),
            "alerts_cleared": slo_status.get("alerts_cleared", 0),
            "ok": not slo_status.get("firing")}


# ---------------------------------------------------------------------------
# the seeded process-chaos drill (--supervise_probe 1)
# ---------------------------------------------------------------------------


def _single_engine_reference(opt, root: str, video_ids) -> dict:
    """The fault-free twin: one serve child, no fault plan, each unique
    video captioned once — the bit-identity reference."""
    workdir = os.path.join(root, "reference")
    os.makedirs(workdir, exist_ok=True)
    child = spawn_serve_child(child_argv(opt, workdir, 0, plan=None),
                              workdir, 0, env=child_env())
    captions = {}
    try:
        for i, vid in enumerate(video_ids):
            child.send_line(json.dumps({"id": f"ref{i}", "video_id": vid}))
        deadline = time.monotonic() + 300.0
        while len(captions) < len(video_ids):
            if time.monotonic() > deadline:
                raise RuntimeError(
                    "reference child timed out with "
                    f"{len(captions)}/{len(video_ids)} answered")
            if child.poll() is not None:
                raise RuntimeError(
                    f"reference child exited {child.poll()} early")
            got = child.lines()
            if not got:
                time.sleep(0.01)
            for raw in got:
                obj = json.loads(raw)
                if "caption" in obj:
                    captions[obj["video_id"]] = obj["caption"]
    finally:
        child.terminate()
        child.close()
    return captions


def run_probe(opt) -> int:
    """The drill, machine-checked: SIGKILL one replica mid-stream at
    ``--supervise_replicas`` children; every request answered once,
    captions bit-identical to the fault-free single-engine child, zero
    post-warm-up compiles per live child, the killed replica's blackbox
    harvested.  Prints the record line ``scripts/serve_report.py``
    renders and gates."""
    root = opt.supervise_dir or tempfile.mkdtemp(prefix="cst_supervise_")
    os.makedirs(root, exist_ok=True)
    plan = FaultPlan.parse(opt.fault_plan or "proc_kill@replica=1")
    registry = MetricsRegistry()
    plan.bind_metrics(registry)
    log.warning("CHAOS: process fault plan armed: %s", plan)
    killed_replica = next((s.replica for s in plan.specs
                           if s.kind == "proc_kill"), None)

    # Two rounds of slots per child: the kill lands while the victim still
    # owes work, however fast the device decodes.
    num_requests = 16 * opt.supervise_replicas
    video_ids = [f"v{i % 16}" for i in range(num_requests)]
    answers: dict = {i: [] for i in range(num_requests)}

    tracer, lifecycle, fleet_obs = build_observability(opt, root, registry)
    if lifecycle is not None:
        lifecycle.attach(counters=lambda: registry.snapshot().get("counters"))
    sup = build_supervisor(opt, root, plan=plan, registry=registry,
                           lifecycle=lifecycle, fleet_obs=fleet_obs)
    rc = 0
    try:
        # Every child's post-warm compile baseline before traffic.
        _wait_warm(sup)
        t0 = time.monotonic()
        for i, vid in enumerate(video_ids):
            sup.submit(i, vid, respond=answers[i].append, stream=True)
        deadline = time.monotonic() + 600.0
        while sup.outstanding:
            if not sup.tick():
                time.sleep(0.005)
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"drill timed out with {sup.outstanding} of "
                    f"{num_requests} unanswered")
        makespan = time.monotonic() - t0

        # The fleet heals before it is judged: a pending kill has landed
        # and the restart has happened, not only been scheduled.
        heal = time.monotonic() + 300.0
        while not all(r.live and r.kill_at is None for r in sup._replicas):
            sup.tick()
            if time.monotonic() > heal:
                raise RuntimeError("fleet never healed: "
                                   + str([r.state for r in sup._replicas]))
            time.sleep(0.02)
        _wait_warm(sup)
        recompiles, builds = _recompiles(sup)

        finals, prefix_ok, chunks_total = _streams_check(
            answers, range(num_requests))
        completed = len(finals)
        reference = _single_engine_reference(opt, root,
                                             sorted(set(video_ids)))
        mismatches = sum(1 for i, cap in finals.items()
                         if reference.get(video_ids[i]) != cap)
        parity_ok = completed == num_requests and mismatches == 0

        stats = sup.stats()
        c = stats["supervisor"]
        incidents = stats["incidents"]
        blackbox_harvested = any(
            "blackbox.json" in (inc.get("files") or [])
            for inc in incidents
            if killed_replica is None
            or inc.get("replica") == killed_replica)
        budget_ok = c["sup_replica_deaths"] == 0
        slo = _slo_block(fleet_obs.slo_status())
        record = {
            "metric": SERVE_METRIC, "schema": 1,
            "value": round(completed / makespan, 2) if makespan else None,
            "platform": _platform(opt),
            "completed": completed, "num_requests": num_requests,
            "shed": c["sup_shed"], "makespan_s": round(makespan, 3),
            "latency_p50_ms": stats.get("latency_p50_ms"),
            "latency_p99_ms": stats.get("latency_p99_ms"),
            "beam_size": opt.beam_size, "decode_chunk": opt.decode_chunk,
            "buckets": opt.serve_buckets,
            "recompiles_after_warmup": recompiles,
            "stream": {"enabled": True, "prefix_ok": prefix_ok,
                       "chunks": chunks_total},
            "slo": slo,
            "fleet_obs": {
                "samples": len(fleet_obs.series()),
                "metrics_file": fleet_obs.metrics_path,
                "clock_synced_pids": len(
                    fleet_obs.clock_sync.doc()["children"]),
                "trace_dir": os.path.join(root, "trace"),
            },
            "supervisor": {
                "enabled": True,
                "replicas": opt.supervise_replicas,
                "restart_limit": opt.supervise_restart_limit,
                "killed_replica": killed_replica,
                "restarts": c["sup_replica_restarts"],
                "requeued": c["sup_requeued"],
                "deaths": c["sup_replica_deaths"],
                "wedge_kills": c["sup_wedge_kills"],
                "budget_ok": budget_ok,
                "parity_ok": parity_ok,
                "parity_mismatches": mismatches,
                "incidents": len(incidents),
                "blackbox_harvested": blackbox_harvested,
                "per_replica": stats["per_replica"],
                "library_builds": builds,
                "captions": {video_ids[i]: cap
                             for i, cap in sorted(finals.items())},
            },
        }
        print(json.dumps(record), flush=True)
        report = {"answered": completed == num_requests,
                  "parity_ok": parity_ok, "prefix_ok": prefix_ok,
                  "recompiles": recompiles, "budget_ok": budget_ok,
                  "blackbox_harvested": blackbox_harvested,
                  "slo_ok": slo["ok"]}
        print(f"serve_supervisor: probe {json.dumps(report)}",
              file=sys.stderr)
        if not all([report["answered"], parity_ok, prefix_ok,
                    recompiles == 0, blackbox_harvested, slo["ok"]]):
            rc = 1
    except SupervisorUnrecoverable as e:
        print(f"serve_supervisor: UNRECOVERABLE: {e}; exiting "
              f"{EXIT_WEDGE} ({describe(EXIT_WEDGE)})", file=sys.stderr)
        rc = EXIT_WEDGE
    finally:
        sup.shutdown()
        close_observability(tracer, fleet_obs)
        write_supervisor_exit(root, rc, sup, registry)
        print("serve_supervisor: " + json.dumps(sup.supervisor_counters()),
              file=sys.stderr)
    return rc


# ---------------------------------------------------------------------------
# the seeded 3-phase autoscale drill (--autoscale_probe 1)
# ---------------------------------------------------------------------------


def run_autoscale_probe(opt) -> int:
    """Idle, a sustained storm, idle, through the real children: the fleet
    starts at ``--autoscale_min``, scales up once the storm's queue_wait
    attribution burns, drains back down in the last idle phase, answers
    every request exactly once bit-identical to a single-engine child and
    pays no post-warm-up compile in a live child.  Prints the record
    line; the decisions log and fleet_metrics.jsonl feed
    ``scripts/fleet_report.py``'s autoscale gates."""
    root = opt.supervise_dir or tempfile.mkdtemp(prefix="cst_autoscale_")
    os.makedirs(root, exist_ok=True)
    if opt.autoscale_max <= 0:
        opt.autoscale_max = max(3, opt.autoscale_min + 1)
    if not opt.serve_lifecycle:
        # The children's latency attribution is the decision signal.
        log.warning("autoscale probe: forcing --serve_lifecycle 1 "
                    "(attribution is the autoscaler's input)")
        opt.serve_lifecycle = 1
    registry = MetricsRegistry()
    idle_n = 3
    video_ids: list = []
    answers: dict = {}

    tracer, lifecycle, fleet_obs = build_observability(opt, root, registry)
    if lifecycle is not None:
        lifecycle.attach(counters=lambda: registry.snapshot().get("counters"))
    autoscaler = build_autoscaler(opt, root, fleet_obs, registry=registry,
                                  lifecycle=lifecycle)
    sup = build_supervisor(opt, root, registry=registry, lifecycle=lifecycle,
                           fleet_obs=fleet_obs, autoscaler=autoscaler)
    scrape_s = opt.fleet_scrape_ms / 1000.0
    rc = 0
    try:
        _wait_warm(sup)
        assert sup.active_replicas() == opt.autoscale_min, (
            "fleet must START at --autoscale_min, got "
            f"{sup.active_replicas()}")

        def submit(i: int) -> None:
            video_ids.append(f"v{i % 12}")
            answers[i] = []
            sup.submit(i, video_ids[i], respond=answers[i].append,
                       stream=True)

        def pump(until: float, stop=None) -> None:
            while time.monotonic() < until:
                if not sup.tick():
                    time.sleep(0.005)
                if stop is not None and stop():
                    return

        t0 = time.monotonic()
        # Phase 1, an idle trickle: the fleet must not grow on it.
        for i in range(idle_n):
            submit(i)
            pump(time.monotonic() + 2 * scrape_s)
        base_after_idle = sup.active_replicas()

        # Phase 2, a standing 4x storm at the fleet's edge: keep about 4
        # replicas' worth of work queued in front of the floor's children
        # so queue_wait burns for whole fast and slow windows.
        backlog = max(8, 4 * opt.autoscale_min * 4)
        budget_intervals = 40
        up_deadline = time.monotonic() + max(budget_intervals * scrape_s,
                                             60.0)
        i = idle_n
        while time.monotonic() < up_deadline:
            if sup.active_replicas() > opt.autoscale_min:
                break
            while sup.outstanding < backlog:
                submit(i)
                i += 1
            if not sup.tick():
                time.sleep(0.005)
        scaled_up = sup.active_replicas() > opt.autoscale_min
        up_intervals = (time.monotonic() - t0) / scrape_s

        deadline = time.monotonic() + 600.0
        while sup.outstanding:
            if not sup.tick():
                time.sleep(0.005)
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"drill timed out with {sup.outstanding} of "
                    f"{len(answers)} unanswered")

        # Phase 3, idle again: the extra replicas must drain out.
        for _ in range(idle_n):
            submit(i)
            i += 1
            pump(time.monotonic() + 2 * scrape_s)
        num_requests = len(answers)
        pump(time.monotonic() + 120.0,
             stop=lambda: (sup.active_replicas() <= opt.autoscale_min
                           and not sup.outstanding))
        while sup.outstanding:
            if not sup.tick():
                time.sleep(0.005)
            if time.monotonic() > deadline:
                raise RuntimeError("phase-3 requests unanswered")
        scaled_down = sup.active_replicas() <= opt.autoscale_min
        makespan = time.monotonic() - t0

        recompiles, builds = _recompiles(sup)
        finals, prefix_ok, _ = _streams_check(answers, range(num_requests))
        completed = len(finals)
        reference = _single_engine_reference(opt, root,
                                             sorted(set(video_ids)))
        mismatches = sum(1 for i, cap in finals.items()
                         if reference.get(video_ids[i]) != cap)
        parity_ok = completed == num_requests and mismatches == 0

        stats = sup.stats()
        c = stats["supervisor"]
        asc = stats.get("autoscale") or {}
        budget_ok = c["sup_replica_deaths"] == 0
        slo = _slo_block(fleet_obs.slo_status())
        # No thrash: one up and one down in a clean run; <= 4 tolerates
        # one extra round trip.
        changes = asc.get("scale_ups", 0) + asc.get("scale_downs", 0)
        no_thrash = changes <= 4
        record = {
            "metric": SERVE_METRIC, "schema": 1,
            "value": round(completed / makespan, 2) if makespan else None,
            "platform": _platform(opt),
            "completed": completed, "num_requests": num_requests,
            "shed": c["sup_shed"], "makespan_s": round(makespan, 3),
            "latency_p50_ms": stats.get("latency_p50_ms"),
            "latency_p99_ms": stats.get("latency_p99_ms"),
            "beam_size": opt.beam_size, "decode_chunk": opt.decode_chunk,
            "buckets": opt.serve_buckets,
            "recompiles_after_warmup": recompiles,
            "stream": {"enabled": True, "prefix_ok": prefix_ok},
            "slo": slo,
            "fleet_obs": {
                "samples": len(fleet_obs.series()),
                "metrics_file": fleet_obs.metrics_path,
                "trace_dir": os.path.join(root, "trace"),
            },
            "supervisor": {
                "enabled": True,
                "replicas": len(sup._replicas),
                "restart_limit": opt.supervise_restart_limit,
                "killed_replica": None,
                "restarts": c["sup_replica_restarts"],
                "requeued": c["sup_requeued"],
                "deaths": c["sup_replica_deaths"],
                "wedge_kills": c["sup_wedge_kills"],
                "budget_ok": budget_ok,
                "parity_ok": parity_ok,
                "parity_mismatches": mismatches,
                "incidents": len(stats["incidents"]),
                "blackbox_harvested": True,
                "per_replica": stats["per_replica"],
                "library_builds": builds,
                "captions": {video_ids[i]: cap
                             for i, cap in sorted(finals.items())},
            },
            "autoscale": {
                "enabled": True,
                "min": opt.autoscale_min, "max": opt.autoscale_max,
                "started_at_min": base_after_idle == opt.autoscale_min,
                "scaled_up": scaled_up,
                "scale_up_intervals": round(up_intervals, 1),
                "scale_up_budget_intervals": budget_intervals,
                "scaled_down": scaled_down,
                "scale_ups": asc.get("scale_ups", 0),
                "scale_downs": asc.get("scale_downs", 0),
                "replica_changes": changes,
                "no_thrash": no_thrash,
                "brownout_entries": asc.get("brownout_entries", 0),
                "rung": asc.get("rung", 0),
                "decisions": asc.get("decisions", 0),
                "decisions_file": autoscaler.decisions_path,
                "answered_ok": completed == num_requests,
            },
        }
        print(json.dumps(record), flush=True)
        report = {"answered": completed == num_requests,
                  "parity_ok": parity_ok, "prefix_ok": prefix_ok,
                  "recompiles": recompiles, "budget_ok": budget_ok,
                  "started_at_min": base_after_idle == opt.autoscale_min,
                  "scaled_up": scaled_up, "scaled_down": scaled_down,
                  "no_thrash": no_thrash}
        print(f"serve_supervisor: autoscale probe {json.dumps(report)}",
              file=sys.stderr)
        if not all([report["answered"], parity_ok, prefix_ok,
                    recompiles == 0, budget_ok, report["started_at_min"],
                    scaled_up, scaled_down, no_thrash]):
            rc = 1
    except SupervisorUnrecoverable as e:
        print(f"serve_supervisor: UNRECOVERABLE: {e}; exiting "
              f"{EXIT_WEDGE} ({describe(EXIT_WEDGE)})", file=sys.stderr)
        rc = EXIT_WEDGE
    finally:
        sup.shutdown()
        close_observability(tracer, fleet_obs)
        write_supervisor_exit(root, rc, sup, registry)
        print("serve_supervisor: " + json.dumps(sup.supervisor_counters()),
              file=sys.stderr)
    return rc


# ---------------------------------------------------------------------------
# the supervisor-death journal drill (--journal_probe 1)
# ---------------------------------------------------------------------------


def _supervisor_argv(opt, root: str, journal_dir: str) -> list:
    """A whole supervisor command line for the journal drill: the drill
    runs the supervisor as a subprocess (socket mode, ephemeral port) so
    SIGKILLing it is a real process death.  Both incarnations get the same
    argv: recovery must come from the journal, not from flags."""
    argv = [sys.executable, "-m", "cst_captioning_tpu_torch.serve_supervisor",
            "--serve_port", "-1", "--supervise_dir", root,
            "--journal_dir", journal_dir, "--loglevel", "WARNING"]
    forward = [("--supervise_replicas", opt.supervise_replicas),
               ("--supervise_restart_limit", opt.supervise_restart_limit),
               ("--supervise_backoff_ms", opt.supervise_backoff_ms),
               ("--journal_segment_bytes", opt.journal_segment_bytes),
               ("--journal_compact", opt.journal_compact),
               ("--fleet_scrape_ms", opt.fleet_scrape_ms),
               ("--slo_p99_ms", opt.slo_p99_ms),
               ("--slo_availability", opt.slo_availability),
               ("--slo_error_rate", opt.slo_error_rate)]
    for flag, val in forward:
        argv += [flag, str(val)]
    return argv + _forwarded(opt)


def _is_terminal(obj: dict) -> bool:
    return bool(obj.get("final")) or "error" in obj


def _drain_into(child, answers: dict) -> None:
    for raw in child.lines():
        try:
            obj = json.loads(raw)
        except ValueError:
            continue
        rid = obj.get("id")
        if rid is not None:
            answers.setdefault(rid, []).append(obj)


def _wire_stats(child, answers: dict, timeout_s: float = 30.0) -> dict:
    """One ``{"op": "stats"}`` round trip; request lines that arrive
    meanwhile go into ``answers``."""
    child.send_line(json.dumps({"op": "stats"}))
    end = time.monotonic() + timeout_s
    while time.monotonic() < end:
        for raw in child.lines():
            try:
                obj = json.loads(raw)
            except ValueError:
                continue
            if obj.get("op") == "stats":
                return obj
            if obj.get("id") is not None:
                answers.setdefault(obj["id"], []).append(obj)
        if child.poll() is not None:
            raise RuntimeError(
                f"supervisor exited {child.poll()} during stats query")
        time.sleep(0.005)
    raise RuntimeError("supervisor stats query timed out")


def run_journal_probe(opt) -> int:
    """Storm a journal-armed supervisor subprocess with streams in flight,
    SIGKILL its whole process group mid-storm (the supervisor and its
    children die together), relaunch on the same ``--journal_dir``,
    resubmit every id with its idempotency key and stream watermark, and
    hold: every accepted id answered exactly once; every caption equal to
    the single-engine child's; the chunks before the kill and after the
    relaunch one gapless prefix of the caption; the recovery ledger
    covering every id; a duplicate answered from the journal with no
    decode; no post-warm-up compile after the relaunch.  Prints the record
    line ``scripts/serve_report.py`` gates."""
    root = opt.supervise_dir or tempfile.mkdtemp(prefix="cst_journal_")
    os.makedirs(root, exist_ok=True)
    journal_dir = opt.journal_dir or os.path.join(root, "journal")
    argv = _supervisor_argv(opt, root, journal_dir)

    num_requests = 12
    kill_after_terminals = 2
    video_ids = [f"v{i % 6}" for i in range(num_requests)]
    qid = [f"q{i}" for i in range(num_requests)]

    reference = _single_engine_reference(opt, root, sorted(set(video_ids)))

    def in_flight(answers) -> int:
        return sum(1 for i in range(num_requests)
                   if not any(_is_terminal(o) for o in answers.get(qid[i], []))
                   and any(o.get("stream") and not o.get("final")
                           for o in answers.get(qid[i], [])))

    # Incarnation 1: the storm, then SIGKILL of the process group.
    p1: dict = {}
    sup1 = spawn_serve_child(argv, os.path.join(root, "sup1"), 0,
                             env=child_env(), startup_timeout_s=600.0,
                             new_session=True)
    t0 = time.monotonic()
    try:
        for i in range(num_requests):
            sup1.send_line(json.dumps(
                {"id": qid[i], "video_id": video_ids[i], "op": "stream",
                 "idem": f"k{i}"}))
        deadline = time.monotonic() + 300.0
        while True:
            if sup1.poll() is not None:
                raise RuntimeError(
                    f"supervisor exited {sup1.poll()} before the kill")
            _drain_into(sup1, p1)
            terms = sum(1 for objs in p1.values()
                        if any(_is_terminal(o) for o in objs))
            # Mid-storm: terminals already sent and a stream under way.
            if terms >= kill_after_terminals and in_flight(p1):
                break
            if terms >= num_requests:
                raise RuntimeError("the storm ended before a kill point "
                                   "with a stream in flight")
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"storm stalled: only {terms} terminal(s) in 300s")
            time.sleep(0.001)
        # The supervisor leads its own process group (new_session), so one
        # killpg reaches every child it spawned.
        os.killpg(sup1.proc.pid, signal.SIGKILL)
        sup1.proc.wait()
        time.sleep(0.2)  # the reader thread flushes buffered lines
        _drain_into(sup1, p1)
    finally:
        sup1.close()

    p1_term = {r: [o for o in objs if _is_terminal(o)]
               for r, objs in p1.items()}
    terminals_at_kill = sum(1 for t in p1_term.values() if t)
    streams_in_flight = sum(
        1 for i in range(num_requests)
        if not p1_term.get(qid[i])
        and any(o.get("stream") and not o.get("final")
                for o in p1.get(qid[i], [])))
    killed_mid_storm = terminals_at_kill >= 1 and streams_in_flight >= 1

    # Incarnation 2: relaunch on the same journal and resubmit.
    p2: dict = {}
    rc = 0
    sup2 = spawn_serve_child(argv, os.path.join(root, "sup2"), 0,
                             env=child_env(), startup_timeout_s=600.0,
                             new_session=True)
    rc2 = None
    try:
        for i in range(num_requests):
            req = {"id": qid[i], "video_id": video_ids[i], "op": "stream",
                   "idem": f"k{i}"}
            seqs = [o["seq"] for o in p1.get(qid[i], [])
                    if o.get("stream") and not o.get("final")]
            if seqs:
                # The client's watermark: the attach resumes past it.
                req["have_seq"] = max(seqs)
            sup2.send_line(json.dumps(req))
        deadline = time.monotonic() + 600.0
        while True:
            if sup2.poll() is not None:
                raise RuntimeError(
                    f"relaunched supervisor exited {sup2.poll()} early")
            _drain_into(sup2, p2)
            done = sum(1 for i in range(num_requests)
                       if any(_is_terminal(o) for o in p2.get(qid[i], [])))
            if done >= num_requests:
                break
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"relaunch drill timed out with {done} of "
                    f"{num_requests} resubmits answered")
            time.sleep(0.005)
        makespan = time.monotonic() - t0

        # A duplicate of a terminal key is answered from the journal,
        # without touching sup_requests.
        stats_before = _wire_stats(sup2, p2)
        sup2.send_line(json.dumps(
            {"id": "qdup", "video_id": video_ids[0], "op": "stream",
             "idem": "k0"}))
        dup_deadline = time.monotonic() + 60.0
        while not any(_is_terminal(o) for o in p2.get("qdup", [])):
            if time.monotonic() > dup_deadline:
                raise RuntimeError("duplicate submit never answered")
            _drain_into(sup2, p2)
            time.sleep(0.005)
        stats_after = _wire_stats(sup2, p2)
        dup_fin = next(o for o in p2["qdup"] if _is_terminal(o))
        dup_suppressed = (
            dup_fin.get("idempotent") is True
            and dup_fin.get("caption") == reference.get(video_ids[0])
            and stats_after["supervisor"]["sup_requests"]
            == stats_before["supervisor"]["sup_requests"]
            and stats_after["supervisor"]["sup_journal_dup_hits"]
            > stats_before["supervisor"]["sup_journal_dup_hits"])
        recompiles = 0
        for rep in stats_after.get("per_replica") or []:
            if rep.get("compiles") is not None \
                    and rep.get("compiles0") is not None:
                recompiles += max(0, int(rep["compiles"])
                                  - int(rep["compiles0"]))
    finally:
        sup2.terminate()
        end = time.monotonic() + 120.0
        while time.monotonic() < end:
            rc2 = sup2.poll()
            if rc2 is not None:
                break
            time.sleep(0.05)
        if rc2 is None:
            os.killpg(sup2.proc.pid, signal.SIGKILL)
        sup2.close()
    clean_exit = rc2 == EXIT_PREEMPTED

    ledger: dict = {}
    try:
        with open(os.path.join(root, "recovery_ledger.json")) as f:
            ledger = json.load(f)
    except (OSError, ValueError):
        pass
    exit_doc: dict = {}
    try:
        with open(os.path.join(root, "supervisor_exit.json")) as f:
            exit_doc = json.load(f)
    except (OSError, ValueError):
        pass
    replayed = ledger.get("replayed") or []
    replayed_keys = {r.get("key") for r in replayed}
    recovered_terminals = int(ledger.get("recovered_terminals") or 0)
    torn_records = int(ledger.get("torn_records") or 0)
    open_at_exit = (exit_doc.get("journal") or {}).get("open")

    completed = mismatches = chunks_total = idempotent_answers = 0
    exactly_once = prefix_ok = True
    captions_out = {}
    for i in range(num_requests):
        objs = p1.get(qid[i], []) + p2.get(qid[i], [])
        terminal = [o for o in objs if _is_terminal(o)]
        authoritative = [o for o in terminal if not o.get("idempotent")]
        idempotent_answers += len(terminal) - len(authoritative)
        if not terminal or len(authoritative) > 1:
            exactly_once = False
        captions = {o.get("caption") for o in terminal if "caption" in o}
        if len(captions) != 1:
            exactly_once = False
            continue
        cap = captions.pop()
        completed += 1
        captions_out[video_ids[i]] = cap
        if cap != reference.get(video_ids[i]):
            mismatches += 1
        # Chunks before the kill and after the attach, deduplicated by
        # seq (the attach may resend a chunk the socket delivered at the
        # kill), must be one gapless prefix of the caption.
        by_seq: dict = {}
        for o in objs:
            if o.get("stream") and not o.get("final"):
                if by_seq.setdefault(o["seq"], o["text"]) != o["text"]:
                    prefix_ok = False
        chunks_total += len(by_seq)
        if sorted(by_seq) != list(range(len(by_seq))):
            prefix_ok = False
            continue
        text = " ".join(by_seq[s] for s in sorted(by_seq)
                        if by_seq[s]).strip()
        if not cap.startswith(text):
            prefix_ok = False
    answered = completed == num_requests
    parity_ok = answered and mismatches == 0
    covered_ok = all(
        f"k{i}" in replayed_keys
        or any(o.get("idempotent") for o in p2.get(qid[i], [])
               if _is_terminal(o))
        for i in range(num_requests))
    replay_accounted = (covered_ok
                        and len(replayed) + recovered_terminals
                        == num_requests
                        and open_at_exit == 0)
    torn_ok = torn_records <= 1

    c = stats_after["supervisor"]
    slo = _slo_block(stats_after.get("slo") or {})
    record = {
        "metric": SERVE_METRIC, "schema": 1,
        "value": round(completed / makespan, 2) if makespan else None,
        "platform": _platform(opt),
        "completed": completed, "num_requests": num_requests,
        "shed": c["sup_shed"], "makespan_s": round(makespan, 3),
        "latency_p50_ms": stats_after.get("latency_p50_ms"),
        "latency_p99_ms": stats_after.get("latency_p99_ms"),
        "beam_size": opt.beam_size, "decode_chunk": opt.decode_chunk,
        "buckets": opt.serve_buckets,
        "recompiles_after_warmup": recompiles,
        "stream": {"enabled": True, "prefix_ok": prefix_ok,
                   "chunks": chunks_total},
        "slo": slo,
        "supervisor": {
            "enabled": True,
            "replicas": opt.supervise_replicas,
            "restart_limit": opt.supervise_restart_limit,
            "killed_replica": None,
            "restarts": c["sup_replica_restarts"],
            "requeued": c["sup_requeued"],
            "deaths": c["sup_replica_deaths"],
            "wedge_kills": c["sup_wedge_kills"],
            "budget_ok": c["sup_replica_deaths"] == 0,
            "parity_ok": parity_ok,
            "parity_mismatches": mismatches,
            "incidents": len(stats_after.get("incidents") or []),
            "blackbox_harvested": True,
            "per_replica": stats_after.get("per_replica") or [],
            "captions": captions_out,
        },
        "journal": {
            "enabled": True,
            "dir": journal_dir,
            "killed_mid_storm": killed_mid_storm,
            "terminals_before_kill": terminals_at_kill,
            "streams_in_flight_at_kill": streams_in_flight,
            "replayed": len(replayed),
            "recovered_terminals": recovered_terminals,
            "replay_accounted": replay_accounted,
            "exactly_once": exactly_once,
            "idempotent_answers": idempotent_answers,
            "dup_suppressed": dup_suppressed,
            "dup_hits": c["sup_journal_dup_hits"],
            "attached": c["sup_journal_attached"],
            "torn_records": torn_records,
            "torn_ok": torn_ok,
            "segments_scanned": ledger.get("segments_scanned"),
            "high_water": ledger.get("high_water"),
            "open_at_exit": open_at_exit,
            "relaunch_rc": rc2,
            "clean_exit": clean_exit,
        },
    }
    print(json.dumps(record), flush=True)
    report = {"answered": answered, "exactly_once": exactly_once,
              "parity_ok": parity_ok, "prefix_ok": prefix_ok,
              "recompiles": recompiles, "replay_accounted": replay_accounted,
              "dup_suppressed": dup_suppressed, "torn_ok": torn_ok,
              "killed_mid_storm": killed_mid_storm,
              "clean_exit": clean_exit}
    print(f"serve_supervisor: journal probe {json.dumps(report)}",
          file=sys.stderr)
    if not all([answered, exactly_once, parity_ok, prefix_ok,
                recompiles == 0, replay_accounted, dup_suppressed, torn_ok,
                killed_mid_storm, clean_exit]):
        rc = 1
    return rc


# ---------------------------------------------------------------------------
# serving mode
# ---------------------------------------------------------------------------


def run_serving(opt) -> int:
    handler = PreemptionHandler().install()
    registry = MetricsRegistry()
    plan = FaultPlan.parse(opt.fault_plan)
    if plan is not None:
        plan.bind_metrics(registry)
        log.warning("CHAOS: process fault plan armed: %s", plan)
    root = opt.supervise_dir or tempfile.mkdtemp(prefix="cst_supervise_")
    os.makedirs(root, exist_ok=True)

    # The supervisor's own flight recorder, span tracer and fleet plane
    # (the children each run their own recorder and tracer).
    tracer, lifecycle, fleet_obs = build_observability(opt, root, registry)
    autoscaler = build_autoscaler(opt, root, fleet_obs, registry=registry,
                                  lifecycle=lifecycle)
    journal = build_journal(opt)
    sup = build_supervisor(opt, root, plan=plan, registry=registry,
                           lifecycle=lifecycle, fleet_obs=fleet_obs,
                           autoscaler=autoscaler, journal=journal)
    # The children are live: replay the journal before the wire opens, so
    # a duplicate resubmit attaches to the replay instead of racing it.
    replay_and_ledger(sup, root)
    blackbox = (os.path.join(root, "blackbox.json")
                if opt.serve_blackbox else None)
    server = SupervisorServer(sup, handler=handler, registry=registry,
                              lifecycle=lifecycle, blackbox_path=blackbox)
    if lifecycle is not None:
        lifecycle.attach(
            health=server.health_payload,
            counters=lambda: registry.snapshot().get("counters"))
    watchdog = None
    if opt.serve_heartbeat_file or opt.wedge_timeout > 0:
        watchdog = ProgressWatchdog(
            opt.wedge_timeout, describe=lambda: "supervisor scheduler loop",
            heartbeat_path=opt.serve_heartbeat_file,
            payload=lambda: {"serving": server.health_payload(),
                             **registry.heartbeat_payload()},
            heartbeat_interval_s=1.0).start()
        server.watchdog = watchdog
    print(f"serve_supervisor: {len(sup._replicas)} child process(es) up "
          f"in {root}", file=sys.stderr, flush=True)
    rc = 0
    try:
        try:
            if opt.serve_port:
                rc = server.run_socket(max(opt.serve_port, 0))
            else:
                rc = server.run_stdin()
        except SupervisorUnrecoverable as e:
            print(f"serve_supervisor: UNRECOVERABLE: {e}; exiting "
                  f"{EXIT_WEDGE} ({describe(EXIT_WEDGE)})", file=sys.stderr)
            # Every outstanding id answered first, so the blackbox holds
            # the final health (every replica dead) and those answers.
            sup.hard_abort()
            if lifecycle is not None and blackbox:
                try:
                    lifecycle.dump(blackbox, reason="unrecoverable")
                    print(f"serve_supervisor: blackbox written to "
                          f"{blackbox}", file=sys.stderr)
                except OSError as werr:
                    print(f"serve_supervisor: blackbox write failed: "
                          f"{werr}", file=sys.stderr)
            rc = EXIT_WEDGE
    finally:
        if watchdog is not None:
            watchdog.stop()
        close_observability(tracer, fleet_obs)
        stats = sup.stats()
        print("serve_supervisor: " + json.dumps(stats), file=sys.stderr)
        if opt.result_file:
            atomic_json_write(opt.result_file,
                              {"stats": stats,
                               "health": sup.health_payload(),
                               "telemetry": registry.snapshot()},
                              indent=2)
        write_supervisor_exit(root, rc, sup, registry)
    return rc


def main(argv=None) -> int:
    opt = parse_supervisor_args(argv)
    configure_cli_logging(opt.loglevel)
    if opt.journal_probe:
        return run_journal_probe(opt)
    if opt.autoscale_probe:
        return run_autoscale_probe(opt)
    if opt.supervise_probe:
        return run_probe(opt)
    return run_serving(opt)


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        code = EXIT_FAILURE
    sys.stdout.flush()
    sys.stderr.flush()
    # Reader threads may still be blocked in a read; leave without the
    # interpreter's teardown.
    os._exit(code)
