"""Fleet-serving CLI of the port (counterpart of ``scripts/serve_fleet.py``):
the JSONL front end over N self-healing engine replicas.

    python -m cst_captioning_tpu_torch.serve_fleet --serve_demo 1 \\
        --serve_replicas 3 < requests.jsonl

The backends, flags, wire format, drain and exit codes are the serve
CLI's (``serve.py``, whose helpers this module uses); a client cannot
tell one engine from a fleet except by throughput.  On top:

- ``--serve_replicas`` engine replicas behind ``serving.fleet.
  FleetRouter``, one per card round-robin where the machine has several,
  all on the one card otherwise (they then share it, and its stream);
- one exact-result cache shared by every replica and every restarted
  engine;
- one base lifecycle tracer: the router records intake, each replica's
  engine holds ``for_replica(k)``, and the blackbox carries every
  replica's health;
- ``{"op": "health"}`` answers the fleet view (worst-of status plus every
  replica's detail), and so does the heartbeat file;
- ``--fault_plan 'serve_wedge@replica=K'`` (and the other serving kinds)
  fires inside replica K's engine, once;
- a replica whose ladder is exhausted is restarted with its residents
  re-queued; when every replica has spent ``--serve_restart_limit`` the
  blackbox is written and the process exits 124.

Fleet stats go to stderr as one JSON line (``serve_fleet: {...}``).
"""

from __future__ import annotations

import copy
import os
import sys

import torch

from .resilience.exitcodes import EXIT_FAILURE
from .resilience.faults import FaultPlan
from .resilience.preemption import PreemptionHandler
from .serve import (build_backend, configure_cli_logging, engine_kwargs,
                    make_tracers, parse_args, serve_until_exit,
                    warn_serve_deadline)
from .serving.cache import ResultCache
from .serving.engine import ServingEngine, ServingRefused
from .serving.fleet import FleetRouter, FleetUnrecoverable
from .serving.server import CaptionServer
from .telemetry.registry import MetricsRegistry


def replica_devices(model):
    """The cards the replicas go to round-robin: every visible one when
    the model is on a CUDA device and the machine has more than one,
    else None (every replica on the model's own device)."""
    if model.device.type != "cuda" or torch.cuda.device_count() < 2:
        return None
    return [torch.device("cuda", k) for k in range(torch.cuda.device_count())]


def main(argv=None) -> int:
    opt = parse_args(argv, fleet=True, description=__doc__.splitlines()[0])
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
        print(f"serve_fleet: refused: {e}", file=sys.stderr, flush=True)
        return EXIT_FAILURE
    tracer, lifecycle = make_tracers(opt, registry)
    result_cache = ResultCache(opt.serve_cache) if opt.serve_cache else None
    devices = replica_devices(model)
    models = {model.device: model}

    def model_on(dev):
        if dev not in models:
            models[dev] = copy.deepcopy(model).to(dev)
        return models[dev]

    def engine_factory(replica: int) -> ServingEngine:
        dev = (model.device if devices is None
               else devices[replica % len(devices)])
        return ServingEngine(
            model_on(dev), feat_shapes, **engine_kwargs(opt),
            fault_plan=(plan.for_replica(replica) if plan is not None
                        else None),
            result_cache=result_cache, registry=registry, tracer=tracer,
            lifecycle=(lifecycle.for_replica(replica)
                       if lifecycle is not None else None))

    router = FleetRouter(engine_factory, opt.serve_replicas,
                         devices=devices,
                         restart_limit=opt.serve_restart_limit,
                         registry=registry, lifecycle=lifecycle)
    router.warm()
    server = CaptionServer(router, vocab, feats_for, handler=handler,
                           registry=registry, health_source=router.health,
                           lifecycle=lifecycle,
                           blackbox_path=opt.serve_blackbox or None)
    print(f"serve_fleet: ready: {opt.serve_replicas} replica(s) on "
          f"{len(devices) if devices else 1} device(s) ({model.device}; "
          f"decode_kernel={opt.decode_kernel}, compute {model.dtype}, beam "
          f"{router.beam_size}, buckets {router.buckets}, cache "
          f"{opt.serve_cache}, restart limit {opt.serve_restart_limit}, "
          f"lifecycle {int(lifecycle is not None)})", file=sys.stderr,
          flush=True)
    if plan is not None:
        print(f"serve_fleet: CHAOS: fault plan armed: {plan}",
              file=sys.stderr, flush=True)
    return serve_until_exit("serve_fleet", opt, server, registry, tracer,
                            lifecycle, FleetUnrecoverable)


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # A reader thread may still be blocked in a read; leave without the
    # interpreter's teardown, which can abort under it.
    os._exit(code)
