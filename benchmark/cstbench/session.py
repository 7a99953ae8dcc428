"""One run of a cell: set-up (inputs, the program, its first steps, which
the comparison judges, and warm-up), the measured window, the traced
segment (``--trace 1``), then, with the program freed, the reference and
the comparison.

The window is a closed loop of ``Trainer.iteration()`` calls for
``seconds`` of the host's clock, between two device synchronisations.
After each call a CUDA event is recorded on the stream, with no host
sync; a step's time is the interval between consecutive events, so it
holds the device's idle gaps.
"""

from __future__ import annotations

import gc
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from . import check, inputs, program, trace
from .reference import models as ref_models
from .reference import train as ref_train
from .spec import BENCH_DIR, Cell

CHECK_STEPS = 3


@dataclass
class RunRecord:
    """What a run measured; the metric readers read it."""

    cell: Cell
    setup_s: float = 0.0
    window_s: float = 0.0
    steps: int = 0
    rows_per_step: int = 0
    step_ms: List[float] = field(default_factory=list)
    #: per window step: the program's phase times (ms) and its metrics
    phases: List[Dict[str, float]] = field(default_factory=list)
    values: List[Dict[str, float]] = field(default_factory=list)
    data_wait_s: Optional[float] = None
    flops_per_step: float = 0.0
    peak_flops: float = 0.0
    trace: Optional[trace.TraceSummary] = None
    calls: Dict[str, list] = field(default_factory=lambda: {"k1": [],
                                                            "k2": []})
    memory_peak_bytes: int = 0
    knobs: dict = field(default_factory=dict)
    #: seconds of set-up's parts, from the run's start
    setup_parts: Dict[str, float] = field(default_factory=dict)
    numbers: Dict[str, float] = field(default_factory=dict)
    #: the interpreter's collections per generation in the window
    gc_collections: List[int] = field(default_factory=list)


class _Clock:
    """CUDA events on a CUDA device, the host's clock elsewhere."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def intervals_ms(self, marks) -> List[float]:
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _host(x) -> float:
    return float(x.detach().float().cpu()) if torch.is_tensor(x) else float(x)


def run(cell: Cell, seed: int, seconds: float, traced: bool,
        device: torch.device, t0: float,
        options: Optional[dict] = None,
        plant: Optional[Callable[[object], Callable[[], None]]] = None,
        shared: Optional[dict] = None) -> RunRecord:
    """One run.  ``options`` override the train CLI's options (the
    control's precision); ``plant(trainer)`` breaks the program (a fault
    the comparison must catch) and returns what mends it; ``shared``
    keeps the split and the reward tables between runs of one process
    (the control's).  None of them is used by a benchmark run."""
    from cst_captioning_tpu_torch.training.trainer import phase_ms

    rec = RunRecord(cell=cell)

    def part(name):
        rec.setup_parts[name] = time.perf_counter() - t0 - sum(
            rec.setup_parts.values())

    part("start")
    cfg, traffic = cell.config, cell.traffic
    out_dir = os.path.join(BENCH_DIR, ".out", cell.name)
    key = (seed, traffic["videos"], cfg["vocab_size"], str(cfg["feat_shapes"]))
    if shared is not None and shared.get("split_key") == key:
        arrays = shared["split"]
    else:
        arrays = inputs.make_split(seed, traffic, cfg, device)
        if shared is not None:
            shared.update(split_key=key, split=arrays, tables={})
    part("inputs")
    argv = program.trainer_argv(
        {**cfg, "options": {**cfg["options"], **(options or {})}}, traffic,
        seed, device.type, os.path.join(out_dir, "ckpt"), traced)
    trainer, opt = program.build(
        argv, arrays, None if shared is None else shared["tables"])
    rec.knobs = program.resolved_knobs(opt)
    vocab_rows = trainer.vocab.size_with_pad
    weights = inputs.make_weights(
        seed, ref_models.layout(cfg, vocab_rows), device)
    program.load_weights(trainer, weights)
    weights = {n: w.to("cpu", copy=True) for n, w in weights.items()}
    mend = plant(trainer) if plant is not None else None
    part("program")

    seen = program.Observer(trainer)
    mine: Dict[str, list] = {"loss": [], "reward": [], "baseline": []}
    for k in range(CHECK_STEPS):
        (_, m), = trainer.iteration()
        for name in ("loss", "reward", "baseline"):
            if name in m:
                mine[name].append(_host(m[name]))
        if k == 0:
            mine["mu1"] = program.named_state(trainer, "mu")
    mine["params3"] = program.named_params(trainer)
    mine["params0"] = weights
    seen.close()
    spi = int(cfg["captions_per_video"])
    mine["batch"] = check.batch_faults(seen.batches, arrays.labels, spi)
    masks = None
    if traffic["options"].get("use_rl"):
        mine["noise_z"] = check.noise_z(seen.noise)
    elif float(traffic["options"].get("drop_prob", 0)) > 0:
        masks = [check.dropout_sites(m, dropout_shapes(cfg, len(b.video_ix)))
                 for m, b in zip(seen.masks, seen.batches)]
        mine["dropout_z"] = check.dropout_z(
            masks, float(traffic["options"]["drop_prob"]))
    part("first_steps")

    for _ in range(int(traffic["warmup_steps"])):
        trainer.iteration()
    _sync(device)
    phases = trainer.telemetry.phases
    if phases is not None:
        phases.drain_ms(1)                       # set-up's phases
    part("warmup")

    clock = _Clock(device)
    done = []
    rec.rows_per_step = int(traffic["options"]["batch_size"]) * spi
    if seconds > 0:
        _sync(device)
        gc_before = [s["collections"] for s in gc.get_stats()]
        marks = [clock.mark()]
        start = time.perf_counter()
        rec.setup_s = start - t0
        while time.perf_counter() - start < seconds:
            done.extend(m for _, m in trainer.iteration())
            marks.append(clock.mark())
        _sync(device)
        rec.window_s = time.perf_counter() - start
        rec.gc_collections = [s["collections"] - b for s, b in
                              zip(gc.get_stats(), gc_before)]
        rec.steps = len(marks) - 1
        rec.step_ms = clock.intervals_ms(marks)
    if phases is not None and rec.steps:
        rec.data_wait_s = (phases.drain_ms(rec.steps)["data_wait_ms"]
                           * rec.steps / 1e3)
    rec.phases = [phase_ms(m) for m in done]
    rec.values = [{k: _host(m[k]) for k in ("rollout_steps", "bad_step")
                   if k in m} for m in done]
    del done
    if device.type == "cuda":
        rec.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
    rec.flops_per_step = cell.flops(cfg, traffic)
    rec.peak_flops = float(cfg["peak_tflops"]) * 1e12

    if traced:
        n, path = int(traffic["trace_steps"]), os.path.join(out_dir,
                                                            "trace.json")
        rec.trace = trace.profile(trainer.iteration, n, path, host=False)
        with program.kernel_ranges(rec.calls):
            hosted = trace.profile(trainer.iteration, n, path, host=True)
        rec.trace.idle_gaps, rec.trace.ranges = (hosted.idle_gaps,
                                                 hosted.ranges)

    if mend is not None:
        mend()
    trainer.close()
    del trainer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    theirs = ref_train.run(weights, cfg, traffic, arrays, seen.batches,
                           seen.rollouts, device, masks, seen.noise)
    rec.numbers = check.numbers(mine, theirs)
    return rec


def dropout_shapes(cfg: dict, videos: int) -> List[tuple]:
    """The shapes of one XE step's dropout masks in the model's draw
    order: the pooled feature, the memory, then each decode step's LSTM
    output."""
    h = int(cfg["options"]["rnn_size"])
    frames = sum(t for t, _ in cfg["feat_shapes"])
    rows = videos * int(cfg["captions_per_video"])
    return ([(videos, h), (videos, frames, h)]
            + [(rows, h)] * int(cfg["max_length"]))
