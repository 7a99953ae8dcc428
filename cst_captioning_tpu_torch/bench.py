"""Throughput bench of the port: captions/s/chip of the XE and CST
training stages, the serving engine and the data feed (counterpart of
the reference's root ``bench.py``).

    python -m cst_captioning_tpu_torch.bench [--stage both|xe|cst|serving|data]

Prints one JSON line per run on standard output:
``{"metric", "value", "unit", "vs_baseline", ...}``.  The default stage
``both`` measures XE and CST and headlines the lower of the two, so the
number cannot pass on the easy stage alone.  CST headlines the fused
on-device step (``--device_rewards 1``, the trainer's default) and reports
beside it the host reward path at the trainer's pipeline depth
(``--overlap_depth 2``) and the serial loop (depth 0), scored by the
native C++ CIDEr-D (``--native_cider 1``, the trainer's default; the
Python scorer with a warning where the library cannot be built;
``cst_scorer`` says which ran).  ``vs_baseline`` is the value over the
north-star of 5000 captions/s/chip (``BASELINE.md``); the serving and
data stages have none (null).

Shapes are MSR-VTT's: ResNet-152 (28, 2048) + C3D (1, 4096) features,
vocabulary 8000, 30-token captions, 32 videos x 20 captions a batch,
E = H = A = 512, seeded weights and data (numpy and CPU generators, so
every device gets the same numbers).  Both kernels run: K1 in every
teacher-forced step, K2 in every decode step (``--decode_kernel fused``);
each record carries the launches its stage made.  Timing: one warm-up,
then the host clock around the timed steps, closed by
``torch.cuda.synchronize()``.

Runs on the CUDA device unless ``--device cpu`` is given; without a GPU
it raises.  It never falls back: a path that fails fails the run.  Flags
whose parts are not ported are refused with the ROADMAP item that holds
them.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import default_device
from .data.loader import feat_dtype
from .data.vocab import Vocab
from .models.captioner import CaptionModel
from .ops import launch_counts, reset_launch_counts
from .ops.device_ciderd import auto_ref_chunk
from .ops.losses import sequence_mask
from .ops.sampling import gumbel_noise, sample_with_baseline
from .serving.bench import ARRIVAL_SHAPES, serving_probe
from .serving.buckets import parse_buckets
from .telemetry.flops import DEFAULT_FEAT_SHAPES, caption_step_flops, \
    mfu_fields
from .train import positive_int
from .training.device_rewards import build_device_tables
from .training.pipeline import RewardPipeline
from .training.rewards import RewardComputer, host_scorer
from .training.state import Optimizer
from .training.steps import fused_cst_step, rl_grad_step, rollout, xe_step
from .weights import init_like_flax_

#: The north-star: captions/s/chip for the XE and CST stages.
BASELINE_CAPTIONS_PER_SEC = 5000.0

HEADLINE_METRIC = {
    "xe": "xe_captions_per_sec_per_chip",
    "cst": "cst_captions_per_sec_per_chip",
    "both": "min_xe_cst_captions_per_sec_per_chip",
    "serving": "serve_captions_per_sec_per_chip",
    "data": "data_feed_captions_per_sec",
}

#: Flags of the reference's bench whose parts the port has not yet:
#: ``{dest: (the value that leaves them off, where they wait)}``.  Any
#: other value is refused.
REFUSED = {
    "data_shards": (0, "ROADMAP Queue 1 item 5 (DP and CP)"),
    "data_shard_id": (0, "ROADMAP Queue 1 item 5 (DP and CP)"),
    "scan_unroll": (None, "ROADMAP Queue 1 item 4 (tuning)"),
}


def analytic_step_flops(args) -> Dict[str, float]:
    """Model FLOPs of one step at this run's shapes -> {"xe", "cst"}."""
    return caption_step_flops(args.batch_size, args.seq_per_img,
                              args.seq_len, args.vocab, args.hidden)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build(args, device: torch.device):
    """The port's ``CaptionModel`` at the bench's widths with flax-like
    weights from seed 0 (K1 on, ``--decode_kernel``), its Adam optimizer
    (lr 2e-4, clip 10), features (B, T, D) in the feature dtype the train
    CLI uses and 0-terminated labels (B*S, L), seeded from numpy.
    -> (model, optimizer, feats, labels)."""
    b, s, L, v, h = (args.batch_size, args.seq_per_img, args.seq_len,
                     args.vocab, args.hidden)
    model = CaptionModel(
        v, [d for _, d in DEFAULT_FEAT_SHAPES], embed_size=h, hidden_size=h,
        attn_size=h, use_kernel_attention=True,
        decode_kernel=args.decode_kernel, drop_prob=0.5,
        dtype=torch.bfloat16 if args.bfloat16 else torch.float32)
    init_like_flax_(model, torch.Generator().manual_seed(0))
    model.to(device)
    opt = Optimizer(model.parameters(), learning_rate=2e-4, grad_clip=10.0)
    rng = np.random.default_rng(0)
    fdt = feat_dtype(bool(args.bfloat16), None)
    feats = [torch.from_numpy(rng.standard_normal((b, t, d))
                              .astype(np.float32)).to(fdt).to(device)
             for t, d in DEFAULT_FEAT_SHAPES]
    labels = rng.integers(1, v, (b * s, L))
    # Captions average about 10 tokens: 0-terminated at 6..L-2.
    lens = rng.integers(6, L - 1, b * s)
    labels = np.where(np.arange(L)[None, :] < lens[:, None], labels, 0)
    return model, opt, feats, torch.from_numpy(labels).long().to(device)


def synthetic_rewarder(batch: int, seq_per_img: int, vocab_size: int,
                       native: bool = True):
    """The vocabulary, a synthetic corpus of 20 references of 10 words
    per video, the CIDEr-D scorer and the ``RewardComputer``: the CST
    reward set-up of ``bench_cst``.  -> (reward computer, video ids,
    scorer kind "native" or "python", refs, vocab)."""
    vocab = Vocab({i: f"w{i}" for i in range(1, vocab_size)})
    rng = np.random.default_rng(1)
    refs = {f"v{i}": [" ".join(f"w{w}" for w in
                               rng.integers(1, vocab_size, 10))
                      for _ in range(20)]
            for i in range(batch)}
    scorer, kind = host_scorer(refs, vocab.word_to_ix, native=native)
    rc = RewardComputer(vocab, scorer, refs, seq_per_img=seq_per_img,
                        baseline="greedy")
    return rc, list(refs), kind, refs, vocab


def _timed(fn, steps: int, device: torch.device,
           after_warmup=None) -> float:
    """Seconds of ``steps`` calls of ``fn`` after one warm-up call (and
    ``after_warmup()``, untimed)."""
    fn()
    sync(device)
    if after_warmup is not None:
        after_warmup()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    sync(device)
    return time.perf_counter() - t0


def bench_xe(args, device: torch.device) -> float:
    """XE captions/s: teacher-forced steps with dropout and Adam."""
    model, opt, feats, labels = build(args, device)
    weights = torch.ones(labels.shape[0], device=device)
    gen = torch.Generator(device).manual_seed(0)
    dt = _timed(lambda: xe_step(model, opt, feats, labels, weights,
                                args.seq_per_img, gen),
                args.steps, device)
    return args.batch_size * args.seq_per_img * args.steps / dt


def snapshot(model, opt: Optimizer, gen: torch.Generator):
    """Copies of the weights, the optimizer's state and count, and the
    noise generator's state: what a CST step changes."""
    return ({k: v.clone() for k, v in model.state_dict().items()},
            [{k: v.clone() for k, v in st.items()} for st in opt.state],
            opt.count.clone(), gen.get_state())


@torch.no_grad()
def restore(model, opt: Optimizer, gen: torch.Generator, snap) -> None:
    """Put back what ``snapshot`` copied, in place."""
    weights, state, count, rng = snap
    model.load_state_dict(weights)
    for st, saved in zip(opt.state, state):
        for k, v in saved.items():
            st[k].copy_(v)
    opt.count.copy_(count)
    gen.set_state(rng)


def rollout_step_probe(model, feats, args, noise) -> dict:
    """Early-exit accounting (not a throughput): the decode steps the
    rollout executes under ``--decode_chunk`` against the full
    ``seq_len``.  The bench model is all but untrained and ends few
    captions, so the EOS logit is raised by ``--probe_eos_bias`` for this
    one untimed rollout (a converged policy ends most captions in 7-10 of
    30 steps), then restored."""
    bias = model.logit.bias
    with torch.no_grad():
        saved = bias[0].clone()
        bias[0] += args.probe_eos_bias
    try:
        sampled, _, _, steps = sample_with_baseline(
            model, feats, args.seq_len, args.seq_per_img, noise=noise,
            decode_chunk=args.decode_chunk, return_steps=True)
    finally:
        with torch.no_grad():
            bias[0] = saved
    lens = sequence_mask(sampled).sum(dim=1).cpu().numpy()
    return {
        "eos_bias": args.probe_eos_bias,
        "steps_legacy": args.seq_len,
        "steps_executed": int(steps),
        "steps_saved_pct": round(100.0 * (1 - steps / args.seq_len), 1),
        "len_mean": round(float(lens.mean()), 2),
        "len_p50": float(np.percentile(lens, 50)),
        "len_max": float(lens.max()),
    }


def bench_cst(args, device: torch.device) -> dict:
    """CST captions/s on the three paths: the host reward pipeline at
    ``--overlap_depth`` and serial (depth 0), both scored on the host,
    and the fused on-device step, the headline under ``--device_rewards
    1`` (the host pipeline under 0).  Then the rollout probe (with
    ``--decode_chunk`` > 0).

    CST trains the model it times, and the rollouts shorten as it
    learns, so every timed loop starts from the same state: the weights,
    optimizer state and noise of the first, restored after each warm-up
    and before each path.  (The reference's bench threads one state
    through all three paths, so a later path there times shorter
    rollouts.)  Each record still says how long its rollouts were: that
    moves with ``--steps``."""
    model, opt, feats, _ = build(args, device)
    rc, video_ids, scorer_kind, refs, vocab = synthetic_rewarder(
        args.batch_size, args.seq_per_img, args.vocab,
        native=bool(args.native_cider))
    ncaps = args.batch_size * args.seq_per_img
    gen = torch.Generator(device).manual_seed(1)
    noise = gumbel_noise(gen, dtype=model.dtype)
    start = snapshot(model, opt, gen)

    def reset():
        restore(model, opt, gen, start)

    # Decode steps of each rollout of the loop being run.
    executed: List[int] = []

    def rollout_fn(f, ctx):
        out = rollout(model, f, args.seq_len, args.seq_per_img, noise,
                      greedy_baseline=True, decode_chunk=args.decode_chunk)
        executed.append(out[2])
        return out

    def grad_fn(f, sampled, advantage, ctx):
        return rl_grad_step(model, opt, f, sampled,
                            torch.from_numpy(advantage).to(device),
                            args.seq_per_img)

    def run_loop(depth: int, steps: int) -> float:
        """-> the mean decode steps of the loop's rollouts."""
        executed.clear()
        # The trainer's own pipeline class, as the trainer drives it.
        pipe = RewardPipeline(rollout_fn, grad_fn,
                              lambda ctx, s, g: rc(video_ids, s, g), depth)
        for _ in range(steps):
            pipe.push(feats, {})
        pipe.drain()
        sync(device)
        return float(np.mean(executed))

    run_loop(args.overlap_depth, 2)                  # warm-up
    reset()
    t0 = time.perf_counter()
    host_steps = run_loop(args.overlap_depth, args.steps)
    host = ncaps * args.steps / (time.perf_counter() - t0)
    reset()
    t0 = time.perf_counter()
    serial_steps = run_loop(0, args.steps)
    serial = ncaps * args.steps / (time.perf_counter() - t0)

    corpus, tables, _ = build_device_tables(refs, vocab.word_to_ix,
                                            device=device)
    vix = torch.arange(args.batch_size, device=device)
    ref_chunk = auto_ref_chunk(ncaps, args.seq_len, tables)
    fused_steps: List[torch.Tensor] = []

    def fused_fn():
        m = fused_cst_step(model, opt, feats, vix, noise, corpus, tables,
                           args.seq_len, args.seq_per_img, baseline="greedy",
                           ref_chunk=ref_chunk,
                           decode_chunk=args.decode_chunk)
        fused_steps.append(m["rollout_steps"])

    reset()
    dt = _timed(fused_fn, args.steps, device, after_warmup=reset)
    fused = ncaps * args.steps / dt
    fused_executed = float(torch.stack(fused_steps[1:]).mean())

    probe = (rollout_step_probe(model, feats, args, noise)
             if args.decode_chunk > 0 else None)
    value, path = ((fused, "device_fused") if args.device_rewards
                   else (host, "host_pipeline"))
    return {
        "value": value,
        "path": path,
        "host_pipeline_captions_per_sec": round(host, 1),
        "serial_captions_per_sec": round(serial, 1),
        "fused_captions_per_sec": round(fused, 1),
        "host_pipeline_rollout_steps": round(host_steps, 2),
        "serial_rollout_steps": round(serial_steps, 2),
        "fused_rollout_steps": round(fused_executed, 2),
        "overlap_depth": args.overlap_depth,
        "scorer": scorer_kind,
        "decode_chunk": args.decode_chunk,
        "decode_kernel": args.decode_kernel,
        "rollout_probe": probe,
    }


def bench_serving(args, device: torch.device) -> dict:
    """Open-loop serving probe (``serving/bench.py``) at the bench's
    shapes, the EOS logit raised by ``--probe_eos_bias`` as in the
    rollout probe, so the untrained model ends its captions.  With
    ``--serve_cache_compare 1`` and a cache: an unmeasured rehearsal,
    then the cache-off twin and the cached probe at the same seed (the
    same arrivals and mix), and the record carries ``cache_speedup``.
    ``--replicas`` > 1 serves through a fleet whose replicas share the
    one device (``replicas_share_device``); ``--serve_trace`` or
    ``--serve_blackbox`` arm the request-lifecycle tracer."""
    model, _, _, _ = build(args, device)
    with torch.no_grad():
        model.logit.bias[0] += args.probe_eos_bias
    model.eval()
    kw = dict(num_requests=args.serve_requests, rate_hz=args.serve_rate,
              max_len=args.seq_len, beam_size=args.serve_beam,
              decode_chunk=args.decode_chunk,
              bucket_sizes=parse_buckets(args.serve_buckets), queue_limit=0,
              seed=777, stream=bool(args.serve_stream),
              cache_size=args.serve_cache, unique_videos=args.serve_unique,
              zipf_alpha=args.serve_zipf, replicas=args.replicas,
              kill_replica=args.serve_kill_replica,
              arrival_shape=args.arrival_shape,
              arrival_trace=args.arrival_trace,
              lifecycle=bool(args.serve_trace or args.serve_blackbox),
              blackbox_path=args.serve_blackbox)
    shapes = list(DEFAULT_FEAT_SHAPES)
    if args.serve_cache_compare and args.serve_cache:
        # The process's first probe pays one-time costs (allocator,
        # handles) that would land on whichever measured run goes first.
        serving_probe(model, shapes, **{
            **kw, "cache_size": 0, "num_requests": 8,
            "rate_hz": min(args.serve_rate, 100.0), "blackbox_path": None})
        twin = serving_probe(model, shapes, **{**kw, "cache_size": 0,
                                               "blackbox_path": None})
        out = serving_probe(model, shapes, **kw)
        out["cache_off_captions_per_sec"] = twin["captions_per_sec"]
        out["cache_off_latency_p50_ms"] = twin["latency_p50_ms"]
        if twin["captions_per_sec"] > 0:
            out["cache_speedup"] = round(
                out["captions_per_sec"] / twin["captions_per_sec"], 3)
    else:
        out = serving_probe(model, shapes, **kw)
    out["eos_bias"] = args.probe_eos_bias
    if args.replicas > 1:
        out["replicas_share_device"] = True
    return out


def bench_data(args) -> dict:
    """Loader-only feed probe (``data/bench.py``).  With
    ``--loader_workers`` > 1 and ``--data_compare 1`` the one-worker twin
    runs at the same seed in the same run, after an unmeasured rehearsal,
    and the record carries the speed-up."""
    from .data.bench import feed_probe

    kw = dict(batch_size=args.batch_size, seq_per_img=args.seq_per_img,
              seq_len=args.seq_len, vocab=args.vocab,
              num_videos=args.data_videos, workers=args.loader_workers,
              read_ms=args.data_read_ms, consumer_ms=args.data_consumer_ms,
              batches=args.data_batches, seed=777,
              # Every worker can hold a ticket, with slack for emission
              # order; the occupancy gauge reports what is used.
              prefetch_size=max(4, args.loader_workers + 2))
    if args.data_compare and args.loader_workers > 1:
        feed_probe(**{**kw, "workers": 1, "batches": 4})    # rehearsal
        twin = feed_probe(**{**kw, "workers": 1})
        out = feed_probe(**kw)
        out["single_worker_captions_per_sec"] = twin["captions_per_sec"]
        out["single_worker_batches_per_sec"] = twin["batches_per_sec"]
        out["single_worker_data_wait_share"] = twin["data_wait_share"]
        out["workers_speedup"] = round(
            out["captions_per_sec"] / twin["captions_per_sec"], 3)
        return out
    feed_probe(**{**kw, "batches": 4})                      # rehearsal
    return feed_probe(**kw)


def resolved_config(args) -> dict:
    """The settings that change what a run measures.  ``steps`` is one:
    CST trains as it is timed, and its rollouts shorten with the steps
    taken."""
    config = {k: getattr(args, k) for k in
              ("batch_size", "seq_per_img", "seq_len", "vocab", "hidden",
               "steps",
               "bfloat16", "native_cider", "overlap_depth",
               "device_rewards", "decode_chunk", "decode_kernel")}
    if args.stage == "serving":
        config.update({k: getattr(args, k) for k in
                       ("serve_requests", "serve_rate", "serve_buckets",
                        "serve_beam", "serve_zipf", "serve_unique",
                        "arrival_shape", "serve_stream", "serve_cache",
                        "serve_cache_compare", "replicas",
                        "serve_kill_replica")})
        # A traced record and an untraced one are different protocols.
        config["serve_trace"] = int(bool(args.serve_trace
                                         or args.serve_blackbox))
    if args.stage == "data":
        config.update({k: getattr(args, k) for k in
                       ("loader_workers", "data_read_ms",
                        "data_consumer_ms", "data_batches", "data_videos",
                        "data_compare")})
    return config


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--stage", default="both",
                   choices=("both", "xe", "cst", "serving", "data"),
                   help="both (default): XE and CST, the headline the lower "
                        "of the two; serving: the open-loop serving probe; "
                        "data: the loader-only feed probe")
    p.add_argument("--device", default=None,
                   help="torch device; default cuda (raises without a GPU)")
    p.add_argument("--batch_size", type=positive_int, default=32)
    p.add_argument("--seq_per_img", type=positive_int, default=20)
    p.add_argument("--seq_len", type=positive_int, default=30)
    p.add_argument("--vocab", type=positive_int, default=8000)
    p.add_argument("--hidden", type=positive_int, default=512)
    p.add_argument("--steps", type=positive_int, default=20)
    p.add_argument("--bfloat16", type=int, default=1,
                   help="1 = compute in bfloat16 over float32 parameters "
                        "(the train CLI's --use_bfloat16), both kernels in "
                        "bfloat16 storage")
    p.add_argument("--overlap_depth", type=int, default=2,
                   help="CST host-path pipeline depth (the trainer's "
                        "--overlap_rewards default); the serial loop is "
                        "measured beside it")
    p.add_argument("--device_rewards", type=int, default=1,
                   help="the CST headline: 1 = the fused on-device step "
                        "(the trainer's default), 0 = the host pipeline; "
                        "both are measured either way")
    p.add_argument("--native_cider", type=int, default=1,
                   help="1 = the C++ CIDEr-D scorer on the host path (the "
                        "trainer's default)")
    p.add_argument("--decode_chunk", type=int, default=8,
                   help="early-exit chunk of the rollouts and the serving "
                        "engine; 0 = one full-length loop")
    p.add_argument("--decode_kernel", default="fused",
                   choices=("fused", "reference", "bf16"),
                   help="decode cell of rollouts and serving: the K2 kernel "
                        "(default), the model's cell, or its bfloat16 "
                        "variant")
    p.add_argument("--probe_eos_bias", type=float, default=10.0,
                   help="EOS-logit bias of the rollout probe and the "
                        "serving stage (an untrained model never ends its "
                        "captions); the timed CST steps run without it")
    g = p.add_argument_group("--stage serving")
    g.add_argument("--serve_requests", type=positive_int, default=24)
    g.add_argument("--serve_rate", type=float, default=8.0,
                   help="mean arrival rate, requests/s")
    g.add_argument("--serve_buckets", default="1,4,8")
    g.add_argument("--serve_beam", type=positive_int, default=1,
                   help="beam width of every request (1 = greedy)")
    g.add_argument("--serve_zipf", type=float, default=0.0,
                   help="zipf exponent of the request mix over "
                        "--serve_unique videos (0 = round-robin)")
    g.add_argument("--serve_unique", type=positive_int, default=None,
                   help="distinct videos in the mix (default: one per "
                        "request)")
    g.add_argument("--serve_stream", type=int, default=0,
                   help="1 = every request streams; the record carries "
                        "TTFT and chunk-gap percentiles")
    g.add_argument("--serve_cache", type=int, default=0,
                   help="exact-result cache entries (0: off); repeats in "
                        "the mix (--serve_zipf, --serve_unique) hit it")
    g.add_argument("--serve_cache_compare", type=int, default=0,
                   help="1 = also run the cache-off twin at the same seed "
                        "and report cache_speedup (needs --serve_cache)")
    g.add_argument("--replicas", type=positive_int, default=1,
                   help="> 1: the same load through the fleet router over "
                        "this many engine replicas sharing the device; the "
                        "record's fleet.parity_ok holds every caption "
                        "against a single engine's")
    g.add_argument("--serve_kill_replica", type=int, default=-1,
                   help="with --replicas N: hard-kill this replica once "
                        "half the requests are submitted (-1: none)")
    g.add_argument("--serve_trace", type=int, default=0,
                   help="1 = arm the request-lifecycle tracer: the record "
                        "gains its terminal accounting and the latency "
                        "attribution")
    g.add_argument("--serve_blackbox", default=None,
                   help="write the flight recorder's blackbox.json here at "
                        "the probe's end (implies --serve_trace 1)")
    g.add_argument("--arrival_shape", default="poisson",
                   choices=ARRIVAL_SHAPES)
    g.add_argument("--arrival_trace", default=None,
                   help='JSONL of {"t": seconds} for --arrival_shape '
                        "replay")
    g = p.add_argument_group("--stage data")
    g.add_argument("--loader_workers", type=positive_int, default=1,
                   help="prefetch threads (the train CLI's "
                        "--loader_workers); > 1 also measures one worker "
                        "in the same run (--data_compare)")
    g.add_argument("--data_read_ms", type=float, default=10.0,
                   help="simulated blocking read per batch, ms")
    g.add_argument("--data_consumer_ms", type=float, default=0.0,
                   help="simulated step time of the paced phase, ms; 0 "
                        "skips it")
    g.add_argument("--data_batches", type=positive_int, default=48)
    g.add_argument("--data_videos", type=positive_int, default=64)
    g.add_argument("--data_compare", type=int, default=1)
    g = p.add_argument_group("refused: their parts are not ported")
    for dest, (off, where) in REFUSED.items():
        g.add_argument(f"--{dest}", default=off,
                       type=str if off is None else type(off),
                       help=f"not ported: {where}")
    args = p.parse_args(argv)
    for dest, (off, where) in REFUSED.items():
        if getattr(args, dest) != off:
            p.error(f"--{dest} is not ported yet: {where}")
    return args


def run(args) -> dict:
    """Measure ``args.stage`` -> its JSON record."""
    device = default_device(args.device)
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        count = torch.cuda.device_count()
    else:
        name, count = str(device), 0
    common = {"unit": "captions/s/chip", "platform": device.type,
              "device": name, "num_devices": count, "tuned": False,
              "tuning_record": None, "config": resolved_config(args)}
    ncaps = args.batch_size * args.seq_per_img
    flops = analytic_step_flops(args)

    def stage(fn, *a):
        reset_launch_counts()
        out = fn(*a)
        return out, launch_counts()

    if args.stage == "data":
        data, launches = stage(bench_data, args)
        return {"metric": HEADLINE_METRIC["data"],
                "value": data["captions_per_sec"], "vs_baseline": None,
                **common, "unit": "captions/s",
                **{k: v for k, v in data.items() if k != "captions_per_sec"},
                "launches": launches}
    if args.stage == "serving":
        serve, launches = stage(bench_serving, args, device)
        return {"metric": HEADLINE_METRIC["serving"],
                "value": serve["captions_per_sec"], "vs_baseline": None,
                **common,
                **{k: v for k, v in serve.items()
                   if k != "captions_per_sec"},
                "launches": launches}
    if args.stage == "xe":
        xe, launches = stage(bench_xe, args, device)
        return {"metric": HEADLINE_METRIC["xe"], "value": round(xe, 1),
                "vs_baseline": round(xe / BASELINE_CAPTIONS_PER_SEC, 3),
                **common, **mfu_fields(flops["xe"], xe, ncaps, name),
                "launches": launches}
    if args.stage == "cst":
        cst, launches = stage(bench_cst, args, device)
        return {"metric": HEADLINE_METRIC["cst"],
                "value": round(cst["value"], 1),
                "vs_baseline": round(cst["value"]
                                     / BASELINE_CAPTIONS_PER_SEC, 3),
                **common, **{k: v for k, v in cst.items() if k != "value"},
                **mfu_fields(flops["cst"], cst["value"], ncaps, name),
                "launches": launches}
    xe, xe_launches = stage(bench_xe, args, device)
    cst, cst_launches = stage(bench_cst, args, device)
    worst = min(xe, cst["value"])
    return {
        "metric": HEADLINE_METRIC["both"],
        "value": round(worst, 1),
        "vs_baseline": round(worst / BASELINE_CAPTIONS_PER_SEC, 3),
        **common,
        "xe_captions_per_sec": round(xe, 1),
        "cst_captions_per_sec": round(cst["value"], 1),
        "cst_path": cst["path"],
        "cst_host_pipeline_captions_per_sec":
            cst["host_pipeline_captions_per_sec"],
        "cst_serial_captions_per_sec": cst["serial_captions_per_sec"],
        "cst_fused_captions_per_sec": cst["fused_captions_per_sec"],
        **{f"cst_{k}": cst[k] for k in (
            "host_pipeline_rollout_steps", "serial_rollout_steps",
            "fused_rollout_steps")},
        "cst_overlap_depth": cst["overlap_depth"],
        "cst_scorer": cst["scorer"],
        "cst_decode_chunk": cst["decode_chunk"],
        "cst_decode_kernel": cst["decode_kernel"],
        "cst_rollout_probe": cst["rollout_probe"],
        **{f"xe_{k}": v for k, v in
           mfu_fields(flops["xe"], xe, ncaps, name).items()},
        **{f"cst_{k}": v for k, v in
           mfu_fields(flops["cst"], cst["value"], ncaps, name).items()},
        "xe_launches": xe_launches,
        "cst_launches": cst_launches,
    }


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=logging.WARNING, stream=sys.stderr)
    print(json.dumps(run(args)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
