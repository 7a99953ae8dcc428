"""Spawned ranks and the data-parallel pipeline (counterpart of the
reference's ``parallel/dryrun.py``).

``run_ranks(n, fn, ...)`` starts ``n`` processes (the ``spawn`` start
method), each in a process group over a ``FileStore`` in a temporary
directory (no port needed), builds the mesh, runs ``fn(mesh, *args)``
and returns every rank's result; a rank that raises fails the call with
its traceback.  At one rank ``fn`` runs in this process without a
group.  The backend is ``gloo`` on the CPU and ``nccl`` on CUDA unless
the caller names one (ranks sharing one card run ``gloo``).

``run_dp_pipeline`` is the reference's pipeline at any rank count: XE
steps, a rollout with the host round trip (tokens gathered to the host
and sharded again), a REINFORCE step, the fused CST step on device
tables, and at an even rank count the time-sharded cross-attention; it
returns rank 0's results under the reference's keys.  The reference
retries a pipeline whose scalars its native stack garbled to zero; the
port re-runs nothing (a silent re-run would hide a fault):
``garble_retries`` reads 0.

A rank body given to ``run_ranks`` must be importable by a spawned
process: a module-level function of an importable module.
"""

from __future__ import annotations

import hashlib
import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .dp import DataParallel, default_backend, distributed_init
from .mesh import Mesh, make_mesh, shard_batch_arrays

VOCAB = 50
HIDDEN = 16
SEQ_PER_IMG = 2
MAX_LEN = 8
FEAT_SHAPES = [(4, 12), (1, 6)]
LEARNING_RATE = 1e-3


def _rank_main(rank: int, n: int, init_file: str, backend: str, device: str,
               model_parallel: int, fn: Callable, args: tuple,
               out: "mp.Queue") -> None:
    try:
        distributed_init(None, n, rank, backend=backend, device=device,
                         init_method=f"file://{init_file}")
        try:
            result = fn(make_mesh(model_parallel), *args)
        finally:
            torch.distributed.destroy_process_group()
        out.put((rank, "ok", result))
    except BaseException:
        out.put((rank, "error", traceback.format_exc()))


#: How long ``run_ranks`` waits for every rank's result.
RANKS_TIMEOUT_S = 600.0


def run_ranks(n_ranks: int, fn: Callable, *args, model_parallel: int = 1,
              device: str = "cpu", backend: Optional[str] = None
              ) -> List[Any]:
    """``fn(mesh, *args)`` on ``n_ranks`` ranks -> the results, in rank
    order.  ``fn`` and ``args`` must pickle; results too (numpy, not
    tensors).  A rank that raises or dies fails the call; so does a rank
    with no result after ``RANKS_TIMEOUT_S``."""
    if n_ranks == 1 and model_parallel == 1:
        return [fn(make_mesh(1), *args)]
    backend = backend or default_backend(device)
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="cst_ranks_")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n_ranks, os.path.join(tmp, "store"),
                               backend, device, model_parallel, fn, args,
                               out))
             for r in range(n_ranks)]
    results: Dict[int, Any] = {}
    deadline = time.monotonic() + RANKS_TIMEOUT_S
    try:
        for p in procs:
            p.start()
        while len(results) < n_ranks:
            try:
                rank, status, value = out.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode not in (None, 0)]
                if dead:        # died before it could report
                    raise RuntimeError(
                        f"rank(s) {dead} of {n_ranks} exited with "
                        f"{[procs[r].exitcode for r in dead]} and no "
                        "result") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{n_ranks - len(results)} of {n_ranks} ranks gave "
                        f"no result in {RANKS_TIMEOUT_S:.0f} s") from None
                continue
            if status != "ok":
                raise RuntimeError(f"rank {rank} of {n_ranks} failed:\n"
                                   f"{value}")
            results[rank] = value
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)
    return [results[r] for r in range(n_ranks)]


def digest(arrays: Sequence[np.ndarray]) -> str:
    """A digest of the bits of ``arrays`` (ranks compare states with
    it)."""
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def gather_rows(mesh: Mesh, local: torch.Tensor) -> np.ndarray:
    """The global batch of ``local`` rows, gathered over the data axis."""
    return torch.cat(mesh.data.all_gather(local.contiguous()),
                     dim=0).cpu().numpy()


def pipeline_model(cfg: dict, device: str, decode_kernel: str,
                   kernel_attention: bool, drop_prob: float,
                   params: Optional[Dict[str, np.ndarray]]):
    """The pipeline's attention-LSTM at the widths of ``cfg`` on
    ``device``: initialised from seed 0, or from ``params`` (a state dict
    of numpy arrays)."""
    from ..models.captioner import CaptionModel
    from ..weights import init_like_flax_

    model = CaptionModel(
        cfg["vocab"], [d for _, d in cfg["feat_shapes"]],
        embed_size=cfg["hidden"], hidden_size=cfg["hidden"],
        attn_size=cfg["hidden"], num_layers=1, use_attention=True,
        use_kernel_attention=kernel_attention, decode_kernel=decode_kernel,
        drop_prob=drop_prob)
    if params is None:
        init_like_flax_(model, torch.Generator().manual_seed(0))
    else:
        model.load_state_dict({k: torch.as_tensor(v)
                               for k, v in params.items()})
    return model.to(device)


def ragged_labels(rng: np.random.Generator, rows: int, max_len: int,
                  vocab: int) -> np.ndarray:
    """Caption rows whose lengths grow down the batch (row ``i`` ends
    after ``1 + i * (max_len - 1) // (rows - 1)`` words), so the ranks'
    mask totals differ."""
    labels = rng.integers(1, vocab, (rows, max_len)).astype(np.int32)
    for i in range(rows):
        labels[i, 1 + i * (max_len - 1) // max(rows - 1, 1):] = 0
    return labels


def pipeline_rank(mesh: Mesh, batch_size: int, xe_steps: int,
                  decode_kernel: str, kernel_attention: bool, device: str,
                  cfg: dict, drop_prob: float,
                  params: Optional[Dict[str, np.ndarray]],
                  noise: Optional[Callable], ragged: bool,
                  decode_chunk: int, optim: str, grads: bool) -> dict:
    """One rank of ``run_dp_pipeline`` (its docstring)."""
    from ..ops import launch_counts, reset_launch_counts
    from ..ops.sampling import gumbel_noise
    from ..training.device_rewards import build_device_tables
    from ..training.state import Optimizer
    from ..training.steps import fused_cst_step, rl_grad_step, rollout
    from ..training.steps import xe_step
    from .sequence import sp_cross_attention

    B, S, L, V = batch_size, cfg["seq_per_img"], cfg["max_len"], cfg["vocab"]
    dev = torch.device(device)
    dp = DataParallel(mesh)
    model = pipeline_model(cfg, device, decode_kernel, kernel_attention,
                           drop_prob, params)
    opt = Optimizer(model.parameters(), optim, learning_rate=LEARNING_RATE,
                    grad_clip=5.0)
    reduced: List[Dict[str, np.ndarray]] = []
    if grads and mesh.rank == 0:
        step = opt.step
        names = [name for name, _ in model.named_parameters()]

        def recording_step(*args, **kwargs):
            """Keep each update's reduced gradients (zeros where a
            parameter has none, as the optimizer takes them)."""
            reduced.append({
                name: (np.zeros(tuple(p.shape), np.float32) if p.grad is None
                       else p.grad.detach().float().cpu().numpy())
                for name, p in zip(names, opt.params)})
            return step(*args, **kwargs)

        opt.step = recording_step
    rng = np.random.default_rng(0)
    feats = [rng.standard_normal((B,) + tuple(s)).astype(np.float32)
             for s in cfg["feat_shapes"]]
    labels = (ragged_labels(rng, B * S, L, V) if ragged
              else rng.integers(1, V, (B * S, L)).astype(np.int32))
    weights = np.ones(B * S, np.float32)
    advantage = rng.standard_normal(B * S).astype(np.float32)

    def local(x):
        return torch.from_numpy(shard_batch_arrays(mesh, x)).to(dev)

    lfeats = [local(f) for f in feats]
    step_ms: Dict[str, List[float]] = {}

    def timed(name: str, fn: Callable):
        """``fn()``, its milliseconds on the host clock to a synchronised
        device under ``step_ms[name]``."""
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        step_ms.setdefault(name, []).append(
            (time.perf_counter() - t0) * 1e3)
        return out

    def fresh_noise():
        if noise is not None:
            return noise()
        return gumbel_noise(torch.Generator(dev).manual_seed(1))

    # -- XE steps --------------------------------------------------------
    reset_launch_counts()
    gen = torch.Generator(dev).manual_seed(1)
    xe_losses = []
    for _ in range(xe_steps):
        m = timed("xe", lambda: xe_step(model, opt, lfeats,
                                        local(labels).long(),
                                        local(weights), S, gen, dp=dp))
        xe_losses.append(m["loss"])

    # -- CST: rollout -> the host -> the REINFORCE step --------------------
    sampled, greedy, rollout_steps = timed("rollout", lambda: rollout(
        model, lfeats, L, S, fresh_noise(), greedy_baseline=True,
        decode_chunk=decode_chunk, dp=dp))
    sampled_host = gather_rows(mesh, sampled)
    greedy_host = gather_rows(mesh, greedy)
    rl = timed("rl", lambda: rl_grad_step(model, opt, lfeats,
                                          local(sampled_host),
                                          local(advantage), S, dp=dp))

    # -- the fused step on device tables ---------------------------------
    refs = {f"v{i}": [f"w{1 + (i + j) % (V - 1)} w{1 + (i * j) % (V - 1)}"
                      for j in range(3)] for i in range(B)}
    corpus, tables, _ = build_device_tables(
        refs, {f"w{k}": k for k in range(1, V)}, device=dev)
    fused = timed("fused", lambda: fused_cst_step(
        model, opt, lfeats, local(np.arange(B, dtype=np.int64)),
        fresh_noise(), corpus, tables, L, S, decode_chunk=decode_chunk,
        dp=dp))
    launches = {}
    for counts in mesh.data.all_gather_objects(launch_counts()):
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n

    # -- time-sharded cross-attention, at an even rank count -------------
    sp_ctx_sum = None
    if mesh.world_size % 2 == 0:
        sp_mesh = make_mesh(model_parallel=2)
        bq = sp_mesh.shape["data"] * 2
        kv = torch.from_numpy(rng.standard_normal(
            (bq, 64, cfg["hidden"])).astype(np.float32)).to(dev)
        qq = torch.from_numpy(rng.standard_normal(
            (bq, 4, cfg["hidden"])).astype(np.float32)).to(dev)
        sp_ctx_sum = float(sp_cross_attention(qq, kv, kv, sp_mesh).sum())

    params_np = {k: v.detach().cpu().numpy()
                 for k, v in model.state_dict().items()}
    opt_np = [v.cpu().numpy() for st in opt.state for v in st.values()]
    mine = digest(list(params_np.values()) + opt_np)
    return {
        "mesh_shape": dict(mesh.shape),
        "xe_losses": [float(x) for x in xe_losses],
        "sampled": sampled_host, "greedy": greedy_host,
        "rl_loss": float(rl["loss"]),
        "fused_loss": float(fused["loss"]),
        "fused_reward": float(fused["reward"]),
        "rollout_steps": float(rollout_steps),
        "fused_rollout_steps": float(fused["rollout_steps"]),
        "sp_ctx_sum": sp_ctx_sum,
        "garble_retries": 0,
        "params": params_np,
        # rank 0's reduced gradients of every update, where asked for
        "grads": reduced if grads and mesh.rank == 0 else None,
        # milliseconds of each step on rank 0; kernel launches of the XE,
        # rollout, RL and fused steps summed over the data ranks
        "step_ms": step_ms, "launches": launches,
        # every rank ends with the same parameters and optimizer state
        "ranks_agree": len(set(mesh.data.all_gather_objects(mine))) == 1,
    }


def run_dp_pipeline(n_ranks: int, batch_size: Optional[int] = None,
                    xe_steps: int = 1, decode_kernel: str = "reference",
                    device: str = "cpu", backend: Optional[str] = None,
                    kernel_attention: bool = False,
                    config: Optional[dict] = None, drop_prob: float = 0.5,
                    params: Optional[Dict[str, np.ndarray]] = None,
                    noise: Optional[Callable] = None, ragged: bool = False,
                    decode_chunk: int = 0, optim: str = "adam",
                    grads: bool = False) -> dict:
    """XE steps, a rollout with the host round trip, a REINFORCE step
    and the fused CST step, data-parallel over ``n_ranks`` spawned ranks
    (the reference's ``run_dp_pipeline``) -> rank 0's results: the XE
    losses, the sampled and greedy tokens of the global batch, the RL and
    fused losses, the fused reward, the SP context sum (even rank counts),
    the final parameters and ``ranks_agree`` (every rank's parameters and
    optimizer state have the same bits).

    ``batch_size`` (videos) defaults to ``2 * n_ranks``; compare rank
    counts at one batch size that each divides.  ``config`` overrides the
    widths (``vocab``, ``hidden``, ``seq_per_img``, ``max_len``,
    ``feat_shapes``); ``decode_kernel="fused"`` rolls out on K2 and
    ``kernel_attention`` teacher-forces on K1; ``optim`` is the
    optimizer (at ``LEARNING_RATE``); with ``grads`` rank 0 returns the
    gradients each update took, summed over the ranks, under ``grads``
    (a dict of numpy arrays per update).  Test hooks: ``params``
    (a state dict of numpy arrays) replaces the seeded initialisation,
    ``noise()`` (one rank only) gives each rollout's noise source,
    ``drop_prob`` the dropout rate, ``ragged`` caption lengths that differ
    across the ranks, ``decode_chunk`` the rollout's early-exit chunk."""
    cfg = {"vocab": VOCAB, "hidden": HIDDEN, "seq_per_img": SEQ_PER_IMG,
           "max_len": MAX_LEN, "feat_shapes": FEAT_SHAPES, **(config or {})}
    if noise is not None and n_ranks != 1:
        raise ValueError("a noise hook runs in one process only")
    b = batch_size if batch_size is not None else 2 * n_ranks
    return run_ranks(n_ranks, pipeline_rank, b, xe_steps, decode_kernel,
                     kernel_attention, device, cfg, drop_prob, params,
                     noise, ragged, decode_chunk, optim, grads,
                     device=device, backend=backend)[0]
