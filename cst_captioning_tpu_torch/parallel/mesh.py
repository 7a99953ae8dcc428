"""The device mesh as process groups (counterpart of the reference's
``parallel/mesh.py``).

The reference puts every device of ONE process on a ``(data, model)``
grid and lets XLA's partitioner insert the collectives.  The port runs
one process per device over ``torch.distributed``: rank ``r`` sits at
``(r // mp, r % mp)`` of the same grid (``np.arange(n).reshape(n // mp,
mp)``, the reference's ``np.asarray(devices).reshape(n // mp, mp)``).
Each rank's **data axis** is its grid column (the ranks that hold the
same time block and different batch rows: the gradient all-reduce of
data parallelism runs over it) and its **model axis** is its grid row
(the ranks that hold the same batch rows and different time blocks: the
collectives of context parallelism run over it).

``Axis`` is one axis as this rank sees it, with the collectives the port
uses.  An axis of size 1 inside a larger world has no group and its
collectives return their input; an axis that spans the whole world uses
the default group, at world size 1 too, so a one-rank run with a
process group goes through the backend's one-rank collectives (copies).

The gloo backend runs its collectives on host memory: where gloo carries
a CUDA tensor (two ranks sharing one card, which NCCL refuses), the
collective copies it to the host and back explicitly (``_on_host``).

Which rows of a global batch a rank owns is said in one place,
``host_local_slice``: the contiguous block of whole videos at its data
index (with their ``seq_per_img`` caption rows, which follow the videos
in the same order), so a video's captions stay on one rank and the
per-video baselines stay local.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def mesh_grid(n: int, model_parallel: int = 1) -> np.ndarray:
    """The ``(data, model)`` grid of ``n`` ranks: rank ``r`` at ``(r //
    model_parallel, r % model_parallel)``.  Raises as the reference's
    ``make_mesh`` does when ``model_parallel`` does not divide ``n``."""
    if model_parallel < 1 or n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by model_parallel="
                         f"{model_parallel}")
    return np.arange(n).reshape(n // model_parallel, model_parallel)


def _on_host(tensor: torch.Tensor, backend: Optional[str]) -> bool:
    return backend == "gloo" and tensor.is_cuda


@dataclass
class Axis:
    """One mesh axis as this rank sees it: its process group (None for a
    single-rank axis inside a larger world), this rank's index on it, its
    size, the global ranks along it in axis order and the group's
    backend."""

    name: str
    group: Optional[object]
    index: int
    size: int
    ranks: List[int] = field(default_factory=list)
    backend: Optional[str] = None

    def all_reduce(self, t: torch.Tensor, op=None) -> torch.Tensor:
        """The reduction of ``t`` over the axis, a new tensor (``op``: a
        ``dist.ReduceOp``, SUM by default); ``t`` itself is unchanged."""
        if self.group is None:
            return t
        op = dist.ReduceOp.SUM if op is None else op
        if _on_host(t, self.backend):
            # gloo on a CUDA tensor: an explicit host copy each way.
            host = t.detach().cpu()
            dist.all_reduce(host, op=op, group=self.group)
            return host.to(t.device)
        out = t.detach().clone()
        dist.all_reduce(out, op=op, group=self.group)
        return out

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        return self.all_reduce(t)

    def all_max(self, t: torch.Tensor) -> torch.Tensor:
        return self.all_reduce(t, dist.ReduceOp.MAX)

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t`` (same shape on every rank), in axis order."""
        if self.group is None:
            return [t]
        src = t.detach().contiguous()
        staged = _on_host(src, self.backend)
        if staged:  # gloo on a CUDA tensor: an explicit host copy
            src = src.cpu()
        out = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(out, src, group=self.group)
        return [x.to(t.device) for x in out] if staged else out

    def all_gather_objects(self, obj) -> list:
        """Every rank's picklable ``obj``, in axis order."""
        if self.group is None:
            return [obj]
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out


@dataclass
class Mesh:
    """This rank's place on the ``(data, model)`` grid: ``shape`` (the
    reference's ``mesh.shape``), the rank's coordinates and its two
    axes."""

    world_size: int
    rank: int
    model_parallel: int
    data: Axis
    model: Axis

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data.size, MODEL_AXIS: self.model.size}

    @property
    def coords(self) -> Tuple[int, int]:
        return self.data.index, self.model.index


def _axis(name: str, lines: Sequence[Sequence[int]], rank: int,
          world: int) -> Axis:
    """The axis whose lines (rows or columns of the grid) are ``lines``.
    Every rank calls ``dist.new_group`` for every line, in the same
    order, as ``torch.distributed`` requires."""
    mine = next(list(map(int, line)) for line in lines if rank in line)
    size = len(mine)
    if not dist.is_initialized():
        return Axis(name, None, mine.index(rank), size, mine)
    if size == world:
        group = dist.group.WORLD
    else:
        groups = [dist.new_group(list(map(int, line))) if size > 1
                  else None for line in lines]
        group = groups[[rank in line for line in lines].index(True)]
    backend = None if group is None else dist.get_backend(group)
    return Axis(name, group, mine.index(rank), size, mine, backend)


def make_mesh(model_parallel: int = 1) -> Mesh:
    """The mesh of this process's group (world size 1 without one): the
    grid of ``mesh_grid``, a data axis per column and a model axis per
    row.  Every rank of the group calls it, in the same order."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    grid = mesh_grid(world, model_parallel)
    data = _axis(DATA_AXIS, list(grid.T), rank, world)
    model = _axis(MODEL_AXIS, list(grid), rank, world)
    return Mesh(world, rank, model_parallel, data, model)


def host_local_slice(global_batch: int,
                     process_index: Optional[int] = None,
                     process_count: Optional[int] = None) -> slice:
    """This rank's contiguous rows of a global batch of
    ``global_batch`` rows (the process group's rank and size by
    default).  Raises where the count does not divide the batch."""
    pi = ((dist.get_rank() if dist.is_initialized() else 0)
          if process_index is None else process_index)
    pc = ((dist.get_world_size() if dist.is_initialized() else 1)
          if process_count is None else process_count)
    if global_batch % pc != 0:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{pc} hosts")
    per = global_batch // pc
    return slice(pi * per, (pi + 1) * per)


def shard_batch_arrays(mesh: Mesh, tree):
    """This rank's rows of every tensor or array in ``tree`` (lists,
    tuples and dicts of them): ``host_local_slice`` of each leading axis
    at the rank's data index.  Feature lists, caption rows and per-row
    weights share the video order, so one rule covers the batch."""
    if isinstance(tree, dict):
        return {k: shard_batch_arrays(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_batch_arrays(mesh, v) for v in tree)
    return tree[host_local_slice(tree.shape[0], mesh.data.index,
                                 mesh.data.size)]


class RowDraw:
    """A generator whose draws are this rank's rows of the draw world
    size 1 makes: ``rand(shape)`` draws ``(shape[0] * count, ...)`` on
    the wrapped generator, the same on every rank, and keeps rows
    ``[index * shape[0], (index + 1) * shape[0])``.  A draw that has no
    batch axis (``rows=False``) is the global draw itself."""

    def __init__(self, generator: torch.Generator, index: int, count: int):
        self.generator = generator
        self.index = index
        self.count = count

    def rand(self, shape, device, rows: bool = True) -> torch.Tensor:
        shape = tuple(shape)
        if not rows:
            return torch.rand(shape, generator=self.generator, device=device)
        n = shape[0]
        full = torch.rand((n * self.count,) + shape[1:],
                          generator=self.generator, device=device)
        return full[self.index * n:(self.index + 1) * n]
