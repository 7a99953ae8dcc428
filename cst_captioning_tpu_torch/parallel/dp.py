"""Data parallelism over ``torch.distributed`` (counterpart of the
reference's ``parallel/dp.py``).

The reference jits a step with the state replicated and the batch
sharded, and XLA's partitioner makes the result global-view: the same
losses, tokens and parameters on 1 or N devices.  The port runs one
process per device and makes each of those places explicit
(``DataParallel``, which the step functions of ``training/steps.py``
take as ``dp``):

- **loss denominators.**  A rank's loss is its own masked sum over the
  ALL-REDUCED mask total (``sum``), and the gradients are summed over
  the ranks (``reduce_grads``): the mean of the ranks' local means is a
  different loss whenever their captions' lengths differ;
- **random draws.**  Every rank draws the global shape of a dropout mask
  or of the rollout's Gumbel noise and keeps its own rows (``draw``,
  ``noise_rows``), so rank ``r`` draws exactly its rows of the draw of
  world size 1;
- **metrics and decisions.**  Metric means are all-reduced sums over
  all-reduced counts (``mean``, and ``host_means`` for the host reward's
  stats); the rollout's chunked early exit stops
  when every rank's rows have finished (``all_true``), so every rank's
  noise generator advances as far as world size 1's; the divergence
  guard sees the global loss and the reduced gradients' norm, so every
  rank takes the same decision.

With context parallelism (``parallel/cp.py``) the model axis holds one
batch's time blocks: each model rank computes the same (replicated)
loss, so its backward is scaled by ``1 / mp`` (``backward``) and the
gradients are summed over the model axis, then over the data axis.

``distributed_init`` starts the process group: ``nccl`` for a CUDA
device (one process per GPU) and ``gloo`` for the CPU, unless the caller
names the backend (two ranks sharing one card run gloo, which carries
their CUDA tensors through host copies: NCCL refuses two ranks on one
device).  A group that fails to start raises; nothing switches to
another backend.
"""

from __future__ import annotations

import datetime
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, RowDraw, make_mesh


#: How long a collective, and the group's start, may wait for a peer.
GROUP_TIMEOUT = datetime.timedelta(minutes=10)


def default_backend(device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` otherwise."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     device="cuda", init_method: Optional[str] = None
                     ) -> bool:
    """Start this process's group -> whether one was started.

    A no-op (False) for one process without an address: no
    ``num_processes`` (or 0), or 1 and no ``coordinator_address``, as the
    reference's single-host run.  Otherwise ``init_process_group`` over
    ``tcp://<coordinator_address>`` (``init_method`` instead, e.g. a
    ``file://`` store) with ``num_processes`` ranks, this one
    ``process_id``; ``backend`` defaults to ``default_backend(device)``.
    With nccl each process binds GPU ``process_id % device_count``.
    """
    if not num_processes or (num_processes == 1 and not coordinator_address
                             and not init_method):
        return False
    if process_id is None or not 0 <= process_id < num_processes:
        raise ValueError(f"--process_id {process_id} must be in [0, "
                         f"{num_processes})")
    if init_method is None:
        if not coordinator_address:
            raise ValueError(f"{num_processes} processes need "
                             "--coordinator_address host:port")
        init_method = f"tcp://{coordinator_address}"
    backend = backend or default_backend(device)
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=init_method, world_size=int(num_processes),
        rank=int(process_id), timeout=GROUP_TIMEOUT)
    return True


class DataParallel:
    """A rank's share of a global-view step over ``mesh`` (this process
    group's ``make_mesh()`` by default): see the module doc."""

    def __init__(self, mesh: Optional[Mesh] = None):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.data = self.mesh.data
        self.model = self.mesh.model
        #: A gloo group of the world for host flags (``any``): over NCCL
        #: a flag would travel through the card and wait for its queue.
        self._host_group = None
        if (dist.is_initialized() and dist.get_world_size() > 1
                and dist.get_backend() != "gloo"):
            self._host_group = dist.new_group(backend="gloo")

    @property
    def index(self) -> int:
        """This rank's index on the data axis."""
        return self.data.index

    @property
    def count(self) -> int:
        """Data-parallel ranks."""
        return self.data.size

    # -- losses and gradients ------------------------------------------------

    def backward(self, loss: torch.Tensor) -> None:
        """This rank's part of the global loss's backward: the loss as
        is, or over ``mp`` where the model axis replicates it."""
        if self.model.size > 1:
            loss = loss / self.model.size
        loss.backward()

    @torch.no_grad()
    def reduce_grads(self, params: Sequence[torch.Tensor]) -> None:
        """Sum every gradient over the model axis, then over the data
        axis, in one flat buffer per axis."""
        grads = [p.grad for p in params if p.grad is not None]
        if not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        for axis in (self.model, self.data):
            flat = axis.all_sum(flat)
        at = 0
        for g in grads:
            g.copy_(flat[at:at + g.numel()].view_as(g))
            at += g.numel()

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the data axis: a loss denominator over the
        global batch, or a global metric made of the ranks' shares."""
        return self.data.all_sum(t.detach())

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The global mean of per-row values ``x``: all-reduced sum over
        all-reduced count (``x.mean()`` on a single rank without a
        group)."""
        if self.data.group is None:
            return x.float().mean()
        both = self.data.all_sum(torch.stack(
            [x.float().sum(), torch.tensor(float(x.numel()),
                                           device=x.device)]))
        return both[0] / both[1]

    def host_means(self, rows: Dict[str, np.ndarray]) -> Dict[str, float]:
        """The global mean of each entry's per-row host values (the host
        reward's stats): float64 sums and counts all-reduced over the
        data axis, on the card where the axis runs NCCL."""
        names = sorted(rows)
        both = torch.tensor(
            [float(np.sum(rows[k], dtype=np.float64)) for k in names]
            + [float(np.size(rows[k])) for k in names], dtype=torch.float64,
            device=("cuda" if self.data.backend == "nccl" else "cpu"))
        both = self.data.all_sum(both).cpu().numpy()
        n = len(names)
        return {k: float(both[i] / both[n + i]) for i, k in enumerate(names)}

    def max(self, t: torch.Tensor) -> torch.Tensor:
        return self.data.all_max(t)

    def all_true(self, flag: torch.Tensor) -> bool:
        """Whether ``flag`` (a 0-d bool) holds on every data rank."""
        if self.data.group is None:
            return bool(flag)
        return bool(self.data.all_reduce(flag.to(torch.int32).reshape(1),
                                         dist.ReduceOp.MIN)[0])

    def any(self, flag: bool) -> bool:
        """Whether a host flag holds on any rank of the world (a
        decision every rank must take together: preemption), over gloo
        on the host, with no wait for the card."""
        if not dist.is_initialized():
            return bool(flag)
        t = torch.tensor([int(bool(flag))], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._host_group)
        return bool(t[0])

    # -- random draws ----------------------------------------------------------

    def draw(self, generator: torch.Generator):
        """The dropout generator of this rank: its rows of world size 1's
        draws (the generator itself on a single data rank)."""
        if self.count == 1:
            return generator
        return RowDraw(generator, self.index, self.count)

    def noise_rows(self, noise: Callable, blocks: Sequence[int]) -> Callable:
        """The rollout noise of this rank: ``blocks`` are the local row
        counts of the rollout's row blocks (the samples, then the greedy
        rows); each step draws the global ``(sum(blocks) * count, V)``
        and keeps this rank's rows of every block."""
        if self.count == 1:
            return noise
        rows: List[torch.Tensor] = []
        offset = 0
        for n in blocks:
            rows.append(offset + self.index * n + torch.arange(n))
            offset += n * self.count
        index = torch.cat(rows)
        n_global = offset

        def draw(t: int, shape) -> torch.Tensor:
            full = noise(t, (n_global,) + tuple(shape[1:]))
            return full[index.to(full.device)]

        return draw
