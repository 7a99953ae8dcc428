"""Parallelism over ``torch.distributed``, one process per device
(counterpart of the reference's ``parallel/``): the ``(data, model)``
mesh as process groups, global-view data parallelism, the sequence-
parallel attention ops and the context-parallel XE step.
``parallel/dryrun.py`` (not imported here) spawns ranks and runs the
reference's data-parallel pipeline at any rank count.

The reference's ``batch_sharding``, ``replicated_sharding`` and
``data_parallel_jit`` are GSPMD annotations with no counterpart: here a
rank holds its rows (``shard_batch_arrays``) and a step is global-view
through ``DataParallel``.
"""

from .cp import TimeShard, context_parallel_xe_step, time_shard_memory
from .dp import DataParallel, default_backend, distributed_init
from .mesh import (DATA_AXIS, MODEL_AXIS, Axis, Mesh, RowDraw,
                   host_local_slice, make_mesh, mesh_grid,
                   shard_batch_arrays)
from .sequence import (ring_cross_attention, sp_additive_attention,
                       sp_cross_attention, sp_dot_attention,
                       sp_multihead_cross_attention, time_sharding)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Axis",
    "DataParallel",
    "Mesh",
    "RowDraw",
    "TimeShard",
    "context_parallel_xe_step",
    "default_backend",
    "distributed_init",
    "host_local_slice",
    "make_mesh",
    "mesh_grid",
    "ring_cross_attention",
    "shard_batch_arrays",
    "sp_additive_attention",
    "sp_cross_attention",
    "sp_dot_attention",
    "sp_multihead_cross_attention",
    "time_shard_memory",
    "time_sharding",
]
