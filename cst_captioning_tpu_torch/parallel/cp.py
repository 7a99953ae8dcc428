"""Context parallelism: the XE step with the long modality time-sharded
(counterpart of the reference's ``parallel/cp.py``).

The reference jits the step with the long feature stream sharded
``(batch -> data, time -> model)`` and the encoder memory constrained
time-sharded (``time_shard_memory`` as the model's
``encode_constraint``); XLA's partitioner inserts the cross-attention,
pooling and gradient collectives.  The port does each by hand, for the
model the reference tests CP on, the transformer decoder over the
temporal memory:

- **the memory.**  The concatenated memory (sum of the modalities' T)
  splits into ``mp`` equal blocks over the model axis.  A rank reads the
  features of its block only: its time range of each time-sharded
  modality (``TimeShard.local_feats``), and the short, replicated
  modalities whole;
- **the encoder** (``models/encoder.py``) projects the local features;
  a time-sharded modality's mean is the all-reduced sum of the ranks'
  block sums over its T, a replicated one's is computed on every rank;
- **the cross-attention** (``models/decoder_transformer.py``) runs
  ``sp_multihead_cross_attention`` over the model axis: the decoder's
  queries are replicated, the keys and values are the rank's block;
- **the gradients.**  Every model rank computes the same loss; its
  backward is scaled by ``1 / mp``, the forward all-reduces have a
  backward that all-reduces the gradient (``sequence.AllSum``), and each
  parameter's gradient is summed over the model axis, then over the data
  axis by the data-parallel rule (``dp.DataParallel``).

Divisibility, the reference's rule: each time-sharded modality's T and
the concatenated memory's T must be multiples of the model axis; an
indivisible T raises.  Dropout is not applied under context parallelism
(a training step with ``drop_prob`` > 0 raises): the reference draws
its masks over the global memory, which no rank holds here.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from .dp import DataParallel
from .mesh import Axis, Mesh, host_local_slice


class TimeShard:
    """A model's context-parallel layout: the model ``axis``, the global
    ``feat_times`` of the modalities and which of them are
    ``sharded``; ``ranges[m]`` is this rank's time range of modality
    ``m`` in the memory's block."""

    def __init__(self, axis: Axis, feat_times: Sequence[int],
                 sharded: Sequence[bool]):
        if len(feat_times) != len(sharded):
            raise ValueError(f"{len(feat_times)} modalities, "
                             f"{len(sharded)} sharding flags")
        mp = axis.size
        total = sum(int(t) for t in feat_times)
        bad = [(m, t) for m, (t, s) in enumerate(zip(feat_times, sharded))
               if s and t % mp]
        if bad or total % mp:
            raise ValueError(
                f"context parallelism over {mp} ranks needs every "
                f"time-sharded modality's T and the memory's T ({total}) to "
                f"be multiples of {mp}; indivisible: "
                f"{bad or [('memory', total)]}: pad the stream")
        self.axis = axis
        self.feat_times = tuple(int(t) for t in feat_times)
        self.sharded = tuple(bool(s) for s in sharded)
        per = total // mp
        lo, hi = axis.index * per, (axis.index + 1) * per
        self.ranges: List[Tuple[int, int]] = []
        offset = 0
        for t in self.feat_times:
            self.ranges.append((min(max(lo - offset, 0), t),
                                min(max(hi - offset, 0), t)))
            offset += t

    def local_feats(self, feats: Sequence[torch.Tensor]
                    ) -> List[torch.Tensor]:
        """This rank's inputs of global-time features: its time range of
        every time-sharded modality, the others whole."""
        return [x[:, a:b] if s else x
                for x, s, (a, b) in zip(feats, self.sharded, self.ranges)]


def time_shard_memory(mesh: Mesh, feat_times: Sequence[int],
                      feats_time_sharded: Sequence[bool]) -> TimeShard:
    """The model's context-parallel layout over ``mesh``'s model axis
    (``CaptionModel.shard_time`` takes it)."""
    return TimeShard(mesh.model, feat_times, feats_time_sharded)


def context_parallel_xe_step(model, opt, feats: Sequence[torch.Tensor],
                             labels: torch.Tensor, weights: torch.Tensor,
                             seq_per_img: int, generator: torch.Generator,
                             dp: DataParallel, guard: bool = False):
    """The XE step of a time-sharded model (``model.shard_time`` done)
    on GLOBAL tensors: this rank's rows (data axis) and time ranges
    (model axis) are taken here, then ``training.steps.xe_step`` runs
    with ``dp``.  Returns its metrics, the same on every rank."""
    from ..training.steps import xe_step

    if getattr(model, "time_shard", None) is None:
        raise ValueError("context_parallel_xe_step needs a time-sharded "
                         "model (CaptionModel.shard_time)")
    rows = host_local_slice(feats[0].shape[0], dp.index, dp.count)
    caps = slice(rows.start * seq_per_img, rows.stop * seq_per_img)
    local = model.time_shard.local_feats([f[rows] for f in feats])
    return xe_step(model, opt, local, labels[caps], weights[caps],
                   seq_per_img, generator, guard=guard, dp=dp)
