"""The system under test: the port's ``Trainer``, built from the train
CLI's own parser with the cell's options and handed the benchmark's split
in memory (``Trainer(opt, splits=...)``), so each step goes through the
prefetcher, the model, the kernels and the optimizer as
``python -m cst_captioning_tpu_torch.train`` runs them.

What the benchmark takes from the program besides the system: the
parameter and optimizer tensors (to judge them); the batches the loader
drew, the dropout masks and Gumbel noise the program drew and the tokens
the rollout produced (observed at the call, for the comparison); the
step's metrics and phase marks; and the kernel entry points
(``ops.attention.fused_additive_attention``,
``ops.decode_cell_kernel.fused_decode_cell``), around which the traced
segment puts profiler ranges.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, List, Optional

import numpy as np
import torch

from .inputs import SplitArrays
from .spec import option_argv


def trainer_argv(config: dict, traffic: dict, seed: int, device: str,
                 out_dir: str, step_timing: bool) -> List[str]:
    opts = {**config["options"], **traffic["options"],
            "max_length": config["max_length"],
            "seq_per_img": config["captions_per_video"],
            "seed": seed, "device": device, "checkpoint_path": out_dir}
    if step_timing:
        opts["step_timing"] = 1
    return option_argv(opts)


def port_split(arrays: SplitArrays):
    """The benchmark's split as the port's in-memory ``Split``."""
    from cst_captioning_tpu_torch.data.synthetic import Split
    from cst_captioning_tpu_torch.data.vocab import Vocab

    n, c, length = arrays.labels.shape
    ids = [f"video{i}" for i in range(n)]
    words = np.asarray(arrays.words, dtype=object)
    refs = {vid: [" ".join(words[row[row > 0]]) for row in arrays.labels[i]]
            for i, vid in enumerate(ids)}
    return Split(
        video_ids=ids, labels=arrays.labels.reshape(n * c, length),
        label_start=np.arange(n, dtype=np.int64) * c,
        label_end=np.arange(1, n + 1, dtype=np.int64) * c,
        feats=arrays.feats,
        vocab=Vocab({i: w for i, w in enumerate(arrays.words) if i}),
        refs=refs)


def build(argv: List[str], arrays: SplitArrays,
          device_tables: Optional[dict] = None):
    """-> the ``Trainer`` of the train CLI's options ``argv`` over the
    benchmark's split (train and validation alike: the run never
    validates); ``device_tables`` is the trainer's cache of reward
    tables."""
    from cst_captioning_tpu_torch import train
    from cst_captioning_tpu_torch.training.trainer import Trainer

    opt = train.parse_args(argv)
    split = port_split(arrays)
    return Trainer(opt, splits=(split, split),
                   device_tables=device_tables), opt


@torch.no_grad()
def load_weights(trainer, weights: Dict[str, torch.Tensor]) -> None:
    """Put the benchmark's weights into the program's parameters, name by
    name; a name on one side only is an error."""
    params = dict(trainer.model.named_parameters())
    if set(params) != set(weights):
        raise ValueError(
            f"parameters differ: program only {sorted(set(params) - set(weights))}, "
            f"benchmark only {sorted(set(weights) - set(params))}")
    for name, p in params.items():
        p.copy_(weights[name])


def named_state(trainer, key: str) -> Dict[str, torch.Tensor]:
    """Host copies of the optimizer's ``key`` state, by parameter name."""
    names = [n for n, _ in trainer.model.named_parameters()]
    return {n: st[key].detach().to("cpu", torch.float32, copy=True)
            for n, st in zip(names, trainer.optimizer.state)}


def named_params(trainer) -> Dict[str, torch.Tensor]:
    return {n: p.detach().to("cpu", torch.float32, copy=True)
            for n, p in trainer.model.named_parameters()}


class Observer:
    """Records, while armed, each batch the trainer draws, the dropout
    masks the model draws for it (in draw order), and each rollout's
    (sampled, greedy) tokens with the noise of its sampled rows: the
    program's own draws, which the reference cannot make again.  It wraps
    the trainer's ``next_batch``, the models' mask draw
    (``models.encoder.dropout_keep``, which ``models.captioner`` binds
    by name too) and the fused step's ``rollout`` with its noise
    source; ``close`` restores them."""

    def __init__(self, trainer):
        from cst_captioning_tpu_torch.models import captioner, encoder
        from cst_captioning_tpu_torch.training import steps

        self.batches: List = []
        #: per batch, the masks drawn for it, on the host
        self.masks: List[List[torch.Tensor]] = []
        self.rollouts: List = []
        #: per rollout, per decode step, the sampled rows' noise (N, V)
        self.noise: List[List[torch.Tensor]] = []
        self._trainer = trainer
        self._restore = [(m, name, getattr(m, name)) for m, name in (
            (steps, "rollout"), (encoder, "dropout_keep"),
            (captioner, "dropout_keep"))]
        draw, rollout = trainer.next_batch, steps.rollout

        def next_batch():
            batch = draw()
            self.batches.append(batch)
            self.masks.append([])
            return batch

        def masked(keep):
            @functools.wraps(keep)
            def dropout_keep(*args, **kwargs):
                mask = keep(*args, **kwargs)
                if self.masks:
                    self.masks[-1].append(mask.to("cpu", copy=True))
                return mask
            return dropout_keep

        @functools.wraps(rollout)
        def observed(model, feats, max_len, seq_per_img, noise, *args,
                     **kwargs):
            rows = feats[0].shape[0] * seq_per_img
            drawn: List[torch.Tensor] = []

            def recorded(t, shape):
                g = noise(t, shape)
                drawn.append(g[:rows].to("cpu", torch.float32, copy=True))
                return g

            out = rollout(model, feats, max_len, seq_per_img, recorded,
                          *args, **kwargs)
            self.rollouts.append((out[0].clone(),
                                  None if out[1] is None else out[1].clone()))
            self.noise.append(drawn)
            return out

        trainer.next_batch = next_batch
        steps.rollout = observed
        encoder.dropout_keep = masked(encoder.dropout_keep)
        captioner.dropout_keep = masked(captioner.dropout_keep)

    def close(self) -> None:
        for module, name, fn in self._restore:
            setattr(module, name, fn)
        del self._trainer.next_batch


@contextlib.contextmanager
def kernel_ranges(calls: Dict[str, list]):
    """Profiler ranges ``bench.k1`` and ``bench.k2`` around every call of
    the port's K1 and K2 entry points, and the shapes of each call in
    ``calls["k1"]``/``calls["k2"]``: (B, T, A, H, storage bytes) and
    (B, T, E, A, H, storage bytes)."""
    from cst_captioning_tpu_torch.ops import attention, decode_cell_kernel

    k1 = attention.fused_additive_attention
    k2 = decode_cell_kernel.fused_decode_cell

    def wrap(fn, name, shapes):
        @functools.wraps(fn)
        def call(*args):
            calls[name].append(shapes(*args))
            with torch.profiler.record_function(f"bench.{name}"):
                return fn(*args)

        return call

    def k1_shapes(q, proj_mem, memory, score_v):
        b, t, a = proj_mem.shape
        return b, t, a, memory.shape[-1], memory.element_size()

    def k2_shapes(x, c, h, q, proj_mem, memory, *rest):
        b, t, a = proj_mem.shape
        return (b, t, x.shape[-1], a, memory.shape[-1],
                memory.element_size())

    w1 = wrap(k1, "k1", k1_shapes)
    w2 = wrap(k2, "k2", k2_shapes)
    attention.fused_additive_attention = w1
    decode_cell_kernel.fused_decode_cell = w2
    try:
        yield
    finally:
        attention.fused_additive_attention = k1
        decode_cell_kernel.fused_decode_cell = k2
        for fn, wrapped in ((k1, w1), (k2, w2)):      # the launch counters
            fn.__dict__.update({k: v for k, v in wrapped.__dict__.items()
                                if k.startswith("launches")})


def resolved_knobs(opt) -> Dict[str, Optional[object]]:
    """The program's knobs as they resolved (the cell sets none)."""
    keys = ("decode_chunk", "remat_cell", "overlap_rewards", "decode_kernel",
            "device_rewards", "scan_unroll", "loader_workers",
            "device_feats", "use_bfloat16")
    return {k: getattr(opt, k, None) for k in keys} | {
        "tuned": (getattr(opt, "tuned_provenance", None) or {}).get("tuned")}
