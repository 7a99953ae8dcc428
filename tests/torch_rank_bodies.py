"""Rank bodies of the parallelism tests, for ``dryrun.run_ranks``: each
is ``fn(mesh, *args)`` and returns numpy or plain values.  A spawned
rank imports this module by name (it inherits the test process's
``sys.path``, which holds ``tests/``)."""

from typing import Dict, Sequence

import numpy as np
import torch

from cst_captioning_tpu_torch.data.loader import CaptionLoader
from cst_captioning_tpu_torch.data.synthetic import SyntheticSpec, generate
from cst_captioning_tpu_torch.models.captioner import CaptionModel
from cst_captioning_tpu_torch.models.encoder import dropout_keep
from cst_captioning_tpu_torch.ops.sampling import gumbel_noise
from cst_captioning_tpu_torch.parallel.cp import (context_parallel_xe_step,
                                                  time_shard_memory)
from cst_captioning_tpu_torch.parallel.dp import DataParallel
from cst_captioning_tpu_torch.parallel.dryrun import (FEAT_SHAPES, HIDDEN,
                                                      MAX_LEN, SEQ_PER_IMG,
                                                      VOCAB, gather_rows,
                                                      pipeline_model)
from cst_captioning_tpu_torch.parallel.mesh import (Mesh, make_mesh,
                                                    shard_batch_arrays)
from cst_captioning_tpu_torch.parallel.sequence import (
    sp_additive_attention, sp_cross_attention, sp_multihead_cross_attention,
    time_sharding)
from cst_captioning_tpu_torch.training.device_rewards import \
    build_device_tables
from cst_captioning_tpu_torch.training.evaluation import decode_split
from cst_captioning_tpu_torch.training.state import Optimizer
from cst_captioning_tpu_torch.training.steps import fused_cst_step, xe_step
from cst_captioning_tpu_torch.weights import init_like_flax_


def mesh_rank(mesh: Mesh) -> dict:
    """This rank's coordinates and the global ranks along its axes."""
    return {"rank": mesh.rank, "coords": mesh.coords, "shape": mesh.shape,
            "data": list(mesh.data.ranks), "model": list(mesh.model.ranks)}


def flag_rank(mesh: Mesh, raised_on: int) -> list:
    """``DataParallel.any`` of a host flag raised on rank ``raised_on``
    only, then of no flag: -> [True, False] on every rank."""
    dp = DataParallel(mesh)
    return [dp.any(mesh.rank == raised_on), dp.any(False)]


def dropout_rank(mesh: Mesh, batch: int, seq_per_img: int, time: int,
                 hidden: int, vocab: int, device: str = "cpu") -> dict:
    """The draws of a data-parallel rank, gathered into the global batch:
    dropout keep masks of a pooled (B, H), a memory (B, T, H) and a
    caption-row (B*S, H) shape and one with no batch axis, then two steps
    of rollout noise over the sample and greedy row blocks."""
    dev = torch.device(device)
    dp = DataParallel(mesh)
    b = batch // dp.count
    draw = dp.draw(torch.Generator(dev).manual_seed(5))
    out = {}
    for name, shape in (("pooled", (b, hidden)),
                        ("memory", (b, time, hidden)),
                        ("cell", (b * seq_per_img, hidden))):
        out[name] = gather_rows(mesh, dropout_keep(shape, 0.5, draw, dev))
    out["weights"] = dropout_keep((time, time), 0.5, draw, dev,
                                  rows=False).cpu().numpy()
    noise = dp.noise_rows(gumbel_noise(torch.Generator(dev).manual_seed(6)),
                          [b * seq_per_img, b])
    for t in range(2):
        x = noise(t, (b * seq_per_img + b, vocab))
        out[f"noise{t}"] = np.concatenate(
            [gather_rows(mesh, x[:b * seq_per_img]),
             gather_rows(mesh, x[b * seq_per_img:])])
    return out


def guard_rank(mesh: Mesh, nan_rank: int, device: str = "cpu") -> dict:
    """The divergence guard across ranks: one good XE step, then an XE
    step whose caption weights are NaN on rank ``nan_rank`` only, then a
    fused CST step whose features are NaN there; -> each guarded step's
    ``bad_step`` and whether every parameter and optimizer tensor kept
    its bits."""
    dev = torch.device(device)
    dp = DataParallel(mesh)
    cfg = {"vocab": VOCAB, "hidden": HIDDEN, "feat_shapes": FEAT_SHAPES}
    model = pipeline_model(cfg, device, "reference", False, 0.5, None)
    opt = Optimizer(model.parameters(), "adam", learning_rate=1e-3,
                    grad_clip=5.0)
    B, S, L, V = 2 * dp.count, SEQ_PER_IMG, MAX_LEN, VOCAB
    rng = np.random.default_rng(0)
    feats = [rng.standard_normal((B,) + s).astype(np.float32)
             for s in FEAT_SHAPES]
    labels = rng.integers(1, V, (B * S, L)).astype(np.int64)

    def local(x):
        return torch.from_numpy(shard_batch_arrays(mesh, x)).to(dev)

    lfeats = [local(f) for f in feats]
    gen = torch.Generator(dev).manual_seed(1)
    xe_step(model, opt, lfeats, local(labels), local(np.ones(B * S,
                                                             np.float32)),
            S, gen, guard=True, dp=dp)

    def state():
        return ([p.detach().clone() for p in model.parameters()]
                + [v.clone() for st in opt.state for v in st.values()]
                + [opt.count.clone()])

    def same(before):
        return all(torch.equal(a, b) for a, b in zip(before, state()))

    out = {}
    weights = local(np.ones(B * S, np.float32))
    if dp.index == nan_rank:
        weights = torch.full_like(weights, float("nan"))
    before = state()
    m = xe_step(model, opt, lfeats, local(labels), weights, S, gen,
                guard=True, dp=dp)
    out["xe_bad"], out["xe_unchanged"] = float(m["bad_step"]), same(before)
    refs = {f"v{i}": ["w1 w2", "w3"] for i in range(B)}
    corpus, tables, _ = build_device_tables(
        refs, {f"w{k}": k for k in range(1, V)}, device=dev)
    nan_feats = [torch.full_like(f, float("nan")) if dp.index == nan_rank
                 else f for f in lfeats]
    before = state()
    m = fused_cst_step(model, opt, nan_feats,
                       local(np.arange(B, dtype=np.int64)),
                       gumbel_noise(torch.Generator(dev).manual_seed(1)),
                       corpus, tables, L, S, guard=True, dp=dp)
    out["fused_bad"] = float(m["bad_step"])
    out["fused_unchanged"] = same(before)
    return out


def sp_ops_rank(mesh: Mesh, x: Dict[str, np.ndarray],
                device: str = "cpu") -> dict:
    """Every SP op of ``parallel/sequence.py`` on global inputs ``x``
    (numpy): the dot attention by the combine and by the ring, with and
    without ``mask``, the multi-head wrapper (``q4``, ``k4``, ``v4``), and
    the additive attention (``qp``, ``mem``, ``pm``, ``sv``, ``amask``)
    -> their global results."""
    dev = torch.device(device)
    t = {k: torch.from_numpy(v).to(dev) for k, v in x.items()}
    out = {}
    for ring in (False, True):
        tag = "ring" if ring else "dot"
        out[tag] = sp_cross_attention(t["q"], t["k"], t["v"], mesh,
                                      ring=ring)
        out[f"{tag}_masked"] = sp_cross_attention(
            t["q"], t["k"], t["v"], mesh, mask=t["mask"], ring=ring)
        rows, times = time_sharding(mesh, t["q4"].shape[0],
                                    t["k4"].shape[1])
        out[f"multihead_{tag}"] = gather_rows(
            mesh, sp_multihead_cross_attention(
                t["q4"][rows], t["k4"][rows, times], t["v4"][rows, times],
                mesh.model, ring=ring))
    rows, times = time_sharding(mesh, t["qp"].shape[0], t["mem"].shape[1])
    out["additive"] = gather_rows(mesh, sp_additive_attention(
        t["qp"][rows], t["mem"][rows, times], t["pm"][rows, times],
        t["sv"], mesh.model, mask=t["amask"][rows, times]))
    return {k: v if isinstance(v, np.ndarray) else v.cpu().numpy()
            for k, v in out.items()}


def cp_xe_rank(mesh: Mesh, cfg: dict, params: Dict[str, np.ndarray],
               x: Dict[str, np.ndarray], sharded: Sequence[bool],
               learning_rate: float = 1e-2, device: str = "cpu") -> dict:
    """One SGD XE step of the transformer ``cfg`` (``vocab``, ``hidden``,
    ``heads``, ``layers``, ``feat_shapes``, ``max_len``, ``seq_per_img``)
    from ``params`` on the global batch ``x`` (``feats0``..., ``labels``):
    context-parallel over the model axis when it has more than one rank
    (modalities time-sharded where ``sharded`` says), the plain step
    otherwise -> the loss and the updated parameters."""
    dev = torch.device(device)
    shapes = cfg["feat_shapes"]
    model = CaptionModel(
        cfg["vocab"], [d for _, d in shapes], embed_size=cfg["hidden"],
        hidden_size=cfg["hidden"], attn_size=cfg["hidden"], drop_prob=0.0,
        decoder_type="transformer", num_heads=cfg["heads"],
        num_tx_layers=cfg["layers"], tx_max_len=cfg["max_len"] + 1)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()})
    model.to(dev)
    opt = Optimizer(model.parameters(), "sgd", learning_rate=learning_rate)
    feats = [torch.from_numpy(x[f"feats{m}"]).to(dev)
             for m in range(len(shapes))]
    labels = torch.from_numpy(x["labels"]).long().to(dev)
    weights = torch.ones(labels.shape[0], device=dev)
    gen = torch.Generator(dev).manual_seed(0)
    if mesh.model.size > 1:
        model.shard_time(time_shard_memory(mesh, [t for t, _ in shapes],
                                           sharded))
        m = context_parallel_xe_step(model, opt, feats, labels, weights,
                                     cfg["seq_per_img"], gen,
                                     DataParallel(mesh))
    else:
        m = xe_step(model, opt, feats, labels, weights, cfg["seq_per_img"],
                    gen)
    return {"loss": float(m["loss"]),
            "params": {k: v.detach().cpu().numpy()
                       for k, v in model.state_dict().items()}}


def decode_rank(mesh: Mesh, videos: int, batch_size: int, max_len: int,
                device: str = "cpu") -> list:
    """Greedy validation of a seeded model on a synthetic split of
    ``videos`` videos, the loader strided by rank
    (``training/evaluation.decode_split``) -> the predictions, which
    every rank returns whole, in split order."""
    split = generate("val", SyntheticSpec(num_videos=videos,
                                          max_len=max_len), consensus=False)
    model = CaptionModel(split.vocab.size_with_pad, split.feat_dims,
                         embed_size=HIDDEN, hidden_size=HIDDEN,
                         attn_size=HIDDEN)
    init_like_flax_(model, torch.Generator().manual_seed(0))
    loader = CaptionLoader(split, batch_size, seq_per_img=1, shuffle=False,
                           process_index=mesh.data.index,
                           process_count=mesh.data.size)
    return decode_split(model.to(device), loader, split.vocab, max_len)
