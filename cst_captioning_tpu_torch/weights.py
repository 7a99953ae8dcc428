"""Weights for the port: conversion from and to the reference's Flax
parameter tree (``from_flax``, ``to_flax``), flat ``.npz`` loading, the
exported checkpoint directory, the Flax initialisers for training from
scratch (``init_like_flax_``), and the seeded weights of the serving demo
(``init_random_``).

An **exported checkpoint** is a directory holding ``params.npz`` (the
Flax tree flat, ``"a/b/c"`` keys, as ``load_params_npz`` reads it),
``infos.json`` (``{"opt": the options it was trained with, ...}``, the
reference's infos file), ``vocab.json`` (``{"ix_to_word": ...}``) and
``export.json`` (``"kind": "checkpoint"``, the SHA-256 and size of each
of those files, the source).  ``export_for_torch.py checkpoint`` writes
one from a reference (orbax) checkpoint; ``save_exported_checkpoint``
writes one from the port's own weights.  ``load_exported_checkpoint``
verifies the digests and returns the tree, the options and the
vocabulary; ``exported_model_opts`` picks the model options the
reference's ``eval.py`` takes from a checkpoint.

Layout: Flax ``Dense`` kernels are ``(in, out)``; the port TRANSPOSES them
into ``nn.Linear`` weights ``(out, in)``.  The LSTM gate kernels are the
exception: they stay ``(in, out)`` and are concatenated into one
parameter per layer, ``w = [W_i; W_h]`` of shape ``(in + H, 4H)`` with
gate columns ``i | f | g | o`` and the h-side bias as ``bias`` (4H,) —
the layout the fused decode kernel reads (``models/decoder_lstm.py``).

The converter works from the tree the reference's ``CaptionModel``
builds (``encoder/embed_{m}``, ``encoder/fuse``, ``memory_proj``,
``cell/embed/embedding``, ``cell/attn/{query_proj/kernel,score_v}``,
``cell/lstm{l}/{ii,if,ig,io}/kernel``,
``cell/lstm{l}/{hi,hf,hg,ho}/{kernel,bias}``, ``state_init_{l}``,
``logit``), or, for the transformer, the ``tx`` subtree in place of
``memory_proj``, ``cell``, ``state_init_{l}`` and ``logit``:
``tx/embed/embedding``, ``tx/pos_embed``, ``tx/block_{i}/{LayerNorm_0,
LayerNorm_1, LayerNorm_2, Dense_0, Dense_1}``,
``tx/block_{i}/{self_attn,cross_attn}/{query,key,value,out}`` (flax
``DenseGeneral``: kernels (H, heads, head_dim) and (heads, head_dim, H),
flattened into ``nn.Linear`` weights), ``tx/LayerNorm_0`` and
``tx/logit``.  A manet tree is a temporal one: its fusion comes from the
saved options.  Unknown or missing keys raise.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from . import default_device
from .data.vocab import Vocab, load_vocab, save_vocab
from .models.captioner import DECODER_TYPES, CaptionModel
from .resilience.integrity import atomic_json_write

GATES = ("i", "f", "g", "o")   # flax OptimizedLSTMCell concat order


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    out = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(_flatten(val, path + "/"))
        else:
            out[path] = val
    return out


def load_params_npz(path: str) -> Dict[str, Any]:
    """A flat ``"a/b/c"``-keyed npz (an optional leading ``params/`` is
    dropped) -> the nested parameter dict ``from_flax`` takes."""
    tree: Dict[str, Any] = {}
    with np.load(path) as npz:
        for key in npz.files:
            parts = key.split("/")
            if parts[0] == "params":
                parts = parts[1:]
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = npz[key]
    return tree


def config_from_flax(params: Mapping) -> Dict[str, Any]:
    """The ``CaptionModel`` widths a Flax tree encodes.  A transformer
    tree (a ``tx`` subtree) adds ``decoder_type``, ``num_heads``,
    ``num_tx_layers`` and ``tx_max_len``; its word embedding is ``rnn_size``
    wide, so ``embed_size`` is the hidden size.  The fusion is not in the
    tree: a manet tree is a temporal one, and the caller takes the fusion
    from the saved options."""
    enc = params["encoder"]
    feat_dims = []
    while f"embed_{len(feat_dims)}" in enc:
        feat_dims.append(
            int(np.shape(enc[f"embed_{len(feat_dims)}"]["kernel"])[0]))
    hidden = int(np.shape(enc["fuse"]["kernel"])[1])
    if "tx" in params:
        tx = params["tx"]
        num_tx_layers = 0
        while f"block_{num_tx_layers}" in tx:
            num_tx_layers += 1
        vocab_size = np.shape(tx["embed"]["embedding"])[0]
        return {
            "vocab_size": int(vocab_size), "feat_dims": feat_dims,
            "embed_size": hidden, "hidden_size": hidden,
            "decoder_type": "transformer",
            "num_heads": int(np.shape(
                tx["block_0"]["self_attn"]["query"]["kernel"])[1]),
            "num_tx_layers": num_tx_layers,
            "tx_max_len": int(np.shape(tx["pos_embed"])[0]),
        }
    cell = params["cell"]
    num_layers = 0
    while f"lstm{num_layers}" in cell:
        num_layers += 1
    vocab_size, embed_size = np.shape(cell["embed"]["embedding"])
    return {
        "vocab_size": int(vocab_size),
        "feat_dims": feat_dims,
        "embed_size": int(embed_size),
        "hidden_size": hidden,
        "num_layers": num_layers,
        "attn_size": int(np.shape(params["memory_proj"]["kernel"])[1]),
        "use_attention": "attn" in cell,
    }


#: The transformer block's flax submodules -> the port's.
TX_BLOCK_LAYERS = (("LayerNorm_0", "ln0"), ("LayerNorm_1", "ln1"),
                   ("LayerNorm_2", "ln2"), ("Dense_0", "mlp0"),
                   ("Dense_1", "mlp1"))
TX_ATTENTIONS = ("self_attn", "cross_attn")
TX_PROJECTIONS = ("query", "key", "value", "out")


def from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax parameter tree (nested dict of arrays, without the
    ``"params"`` level) -> the port's ``CaptionModel`` state dict."""
    flat = _flatten(params)
    used = set()

    def take(path: str) -> torch.Tensor:
        if path not in flat:
            raise KeyError(f"flax tree has no {path!r}")
        used.add(path)
        return torch.from_numpy(np.array(flat[path], dtype=np.float32))

    def dense(src: str, dst: str, bias: bool = True) -> None:
        sd[f"{dst}.weight"] = take(f"{src}/kernel").T.contiguous()
        if bias:
            sd[f"{dst}.bias"] = take(f"{src}/bias")

    def layer_norm(src: str, dst: str) -> None:
        sd[f"{dst}.scale"] = take(f"{src}/scale")
        sd[f"{dst}.bias"] = take(f"{src}/bias")

    cfg = config_from_flax(params)
    sd: Dict[str, torch.Tensor] = {}
    for m in range(len(cfg["feat_dims"])):
        dense(f"encoder/embed_{m}", f"encoder.embed.{m}")
    dense("encoder/fuse", "encoder.fuse")
    if cfg.get("decoder_type") == "transformer":
        sd["tx.embed.weight"] = take("tx/embed/embedding")
        sd["tx.pos_embed"] = take("tx/pos_embed")
        for i in range(cfg["num_tx_layers"]):
            src, dst = f"tx/block_{i}", f"tx.blocks.{i}"
            for flax_name, name in TX_BLOCK_LAYERS:
                if flax_name.startswith("LayerNorm"):
                    layer_norm(f"{src}/{flax_name}", f"{dst}.{name}")
                else:
                    dense(f"{src}/{flax_name}", f"{dst}.{name}")
            for attn in TX_ATTENTIONS:
                for proj in TX_PROJECTIONS:
                    # DenseGeneral: (H, heads, hd) in, (heads, hd, H) out.
                    path = f"{src}/{attn}/{proj}"
                    kernel = take(f"{path}/kernel")
                    kernel = (kernel.reshape(-1, kernel.shape[-1])
                              if proj == "out"
                              else kernel.reshape(kernel.shape[0], -1))
                    sd[f"{dst}.{attn}.{proj}.weight"] = kernel.T.contiguous()
                    sd[f"{dst}.{attn}.{proj}.bias"] = take(
                        f"{path}/bias").reshape(-1)
        layer_norm("tx/LayerNorm_0", "tx.ln")
        dense("tx/logit", "tx.logit")
    else:
        dense("memory_proj", "memory_proj", bias=False)
        sd["cell.embed.weight"] = take("cell/embed/embedding")
        if cfg["use_attention"]:
            dense("cell/attn/query_proj", "cell.attn.query_proj",
                  bias=False)
            sd["cell.attn.score_v"] = take("cell/attn/score_v")
        for layer in range(cfg["num_layers"]):
            pre = f"cell/lstm{layer}"
            w_i = torch.cat([take(f"{pre}/i{g}/kernel") for g in GATES],
                            dim=1)
            w_h = torch.cat([take(f"{pre}/h{g}/kernel") for g in GATES],
                            dim=1)
            sd[f"cell.lstm.{layer}.w"] = torch.cat([w_i, w_h], dim=0)
            sd[f"cell.lstm.{layer}.bias"] = torch.cat(
                [take(f"{pre}/h{g}/bias") for g in GATES])
            dense(f"state_init_{layer}", f"state_init.{layer}")
        dense("logit", "logit")
    unknown = sorted(set(flat) - used)
    if unknown:
        raise KeyError(f"flax tree has keys the port does not know: "
                       f"{unknown}")
    return sd


def to_flax(model_or_state: Any) -> Dict[str, Any]:
    """The port's ``CaptionModel`` (or an LSTM's state dict) -> the
    reference's Flax parameter tree, float32 numpy arrays: the inverse of
    ``from_flax``.  A transformer is passed as the model: its head count,
    which the ``DenseGeneral`` kernels' shapes need, is not in its state
    dict."""
    num_heads = None
    if hasattr(model_or_state, "state_dict"):
        if model_or_state.decoder_type == "transformer":
            num_heads = model_or_state.tx.blocks[0].self_attn.num_heads
        sd = model_or_state.state_dict()
    else:
        sd = model_or_state
    sd = {k: v.detach().float().cpu().numpy() for k, v in sd.items()}
    tree: Dict[str, Any] = {}

    def put(path: str, value: np.ndarray) -> None:
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(value)

    def dense(src: str, dst: str) -> None:
        put(f"{dst}/kernel", sd.pop(f"{src}.weight").T)
        if f"{src}.bias" in sd:
            put(f"{dst}/bias", sd.pop(f"{src}.bias"))

    m = 0
    while f"encoder.embed.{m}.weight" in sd:
        dense(f"encoder.embed.{m}", f"encoder/embed_{m}")
        m += 1
    dense("encoder.fuse", "encoder/fuse")
    if "tx.pos_embed" in sd:
        _tx_to_flax(sd, put, dense, num_heads)
    else:
        _lstm_to_flax(sd, put, dense)
    if sd:
        raise KeyError(f"state dict has keys to_flax does not know: "
                       f"{sorted(sd)}")
    return tree


def _tx_to_flax(sd, put, dense, num_heads: Optional[int]) -> None:
    if num_heads is None:
        raise ValueError("to_flax of a transformer: pass the model, whose "
                         "head count its state dict does not hold")
    put("tx/embed/embedding", sd.pop("tx.embed.weight"))
    put("tx/pos_embed", sd.pop("tx.pos_embed"))
    i = 0
    while f"tx.blocks.{i}.ln0.scale" in sd:
        src, dst = f"tx.blocks.{i}", f"tx/block_{i}"
        for flax_name, name in TX_BLOCK_LAYERS:
            if flax_name.startswith("LayerNorm"):
                put(f"{dst}/{flax_name}/scale", sd.pop(f"{src}.{name}.scale"))
                put(f"{dst}/{flax_name}/bias", sd.pop(f"{src}.{name}.bias"))
            else:
                dense(f"{src}.{name}", f"{dst}/{flax_name}")
        for attn in TX_ATTENTIONS:
            for proj in TX_PROJECTIONS:
                kernel = sd.pop(f"{src}.{attn}.{proj}.weight").T
                bias = sd.pop(f"{src}.{attn}.{proj}.bias")
                hid = kernel.shape[0]
                if proj == "out":
                    kernel = kernel.reshape(num_heads, -1, kernel.shape[1])
                else:
                    kernel = kernel.reshape(hid, num_heads, -1)
                    bias = bias.reshape(num_heads, -1)
                put(f"{dst}/{attn}/{proj}/kernel", kernel)
                put(f"{dst}/{attn}/{proj}/bias", bias)
        i += 1
    put("tx/LayerNorm_0/scale", sd.pop("tx.ln.scale"))
    put("tx/LayerNorm_0/bias", sd.pop("tx.ln.bias"))
    dense("tx.logit", "tx/logit")


def _lstm_to_flax(sd, put, dense) -> None:
    dense("memory_proj", "memory_proj")
    put("cell/embed/embedding", sd.pop("cell.embed.weight"))
    if "cell.attn.score_v" in sd:
        dense("cell.attn.query_proj", "cell/attn/query_proj")
        put("cell/attn/score_v", sd.pop("cell.attn.score_v"))
    layer = 0
    while f"cell.lstm.{layer}.w" in sd:
        w = sd.pop(f"cell.lstm.{layer}.w")
        bias = sd.pop(f"cell.lstm.{layer}.bias")
        hid = w.shape[1] // 4
        n_in = w.shape[0] - hid
        for k, g in enumerate(GATES):
            cols = slice(k * hid, (k + 1) * hid)
            put(f"cell/lstm{layer}/i{g}/kernel", w[:n_in, cols])
            put(f"cell/lstm{layer}/h{g}/kernel", w[n_in:, cols])
            put(f"cell/lstm{layer}/h{g}/bias", bias[cols])
        dense(f"state_init.{layer}", f"state_init_{layer}")
        layer += 1
    dense("logit", "logit")


#: What ``export.json`` says an exported checkpoint is.
EXPORT_FILE = "export.json"
EXPORTED_FILES = ("params.npz", "infos.json", "vocab.json")
#: The model options the reference's ``eval.py`` takes from a
#: checkpoint's saved options (the rest come from the command line).
MODEL_OPT_KEYS = ("model_type", "rnn_size", "input_encoding_size",
                  "num_layers", "att_size", "use_attention", "drop_prob",
                  "num_heads", "num_tx_layers", "use_bfloat16", "max_length",
                  "fusion_type")
#: The ``--model_type`` and ``--fusion_type`` values (the reference's).
MODEL_TYPES = DECODER_TYPES
FUSION_TYPES = ("temporal", "manet")


def _file_digest(path: str) -> Dict[str, Any]:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return {"sha256": h.hexdigest(), "bytes": os.path.getsize(path)}


def is_exported_checkpoint(directory: str) -> bool:
    """True when ``directory`` holds an exported checkpoint (its
    ``export.json`` says ``"kind": "checkpoint"``)."""
    try:
        with open(os.path.join(directory, EXPORT_FILE)) as f:
            return json.load(f).get("kind") == "checkpoint"
    except (OSError, ValueError):
        return False


def save_params_npz(path: str, params: Mapping) -> None:
    """A Flax tree as a flat ``"a/b/c"``-keyed npz (``load_params_npz``
    reads it back)."""
    with open(path, "wb") as f:
        np.savez(f, **{k: np.asarray(v) for k, v in _flatten(params).items()})


def save_exported_checkpoint(directory: str, params: Mapping,
                             opts: Mapping[str, Any], vocab: Vocab,
                             source: str, step: Optional[int] = None) -> None:
    """Write an exported checkpoint: the Flax tree ``params``, the
    training options ``opts``, the vocabulary, and ``export.json`` with
    each file's digest."""
    os.makedirs(directory, exist_ok=True)
    save_params_npz(os.path.join(directory, "params.npz"), params)
    atomic_json_write(os.path.join(directory, "infos.json"),
                      {"opt": dict(opts), "best_step": step})
    save_vocab(os.path.join(directory, "vocab.json"), vocab)
    atomic_json_write(os.path.join(directory, EXPORT_FILE), {
        "kind": "checkpoint", "format": 1, "source": source, "step": step,
        "files": {n: _file_digest(os.path.join(directory, n))
                  for n in EXPORTED_FILES}}, indent=2)


def load_exported_checkpoint(directory: str
                             ) -> Tuple[Dict[str, Any], Dict[str, Any],
                                        Vocab]:
    """-> (the Flax tree, the saved training options, the vocabulary) of
    an exported checkpoint.  Raises unless every file matches the digest
    ``export.json`` holds for it."""
    with open(os.path.join(directory, EXPORT_FILE)) as f:
        export = json.load(f)
    if export.get("kind") != "checkpoint":
        raise ValueError(f"{directory}: {EXPORT_FILE} is not a checkpoint's")
    for name in EXPORTED_FILES:
        want = export["files"][name]
        got = _file_digest(os.path.join(directory, name))
        if got != want:
            raise ValueError(f"{directory}/{name}: digest {got} does not "
                             f"match {EXPORT_FILE}'s {want}")
    with open(os.path.join(directory, "infos.json")) as f:
        opts = json.load(f).get("opt") or {}
    return (load_params_npz(os.path.join(directory, "params.npz")), opts,
            load_vocab(os.path.join(directory, "vocab.json")))


def exported_model_opts(opts: Mapping[str, Any]) -> Dict[str, Any]:
    """The saved options ``MODEL_OPT_KEYS`` names, refused where they ask
    for a model the port does not have (a ``model_type`` other than
    ``lstm`` and ``transformer``, a ``fusion_type`` other than
    ``temporal`` and ``manet``)."""
    picked = {k: opts[k] for k in MODEL_OPT_KEYS if k in opts}
    if picked.get("model_type", "lstm") not in MODEL_TYPES:
        raise ValueError(f"model_type {picked['model_type']!r}: the port "
                         f"has {MODEL_TYPES}")
    if picked.get("fusion_type", "temporal") not in FUSION_TYPES:
        raise ValueError(f"fusion_type {picked['fusion_type']!r}: the port "
                         f"has {FUSION_TYPES}")
    return picked


def model_from_flax(params: Mapping, device=None,
                    **model_kw) -> CaptionModel:
    """A ``CaptionModel`` with the widths and weights of a Flax tree, on
    ``device`` (CUDA unless the caller asks for another; see
    ``default_device``).  ``model_kw`` sets the non-weight options
    (``decode_kernel``, ``use_kernel_attention``)."""
    dev = default_device(device)
    model = CaptionModel(**config_from_flax(params), **model_kw)
    model.load_state_dict(from_flax(params), strict=True)
    return model.eval().to(dev)


#: ``lecun_normal``'s correction: the std of a unit normal truncated to
#: [-2, 2] (jax ``variance_scaling(..., "truncated_normal")``).
_TRUNC_STD = .87962566103423978


@torch.no_grad()
def init_like_flax_(model: CaptionModel,
                    generator: torch.Generator) -> CaptionModel:
    """Weights for training from scratch, drawn as the reference's Flax
    ``model.init`` draws them (the distributions, not the numbers): dense
    kernels ``lecun_normal`` (normal truncated to two std, std
    sqrt(1/fan_in)), biases zero, the word embedding normal with std
    1/sqrt(E), the gate kernels per gate block: input side
    ``lecun_normal``, each (H, H) recurrent block orthogonal; ``score_v``
    normal with std 1/sqrt(A).  The transformer's: the attention
    projections ``lecun_normal`` over their fan-in H (``DenseGeneral``;
    the output's fan-in is heads x head_dim = H), ``pos_embed`` normal
    with std 0.02, LayerNorm scales one and biases zero.  ``generator`` is a CPU generator, so every
    device gets the same numbers."""

    def lecun_(shape, fan_in):
        std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
        out = torch.empty(shape)
        torch.nn.init.trunc_normal_(out, 0.0, std, -2 * std, 2 * std,
                                    generator=generator)
        return out

    for name, p in model.named_parameters():
        if name.endswith("bias"):
            fresh = torch.zeros(p.shape)
        elif name.endswith(".scale"):          # LayerNorm
            fresh = torch.ones(p.shape)
        elif name == "tx.pos_embed":
            fresh = torch.randn(p.shape, generator=generator) * 0.02
        elif name in ("cell.embed.weight", "tx.embed.weight"):
            fresh = torch.randn(p.shape, generator=generator) \
                / p.shape[1] ** 0.5
        elif name == "cell.attn.score_v":
            fresh = torch.randn(p.shape, generator=generator) \
                / p.shape[0] ** 0.5
        elif name.startswith("cell.lstm."):
            n_in = p.shape[0] - p.shape[1] // 4
            hid = p.shape[1] // 4
            blocks_i = [lecun_((n_in, hid), n_in) for _ in range(4)]
            blocks_h = []
            for _ in range(4):
                blk = torch.empty(hid, hid)
                torch.nn.init.orthogonal_(blk, generator=generator)
                blocks_h.append(blk)
            fresh = torch.cat([torch.cat(blocks_i, dim=1),
                               torch.cat(blocks_h, dim=1)], dim=0)
        else:           # nn.Linear weights, (out, in)
            fresh = lecun_(p.shape, p.shape[1])
        p.copy_(fresh.to(p.device))
    return model


@torch.no_grad()
def init_random_(model: CaptionModel, seed: int,
                 eos_bias: Optional[float] = None) -> CaptionModel:
    """Seeded weights (a CPU ``torch.Generator``, so every device gets the
    same numbers): matrices and embeddings ~ N(0, 1/fan_in), the score
    vector ~ N(0, 1/A), biases zero.  ``eos_bias`` is added to the EOS
    (id 0) logit bias, so captions of an untrained model end."""
    gen = torch.Generator().manual_seed(int(seed))
    for name, p in sorted(model.named_parameters()):
        if name.endswith("bias"):
            fresh = torch.zeros(p.shape)
        elif name.endswith(".scale"):          # LayerNorm
            fresh = torch.ones(p.shape)
        else:
            # Linear weights are (out, in), gate weights (in, out).
            fan_in = p.shape[0] if ".lstm." in name else p.shape[-1]
            fresh = torch.randn(p.shape, generator=gen) / fan_in ** 0.5
        p.copy_(fresh.to(p.device))
    if eos_bias:
        head = model.tx.logit if model.decoder_type == "transformer" \
            else model.logit
        head.bias[0] += eos_bias
    return model
