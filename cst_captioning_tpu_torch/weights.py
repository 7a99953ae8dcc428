"""Weights for the port: conversion from the reference's Flax parameter
tree, flat ``.npz`` loading, and seeded random initialisation.

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
``logit``).  Unknown or missing keys raise.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from . import default_device
from .models.captioner import CaptionModel

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
    """The ``CaptionModel`` widths a Flax tree encodes."""
    enc = params["encoder"]
    cell = params["cell"]
    feat_dims = []
    while f"embed_{len(feat_dims)}" in enc:
        feat_dims.append(
            int(np.shape(enc[f"embed_{len(feat_dims)}"]["kernel"])[0]))
    num_layers = 0
    while f"lstm{num_layers}" in cell:
        num_layers += 1
    vocab_size, embed_size = np.shape(cell["embed"]["embedding"])
    return {
        "vocab_size": int(vocab_size),
        "feat_dims": feat_dims,
        "embed_size": int(embed_size),
        "hidden_size": int(np.shape(enc["fuse"]["kernel"])[1]),
        "num_layers": num_layers,
        "attn_size": int(np.shape(params["memory_proj"]["kernel"])[1]),
        "use_attention": "attn" in cell,
    }


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

    cfg = config_from_flax(params)
    sd: Dict[str, torch.Tensor] = {}
    for m in range(len(cfg["feat_dims"])):
        dense(f"encoder/embed_{m}", f"encoder.embed.{m}")
    dense("encoder/fuse", "encoder.fuse")
    dense("memory_proj", "memory_proj", bias=False)
    sd["cell.embed.weight"] = take("cell/embed/embedding")
    if cfg["use_attention"]:
        dense("cell/attn/query_proj", "cell.attn.query_proj", bias=False)
        sd["cell.attn.score_v"] = take("cell/attn/score_v")
    for layer in range(cfg["num_layers"]):
        pre = f"cell/lstm{layer}"
        w_i = torch.cat([take(f"{pre}/i{g}/kernel") for g in GATES], dim=1)
        w_h = torch.cat([take(f"{pre}/h{g}/kernel") for g in GATES], dim=1)
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
        else:
            # Linear weights are (out, in), gate weights (in, out).
            fan_in = p.shape[0] if ".lstm." in name else p.shape[-1]
            fresh = torch.randn(p.shape, generator=gen) / fan_in ** 0.5
        p.copy_(fresh.to(p.device))
    if eos_bias:
        model.logit.bias[0] += eos_bias
    return model
