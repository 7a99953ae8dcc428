"""Plain float32 PyTorch of the captioner the cells run: the feature
encoder and the attention-LSTM decoder, teacher-forced.  Written from the
model's published description (the CST paper's attention-LSTM), with no
kernel, no cache and no batching trick: every product is a
``torch.matmul`` in float32 with TF32 off (``reference.no_tf32``).

Dropout (XE), at the model's sites: the pooled feature and the memory
after the encoder, and each step's LSTM output before the vocabulary
head (the recurrent state keeps the undropped output).  A kept element is
scaled by ``1 / (1 - p)``.  The masks are the program's draws, handed in
(``Drops``): the reference cannot draw the program's random numbers.

Parameters are a dict keyed by the program's parameter names, which is
how the benchmark's weights reach both sides; ``layout`` lists them.

Conventions shared with the program's inputs: token id 0 is BOS (as the
decoder's first input), EOS and padding; a caption of ``S`` captions per
video uses its video's encoding.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

Params = Dict[str, torch.Tensor]


def layout(config: dict, vocab_rows: int) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every parameter of ``config``'s model."""
    m = config["options"]
    h = int(m["rnn_size"])
    feats = [d for _, d in config["feat_shapes"]]
    out = []
    for i, d in enumerate(feats):
        out += [(f"encoder.embed.{i}.weight", (h, d)),
                (f"encoder.embed.{i}.bias", (h,))]
    out += [("encoder.fuse.weight", (h, len(feats) * h)),
            ("encoder.fuse.bias", (h,))]
    e, a = int(m["input_encoding_size"]), int(m["att_size"])
    return out + [
        ("memory_proj.weight", (a, h)),
        ("cell.embed.weight", (vocab_rows, e)),
        ("cell.attn.score_v", (a,)),
        ("cell.attn.query_proj.weight", (a, h)),
        ("cell.lstm.0.w", (e + 2 * h, 4 * h)),
        ("cell.lstm.0.bias", (4 * h,)),
        ("state_init.0.weight", (2 * h, h)),
        ("state_init.0.bias", (2 * h,)),
        ("logit.weight", (vocab_rows, h)),
        ("logit.bias", (vocab_rows,))]


@dataclass
class Drops:
    """One step's dropout masks for a block of rows, as the program drew
    them: ``pooled`` (B, H), ``memory`` (B, T, H), ``steps`` one (B*S, H)
    a decode step; ``p`` the drop probability."""

    p: float
    pooled: torch.Tensor
    memory: torch.Tensor
    steps: List[torch.Tensor]


def drop(x: torch.Tensor, keep: torch.Tensor, p: float) -> torch.Tensor:
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def linear(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    y = torch.matmul(x, w.t())
    return y if b is None else y + b


def encode(P: Params, feats: Sequence[torch.Tensor]):
    """-> (memory (B, sum T, H): each modality's frames through its
    Linear + ReLU, concatenated over time; pooled (B, H): tanh of a
    Linear over the concatenated per-modality time means)."""
    frames, means = [], []
    for i, x in enumerate(feats):
        h = torch.relu(linear(x, P[f"encoder.embed.{i}.weight"],
                              P[f"encoder.embed.{i}.bias"]))
        frames.append(h)
        means.append(h.mean(dim=1))
    pooled = torch.tanh(linear(torch.cat(means, dim=-1),
                               P["encoder.fuse.weight"],
                               P["encoder.fuse.bias"]))
    return torch.cat(frames, dim=1), pooled


def shift_right(tokens: torch.Tensor) -> torch.Tensor:
    """The decoder's inputs: BOS (0), then the tokens but the last."""
    return torch.cat([torch.zeros_like(tokens[:, :1]), tokens[:, :-1]], 1)


def logits(P: Params, feats, tokens: torch.Tensor, seq_per_img: int,
           drops: Optional[Drops] = None) -> torch.Tensor:
    """Teacher-forced logits (B*S, L, V) of the attention-LSTM: the state
    starts from ``tanh(Linear(pooled))`` split into (c, h); each step
    embeds the previous token, attends additively over the memory
    (``v . tanh(W_m m_t + W_q h)``, softmax over time, the weighted sum of
    the memory), and runs one LSTM step on [embedding, context] with gate
    order i, f, g, o and the bias on the recurrent side; with ``drops``,
    dropout at its sites."""
    memory, pooled = encode(P, feats)
    if drops is not None:
        pooled = drop(pooled, drops.pooled, drops.p)
        memory = drop(memory, drops.memory, drops.p)
    proj = linear(memory, P["memory_proj.weight"])
    memory = memory.repeat_interleave(seq_per_img, 0)
    proj = proj.repeat_interleave(seq_per_img, 0)
    pooled = pooled.repeat_interleave(seq_per_img, 0)
    hid = pooled.shape[-1]
    c, h = torch.tanh(linear(pooled, P["state_init.0.weight"],
                             P["state_init.0.bias"])).split(hid, dim=-1)
    w = P["cell.lstm.0.w"]
    n_in = w.shape[0] - hid
    inputs = shift_right(tokens)
    outs = []
    for t in range(tokens.shape[1]):
        x = P["cell.embed.weight"][inputs[:, t]]
        q = linear(h, P["cell.attn.query_proj.weight"])
        score = (torch.tanh(proj + q[:, None, :])
                 * P["cell.attn.score_v"]).sum(-1)
        att = torch.softmax(score, dim=-1)
        ctx = (att[:, :, None] * memory).sum(1)
        gates = (torch.matmul(torch.cat([x, ctx], -1), w[:n_in])
                 + torch.matmul(h, w[n_in:]) + P["cell.lstm.0.bias"])
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs.append(h if drops is None
                    else drop(h, drops.steps[t], drops.p))
    return linear(torch.stack(outs, 1), P["logit.weight"], P["logit.bias"])


def caption_mask(tokens: torch.Tensor) -> torch.Tensor:
    """1 at every position up to and including the first 0 (the EOS the
    model must emit), 0 after it."""
    nonzero = (tokens != 0).float()
    before = torch.cumprod(nonzero[:, :-1], dim=1)
    return torch.cat([torch.ones_like(nonzero[:, :1]), before], dim=1)
