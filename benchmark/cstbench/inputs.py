"""The benchmark's inputs, made from ``--seed``: the training split and the
model's weights.

The split follows the pattern of the port's ``data/synthetic.py`` rich
grammar (frozen here, so a change to the program's generator changes no
cell): per video one concept (two nouns, a verb, a preposition) and its
captions, 60% the canonical form "a S is V P the O", 20% the short form
"the S is V", 20% a form with two random adjectives.  The word pools fill
the configuration's vocabulary.  Captions are drawn with numpy from the
seed; features on ``device`` with a ``torch.Generator`` in a few large
calls (a per-video concept made of the first caption's word signatures,
plus small per-frame noise) and then held on the host, as a data set read
into memory would be.

Weights are drawn on ``device`` from the seed in one call and cut into the
program's parameters by name: matrices normal with std 1/sqrt(fan-in),
word embeddings 1/sqrt(width), the attention score vector 1/sqrt(A),
positions 0.02, biases zero, LayerNorm scales one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

FUNCTION_WORDS = ("a", "the", "is")
PREPOSITIONS = ("in", "on", "with", "near", "under", "behind")
UNK = "<unk>"


@dataclass
class SplitArrays:
    """A split as the benchmark made it: ``labels`` (N, C, L) int32
    0-padded ids (id 0 is EOS and padding), the word of each id
    (``words[0]`` is unused), ``feats`` per modality (N, T, D) float32 on
    the host."""

    labels: np.ndarray
    words: List[str]
    feats: List[np.ndarray]


def word_pools(vocab_size: int) -> Tuple[List[str], List[str], List[str]]:
    """Nouns, verbs and adjectives that, with the prepositions, the
    function words and ``<unk>``, make ``vocab_size`` words."""
    fixed = len(FUNCTION_WORDS) + len(PREPOSITIONS) + 1
    if vocab_size < fixed + 8:
        raise ValueError(f"vocabulary of {vocab_size} words is too small")
    n_nouns = vocab_size * 45 // 100
    n_verbs = vocab_size * 30 // 100
    n_adjs = vocab_size - n_nouns - n_verbs - fixed
    return ([f"noun{i}" for i in range(n_nouns)],
            [f"verb{i}ing" for i in range(n_verbs)],
            [f"adj{i}" for i in range(n_adjs)])


def make_captions(seed: int, num_videos: int, captions_per_video: int,
                  max_len: int, vocab_size: int
                  ) -> Tuple[np.ndarray, List[str]]:
    """-> (labels (N, C, L) int32, words by id)."""
    nouns, verbs, adjs = word_pools(vocab_size)
    words = ["", *FUNCTION_WORDS, *PREPOSITIONS, *nouns, *verbs, *adjs, UNK]
    ix = {w: i for i, w in enumerate(words)}
    a, the, is_ = (ix[w] for w in FUNCTION_WORDS)
    noun0, verb0, adj0 = ix[nouns[0]], ix[verbs[0]], ix[adjs[0]]
    prep0 = ix[PREPOSITIONS[0]]
    rng = np.random.default_rng(seed)
    n, c = num_videos, captions_per_video
    s = noun0 + rng.integers(len(nouns), size=n)
    o = noun0 + rng.integers(len(nouns), size=n)
    v = verb0 + rng.integers(len(verbs), size=n)
    p = prep0 + rng.integers(len(PREPOSITIONS), size=n)
    ad = adj0 + rng.integers(len(adjs), size=(n, c, 2))
    labels = np.zeros((n, c, max_len), dtype=np.int32)
    form = np.arange(c) % 5
    canonical = np.stack([np.full(n, a), s, np.full(n, is_), v, p,
                          np.full(n, the), o], axis=1)
    short = np.stack([np.full(n, the), s, np.full(n, is_), v], axis=1)
    for j in range(c):
        if form[j] < 3:
            row = canonical
        elif form[j] == 3:
            row = short
        else:
            row = np.stack([np.full(n, the), ad[:, j, 0], s,
                            np.full(n, is_), v, p, np.full(n, a),
                            ad[:, j, 1], o], axis=1)
        k = min(row.shape[1], max_len)
        labels[:, j, :k] = row[:, :k]
    return labels, words


def make_features(generator: torch.Generator, labels: np.ndarray,
                  n_words: int, feat_shapes: Sequence[Sequence[int]]
                  ) -> List[np.ndarray]:
    """Per modality (N, T, D) float32 on the host, drawn on the
    generator's device: ``0.1 * noise + 3 * sum of the first caption's
    word signatures`` per video, plus ``0.01 * noise`` per frame."""
    dev = generator.device
    first = torch.from_numpy(labels[:, 0, :].astype(np.int64)).to(dev)
    out = []
    for t, d in feat_shapes:
        sig = torch.randn((n_words, d), generator=generator, device=dev)
        sig /= d ** 0.5
        sig[0] = 0.0                                   # padding
        concept = (0.1 * torch.randn((first.shape[0], d),
                                     generator=generator, device=dev)
                   + 3.0 * sig[first].sum(dim=1))
        frames = torch.randn((first.shape[0], t, d), generator=generator,
                             device=dev)
        frames.mul_(0.01).add_(concept[:, None, :])
        out.append(frames.cpu().numpy())
        del sig, concept, frames
    return out


def make_split(seed: int, traffic: dict, config: dict,
               device: torch.device) -> SplitArrays:
    """The training split of a cell: ``traffic["videos"]`` videos of
    ``config["captions_per_video"]`` captions over the configuration's
    vocabulary, feature shapes and caption length."""
    labels, words = make_captions(
        seed, int(traffic["videos"]), int(config["captions_per_video"]),
        int(config["max_length"]), int(config["vocab_size"]))
    gen = torch.Generator(device=device).manual_seed(seed)
    feats = make_features(gen, labels, len(words), config["feat_shapes"])
    return SplitArrays(labels=labels, words=words, feats=feats)


def _scale(name: str, shape: Tuple[int, ...]) -> float:
    """Standard deviation of a non-constant parameter."""
    if name.endswith("pos_embed"):
        return 0.02
    if name.endswith("embed.weight"):
        return shape[1] ** -0.5
    if name.endswith("score_v"):
        return shape[0] ** -0.5
    if name.endswith(".w"):                  # LSTM gates, (in, out)
        return shape[0] ** -0.5
    return shape[1] ** -0.5                  # (out, in) matrices


def make_weights(seed: int, layout: Sequence[Tuple[str, Tuple[int, ...]]],
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """Float32 weights for every ``(name, shape)`` of ``layout``, drawn on
    ``device`` in one call of a generator seeded from ``seed`` (a stream
    apart from the features')."""
    gen = torch.Generator(device=device).manual_seed(seed ^ 0x5EED)
    drawn = [(n, s) for n, s in layout
             if not (n.endswith("bias") or n.endswith(".scale"))]
    total = sum(int(np.prod(s)) for _, s in drawn)
    flat = torch.randn(total, generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for name, shape in layout:
        if name.endswith("bias"):
            out[name] = torch.zeros(shape, device=device)
        elif name.endswith(".scale"):
            out[name] = torch.ones(shape, device=device)
        else:
            k = int(np.prod(shape))
            out[name] = flat[at:at + k].view(shape) * _scale(name, shape)
            at += k
    return out
