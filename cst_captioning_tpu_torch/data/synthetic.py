"""Synthetic caption splits built in memory (counterpart of the
reference's ``data/synthetic.py`` with the label encoding of its
``data/prepro.py``).

The same grammar, the same random-number chain (``seed + crc32(split)``)
and the same feature signatures as the reference's generator, so a split
here equals the one the reference writes to HDF5 for the same spec:
labels, caption ranges, vocabulary and features alike.  ``generate``
returns the split as arrays; ``write_split`` writes it as the files of
``data/dataset.py`` (the reference's file-writing ``generate``): the
same arrays as ``.npy`` features, the rest through the port's prepro.

Captions are drawn per video from one concept (subject, verb, object,
and for the rich grammar an adjective and a preposition); features are a
per-video signal derived from the first caption's token ids, so the
features predict the captions and training has something to learn.
"""

from __future__ import annotations

import os
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..metrics.consensus import compute_consensus_scores
from ..metrics.tokenizer import tokenize
from .prepro import build_split
from .vocab import Vocab, build_vocab

_SUBJECTS = ["a man", "a woman", "a dog", "a cat", "a child"]
_VERBS = ["is cooking", "is running", "is singing", "is playing",
          "is dancing"]
_OBJECTS = ["in the kitchen", "in the park", "on stage", "with a ball",
            "outside"]


@dataclass
class SyntheticSpec:
    num_videos: int = 8
    captions_per_video: int = 5
    max_len: int = 16
    feat_dims: Tuple[int, ...] = (32, 16)
    feat_times: Tuple[int, ...] = (4, 1)
    seed: int = 0
    # > 0: the rich grammar, word pools of about this many words; 0: the
    # 15-word grammar.
    rich_vocab: int = 0


@dataclass
class Split:
    """One split in memory.  ``labels`` (M, L) int32 0-padded rows; video
    i owns rows ``label_start[i]:label_end[i]``; ``feats`` per modality
    (N, T_m, D_m) float32; ``refs`` the raw captions per video id;
    ``consensus`` the leave-one-out CIDEr-D of each caption (train
    splits)."""

    video_ids: List[str]
    labels: np.ndarray
    label_start: np.ndarray
    label_end: np.ndarray
    feats: List[np.ndarray]
    vocab: Vocab
    refs: Dict[str, List[str]]
    consensus: Optional[Dict[str, np.ndarray]] = field(default=None)

    @property
    def num_videos(self) -> int:
        return len(self.video_ids)

    @property
    def seq_length(self) -> int:
        return self.labels.shape[1]

    @property
    def feat_dims(self) -> List[int]:
        return [int(f.shape[-1]) for f in self.feats]

    @property
    def feat_times(self) -> List[int]:
        return [int(f.shape[1]) for f in self.feats]

    def captions_for(self, video_ix: int) -> np.ndarray:
        return self.labels[self.label_start[video_ix]:
                           self.label_end[video_ix]]

    def features(self, video_ix: np.ndarray) -> List[np.ndarray]:
        return [f[video_ix] for f in self.feats]


def _rich_pools(n_words: int):
    n_nouns = max(n_words * 45 // 100, 4)
    n_verbs = max(n_words * 30 // 100, 2)
    n_adjs = max(n_words - n_nouns - n_verbs - 8, 2)
    nouns = [f"noun{i}" for i in range(n_nouns)]
    verbs = [f"verb{i}ing" for i in range(n_verbs)]
    adjs = [f"adj{i}" for i in range(n_adjs)]
    preps = ["in", "on", "with", "near", "under", "behind"]
    return nouns, verbs, adjs, preps


def _make_captions(rng: np.random.Generator, spec: SyntheticSpec,
                   vocab: Optional[Vocab] = None) -> List[List[str]]:
    """Per video: one concept and its captions.  Rich grammar: 60% the
    consensus form, 20% a shortened form, 20% a form with random
    adjectives.  ``vocab`` (val/test) restricts each word pool to the
    words the train split realised."""
    if spec.rich_vocab:
        if spec.captions_per_video < 5:
            raise ValueError("rich_vocab grammar needs captions_per_video "
                             f">= 5, got {spec.captions_per_video}")
        nouns, verbs, adjs, preps = _rich_pools(spec.rich_vocab)
        if vocab is not None:
            known = set(vocab.word_to_ix)

            def keep(pool, min_n=1):
                kept = [w for w in pool if w in known]
                return kept if len(kept) >= min_n else pool

            nouns = keep(nouns, min_n=2)
            verbs, adjs, preps = keep(verbs), keep(adjs), keep(preps)
        all_caps = []
        for _ in range(spec.num_videos):
            s, o = (nouns[rng.integers(len(nouns))],
                    nouns[rng.integers(len(nouns))])
            v = verbs[rng.integers(len(verbs))]
            p = preps[rng.integers(len(preps))]
            canonical = f"a {s} is {v} {p} the {o}"
            caps = []
            for j in range(spec.captions_per_video):
                if j % 5 < 3:
                    caps.append(canonical)
                elif j % 5 == 3:
                    caps.append(f"the {s} is {v}")
                else:
                    a = adjs[rng.integers(len(adjs))]
                    a2 = adjs[rng.integers(len(adjs))]
                    caps.append(f"the {a} {s} is {v} {p} a {a2} {o}")
            all_caps.append(caps)
        return all_caps
    all_caps = []
    for _ in range(spec.num_videos):
        s = _SUBJECTS[rng.integers(len(_SUBJECTS))]
        v = _VERBS[rng.integers(len(_VERBS))]
        o = _OBJECTS[rng.integers(len(_OBJECTS))]
        all_caps.append([f"{s} {v}" if j % 3 == 2 else f"{s} {v} {o}"
                         for j in range(spec.captions_per_video)])
    return all_caps


def _make_features(spec: SyntheticSpec, captions: List[List[str]],
                   vocab: Vocab, rng: np.random.Generator
                   ) -> List[np.ndarray]:
    """Per modality (N, T, D) float32: a per-video concept (noise plus a
    fixed random signature per token of the first caption, or a bump at
    ``token % D`` for the small grammar) plus small per-frame noise."""
    out = []
    sig_rng = np.random.default_rng(spec.seed + 7919)
    n_words = len(vocab) + 1
    for dim, t_len in zip(spec.feat_dims, spec.feat_times):
        signatures = None
        if spec.rich_vocab:
            signatures = sig_rng.standard_normal(
                (n_words, dim)).astype(np.float32) / np.sqrt(dim)
        feats = np.zeros((spec.num_videos, t_len, dim), dtype=np.float32)
        for i, caps in enumerate(captions):
            concept = rng.standard_normal(dim) * 0.1
            ids = vocab.encode(tokenize(caps[0]), spec.max_len)
            for tok in ids[ids > 0]:
                if signatures is not None:
                    concept += signatures[int(tok) % n_words] * 3.0
                else:
                    concept[int(tok) % dim] += 1.0
            feats[i] = (concept[None, :]
                        + 0.01 * rng.standard_normal((t_len, dim)))
        out.append(feats)
    return out


def generate(split: str = "train", spec: SyntheticSpec = SyntheticSpec(),
             vocab: Optional[Vocab] = None, consensus: bool = True,
             features: bool = True) -> Split:
    """One split.  Pass the train split's vocabulary for val/test so ids
    agree.  ``consensus=False`` skips the consensus scores (validation
    needs none); ``features=False`` leaves ``feats`` empty (a train split
    built for its vocabulary alone: the features draw last from the
    split's stream, so nothing else changes)."""
    rng = np.random.default_rng(spec.seed + zlib.crc32(split.encode()))
    captions = _make_captions(rng, spec, vocab=vocab)
    video_ids = [f"{split}_video{i}" for i in range(spec.num_videos)]
    tokenized = [[tokenize(c) for c in caps] for caps in captions]
    if vocab is None:
        vocab = build_vocab(t for caps in tokenized for t in caps)
    rows, starts, ends = [], [], []
    for caps in tokenized:
        starts.append(len(rows))
        rows.extend(vocab.encode(t, spec.max_len) for t in caps)
        ends.append(len(rows))
    scores = None
    if consensus:
        scores = compute_consensus_scores(
            {vid: [" ".join(t) for t in toks]
             for vid, toks in zip(video_ids, tokenized)})
    return Split(
        video_ids=video_ids,
        labels=np.stack(rows).astype(np.int32),
        label_start=np.asarray(starts, dtype=np.int64),
        label_end=np.asarray(ends, dtype=np.int64),
        feats=(_make_features(spec, captions, vocab, rng) if features
               else []),
        vocab=vocab,
        refs=dict(zip(video_ids, captions)),
        consensus=scores)


def save_feats(path: str, feats: np.ndarray) -> None:
    """One modality's features as ``.npy``, (N, D) when T is 1 (the
    reference's pooled layout), written to a temporary file and
    renamed."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.save(f, feats[:, 0, :] if feats.shape[1] == 1 else feats)
    os.replace(tmp, path)


def write_split(root: str, split: str = "train",
                spec: SyntheticSpec = SyntheticSpec(),
                vocab: Optional[Vocab] = None,
                data: Optional[Split] = None) -> Dict[str, object]:
    """Write one split's files under ``root`` -> the path map of
    ``prepro.build_split`` plus ``feat_npy`` (one ``<split>_feat<m>.npy``
    per modality).  Pass the train split's ``vocab`` for val/test;
    ``data``, a split ``generate`` already built from ``spec`` and
    ``vocab``, is written as it is instead of being generated again."""
    if data is None:
        data = generate(split, spec, vocab=vocab, consensus=False)
    paths: Dict[str, object] = dict(build_split(
        [{"id": v, "captions": data.refs[v]} for v in data.video_ids],
        root, split, max_len=spec.max_len, vocab=data.vocab))
    paths["feat_npy"] = []
    for m, feats in enumerate(data.feats):
        path = os.path.join(root, f"{split}_feat{m}.npy")
        save_feats(path, feats)
        paths["feat_npy"].append(path)
    return paths
