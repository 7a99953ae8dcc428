"""Vocabulary and sequence<->string conversion (copy of the reference's
``data/vocab.py``: ``Vocab``, ``build_vocab``, ``save_vocab`` and
``load_vocab``).

Token-id convention: id 0 is PAD, EOS and the decoder's BOS input at
once; real words occupy ids 1..V, so embedding tables have V+1 rows.
"""

from __future__ import annotations

import json
from collections import Counter
from typing import Dict, Iterable, List, Mapping, Sequence

import numpy as np

from ..resilience.integrity import atomic_json_write

PAD_EOS = 0  # id 0: padding, end-of-sequence, and the decoder's BOS input
UNK_TOKEN = "<unk>"


class Vocab:
    """Immutable word<->id mapping with id 0 reserved for PAD/EOS/BOS."""

    def __init__(self, ix_to_word: Mapping[int, str]):
        self.ix_to_word: Dict[int, str] = {int(k): v
                                           for k, v in ix_to_word.items()}
        if PAD_EOS in self.ix_to_word:
            raise ValueError("id 0 is reserved for PAD/EOS")
        self.word_to_ix: Dict[str, int] = {w: i for i, w
                                           in self.ix_to_word.items()}
        self.unk_ix = self.word_to_ix.get(UNK_TOKEN)

    def __len__(self) -> int:
        # number of real words; embedding tables need len(vocab)+1 rows
        return len(self.ix_to_word)

    @property
    def size_with_pad(self) -> int:
        return len(self.ix_to_word) + 1

    def encode(self, tokens: Sequence[str], max_len: int) -> np.ndarray:
        """Tokens -> fixed-length id row, 0-padded (EOS implicit at the
        first 0).  Unknown words map to ``<unk>``, or are dropped when the
        vocabulary has none (a 0 would read as an early EOS)."""
        out = np.zeros(max_len, dtype=np.int32)
        j = 0
        for w in tokens:
            if j >= max_len:
                break
            ix = self.word_to_ix.get(w, self.unk_ix)
            if ix is None:
                continue
            out[j] = ix
            j += 1
        return out

    def decode(self, ids: Iterable[int]) -> str:
        """Id sequence -> caption string, stopping at the first 0 (EOS)."""
        words = []
        for i in ids:
            i = int(i)
            if i == PAD_EOS:
                break
            words.append(self.ix_to_word.get(i, UNK_TOKEN))
        return " ".join(words)

    def decode_batch(self, seqs) -> List[str]:
        """(B, L) id matrix -> list of caption strings."""
        return [self.decode(row) for row in np.asarray(seqs)]

    def to_json(self) -> Dict[str, str]:
        return {str(k): v for k, v in self.ix_to_word.items()}

    @classmethod
    def from_json(cls, obj: Mapping[str, str]) -> "Vocab":
        return cls({int(k): v for k, v in obj.items()})


def build_vocab(tokenized_captions: Iterable[Sequence[str]],
                count_threshold: int = 1, add_unk: bool = True) -> Vocab:
    """Frequency-thresholded vocabulary: sorted words seen at least
    ``count_threshold`` times, then ``<unk>``; ids from 1."""
    counts = Counter()
    for toks in tokenized_captions:
        counts.update(toks)
    words = sorted(w for w, c in counts.items() if c >= count_threshold)
    if add_unk and UNK_TOKEN not in words:
        words.append(UNK_TOKEN)
    return Vocab({i + 1: w for i, w in enumerate(words)})


def save_vocab(path: str, vocab: Vocab) -> None:
    """``{"ix_to_word": {...}}``, written atomically."""
    atomic_json_write(path, {"ix_to_word": vocab.to_json()})


def load_vocab(path: str) -> Vocab:
    with open(path) as f:
        return Vocab.from_json(json.load(f)["ix_to_word"])
