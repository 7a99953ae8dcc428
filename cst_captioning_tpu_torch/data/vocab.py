"""Vocabulary and sequence<->string conversion (copy of the reference's
``data/vocab.py`` ``Vocab``).

Token-id convention: id 0 is PAD, EOS and the decoder's BOS input at
once; real words occupy ids 1..V, so embedding tables have V+1 rows.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping

import numpy as np

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

    def __len__(self) -> int:
        # number of real words; embedding tables need len(vocab)+1 rows
        return len(self.ix_to_word)

    @property
    def size_with_pad(self) -> int:
        return len(self.ix_to_word) + 1

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
