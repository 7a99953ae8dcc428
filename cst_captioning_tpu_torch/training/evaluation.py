"""Validation and test evaluation: decode a split, score it
(counterpart of the reference's ``training/evaluation.py``, single
process).

Every video of the split is decoded greedily (beam size 1) or by beam
search, the loader's wrap padding is deduplicated, and the captions are
scored by ``metrics.coco_eval.language_eval``: BLEU-1..4, METEOR_approx,
ROUGE-L and CIDEr against the raw references, or the subset ``scorers``
names.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from ..data.loader import CaptionLoader
from ..data.vocab import Vocab
from ..metrics.coco_eval import language_eval
from ..ops.beam import beam_search
from ..ops.sampling import greedy_decode


def decode_split(model, loader: CaptionLoader, vocab: Vocab, max_len: int,
                 beam_size: int = 1, length_norm: float = 0.0,
                 decode_chunk: int = 0,
                 stats: Optional[Dict[str, int]] = None
                 ) -> List[Dict[str, str]]:
    """One ordered pass -> ``[{"image_id", "caption"}]``, one per video.
    ``stats``, when given, gets ``decode_steps`` (the steps the decoder
    executed, summed over the batches) and ``batches``."""
    device = model.device
    seen = set()
    preds = []
    steps = batches = 0
    for batch in loader.iter_eval():
        feats = [torch.from_numpy(f).to(device) for f in batch.feats]
        if beam_size > 1:
            tokens, _, _, n = beam_search(
                model, feats, beam_size, max_len, length_norm=length_norm,
                decode_chunk=decode_chunk, return_steps=True)
        else:
            tokens, n = greedy_decode(model, feats, max_len,
                                      decode_chunk=decode_chunk,
                                      return_steps=True)
        steps += n
        batches += 1
        for vid, row in zip(batch.video_ids, tokens.cpu().numpy()):
            if vid not in seen:
                seen.add(vid)
                preds.append({"image_id": vid, "caption": vocab.decode(row)})
    if stats is not None:
        stats.update(decode_steps=steps, batches=batches)
    return preds


def eval_split(model, loader: CaptionLoader, vocab: Vocab, max_len: int,
               refs: Mapping[str, Sequence[str]], beam_size: int = 1,
               length_norm: float = 0.0,
               scorers: Optional[Sequence[str]] = None,
               decode_chunk: int = 0
               ) -> Tuple[List[Dict[str, str]], Dict[str, float]]:
    """Decode and score one split -> (predictions, metric dict)."""
    preds = decode_split(model, loader, vocab, max_len, beam_size=beam_size,
                         length_norm=length_norm, decode_chunk=decode_chunk)
    return preds, language_eval(preds, refs, scorers=scorers)
