"""Validation: decode a split, score it (counterpart of the reference's
``training/evaluation.py``, single process, CIDEr-D only).

Every video of the split is decoded greedily (``val_beam_size`` 1, the
reference's default) or by beam search, the loader's wrap padding is
deduplicated, and the captions are scored with CIDEr-D against the raw
references after PTB tokenisation of both, as the reference's
``language_eval`` scores its ``CIDEr``.  BLEU, METEOR and ROUGE-L are not
ported yet.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import torch

from ..data.loader import CaptionLoader
from ..data.vocab import Vocab
from ..metrics.ciderd import CiderD
from ..metrics.tokenizer import tokenize_corpus
from ..ops.beam import beam_search
from ..ops.sampling import greedy_decode


def decode_split(model, loader: CaptionLoader, vocab: Vocab, max_len: int,
                 beam_size: int = 1, length_norm: float = 0.0,
                 decode_chunk: int = 0) -> List[Dict[str, str]]:
    """One ordered pass -> ``[{"image_id", "caption"}]``, one per video."""
    device = model.device
    seen = set()
    preds = []
    for batch in loader.iter_eval():
        feats = [torch.from_numpy(f).to(device) for f in batch.feats]
        if beam_size > 1:
            tokens = beam_search(model, feats, beam_size, max_len,
                                 length_norm=length_norm,
                                 decode_chunk=decode_chunk)[0]
        else:
            tokens = greedy_decode(model, feats, max_len,
                                   decode_chunk=decode_chunk)
        for vid, row in zip(batch.video_ids, tokens.cpu().numpy()):
            if vid not in seen:
                seen.add(vid)
                preds.append({"image_id": vid, "caption": vocab.decode(row)})
    return preds


def ciderd_score(preds: Sequence[Mapping[str, str]],
                 refs: Mapping[str, Sequence[str]]) -> float:
    """Corpus CIDEr-D of ``preds`` against ``refs`` (``{id: [raw
    caption, ...]}``), document frequencies from these references."""
    res = tokenize_corpus({p["image_id"]: [p["caption"]] for p in preds})
    gts = tokenize_corpus({k: list(refs[k]) for k in res})
    return CiderD(df_mode="refs").compute_score(
        gts, [{"image_id": k, "caption": v} for k, v in res.items()])[0]


def eval_split(model, loader: CaptionLoader, vocab: Vocab, max_len: int,
               refs: Mapping[str, Sequence[str]], beam_size: int = 1,
               length_norm: float = 0.0, decode_chunk: int = 0
               ) -> Tuple[List[Dict[str, str]], Dict[str, float]]:
    """Decode and score one split -> (predictions, {"CIDEr": score})."""
    preds = decode_split(model, loader, vocab, max_len, beam_size=beam_size,
                         length_norm=length_norm, decode_chunk=decode_chunk)
    return preds, {"CIDEr": float(ciderd_score(preds, refs))}
