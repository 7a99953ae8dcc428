"""Validation and test evaluation: decode a split, score it
(counterpart of the reference's ``training/evaluation.py``).

Every video of the split is decoded greedily (beam size 1) or by beam
search, the loader's wrap padding is deduplicated, and the captions are
scored by ``metrics.coco_eval.language_eval``: BLEU-1..4, METEOR_approx,
ROUGE-L and CIDEr against the raw references, or the subset ``scorers``
names.

Under several processes (a loader with ``process_count`` > 1) each
process decodes its stride of the split and the token rows are
all-gathered (``gather_strided_predictions``), so every process scores
the whole split, in split order, and takes the same checkpoint
decisions.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..data.loader import CaptionLoader
from ..data.vocab import Vocab
from ..metrics.coco_eval import language_eval
from ..ops.beam import beam_search
from ..ops.sampling import greedy_decode


def _allgather(padded: np.ndarray) -> np.ndarray:
    """(maxn, L) on every process -> (P, maxn, L) over the default
    process group."""
    t = torch.from_numpy(np.ascontiguousarray(padded))
    if dist.get_backend() == "nccl":
        t = t.cuda()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).cpu().numpy()


def gather_strided_predictions(local_tokens: np.ndarray,
                               all_video_ids: Sequence[str],
                               process_index: int, process_count: int,
                               allgather: Optional[Callable] = None
                               ) -> Tuple[List[str], List[np.ndarray]]:
    """The whole split's token rows from every process's stride: process
    ``q`` holds split indices ``q::process_count`` (``CaptionLoader``),
    so the strides are known from the count alone and only the tokens
    cross processes, padded to one row count.  -> (video ids, rows) in
    stride order, process by process, as the reference returns them.
    ``allgather`` ((maxn, L) -> (P, maxn, L)) defaults to
    ``dist.all_gather`` over the default group."""
    n_total = len(all_video_ids)
    shards = [list(range(q, n_total, process_count))
              for q in range(process_count)]
    if len(local_tokens) != len(shards[process_index]):
        raise ValueError(
            f"host {process_index} decoded {len(local_tokens)} rows, "
            f"expected {len(shards[process_index])} for its stride")
    maxn = max(len(s) for s in shards)
    padded = np.zeros((maxn,) + local_tokens.shape[1:], local_tokens.dtype)
    padded[:len(local_tokens)] = local_tokens
    gathered = np.asarray((allgather or _allgather)(padded))
    ids: List[str] = []
    rows: List[np.ndarray] = []
    for q, shard in enumerate(shards):
        for j, ix in enumerate(shard):
            ids.append(all_video_ids[ix])
            rows.append(gathered[q, j])
    return ids, rows


def decode_split(model, loader: CaptionLoader, vocab: Vocab, max_len: int,
                 beam_size: int = 1, length_norm: float = 0.0,
                 decode_chunk: int = 0,
                 stats: Optional[Dict[str, int]] = None,
                 beat: Optional[Callable[[], None]] = None
                 ) -> List[Dict[str, str]]:
    """One ordered pass -> ``[{"image_id", "caption"}]``, one per video.
    ``stats``, when given, gets ``decode_steps`` (the steps the decoder
    executed, summed over the batches) and ``batches``; ``beat`` (a
    watchdog's) is called after every decoded batch.  Under
    ``loader.process_count`` > 1 this process decodes its stride and the
    rows of every process are gathered (``gather_strided_predictions``):
    every process returns the whole split's predictions in split
    order."""
    device = model.device
    seen = set()
    ids: List[str] = []
    rows: List[np.ndarray] = []
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
        if beat is not None:
            beat()
        for vid, row in zip(batch.video_ids, tokens.cpu().numpy()):
            if vid not in seen:
                seen.add(vid)
                ids.append(vid)
                rows.append(row)
    if stats is not None:
        stats.update(decode_steps=steps, batches=batches)
    if loader.process_count > 1:
        ids, rows = gather_strided_predictions(
            np.stack(rows), loader.ds.video_ids, loader.process_index,
            loader.process_count)
        order = {v: i for i, v in enumerate(loader.ds.video_ids)}
        ids, rows = zip(*sorted(zip(ids, rows), key=lambda p: order[p[0]]))
    return [{"image_id": v, "caption": vocab.decode(r)}
            for v, r in zip(ids, rows)]


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
