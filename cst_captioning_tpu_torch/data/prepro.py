"""Offline preprocessing: the vocabulary, label, references, df and
consensus files of one split (counterpart of the reference's
``data/prepro.py``, with the label file as ``.npz`` in place of HDF5).

    python -m cst_captioning_tpu_torch.data.prepro \\
        --annotations anns.json --split train --out_dir data/ \\
        [--count_threshold 3] [--max_len 30] [--vocab_json existing.json]

``annotations``: ``{"videos": [{"id": ..., "captions": [...]}, ...]}``
(``data/converters.py`` maps MSR-VTT, MSVD and ActivityNet onto it).
Writes ``<split>_vocab.json``, ``<split>_info.json``,
``<split>_label.npz``, ``<split>_cocofmt.json`` and, unless
``--no_reward_artifacts``, ``<split>_ciderdf.pkl`` (the corpus df,
``--train_cached_tokens``), ``<split>_consensus.pkl`` (the raw
leave-one-out consensus scores, ``--train_bcmrscores_pkl``) and
``<split>_wxe_weights.pkl`` (those normalised at temperature 1).  Feature
files come from upstream extraction and are not written here
(``data/dataset.py`` names them).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..metrics.ciderd import build_corpus_df, save_corpus_df
from ..metrics.consensus import (compute_consensus_scores, normalize_weights,
                                 save_consensus)
from ..metrics.tokenizer import tokenize
from ..resilience.integrity import atomic_json_write
from .vocab import Vocab, build_vocab, load_vocab, save_vocab


def load_annotations(path: str) -> List[dict]:
    with open(path) as f:
        obj = json.load(f)
    return obj["videos"] if isinstance(obj, dict) else obj


def save_labels(path: str, labels: np.ndarray, starts: np.ndarray,
                ends: np.ndarray) -> None:
    """The label ``.npz`` (``labels`` int32, ``label_start_ix`` and
    ``label_end_ix`` int64), written to a temporary file and renamed."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, labels=np.asarray(labels, dtype=np.int32),
                 label_start_ix=np.asarray(starts, dtype=np.int64),
                 label_end_ix=np.asarray(ends, dtype=np.int64))
    os.replace(tmp, path)


def build_split(annotations: Sequence[dict], out_dir: str, split: str,
                max_len: int = 30, count_threshold: int = 1,
                vocab: Optional[Vocab] = None,
                build_reward_artifacts: bool = True) -> Dict[str, str]:
    """Write every offline file of one split -> the path map (keys
    ``vocab_json``, ``info_json``, ``label_npz``, ``cocofmt_json`` and
    with the reward files ``cached_tokens``, ``consensus_pkl``,
    ``wxe_weights_pkl``).  Pass the train split's ``vocab`` for val and
    test."""
    os.makedirs(out_dir, exist_ok=True)
    video_ids = [str(v["id"]) for v in annotations]
    raw_caps = [[str(c) for c in v["captions"]] for v in annotations]
    empty = [vid for vid, caps in zip(video_ids, raw_caps) if not caps]
    if empty:
        raise ValueError(
            f"videos with zero captions (fix or drop them): {empty[:5]}")
    tokenized = [[tokenize(c) for c in caps] for caps in raw_caps]
    if vocab is None:
        vocab = build_vocab((t for caps in tokenized for t in caps),
                            count_threshold=count_threshold)
    paths: Dict[str, str] = {}

    paths["vocab_json"] = os.path.join(out_dir, f"{split}_vocab.json")
    save_vocab(paths["vocab_json"], vocab)

    paths["info_json"] = os.path.join(out_dir, f"{split}_info.json")
    atomic_json_write(paths["info_json"],
                      {"ix_to_word": vocab.to_json(),
                       "videos": [{"id": v} for v in video_ids]})

    rows, starts, ends = [], [], []
    for caps in tokenized:
        starts.append(len(rows))
        rows.extend(vocab.encode(t, max_len) for t in caps)
        ends.append(len(rows))
    paths["label_npz"] = os.path.join(out_dir, f"{split}_label.npz")
    save_labels(paths["label_npz"], np.stack(rows), np.asarray(starts),
                np.asarray(ends))

    paths["cocofmt_json"] = os.path.join(out_dir, f"{split}_cocofmt.json")
    atomic_json_write(paths["cocofmt_json"], {
        "images": [{"id": v} for v in video_ids],
        "annotations": [
            {"image_id": vid, "id": f"{vid}#{j}", "caption": c}
            for vid, caps in zip(video_ids, raw_caps)
            for j, c in enumerate(caps)],
    })

    if build_reward_artifacts:
        tok_refs = {vid: [" ".join(t) for t in toks]
                    for vid, toks in zip(video_ids, tokenized)}
        df, ndocs = build_corpus_df(tok_refs)
        paths["cached_tokens"] = os.path.join(out_dir, f"{split}_ciderdf.pkl")
        save_corpus_df(paths["cached_tokens"], df, ndocs)
        scores = compute_consensus_scores(tok_refs)
        paths["consensus_pkl"] = os.path.join(out_dir,
                                              f"{split}_consensus.pkl")
        save_consensus(paths["consensus_pkl"], scores)
        paths["wxe_weights_pkl"] = os.path.join(out_dir,
                                                f"{split}_wxe_weights.pkl")
        save_consensus(paths["wxe_weights_pkl"], normalize_weights(scores))
    return paths


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, str]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--annotations", required=True)
    ap.add_argument("--split", default="train")
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--max_len", type=int, default=30)
    ap.add_argument("--count_threshold", type=int, default=1)
    ap.add_argument("--vocab_json", default=None,
                    help="reuse an existing vocabulary (val/test splits)")
    ap.add_argument("--no_reward_artifacts", action="store_true")
    args = ap.parse_args(argv)
    paths = build_split(
        load_annotations(args.annotations), args.out_dir, args.split,
        max_len=args.max_len, count_threshold=args.count_threshold,
        vocab=load_vocab(args.vocab_json) if args.vocab_json else None,
        build_reward_artifacts=not args.no_reward_artifacts)
    print(json.dumps(paths, indent=2))
    return paths


if __name__ == "__main__":
    main()
