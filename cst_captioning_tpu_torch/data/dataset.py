"""A split on disk (counterpart of the reference's ``data/dataset.py``,
with numpy files in place of its HDF5 ones).

The files of one split, as the port's prepro (``data/prepro.py``), its
synthetic writer (``data/synthetic.py: write_split``) and the exporter
(``export_for_torch.py data``, from the reference's files) write them
into one directory:

- ``<split>_feat<m>.npy``: modality m's features, (N, D) pooled or
  (N, T, D) temporal, row i the i-th video of the info json (the
  reference's ``<split>_feat<m>.h5`` dataset ``feats``, same dtype and
  shape); read through ``np.load(mmap_mode="r")``;
- ``<split>_label.npz``: ``labels`` (M, L) int32 0-padded token ids,
  ``label_start_ix`` and ``label_end_ix`` (N,) int64, video i's caption
  rows the half-open range [start, end) (the reference's label h5);
- ``<split>_info.json`` (``ix_to_word`` and the ``videos`` list),
  ``<split>_vocab.json``, ``<split>_cocofmt.json`` (the references);
- ``<split>_ciderdf.pkl`` (``--train_cached_tokens``),
  ``<split>_consensus.pkl`` (``--train_bcmrscores_pkl``) and
  ``<split>_wxe_weights.pkl``, the reference's pickles.

``CaptionDataset`` reads a split lazily from the memory-mapped arrays,
or into RAM with ``preload=True``, and offers what the loader and the
trainer read from an in-memory ``synthetic.Split`` (the ``SplitData``
protocol both satisfy).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Protocol, Sequence

import numpy as np

from .vocab import Vocab

#: The reference's HDF5 flags, refused by the port's CLIs with a pointer
#: to the exporter (the card has no ``h5py``).
H5_FLAGS = tuple(f"--{split}_{kind}_h5" for split in ("train", "val", "test")
                 for kind in ("feat", "label"))


class SplitData(Protocol):
    """What the loader, the trainer, evaluation and serving read from a
    split, in memory (``synthetic.Split``) or on disk
    (``CaptionDataset``)."""

    video_ids: List[str]
    vocab: Vocab
    labels: np.ndarray
    label_start: np.ndarray
    label_end: np.ndarray
    consensus: Optional[Dict[str, np.ndarray]]

    @property
    def num_videos(self) -> int: ...

    @property
    def seq_length(self) -> int: ...

    @property
    def feat_dims(self) -> List[int]: ...

    @property
    def feat_times(self) -> List[int]: ...

    @property
    def refs(self) -> Dict[str, List[str]]: ...

    def captions_for(self, video_ix: int) -> np.ndarray: ...

    def features(self, video_ix: np.ndarray) -> List[np.ndarray]: ...


@dataclass
class SplitPaths:
    """The files of one split (any number of feature files >= 1)."""

    feat_npy: Sequence[str]
    label_npz: str
    info_json: str
    cocofmt_json: Optional[str] = None


def split_files(root: str, split: str) -> Dict[str, object]:
    """The files of ``split`` under ``root`` by the names above -> a map
    with ``feat_npy`` (a list, modality order) and each other file that
    exists (``label_npz``, ``info_json``, ``vocab_json``,
    ``cocofmt_json``, ``cached_tokens``, ``consensus_pkl``,
    ``wxe_weights_pkl``).  Raises when the split has no feature file."""
    feats = []
    while os.path.exists(os.path.join(root, f"{split}_feat{len(feats)}.npy")):
        feats.append(os.path.join(root, f"{split}_feat{len(feats)}.npy"))
    if not feats:
        raise FileNotFoundError(f"no {split}_feat0.npy in {root}")
    out: Dict[str, object] = {"feat_npy": feats}
    for key, name in (("label_npz", "label.npz"), ("info_json", "info.json"),
                      ("vocab_json", "vocab.json"),
                      ("cocofmt_json", "cocofmt.json"),
                      ("cached_tokens", "ciderdf.pkl"),
                      ("consensus_pkl", "consensus.pkl"),
                      ("wxe_weights_pkl", "wxe_weights.pkl")):
        path = os.path.join(root, f"{split}_{name}")
        if os.path.exists(path):
            out[key] = path
    return out


def paths_from_opt(opt, split: str) -> Optional[SplitPaths]:
    """``--{split}_feat_npy/_label_npz/_info_json/_cocofmt_file`` ->
    ``SplitPaths``; None when no file of the split is given.  Some but
    not all of the three required files is an error."""
    feat = getattr(opt, f"{split}_feat_npy", None)
    label = getattr(opt, f"{split}_label_npz", None)
    info = getattr(opt, f"{split}_info_json", None)
    if not (feat or label or info):
        return None
    if not (feat and label and info):
        raise ValueError(f"--{split}_feat_npy, --{split}_label_npz and "
                         f"--{split}_info_json go together")
    return SplitPaths(feat_npy=list(feat), label_npz=label, info_json=info,
                      cocofmt_json=getattr(opt, f"{split}_cocofmt_file",
                                           None))


def add_split_args(group, split: str) -> None:
    """The file flags of one split on an argparse group."""
    group.add_argument(f"--{split}_feat_npy", nargs="+", default=None,
                       help=f"{split} feature .npy files, one per modality")
    group.add_argument(f"--{split}_label_npz", default=None)
    group.add_argument(f"--{split}_info_json", default=None,
                       help="vocabulary and video-id list of the split")
    group.add_argument(f"--{split}_cocofmt_file", default=None,
                       help="coco-format references (default: the labels "
                            "decoded)")


def refuse_h5_flags(parser, argv: Sequence[str]) -> None:
    """A reference HDF5 flag is a usage error (exit 2) that names the
    exporter."""
    for a in argv:
        flag = a.split("=", 1)[0]
        if flag in H5_FLAGS:
            parser.error(
                f"{flag}: the port reads numpy files, not HDF5; convert the "
                "split once where h5py is installed with `python "
                "export_for_torch.py data --src_dir DIR --split SPLIT "
                "--out_dir OUT` and pass --*_feat_npy / --*_label_npz")


class CaptionDataset:
    """Random-access view over one split's files.  ``preload=True``
    reads every feature array into RAM as float32 once; otherwise rows
    are read from the memory map per batch.  ``consensus`` is None until
    the trainer sets it from ``--train_bcmrscores_pkl``."""

    def __init__(self, paths: SplitPaths, preload: bool = False):
        self.paths = paths
        with open(paths.info_json) as f:
            info = json.load(f)
        self.vocab = Vocab.from_json(info["ix_to_word"])
        self.video_ids: List[str] = [str(v["id"]) for v in info["videos"]]
        self._feats: List[np.ndarray] = [
            np.load(p, mmap_mode=None if preload else "r")
            for p in paths.feat_npy]
        if preload:
            self._feats = [np.asarray(f, dtype=np.float32)
                           for f in self._feats]
        with np.load(paths.label_npz) as npz:
            self.labels = np.asarray(npz["labels"], dtype=np.int32)
            self.label_start = np.asarray(npz["label_start_ix"])
            self.label_end = np.asarray(npz["label_end_ix"])
        n = len(self.video_ids)
        for feats, path in zip(self._feats, paths.feat_npy):
            if feats.shape[0] != n:
                raise ValueError(f"{path}: {feats.shape[0]} feature rows != "
                                 f"{n} videos in info json")
        if len(self.label_start) != n or len(self.label_end) != n:
            raise ValueError("label index arrays do not match video count")
        empty = np.flatnonzero(self.label_end <= self.label_start)
        if len(empty):
            raise ValueError(f"videos with zero captions: "
                             f"{[self.video_ids[i] for i in empty[:5]]}")
        self.consensus: Optional[Dict[str, np.ndarray]] = None
        self._refs: Optional[Dict[str, List[str]]] = None

    # -- shapes ----------------------------------------------------------

    @property
    def num_videos(self) -> int:
        return len(self.video_ids)

    @property
    def seq_length(self) -> int:
        return self.labels.shape[1]

    @property
    def feat_dims(self) -> List[int]:
        return [int(f.shape[-1]) for f in self._feats]

    @property
    def feat_times(self) -> List[int]:
        """Temporal length per modality; 1 for pooled (N, D) features."""
        return [int(f.shape[1]) if f.ndim == 3 else 1 for f in self._feats]

    # -- access ------------------------------------------------------------

    def features(self, video_ix: np.ndarray) -> List[np.ndarray]:
        """Per-modality float32 (B, T_m, D_m) batches of the given video
        indices, in their order (duplicates allowed); pooled modalities
        come back as (B, 1, D).  The rows are read in ascending order
        (``np.unique``) and gathered back, as the reference reads them."""
        uniq, inv = np.unique(np.asarray(video_ix), return_inverse=True)
        out = []
        for feats in self._feats:
            block = np.asarray(feats[uniq], dtype=np.float32)[inv]
            if block.ndim == 2:
                block = block[:, None, :]
            out.append(block)
        return out

    def captions_for(self, video_ix: int) -> np.ndarray:
        """(num_caps, L) label rows of one video."""
        return self.labels[int(self.label_start[video_ix]):
                           int(self.label_end[video_ix])]

    def references(self) -> Dict[str, List[str]]:
        """Ground-truth caption strings per video id: the cocofmt file's,
        else the labels decoded."""
        if self.paths.cocofmt_json:
            with open(self.paths.cocofmt_json) as f:
                coco = json.load(f)
            refs: Dict[str, List[str]] = {}
            for ann in coco["annotations"]:
                refs.setdefault(str(ann["image_id"]), []).append(
                    ann["caption"])
            return refs
        return {vid: [self.vocab.decode(row) for row in self.captions_for(i)]
                for i, vid in enumerate(self.video_ids)}

    @property
    def refs(self) -> Dict[str, List[str]]:
        """``references()``, read once."""
        if self._refs is None:
            self._refs = self.references()
        return self._refs

    def close(self) -> None:
        self._feats = []

    def __enter__(self) -> "CaptionDataset":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
