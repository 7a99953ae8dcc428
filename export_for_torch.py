#!/usr/bin/env python
"""Convert the JAX package's on-disk data and checkpoints into the files
the PyTorch port reads (``cst_captioning_tpu_torch``), which needs
neither ``h5py`` nor JAX.  Runs where both are installed; the port never
imports it.

    python export_for_torch.py data --src_dir data/ --split train \\
        --out_dir export/ [--feat_h5 resnet.h5 c3d.h5]
    python export_for_torch.py checkpoint --checkpoint_path ck/wxe \\
        --out_dir export/wxe [--vocab_json data/train_vocab.json]

``data``: one split's files as ``data/prepro.py`` and
``data/synthetic.py`` name them (``<split>_feat<m>.h5``,
``<split>_label.h5``, ``<split>_info.json``, ...) become, in
``--out_dir``:

- each feature h5 (dataset ``feats``, in ``--feat_h5`` order when given)
  -> ``<split>_feat<m>.npy``, the same array, dtype and shape, copied in
  row chunks;
- ``<split>_label.h5`` -> ``<split>_label.npz`` (``labels``,
  ``label_start_ix``, ``label_end_ix``, their dtypes kept);
- ``<split>_info.json``, ``_vocab.json``, ``_cocofmt.json``,
  ``_ciderdf.pkl``, ``_consensus.pkl`` and ``_wxe_weights.pkl``, where
  present, copied byte for byte;
- ``export.json``: per split the files written, per file its source,
  SHA-256, size and (arrays) shapes and dtypes.  Exporting another split
  into the same directory adds to it.

``checkpoint``: the best verified step of a reference stage directory,
restored as the reference's ``eval.py`` restores it
(``CheckpointManager(readonly=True).restore_params``, the orbax
checkpoint's own tree), written as an exported checkpoint: ``params.npz``
(the Flax tree flat, ``"a/b/c"`` keys), ``infos.json`` (the stage's infos
file, with the options it trained with), ``vocab.json`` (from
``--vocab_json``, an info json, or the ``train_info_json`` the saved
options name) and ``export.json`` (the SHA-256 and size of each file, the
source and step).  Run it in a process of its own: orbax's restore and
later training in one process is unstable on some hosts.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import sys
from typing import Dict, List, Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from cst_captioning_tpu.resilience.integrity import (  # noqa: E402
    atomic_json_write)

COPIED = ("info.json", "vocab.json", "cocofmt.json", "ciderdf.pkl",
          "consensus.pkl", "wxe_weights.pkl")
#: Rows copied per read of a feature h5 (bounded host memory).
CHUNK_BYTES = 256 << 20


def digest(path: str) -> Dict[str, object]:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return {"sha256": h.hexdigest(), "bytes": os.path.getsize(path)}


def h5_to_npy(src: str, dst: str) -> Dict[str, object]:
    """The ``feats`` dataset of ``src`` as the ``.npy`` ``dst``, copied
    in row chunks into a memory-mapped file, then renamed into place."""
    import h5py

    tmp = f"{dst}.{os.getpid()}.tmp"
    with h5py.File(src, "r") as f:
        feats = f["feats"]
        out = np.lib.format.open_memmap(tmp, mode="w+", dtype=feats.dtype,
                                        shape=feats.shape)
        row = max(1, int(np.prod(feats.shape[1:])) * feats.dtype.itemsize)
        step = max(1, CHUNK_BYTES // row)
        for start in range(0, feats.shape[0], step):
            out[start:start + step] = feats[start:start + step]
        out.flush()
        shape, dtype = list(feats.shape), str(feats.dtype)
        del out
    os.replace(tmp, dst)
    return {"shape": shape, "dtype": dtype}


def label_h5_to_npz(src: str, dst: str) -> Dict[str, object]:
    import h5py

    with h5py.File(src, "r") as f:
        arrays = {k: f[k][()] for k in ("labels", "label_start_ix",
                                        "label_end_ix")}
    tmp = f"{dst}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, dst)
    return {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
            for k, v in arrays.items()}


def export_data(src_dir: str, split: str, out_dir: str,
                feat_h5: Optional[List[str]] = None) -> Dict[str, object]:
    """Export one split; -> its entry in ``export.json``."""
    os.makedirs(out_dir, exist_ok=True)
    if not feat_h5:
        feat_h5 = []
        while os.path.exists(os.path.join(
                src_dir, f"{split}_feat{len(feat_h5)}.h5")):
            feat_h5.append(os.path.join(src_dir,
                                        f"{split}_feat{len(feat_h5)}.h5"))
    if not feat_h5:
        raise FileNotFoundError(f"no {split}_feat0.h5 in {src_dir}; name "
                                "the feature files with --feat_h5")
    label = os.path.join(src_dir, f"{split}_label.h5")
    if not os.path.exists(os.path.join(src_dir, f"{split}_info.json")):
        raise FileNotFoundError(f"no {split}_info.json in {src_dir}")
    files: Dict[str, Dict[str, object]] = {}
    entry: Dict[str, object] = {"feat_npy": []}
    for m, src in enumerate(feat_h5):
        name = f"{split}_feat{m}.npy"
        meta = h5_to_npy(src, os.path.join(out_dir, name))
        files[name] = {"source": os.path.abspath(src), **meta}
        entry["feat_npy"].append(name)
    name = f"{split}_label.npz"
    files[name] = {"source": os.path.abspath(label),
                   "arrays": label_h5_to_npz(label,
                                             os.path.join(out_dir, name))}
    entry["label_npz"] = name
    for suffix in COPIED:
        src = os.path.join(src_dir, f"{split}_{suffix}")
        if os.path.exists(src):
            name = f"{split}_{suffix}"
            shutil.copyfile(src, os.path.join(out_dir, name))
            files[name] = {"source": os.path.abspath(src)}
            entry[suffix.replace(".", "_")] = name
    for name, meta in files.items():
        meta.update(digest(os.path.join(out_dir, name)))
    manifest_path = os.path.join(out_dir, "export.json")
    manifest = {"kind": "data", "format": 1, "splits": {}, "files": {}}
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            manifest = json.load(f)
    manifest["splits"][split] = entry
    manifest["files"].update(files)
    atomic_json_write(manifest_path, manifest, indent=2)
    return entry


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flatten(val, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(val)
    return out


def export_checkpoint(checkpoint_path: str, out_dir: str,
                      vocab_json: Optional[str] = None) -> Dict[str, object]:
    """Export the best verified step of a reference stage directory; ->
    its ``export.json``."""
    from cst_captioning_tpu.training.checkpoint import CheckpointManager

    mgr = CheckpointManager(checkpoint_path, readonly=True)
    try:
        step = mgr._resolve_step(None, best=True)
        # No target tree: the orbax checkpoint's own metadata gives the
        # tree, shapes and dtypes (one host, the topology it was saved on
        # does not matter for a CPU read).
        params = mgr.restore_params(None, step=step)
        infos = dict(mgr.infos)
    finally:
        mgr.close()
    opts = infos.get("opt") or {}
    source = vocab_json or opts.get("train_info_json")
    if not source or not os.path.exists(source):
        raise FileNotFoundError(
            f"no vocabulary: pass --vocab_json (the saved options name "
            f"{opts.get('train_info_json')!r})")
    with open(source) as f:
        ix_to_word = json.load(f)["ix_to_word"]
    os.makedirs(out_dir, exist_ok=True)
    flat = _flatten(params)
    with open(os.path.join(out_dir, "params.npz"), "wb") as f:
        np.savez(f, **flat)
    atomic_json_write(os.path.join(out_dir, "infos.json"), infos)
    atomic_json_write(os.path.join(out_dir, "vocab.json"),
                      {"ix_to_word": ix_to_word})
    manifest = {
        "kind": "checkpoint", "format": 1,
        "source": os.path.abspath(checkpoint_path), "step": int(step),
        "vocab_source": os.path.abspath(source),
        "files": {n: digest(os.path.join(out_dir, n))
                  for n in ("params.npz", "infos.json", "vocab.json")},
        "params": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                   for k, v in flat.items()}}
    atomic_json_write(os.path.join(out_dir, "export.json"), manifest,
                      indent=2)
    return manifest


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="command", required=True)
    d = sub.add_parser("data", help="one split's HDF5 and prepro files")
    d.add_argument("--src_dir", required=True)
    d.add_argument("--split", required=True)
    d.add_argument("--out_dir", required=True)
    d.add_argument("--feat_h5", nargs="+", default=None,
                   help="feature files in modality order (default: "
                        "<split>_feat0.h5, <split>_feat1.h5, ...)")
    c = sub.add_parser("checkpoint", help="a reference stage directory's "
                                          "best verified params")
    c.add_argument("--checkpoint_path", required=True)
    c.add_argument("--out_dir", required=True)
    c.add_argument("--vocab_json", default=None,
                   help="a vocab or info json holding ix_to_word (default: "
                        "the train_info_json of the saved options)")
    args = p.parse_args(argv)
    if args.command == "data":
        out = export_data(args.src_dir, args.split, args.out_dir,
                          args.feat_h5)
    else:
        out = export_checkpoint(args.checkpoint_path, args.out_dir,
                                args.vocab_json)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
