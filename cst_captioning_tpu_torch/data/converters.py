"""Dataset-format converters -> the prepro annotation contract (copy of
the reference's ``data/converters.py``).

The prepro CLI consumes ``{"videos": [{"id": ..., "captions": [...]}]}``
(the reference's offline prepro).  These converters map the public release
formats of the datasets the reference targets onto that shape, splitting by
the datasets' standard conventions:

- MSR-VTT ``videodatainfo.json`` (10k videos; "sentences" list with
  ``video_id``/``caption``, "videos" list with a ``split`` field),
- MSVD / Youtube2Text caption lists (``<clip_id> <caption>`` lines, one per
  caption, clip ids like vid1234 or YouTube-hash_start_end),
- ActivityNet Captions (``{vid: {"sentences": [...], "timestamps": ...}}``
  per-split JSONs).

Each returns {"train"/"val"/"test": [{"id", "captions"}]} ready for
``prepro.build_split`` — use the train vocab for val/test.  The CLI:

    python -m cst_captioning_tpu_torch.data.converters --format msrvtt \
        --input videodatainfo.json --out_prefix data/msrvtt_
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Mapping, Optional, Sequence

from ..resilience.integrity import atomic_json_write

Annotations = List[dict]


def _group(pairs) -> Dict[str, List[str]]:
    by_vid: Dict[str, List[str]] = defaultdict(list)
    for vid, cap in pairs:
        by_vid[str(vid)].append(str(cap))
    return by_vid


def _to_annotations(by_vid: Mapping[str, Sequence[str]]) -> Annotations:
    return [{"id": vid, "captions": list(caps)}
            for vid, caps in by_vid.items()]


def convert_msrvtt(videodatainfo: dict) -> Dict[str, Annotations]:
    """MSR-VTT ``videodatainfo.json`` -> per-split annotations.

    Uses the file's own ``split`` field ("train"/"validate"/"test");
    "validate" is renamed "val".
    """
    split_of = {str(v["video_id"]): v.get("split", "train")
                for v in videodatainfo["videos"]}
    by_vid = _group((s["video_id"], s["caption"])
                    for s in videodatainfo["sentences"])
    out: Dict[str, List[dict]] = {"train": [], "val": [], "test": []}
    for vid, caps in by_vid.items():
        split = split_of.get(vid, "train")
        split = {"validate": "val"}.get(split, split)
        out.setdefault(split, []).append({"id": vid, "captions": caps})
    return out


def convert_msvd(
    caption_lines: Sequence[str],
    splits: Optional[Mapping[str, Sequence[str]]] = None,
    train_frac: float = 1200 / 1970,
    val_frac: float = 100 / 1970,
) -> Dict[str, Annotations]:
    """MSVD ``<clip_id><ws><caption>`` lines -> per-split annotations.

    Lines split on the first whitespace run (the public caption files are
    tab-separated; space-separated variants work too).  ``splits`` maps
    split name -> clip-id list if an official split file is available;
    otherwise clips are split deterministically (sorted order) with the
    standard 1200/100/670 proportions as default fractions.
    """
    pairs = []
    for line in caption_lines:
        parts = line.strip().split(maxsplit=1)
        if len(parts) == 2:
            pairs.append((parts[0], parts[1]))
    by_vid = _group(pairs)
    if splits is not None:
        return {
            name: _to_annotations({v: by_vid[v] for v in vids if v in by_vid})
            for name, vids in splits.items()
        }
    vids = sorted(by_vid)
    n = len(vids)
    n_train = int(n * train_frac)
    n_val = int(n * val_frac)
    return {
        "train": _to_annotations({v: by_vid[v] for v in vids[:n_train]}),
        "val": _to_annotations(
            {v: by_vid[v] for v in vids[n_train:n_train + n_val]}),
        "test": _to_annotations({v: by_vid[v] for v in vids[n_train + n_val:]}),
    }


def convert_activitynet(split_files: Mapping[str, dict]) -> Dict[str, Annotations]:
    """ActivityNet Captions per-split dicts -> annotations.

    ``split_files`` maps split name -> the loaded JSON
    ({vid: {"sentences": [...]}}); ActivityNet distributes train/val_1/val_2
    separately, so the caller chooses the mapping (e.g. val_1 -> val).
    """
    out = {}
    for name, blob in split_files.items():
        out[name] = _to_annotations(
            {vid: [s.strip() for s in item["sentences"]]
             for vid, item in blob.items()}
        )
    return out


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--format", required=True,
                    choices=("msrvtt", "msvd", "activitynet"))
    ap.add_argument("--input", required=True, nargs="+",
                    help="msrvtt: videodatainfo.json | msvd: captions txt | "
                         "activitynet: train.json [val.json ...]")
    ap.add_argument("--out_prefix", required=True,
                    help="writes <out_prefix><split>_anns.json per split")
    args = ap.parse_args(argv)

    if args.format == "msrvtt":
        with open(args.input[0]) as f:
            splits = convert_msrvtt(json.load(f))
    elif args.format == "msvd":
        with open(args.input[0]) as f:
            splits = convert_msvd(f.readlines())
    else:
        names = ("train", "val", "test")[: len(args.input)]
        loaded = {}
        for name, path in zip(names, args.input):
            with open(path) as f:
                loaded[name] = json.load(f)
        splits = convert_activitynet(loaded)

    written = {}
    for split, anns in splits.items():
        if not anns:
            continue
        path = f"{args.out_prefix}{split}_anns.json"
        atomic_json_write(path, {"videos": anns})
        written[split] = path
    print(json.dumps(written, indent=2))
    return written


if __name__ == "__main__":
    main()
