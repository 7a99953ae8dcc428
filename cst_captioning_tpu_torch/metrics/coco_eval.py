"""``language_eval``: the caption metric suite in one process (copy of
the reference's ``metrics/coco_eval.py``).

PTB-style tokenisation of hypotheses and references, then BLEU-1..4,
METEOR (the pure-Python approximation, emitted as ``METEOR_approx``),
ROUGE-L, CIDEr (coco-caption's, which is CIDEr-D) and, on request,
CIDEr-plain.  Predictions are coco-format ``[{"image_id", "caption"}]``;
references a ``{image_id: [caption, ...]}`` mapping or the path of a
coco-format annotations JSON.
"""

from __future__ import annotations

import json
import logging
from typing import Dict, List, Mapping, Optional, Sequence

from .bleu import compute_bleu
from .ciderd import CiderD
from .meteor import compute_meteor
from .rouge import compute_rouge
from .tokenizer import tokenize_corpus

_warned_meteor = False

#: Metrics whose emitted key differs from the name ``--eval_metric``
#: selects them by: METEOR here is the 2005 approximation, so every score
#: dict carries it as METEOR_approx, never as a bare "METEOR".
APPROX_SCORE_KEYS = {"METEOR": "METEOR_approx"}

#: Every metric ``--eval_metric`` may select.
KNOWN_EVAL_METRICS = ("CIDEr", "CIDEr-plain", "METEOR", "METEOR_approx",
                      "ROUGE_L", "Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4")


def score_key(metric: str) -> str:
    """Emitted-scores key for a CLI ``--eval_metric`` name."""
    return APPROX_SCORE_KEYS.get(metric, metric)


def load_cocofmt_refs(cocofmt_file: str) -> Dict[str, List[str]]:
    """Read a coco-format annotations JSON into {image_id: [caption, ...]}."""
    with open(cocofmt_file) as f:
        coco = json.load(f)
    refs: Dict[str, List[str]] = {}
    for ann in coco["annotations"]:
        refs.setdefault(str(ann["image_id"]), []).append(ann["caption"])
    return refs


def language_eval(
    predictions: Sequence[Mapping[str, object]],
    refs: Mapping[str, Sequence[str]] | str,
    scorers: Optional[Sequence[str]] = None,
) -> Dict[str, float]:
    """Score predictions [{"image_id": id, "caption": text}, ...].

    Only the image_ids present in ``predictions`` are scored, as
    COCOEvalCap scores the result set; a prediction whose id has no
    references raises ``KeyError``.  ``scorers`` picks among "Bleu",
    "METEOR" (or "METEOR_approx"), "ROUGE_L", "CIDEr" and "CIDEr-plain";
    the default is all but CIDEr-plain.
    """
    if isinstance(refs, str):
        refs = load_cocofmt_refs(refs)
    res_raw = {str(p["image_id"]): [str(p["caption"])] for p in predictions}
    gts_raw = {k: list(refs[k]) for k in res_raw.keys() if k in refs}
    missing = set(res_raw) - set(gts_raw)
    if missing:
        raise KeyError(f"predictions for ids without references: "
                       f"{sorted(missing)[:5]}")
    res = tokenize_corpus(res_raw)
    gts = tokenize_corpus(gts_raw)

    if scorers is None:
        scorers = ("Bleu", "METEOR", "ROUGE_L", "CIDEr")
    out: Dict[str, float] = {}
    if "Bleu" in scorers:
        bleus, _ = compute_bleu(gts, res, n=4)
        for i, b in enumerate(bleus, 1):
            out[f"Bleu_{i}"] = float(b)
    if "METEOR" in scorers or "METEOR_approx" in scorers:
        global _warned_meteor
        if not _warned_meteor:
            logging.getLogger("cst_captioning_tpu_torch.metrics").warning(
                "METEOR_approx is the pure-Python 2005-algorithm "
                "approximation (exact+stem matching, no WordNet/paraphrase "
                "modules) — NOT numerically comparable to meteor-1.5.jar "
                "numbers from the literature; see metrics/meteor.py")
            _warned_meteor = True
        out["METEOR_approx"] = compute_meteor(gts, res)[0]
    if "ROUGE_L" in scorers:
        out["ROUGE_L"] = compute_rouge(gts, res)[0]
    res_list = [{"image_id": k, "caption": v} for k, v in res.items()]
    if "CIDEr" in scorers:
        # coco-caption's Cider scorer clips counts and applies the gaussian
        # length penalty (CIDEr-D) despite its name; published "CIDEr"
        # columns are that metric.
        out["CIDEr"] = CiderD(df_mode="refs", variant="cider-d"
                              ).compute_score(gts, res_list)[0]
    if "CIDEr-plain" in scorers:
        out["CIDEr-plain"] = CiderD(df_mode="refs", variant="cider"
                                    ).compute_score(gts, res_list)[0]
    return out
