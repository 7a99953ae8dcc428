"""PTB-style caption tokenizer (copy of the reference's
``metrics/tokenizer.py``, pure-Python path).

``tokenize(caption)`` -> lowercase word tokens with PTB-style splitting
(contractions, possessives, punctuation isolation, bracket
normalisation) and coco-caption's punctuation set removed.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List

# coco-caption's PTBTokenizer wrapper removes exactly these tokens after
# the Java tokenizer runs.
PUNCTUATIONS = frozenset(
    [
        "''", "'", "``", "`",
        "-LRB-", "-RRB-", "-LCB-", "-RCB-",
        ".", "?", "!", ",", ":", "-", "--", "...", ";",
    ]
)

# PTB splits these contraction suffixes off the host word.
_CONTRACTIONS = re.compile(r"(?i)([a-z])('ll|'re|'ve|n't|'s|'m|'d)\b")
# Words PTB splits in the middle (cannot, gonna, ...).
_SPECIAL_SPLITS = {
    "cannot": ("can", "not"),
    "gonna": ("gon", "na"),
    "gotta": ("got", "ta"),
    "wanna": ("wan", "na"),
    "lemme": ("lem", "me"),
    "gimme": ("gim", "me"),
    "d'ye": ("d'", "ye"),
    "'tis": ("'t", "is"),
    "'twas": ("'t", "was"),
}
_BRACKETS = {
    "(": "-LRB-", ")": "-RRB-",
    "{": "-LCB-", "}": "-RCB-",
    "[": "-LRB-", "]": "-RRB-",
}
# Isolate punctuation / symbols. Ellipsis and -- first so they stay whole.
_PUNCT_ISOLATE = re.compile(r"(\.\.\.|--|[,;:@#$%&?!\"(){}\[\]<>=+/\\*^~|])")
# Abbreviations like "u.s." keep their periods (PTB treats them as one token);
# any other token-trailing period is sentence-terminal and is split off.
_ABBREV = re.compile(r"^([a-z]\.)+$", re.IGNORECASE)
# Contraction suffixes PTB emits as their own (kept) tokens — exempt from
# apostrophe stripping below.
_CONTRACTION_TOKENS = frozenset(["'s", "'re", "'ve", "'ll", "'m", "'d", "n't", "'t"])


def tokenize(caption: str) -> List[str]:
    """Tokenize one caption string into normalized word tokens."""
    s = caption.replace("\n", " ").replace("—", " -- ").replace("–", " -- ").strip()
    s = _PUNCT_ISOLATE.sub(r" \1 ", s)
    s = _CONTRACTIONS.sub(r"\1 \2", s)
    out: List[str] = []
    for tok in s.split():
        low = tok.lower()
        if low in _SPECIAL_SPLITS:
            out.extend(_SPECIAL_SPLITS[low])
            continue
        # Sentence-terminal period: split off unless abbreviation-shaped.
        if tok.endswith(".") and tok.strip(".") and not _ABBREV.match(tok):
            tok = tok[:-1]
        # Bare surrounding apostrophes ('hello', dogs') are quote characters
        # PTB renders as `/''; strip them — but keep contraction tokens.
        if tok.lower() not in _CONTRACTION_TOKENS:
            tok = tok.strip("'")
        if not tok:
            continue
        tok = _BRACKETS.get(tok, tok)
        low = tok.lower()
        if tok in PUNCTUATIONS or low in PUNCTUATIONS or low == '"':
            continue
        out.append(low)
    return out


def tokenize_to_str(caption: str) -> str:
    """Tokenize and re-join with single spaces (the form metrics consume)."""
    return " ".join(tokenize(caption))


def tokenize_corpus(captions_for_key: Dict[str, Iterable[str]]
                    ) -> Dict[str, List[str]]:
    """``{key: [caption, ...]}`` -> ``{key: [tokenized caption string,
    ...]}`` in the same order (coco-caption's interface)."""
    return {key: [tokenize_to_str(c) for c in caps]
            for key, caps in captions_for_key.items()}
