"""PTB-style caption tokenizer (copy of the reference's
``metrics/tokenizer.py``).

``tokenize(caption)`` -> lowercase word tokens with PTB-style splitting
(contractions, possessives, punctuation isolation, bracket
normalisation) and coco-caption's punctuation set removed.
``tokenize_corpus`` sends the ASCII captions of a whole corpus through the
C++ twin (``native/tokenizer.cpp``) in one call, once a start-up probe has
found it equal to this module on representative captions; without a
toolchain, or for non-ASCII captions, it tokenizes here.
"""

from __future__ import annotations

import logging
import re
from typing import Dict, Iterable, List

from ..native import ptb_tokenize_batch

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


log = logging.getLogger(__name__)

#: The C++ batch tokenizer once resolved: the function, or False when it
#: cannot be built or failed its probe (then never tried again).
_native_batch = None

#: Captions the native tokenizer must tokenize exactly as ``tokenize_to_str``
#: before it is used.
_PROBE = ["A man... isn't (really) cooking the dogs' dinner.",
          "cannot. u.s. 'tis \"quoted\"!"]


def _resolve_native():
    """Load the C++ tokenizer once per process and hold it against this
    module on ``_PROBE``; any build, load or probe failure pins the
    Python path."""
    global _native_batch
    if _native_batch is None:
        try:
            if ptb_tokenize_batch(_PROBE) != [tokenize_to_str(p)
                                              for p in _PROBE]:
                raise RuntimeError("native tokenizer parity probe failed")
            _native_batch = ptb_tokenize_batch
        except RuntimeError as e:   # NativeUnavailable is one
            log.warning("native tokenizer unavailable (%s); tokenizing in "
                        "Python", e)
            _native_batch = False
    return _native_batch


def tokenize_corpus(captions_for_key: Dict[str, Iterable[str]]
                    ) -> Dict[str, List[str]]:
    """``{key: [caption, ...]}`` -> ``{key: [tokenized caption string,
    ...]}`` in the same order (coco-caption's interface).  The ASCII
    captions of every key go through the C++ twin in one batch once it
    is resolved; the rest here."""
    global _native_batch
    corpus = {key: list(caps) for key, caps in captions_for_key.items()}
    native = _resolve_native()
    if not native:
        return {key: [tokenize_to_str(c) for c in caps]
                for key, caps in corpus.items()}
    out = {key: [None if c.isascii() else tokenize_to_str(c) for c in caps]
           for key, caps in corpus.items()}
    slots = [(key, j) for key, caps in out.items()
             for j, tok in enumerate(caps) if tok is None]
    flat = [corpus[key][j] for key, j in slots]
    try:
        toks = native(flat)
    except (RuntimeError, ValueError) as e:
        # A fault of the batch call itself (a batch past the int32
        # offsets, an overflow) pins the Python path too.
        log.warning("native tokenizer failed (%s); tokenizing in Python", e)
        _native_batch = False
        toks = [tokenize_to_str(c) for c in flat]
    for (key, j), tok in zip(slots, toks):
        out[key][j] = tok
    return out
