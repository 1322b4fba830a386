"""Mandarin numbered-pinyin front-end (the port's copy of the JAX recipe's
``text/pinyin.py``).

Counterpart of reference ``examples/fastspeech2/text/pinyin.py`` (initial/
final symbol inventory, MFA-lexicon style: full-form finals ``iou/uei/uen``,
apical vowels ``ii``/``iii``, erhua ``rr``) plus — new here — an actual
grapheme-to-phoneme splitter for orthographic numbered pinyin ("zhong1 guo2"),
which the reference delegates to the external ``pypinyin`` package at
generate time (reference examples/fastspeech2/generate.py:10,60-66).
Without ``pypinyin``, input text must already be
tone-numbered pinyin syllables; the splitter normalizes orthography to the
phonological inventory.
"""

from __future__ import annotations

import re
import warnings
from typing import List

# Prefix marking characters that failed pinyin parsing; consumers map these
# to the plain character table, never to phone symbols.
CHAR_FALLBACK = "\x00"

# 21 standard initials + the glides y/w kept as initials (MFA lexicon style).
initials: List[str] = [
    "b", "p", "m", "f", "d", "t", "n", "l", "g", "k", "h",
    "j", "q", "x", "zh", "ch", "sh", "r", "z", "c", "s", "y", "w",
]

# Full-form (phonological) finals; each carries a tone digit 1-5 in the
# symbol table (5 = neutral tone).
_BASE_FINALS: List[str] = [
    "a", "ai", "an", "ang", "ao",
    "e", "ei", "en", "eng", "er",
    "i", "ia", "ian", "iang", "iao", "ie", "ii", "iii", "in", "ing",
    "iong", "iou",
    "o", "ong", "ou",
    "u", "ua", "uai", "uan", "uang", "uei", "uen", "uo",
    "v", "van", "ve", "vn",
]
_TONES = "12345"
finals: List[str] = [f"{b}{t}" for b in _BASE_FINALS for t in _TONES]

# erhua suffix symbol
valid_symbols: List[str] = initials + finals + ["rr"]

_SYLLABLE_RE = re.compile(r"^([a-zü]+?)(r?)([1-5]?)$")

# Orthographic remainder → full-form final, keyed by the initial class.
_Y_FINALS = {
    "i": "i", "in": "in", "ing": "ing", "a": "ia", "an": "ian",
    "ang": "iang", "ao": "iao", "e": "ie", "o": "o", "ong": "iong",
    "ou": "iou", "u": "v", "ue": "ve", "uan": "van", "un": "vn",
}
_W_FINALS = {
    "u": "u", "a": "ua", "ai": "uai", "an": "uan", "ang": "uang",
    "ei": "uei", "en": "uen", "eng": "eng", "o": "uo",
}


def split_syllable(syllable: str) -> List[str]:
    """Decompose one tone-numbered pinyin syllable into inventory symbols.

    ``"zhong1" → ["zh", "ong1"]``, ``"er2" → ["er2"]``, ``"shi4" →
    ["sh", "iii4"]``, ``"lv3"/"lü3" → ["l", "v3"]``, erhua ``"huar1" →
    ["h", "ua1", "rr"]``. A missing tone digit means neutral tone (5).

    Raises ``ValueError`` on syllables that do not parse.
    """
    syl = syllable.lower().replace("ü", "v")
    m = _SYLLABLE_RE.match(syl)
    if not m:
        raise ValueError(f"not a pinyin syllable: {syllable!r}")
    body, erhua_r, tone = m.groups()
    tone = tone or "5"

    # "er" is a zero-initial final; the regex splits it as body="e" + "r".
    if body == "e" and erhua_r:
        return [f"er{tone}"]

    # Longest-prefix initial match.
    initial = ""
    for cand in sorted(initials, key=len, reverse=True):
        if body.startswith(cand) and len(body) > len(cand):
            initial = cand
            break
    rem = body[len(initial):]

    if initial == "y":
        rem = _Y_FINALS.get(rem, rem)
    elif initial == "w":
        rem = _W_FINALS.get(rem, rem)
    elif initial in ("j", "q", "x"):
        rem = {"u": "v", "ue": "ve", "uan": "van", "un": "vn", "iu": "iou"}.get(rem, rem)
    else:
        # Contracted orthographic forms → full phonological finals. "ue" is
        # the common keyboard spelling of üe after n/l (nue/lue = nüe/lüe).
        rem = {"iu": "iou", "ui": "uei", "un": "uen", "ue": "ve"}.get(rem, rem)
        if rem == "i" and initial in ("z", "c", "s"):
            rem = "ii"
        elif rem == "i" and initial in ("zh", "ch", "sh", "r"):
            rem = "iii"

    if rem not in _BASE_FINALS:
        raise ValueError(f"cannot map final {rem!r} of {syllable!r}")
    out = ([initial] if initial else []) + [f"{rem}{tone}"]
    if erhua_r:
        out.append("rr")
    return out


def pinyin_to_symbols(text: str) -> List[str]:
    """Whitespace-separated numbered-pinyin text → flat phone-symbol list.

    Phone symbols (initials/finals/rr and sp/spn/sil silences) are returned
    bare; tokens that do not parse as pinyin fall back to their characters,
    each prefixed with ``CHAR_FALLBACK`` so the caller can route them to the
    character table instead of the phone table. Word-like tokens that fail
    to parse additionally raise a ``UserWarning`` — a typo ("hao33",
    run-together "ni3hao3") would otherwise synthesize garbage silently.
    """
    out: List[str] = []
    for token in text.split():
        if token in ("sp", "spn", "sil"):
            out.append(token)
            continue
        try:
            out.extend(split_syllable(token))
        except ValueError:
            if any(c.isalnum() for c in token):
                warnings.warn(
                    f"token {token!r} is not tone-numbered pinyin; "
                    "falling back to character passthrough",
                    stacklevel=2,
                )
            out.extend(CHAR_FALLBACK + c for c in token)
    return out
