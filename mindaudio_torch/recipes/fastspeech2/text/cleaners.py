"""English text cleaners (the port's copy of the JAX recipe's
``text/cleaners.py``): lowercase, abbreviation and
number expansion, whitespace collapse, ascii fold."""

from __future__ import annotations

import re
import unicodedata

from .numbers import normalize_numbers

_whitespace_re = re.compile(r"\s+")

_ABBREVIATIONS = [
    (re.compile(rf"\b{abbr}\.", re.IGNORECASE), full)
    for abbr, full in [
        ("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"), ("st", "saint"),
        ("co", "company"), ("jr", "junior"), ("maj", "major"), ("gen", "general"),
        ("drs", "doctors"), ("rev", "reverend"), ("lt", "lieutenant"),
        ("hon", "honorable"), ("sgt", "sergeant"), ("capt", "captain"),
        ("esq", "esquire"), ("ltd", "limited"), ("col", "colonel"), ("ft", "fort"),
    ]
]


def expand_abbreviations(text: str) -> str:
    for pattern, full in _ABBREVIATIONS:
        text = pattern.sub(full, text)
    return text


def convert_to_ascii(text: str) -> str:
    return unicodedata.normalize("NFKD", text).encode("ascii", "ignore").decode()


def collapse_whitespace(text: str) -> str:
    return _whitespace_re.sub(" ", text).strip()


def basic_cleaners(text: str) -> str:
    return collapse_whitespace(text.lower())


def transliteration_cleaners(text: str) -> str:
    return collapse_whitespace(convert_to_ascii(text).lower())


def english_cleaners(text: str) -> str:
    """The LJSpeech pipeline: ascii → lowercase → numbers → abbreviations."""
    text = convert_to_ascii(text).lower()
    text = normalize_numbers(text)
    text = expand_abbreviations(text)
    return collapse_whitespace(text)
