"""Text front-end: cleaners + symbol set + text→id sequences (the port's
copy of the JAX recipe's ``examples/fastspeech2/text/``, pinned to it by
``tests/test_torch_fastspeech2_recipe.py``: the same symbol table and ids).

Phone mode uses ARPAbet via a CMUdict file when one is
provided (``load_cmudict``); otherwise character mode — the same model
trains on either unit.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

from . import cleaners, pinyin

_PAD = "_"
_PUNC = "!'(),.:;? "
_LETTERS = "abcdefghijklmnopqrstuvwxyz"
_ARPABET = [
    "AA", "AE", "AH", "AO", "AW", "AY", "B", "CH", "D", "DH", "EH", "ER",
    "EY", "F", "G", "HH", "IH", "IY", "JH", "K", "L", "M", "N", "NG", "OW",
    "OY", "P", "R", "S", "SH", "T", "TH", "UH", "UW", "V", "W", "Y", "Z", "ZH",
]
_SILENCES = ["sp", "spn", "sil"]

# id 0 is padding; characters, @-prefixed ARPAbet phones, @-prefixed Mandarin
# pinyin initials/finals, and @-prefixed silences share one table (reference
# symbols.py: all_symbols = pad + special + punct + letters + arpabet +
# pinyin + silences). Pinyin and silence blocks are appended last so English
# character/phone ids stay stable with or without the Chinese front-end.
# NOTE: appending the blocks grew vocab_size(); checkpoints predating the
# pinyin front-end have a smaller src_embed table and must be retrained (the
# embedding rows for ids < 76 are unchanged, so a shape-aware restore could
# zero-pad instead).
symbols: List[str] = (
    [_PAD]
    + list(_PUNC)
    + list(_LETTERS)
    + [f"@{p}" for p in _ARPABET]
    + [f"@{p}" for p in pinyin.valid_symbols]
    + [f"@{s}" for s in _SILENCES]
)
_symbol_to_id: Dict[str, int] = {s: i for i, s in enumerate(symbols)}

_stress_re = re.compile(r"([A-Z]+)[0-9]?")


def load_cmudict(path: str) -> Dict[str, List[str]]:
    """Parse a cmudict-format file: WORD  P H O N E S (stress digits dropped)."""
    table = {}
    with open(path, encoding="latin-1") as f:
        for line in f:
            if not line or line.startswith(";;;"):
                continue
            parts = line.split()
            if len(parts) < 2:
                continue
            word = parts[0].split("(")[0].lower()
            phones = [_stress_re.sub(r"\1", p) for p in parts[1:]]
            if word not in table and all(p in _ARPABET for p in phones):
                table[word] = phones
    return table


def clean_text(text: str, cleaner: str = "english_cleaners") -> str:
    return getattr(cleaners, cleaner)(text)


def phones_to_sequence(phones: List[str]) -> List[int]:
    """MFA-alignment phone labels → symbol ids.

    MFA emits ARPABET with stress digits (``AH0``) plus silence labels
    (``sp``/``spn``/``sil``); stress is dropped (the table is stress-free,
    matching load_cmudict) and unknown labels map to ``spn``. Used when
    preprocessing consumes real ``.TextGrid`` alignments (reference
    examples/fastspeech2/preprocess.py:74 get_fs2_features).
    """
    seq = []
    for p in phones:
        if p in _SILENCES:
            seq.append(_symbol_to_id[f"@{p}"])
            continue
        bare = _stress_re.sub(r"\1", p.upper())
        if f"@{bare}" in _symbol_to_id:
            seq.append(_symbol_to_id[f"@{bare}"])
        elif p in _symbol_to_id:  # pinyin initial/final labels
            seq.append(_symbol_to_id[p])
        elif f"@{p}" in _symbol_to_id:
            seq.append(_symbol_to_id[f"@{p}"])
        else:
            seq.append(_symbol_to_id["@spn"])
    return seq


def text_to_sequence(
    text: str,
    cleaner: str = "english_cleaners",
    cmudict: Optional[Dict[str, List[str]]] = None,
) -> List[int]:
    """Cleaned text → symbol ids; with ``cmudict`` words become phones."""
    text = clean_text(text, cleaner)
    seq: List[int] = []
    if cmudict:
        for word in text.split(" "):
            bare = re.sub(r"[^a-z']", "", word)
            if bare in cmudict:
                seq.extend(_symbol_to_id[f"@{p}"] for p in cmudict[bare])
            else:
                seq.extend(_symbol_to_id[c] for c in word if c in _symbol_to_id)
            seq.append(_symbol_to_id[" "])
        if seq:
            seq.pop()
    else:
        seq = [_symbol_to_id[c] for c in text if c in _symbol_to_id]
    return seq


def pinyin_to_sequence(text: str) -> List[int]:
    """Tone-numbered Mandarin pinyin text → symbol ids.

    ``"ni3 hao3" → [@n, @i3, @h, @ao3]`` ids. Silence marks (``sp``/``spn``/
    ``sil``) map to their own symbols; punctuation falls through to the
    character table. Counterpart of the reference's pypinyin-based Chinese
    path (reference generate.py:60-66 + text/pinyin.py inventory).
    """
    seq: List[int] = []
    for sym in pinyin.pinyin_to_symbols(text):
        if sym.startswith(pinyin.CHAR_FALLBACK):
            # Non-pinyin token: plain character table only (never phone ids —
            # 'h' the letter must not resolve to @h the Mandarin initial).
            ch = sym[len(pinyin.CHAR_FALLBACK):]
            if ch in _symbol_to_id:
                seq.append(_symbol_to_id[ch])
        else:
            seq.append(_symbol_to_id[f"@{sym}"])
    return seq


def vocab_size() -> int:
    return len(symbols)
