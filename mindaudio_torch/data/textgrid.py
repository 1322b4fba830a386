"""Praat/MFA TextGrid parsing and alignment → duration conversion (the
port's copy of ``mindaudio_tpu.data.textgrid``, pinned to it by
``tests/test_torch_fastspeech2_recipe.py``), for the FastSpeech2 recipe's
preprocessing. Both the long ("full") and the short text formats that
Praat and MFA write are parsed.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

__all__ = ["read_textgrid", "alignment_to_durations"]

Interval = Tuple[float, float, str]

_NUM = r"-?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?"


def _parse_long(text: str) -> Dict[str, List[Interval]]:
    tiers: Dict[str, List[Interval]] = {}
    # split into per-tier blocks at `item [k]:`
    blocks = re.split(r"item\s*\[\d+\]\s*:", text)[1:]
    for block in blocks:
        cls = re.search(r'class\s*=\s*"([^"]*)"', block)
        name = re.search(r'name\s*=\s*"([^"]*)"', block)
        if cls is None or name is None or cls.group(1) != "IntervalTier":
            continue
        intervals: List[Interval] = []
        for m in re.finditer(
            rf'intervals\s*\[\d+\]\s*:\s*'
            rf'xmin\s*=\s*({_NUM})\s*'
            rf'xmax\s*=\s*({_NUM})\s*'
            rf'text\s*=\s*"((?:[^"]|"")*)"',
            block,
        ):
            intervals.append(
                (float(m.group(1)), float(m.group(2)),
                 m.group(3).replace('""', '"').strip())
            )
        tiers[name.group(1)] = intervals
    return tiers


def _parse_short(text: str) -> Dict[str, List[Interval]]:
    # short format: bare tokens, one per line, after the 2 header lines:
    # xmin xmax <exists> n_tiers then per tier: "IntervalTier" "name"
    # xmin xmax n_intervals then n triples xmin xmax "text"
    toks: List[str] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        toks.append(line)
    tiers: Dict[str, List[Interval]] = {}
    i = 0
    # skip to the tier count: first "<exists>" token
    while i < len(toks) and toks[i] != "<exists>":
        i += 1
    if i >= len(toks):
        return tiers
    i += 1
    n_tiers = int(float(toks[i])); i += 1
    for _ in range(n_tiers):
        cls = toks[i].strip('"'); i += 1
        name = toks[i].strip('"'); i += 1
        i += 2  # tier xmin/xmax
        n_int = int(float(toks[i])); i += 1
        intervals: List[Interval] = []
        for _ in range(n_int):
            if cls == "IntervalTier":
                xmin = float(toks[i]); xmax = float(toks[i + 1])
                txt = toks[i + 2].strip('"')
                intervals.append((xmin, xmax, txt.strip()))
                i += 3
            else:  # TextTier (points): number + mark
                i += 2
        if cls == "IntervalTier":
            tiers[name] = intervals
    return tiers


def read_textgrid(path_or_text: str) -> Dict[str, List[Interval]]:
    """Parse a TextGrid file (or its text) → {tier name: [(xmin, xmax, text)]}.

    Only IntervalTiers are returned. Both Praat text formats are handled;
    MFA writes the long one.
    """
    if "\n" in path_or_text or path_or_text.lstrip().startswith("File type"):
        text = path_or_text
    else:
        with open(path_or_text, encoding="utf-8") as f:
            text = f.read()
    if re.search(r"item\s*\[\d*\]?\s*:", text):
        return _parse_long(text)
    return _parse_short(text)


def alignment_to_durations(
    intervals: List[Interval],
    sample_rate: int,
    hop_length: int,
    silence_labels: Tuple[str, ...] = ("sil", "sp", "spn", ""),
    trim_trailing_silence: bool = True,
):
    """MFA phone intervals → (phones, frame durations, start_s, end_s).

    Frame budget follows the FastSpeech2 convention the reference inherits:
    ``d_i = round(xmax_i * sr / hop) - round(xmin_i * sr / hop)`` so the
    total exactly matches the mel frames of the ``[start_s, end_s)`` clip.
    Leading and (optionally) trailing silences are trimmed; internal
    silences are kept as phones (mapped to "sp" when unlabeled).
    """
    phones: List[str] = []
    durs: List[int] = []
    start_s = end_s = 0.0
    # trim leading silence: first non-silence interval starts the clip
    first = 0
    while first < len(intervals) and intervals[first][2] in silence_labels:
        first += 1
    last = len(intervals)
    if trim_trailing_silence:
        while last > first and intervals[last - 1][2] in silence_labels:
            last -= 1
    if first >= last:
        return [], [], 0.0, 0.0
    start_s = intervals[first][0]
    end_s = intervals[last - 1][1]
    for xmin, xmax, text in intervals[first:last]:
        label = text if text not in silence_labels else "sp"
        frames = (round(xmax * sample_rate / hop_length)
                  - round(xmin * sample_rate / hop_length))
        phones.append(label)
        durs.append(max(int(frames), 0))
    return phones, durs, start_s, end_s
