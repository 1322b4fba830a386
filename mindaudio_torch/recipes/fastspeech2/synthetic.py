"""A synthetic corpus in LJSpeech's layout for the FastSpeech2 recipe (LJSpeech,
CMUdict and MFA alignments are not in the repository).

:func:`gen` writes ``<root>/LJSpeech-1.1/metadata.csv`` (``id|text|text``) and
``wavs/<id>.wav`` (float32 at 22.05 kHz), and for every other utterance an
MFA-style long-format ``<root>/features/TextGrid/<id>.TextGrid`` whose
"phones" tier aligns ARPAbet phones (vowels with a stress digit, a few
internal ``sp`` pauses) between leading and trailing ``sil``; the rest go
through the preprocessing's uniform split of the transcript's characters.
Each phone is a few harmonics of its own f0 held for its own number of
hops, so the features carry learnable structure. Utterances run from 40 to
199 phones, up to about 1,100 frames of hop 256: the longest pass the
recipe's 160 phonemes and 1000 frames, so the truncation and the duration
clamp run. Everything comes from ``seed``.

Usage::

    python -m mindaudio_torch.recipes.fastspeech2.synthetic --root DIR [--utts 96]

then ``preprocess`` with ``--data.ljspeech_dir DIR/LJSpeech-1.1
--data.feature_dir DIR/features``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ...data import io
from .text import _ARPABET

SR, HOP = 22050, 256
LEAD_S = 0.25  # leading and trailing silence, trimmed by the alignment
_VOWELS = {p for p in _ARPABET if p[0] in "AEIOU"}
_WORDS = ["Dr. Smith paid 42 dollars", "the 3rd of May", "Mr. Jones", "1,250 people"]


def phone_rule(p):
    """``(frames, f0 Hz)`` of ARPAbet phone index ``p``: 3-8 hops, 110-213 Hz."""
    return 3 + (p * 7) % 6, 110.0 * 2.0 ** (((p * 5) % 13) / 13.0)


def _audio(rng, spans):
    """Float32 audio of ``spans``, ``(n_samples, f0 or 0 for silence)``: six
    harmonics of the phone's f0, raised-cosine edges, a little noise."""
    f0 = np.concatenate([np.full(n, f) for n, f in spans])
    phase = 2 * np.pi * np.cumsum(f0) / SR
    x = sum(np.sin(k * phase) / k for k in range(1, 7)) * 0.3
    x *= f0 > 0
    edge = int(0.005 * SR)
    pos = 0
    for n, _ in spans:
        ramp = 0.5 - 0.5 * np.cos(np.pi * np.arange(min(edge, n // 2)) / edge)
        x[pos:pos + len(ramp)] *= ramp
        x[pos + n - len(ramp):pos + n] *= ramp[::-1]
        pos += n
    return (x + 0.003 * rng.standard_normal(len(x))).astype(np.float32)


def _textgrid(intervals, total):
    """MFA's long TextGrid text with one "phones" tier of ``(xmin, xmax,
    label)``."""
    lines = ['File type = "ooTextFile"', 'Object class = "TextGrid"', "",
             "xmin = 0", f"xmax = {total}", "tiers? <exists>", "size = 1", "item []:",
             "    item [1]:", '        class = "IntervalTier"', '        name = "phones"',
             "        xmin = 0", f"        xmax = {total}",
             f"        intervals: size = {len(intervals)}"]
    for i, (a, b, label) in enumerate(intervals, 1):
        lines += [f"        intervals [{i}]:", f"            xmin = {a}",
                  f"            xmax = {b}", f'            text = "{label}"']
    return "\n".join(lines) + "\n"


def _transcript(rng, n_chars):
    """About ``n_chars`` characters of words, with a number or an
    abbreviation for the cleaners."""
    words = [str(rng.choice(_WORDS))]
    while sum(len(w) + 1 for w in words) < n_chars:
        words.append("".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz"),
                                        size=int(rng.integers(2, 9)))))
    return " ".join(words) + "."


def gen(root, n_utts=96, seed=0):
    """Write the corpus under ``root``; returns ``(ljspeech_dir,
    feature_dir)``."""
    rng = np.random.default_rng(seed)
    lj = os.path.join(root, "LJSpeech-1.1")
    feature_dir = os.path.join(root, "features")
    os.makedirs(os.path.join(lj, "wavs"), exist_ok=True)
    os.makedirs(os.path.join(feature_dir, "TextGrid"), exist_ok=True)
    lead = int(LEAD_S * SR)
    meta = []
    for i in range(n_utts):
        utt = f"LJ{i // 100 + 1:03d}-{i % 100:04d}"
        idx = rng.integers(0, len(_ARPABET), size=int(rng.integers(40, 200)))
        spans, intervals, t = [(lead, 0.0)], [(0.0, LEAD_S, "sil")], lead
        for j, p in enumerate(idx):
            if j and rng.random() < 0.05:  # an internal pause
                spans.append((2 * HOP, 0.0))
                intervals.append((t / SR, (t + 2 * HOP) / SR, "sp"))
                t += 2 * HOP
            frames, f0 = phone_rule(int(p))
            label = _ARPABET[p] + (str(rng.integers(0, 3)) if _ARPABET[p] in _VOWELS else "")
            spans.append((frames * HOP, f0))
            intervals.append((t / SR, (t + frames * HOP) / SR, label))
            t += frames * HOP
        spans.append((lead, 0.0))
        intervals.append((t / SR, (t + lead) / SR, "sil"))
        io.write(os.path.join(lj, "wavs", utt + ".wav"), _audio(rng, spans), SR)
        text = _transcript(rng, len(idx))
        meta.append(f"{utt}|{text}|{text}")
        if i % 2 == 0:
            with open(os.path.join(feature_dir, "TextGrid", utt + ".TextGrid"), "w",
                      encoding="utf-8") as f:
                f.write(_textgrid(intervals, (t + lead) / SR))
    with open(os.path.join(lj, "metadata.csv"), "w", encoding="utf-8") as f:
        f.write("\n".join(meta) + "\n")
    return lj, feature_dir


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--utts", type=int, default=96)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    lj, feature_dir = gen(args.root, args.utts, args.seed)
    print(f"wrote {args.utts} utterances to {lj}, alignments to {feature_dir}/TextGrid")


if __name__ == "__main__":
    main()
