"""The one traffic generator: every mix is a set of parameters in its cell's
``workloads/<cell>.json`` (``traffic``), read here.

A mix is a list of groups, each ``{"count", "min_s", "max_s"}``: so many
utterances whose durations follow the mix's log-normal shape (``median_s``,
``sigma``) cut to ``[min_s, max_s]``. The durations are the shape's
quantiles at ``(i + 0.5) / count`` inside each group, the same for every
seed, so every seed gives the same set of sizes and so the same work; the
seed decides which utterance gets which duration, the waveforms and the
transcripts (``chars_per_s`` characters a second of audio, drawn from the
alphabet the family gives). Waveforms are white noise at a fixed level,
drawn on the device in one call and stored as 16-bit PCM.
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass
from statistics import NormalDist

import numpy as np


@dataclass
class Utt:
    utt_id: str
    samples: np.ndarray  # int16
    text: str


def durations(traffic):
    """The mix's durations in seconds, group by group (seed-independent)."""
    shape = NormalDist()
    median, sigma = float(traffic["median_s"]), float(traffic["sigma"])
    out = []
    for group in traffic["groups"]:
        lo = shape.cdf(math.log(group["min_s"] / median) / sigma)
        hi = shape.cdf(math.log(group["max_s"] / median) / sigma)
        n = int(group["count"])
        out += [median * math.exp(sigma * shape.inv_cdf(lo + (i + 0.5) / n * (hi - lo)))
                for i in range(n)]
    return out


def transcript(rng, alphabet, n_chars, words):
    """``n_chars`` characters of ``alphabet``; with ``words``, split into
    words of 2-8 characters by single spaces (spaces counted)."""
    if not words:
        return "".join(alphabet[i] for i in rng.integers(0, len(alphabet), n_chars))
    out = []
    while len(out) < n_chars:
        if out:
            out.append(" ")
        out += [alphabet[i] for i in rng.integers(0, len(alphabet), int(rng.integers(2, 9)))]
    out = out[:n_chars]
    if out[-1] == " ":  # a word, not a space, ends the transcript
        out[-1] = alphabet[0]
    return "".join(out)


def generate(traffic, alphabet, seed, device, words=False):
    """The mix's utterances for ``seed``: durations permuted by the seed,
    waveforms drawn on ``device`` from a generator seeded with ``seed``."""
    import torch

    rate = int(traffic["sample_rate"])
    durs = durations(traffic)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(durs))
    lengths = [int(round(durs[j] * rate)) for j in order]
    gen = torch.Generator(device=device).manual_seed(seed)
    level = float(traffic["level"]) * 32767.0
    pcm = (torch.randn(sum(lengths), generator=gen, device=device) * level).clamp_(
        -32768, 32767).to(torch.int16).cpu().numpy()
    starts = np.cumsum([0] + lengths)
    cps = float(traffic["chars_per_s"])
    return [Utt(f"utt{i:06d}", pcm[starts[i]:starts[i + 1]],
                transcript(rng, alphabet, max(1, round(cps * n / rate)), words))
            for i, n in enumerate(lengths)]


def write_wav(path, samples, rate):
    """A mono 16-bit PCM RIFF file."""
    data = np.ascontiguousarray(samples, dtype="<i2").tobytes()
    header = struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(data), b"WAVE", b"fmt ", 16,
                         1, 1, rate, 2 * rate, 2, 16, b"data", len(data))
    with open(path, "wb") as f:
        f.write(header)
        f.write(data)
