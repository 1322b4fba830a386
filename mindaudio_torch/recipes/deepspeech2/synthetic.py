"""A synthetic corpus in LibriSpeech's layout, for running the recipe where
LibriSpeech is not at hand.

Each utterance is a random transcript of the recipe's characters spoken as
a tone sequence: every character holds an equal share of the utterance at a
frequency of its own (a space is silence), plus faint noise. :func:`gen`
writes the extracted-tarball tree (``<speaker>/<chapter>/<utt>.wav`` beside
``<speaker>-<chapter>.trans.txt``) and lays each split out through
``data/librispeech.build_split``, as ``create_json_dict`` lays out the
real tarballs.

Usage::

    python -m mindaudio_torch.recipes.deepspeech2.synthetic --root DIR
"""

from __future__ import annotations

import argparse
import os
import shutil

import numpy as np

from ...data import io
from ...data.librispeech import build_split
from .dataset import HOP, LABELS, MAX_LABEL_LEN, SAMPLE_RATE

__all__ = ["TRAIN_FRAMES", "TEST_FRAMES", "gen"]

# frame ranges, one per group of utterances: batches of the size-sorted
# files of a group fall into the buckets 800, 1250 and 2000 (train) and 3500
# (test)
TRAIN_FRAMES = ((700, 800), (1150, 1250), (1900, 2000))
TEST_FRAMES = ((1200, 3500),)
CHARS = LABELS[:28]  # the blank is not spoken


def _utterance(rng, frames):
    """``(waveform float32, transcript)`` of ``frames`` 10 ms frames."""
    n_samples = (frames - 1) * HOP + int(rng.integers(0, HOP))
    n_chars = int(rng.integers(frames // 10, min(MAX_LABEL_LEN, frames // 6) + 1))
    ids = rng.integers(1, 27, n_chars)  # letters
    space = rng.random(n_chars) < 0.15
    space[1:] &= ~space[:-1]  # single spaces between words, none at the ends
    space[[0, -1]] = False
    ids[space] = 27
    bounds = np.linspace(0, n_samples, n_chars + 1).astype(int)
    t = np.arange(n_samples) / SAMPLE_RATE
    wav = 0.01 * rng.standard_normal(n_samples)
    for c, lo, hi in zip(ids, bounds[:-1], bounds[1:]):
        if c != 27:
            wav[lo:hi] += 0.3 * np.sin(2 * np.pi * (150.0 + 40.0 * c) * t[lo:hi])
    return wav.astype(np.float32), "".join(CHARS[c] for c in ids)


def _write_tree(root, rng, n, frame_ranges):
    """``n`` utterances per frame range, a chapter of each speaker a range."""
    for g, (lo, hi) in enumerate(frame_ranges):
        chapter = os.path.join(root, str(100 + g), "1")
        os.makedirs(chapter)
        lines = []
        for i in range(n):
            wav, text = _utterance(rng, int(rng.integers(lo, hi + 1)))
            utt = f"{100 + g}-1-{i:04d}"
            io.write(os.path.join(chapter, utt + ".wav"),
                     np.round(wav * 32767).astype(np.int16), SAMPLE_RATE)
            lines.append(f"{utt} {text}\n")
        with open(os.path.join(chapter, f"{100 + g}-1.trans.txt"), "w", encoding="utf-8") as f:
            f.writelines(lines)


def gen(root, n_train=64, n_test=64, seed=0, train_frames=TRAIN_FRAMES, test_frames=TEST_FRAMES):
    """Write ``n_train`` utterances per range of ``train_frames`` and
    ``n_test`` per range of ``test_frames`` under ``root``; returns the
    paths of the train and test (``test_clean``) manifests."""
    rng = np.random.default_rng(seed)
    manifests = []
    for split, n, frames in (("train", n_train, train_frames), ("test_clean", n_test, test_frames)):
        extracted = os.path.join(root, "LibriSpeech", split)
        _write_tree(extracted, rng, n, frames)
        manifests.append(build_split([extracted], os.path.join(root, split), split))
        shutil.rmtree(extracted)
    return tuple(manifests)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", required=True)
    parser.add_argument("--n_train", type=int, default=64)
    parser.add_argument("--n_test", type=int, default=64)
    parser.add_argument("--seed", type=int, default=0)
    a = parser.parse_args()
    print(gen(a.root, a.n_train, a.n_test, a.seed))
