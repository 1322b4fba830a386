"""FastSpeech2 feature batches: padded phoneme/mel/pitch/energy/duration
(the port's copy of ``examples/fastspeech2/dataset.py``, pinned to it by
``tests/test_torch_fastspeech2_recipe.py``).

The length regulator expands phonemes to frames on the device under a static
``max_mel_len`` bound, so batches carry the compact phoneme sequences; the
durations are clamped into that bound here.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np


def batch_iterator(
    feature_dir: str,
    batch_size: int,
    max_phoneme_len: int,
    max_mel_len: int,
    epochs: int = 1,
    seed: int = 0,
    rank: int = 0,
    world_size: int = 1,
    shuffle: bool = True,
) -> Iterator[tuple]:
    """Yields (epoch, batch dict) with static shapes:
    ``phonemes (B, Lp)``, ``src_lens (B,)``, ``mel (B, Tm, n_mels)``,
    ``pitch/energy/duration (B, Lp)``."""
    with open(os.path.join(feature_dir, "train.txt"), encoding="utf-8") as f:
        utts = [line.strip() for line in f if line.strip()]

    for epoch in range(epochs):
        rng = np.random.default_rng(seed + epoch)
        order = rng.permutation(len(utts)) if shuffle else np.arange(len(utts))
        sel = order[: (len(order) // batch_size) * batch_size].reshape(-1, batch_size)
        # data parallel over processes: the same batch sequence on every
        # rank, each rank loading its contiguous 1/world_size block of rows
        for batch_idx in sel:
            if world_size > 1:
                local = batch_size // world_size
                batch_idx = batch_idx[rank * local:(rank + 1) * local]
            samples = [
                np.load(os.path.join(feature_dir, utts[i] + ".npy"),
                        allow_pickle=True).item()
                for i in batch_idx
            ]
            n_mels = samples[0]["mel"].shape[-1]
            b = len(samples)
            phonemes = np.zeros((b, max_phoneme_len), np.int32)
            src_lens = np.zeros((b,), np.int32)
            mel = np.zeros((b, max_mel_len, n_mels), np.float32)
            pitch = np.zeros((b, max_phoneme_len), np.float32)
            energy = np.zeros((b, max_phoneme_len), np.float32)
            duration = np.zeros((b, max_phoneme_len), np.int32)
            for i, s in enumerate(samples):
                L = min(len(s["phonemes"]), max_phoneme_len)
                phonemes[i, :L] = s["phonemes"][:L]
                src_lens[i] = L
                pitch[i, :L] = s["pitch"][:L]
                energy[i, :L] = s["energy"][:L]
                d = s["duration"][:L].astype(np.int64)
                # clamp total duration into the static mel bound
                cum = np.cumsum(d)
                d = np.where(cum <= max_mel_len, d,
                             np.maximum(max_mel_len - (cum - d), 0))
                duration[i, :L] = d
                t = min(int(d.sum()), max_mel_len, s["mel"].shape[0])
                mel[i, :t] = s["mel"][:t]
            yield epoch, {
                "phonemes": phonemes, "src_lens": src_lens, "mel": mel,
                "pitch": pitch, "energy": energy, "duration": duration,
            }
