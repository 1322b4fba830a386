"""ECAPA-TDNN data: 3 s waveform crops with speaker labels, augmented on the
host (port of ``examples/ECAPA-TDNN/dataset.py``, pinned to it by
``tests/test_torch_ecapa_recipe.py``).

The collate reads each row's audio, takes a random ``seg_dur`` crop and runs
the waveform augmentation (speed perturbation, ``drop_freq``,
``drop_chunk``, and noise and reverberation when their folders are set) in
NumPy with one ``np.random.Generator``, so the same seeds give the same
batches as the JAX recipe; the fbank runs on the card inside the train step.
"""

from __future__ import annotations

import csv
import glob
import os
from typing import Iterator, Optional

import numpy as np

from ...data import io
from ...data.augment import add_noise, add_reverb, drop_chunk, drop_freq, speed_perturb

__all__ = ["SAMPLE_RATE", "read_segments", "Augmenter", "load_segment", "batch_iterator",
           "n_speakers"]

SAMPLE_RATE = 16000


def read_segments(csv_path: str):
    """``ID,duration,wav,start,stop,spk_id`` rows and ``{spk_id: label}``
    (speakers sorted)."""
    with open(csv_path, encoding="utf-8") as f:
        rows = list(csv.DictReader(f))
    spk_ids = sorted({r["spk_id"] for r in rows})
    spk2label = {s: i for i, s in enumerate(spk_ids)}
    return rows, spk2label


class Augmenter:
    """Waveform augmentation of a ``(B, L)`` batch as ``cfg.augment`` and
    ``cfg.data`` say, with ``rng``: one speed for the whole batch (95, 100
    or 105%, cropped or zero-padded back to ``L``), reverberation and noise
    from the WAVs of ``data.rir_folder``/``data.noise_folder`` when set,
    then ``drop_freq`` and ``drop_chunk``. Returns float32."""

    def __init__(self, cfg, rng: np.random.Generator):
        self.cfg = cfg
        self.rng = rng
        self.noises = sorted(glob.glob(os.path.join(cfg.data.noise_folder, "*.wav"))) \
            if cfg.data.noise_folder else []
        self.rirs = sorted(glob.glob(os.path.join(cfg.data.rir_folder, "*.wav"))) \
            if cfg.data.rir_folder else []

    def __call__(self, batch: np.ndarray) -> np.ndarray:
        cfg, rng = self.cfg, self.rng
        out = batch
        if cfg.augment.speed_perturb:
            speed = rng.choice([95, 100, 105])
            if speed != 100:
                n = out.shape[-1]
                res = speed_perturb(out, SAMPLE_RATE, speeds=(int(speed),), rng=rng)
                fixed = np.zeros_like(out)
                m = min(n, res.shape[-1])
                fixed[..., :m] = res[..., :m]
                out = fixed
        if self.rirs:
            out = add_reverb(out, self.rirs, reverb_prob=1.0, rng=rng)
        if self.noises:
            out = add_noise(out, self.noises, 0, 15, mix_prob=1.0, rng=rng)
        if cfg.augment.drop_freq:
            out = drop_freq(out, rng=rng)
        if cfg.augment.drop_chunk:
            lengths = np.full((out.shape[0],), out.shape[-1])
            out = drop_chunk(out, lengths, rng=rng)
        return out.astype(np.float32)


def load_segment(row, seg_len: int, rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """The row's audio fitted to ``seg_len`` samples: the ``start:stop``
    span (the whole file when ``stop <= start``), then a random crop with
    ``rng`` or the first ``seg_len`` samples without, zero-padded."""
    start, stop = int(row["start"]), int(row["stop"])
    if stop > start:
        x, sr = io.read(row["wav"], offset=start / SAMPLE_RATE,
                        duration=(stop - start) / SAMPLE_RATE)
    else:
        x, sr = io.read(row["wav"])
    x = np.asarray(x, np.float32)
    if x.ndim > 1:
        x = x[:, 0]
    if rng is not None and len(x) > seg_len:
        off = int(rng.integers(0, len(x) - seg_len + 1))
        x = x[off:off + seg_len]
    out = np.zeros(seg_len, np.float32)
    n = min(len(x), seg_len)
    out[:n] = x[:n]
    return out


def batch_iterator(csv_path: str, batch_size: int, seg_dur: float = 3.0, epochs: int = 1,
                   seed: int = 0, augmenter: Optional[Augmenter] = None,
                   shuffle: bool = True, rank: int = 0,
                   world_size: int = 1) -> Iterator[tuple]:
    """``(epoch, {"wavs": (B, L) float32, "labels": (B,) int32})``: each
    epoch's rows shuffled by ``default_rng(seed + epoch)`` (which also draws
    the crops), the last partial batch dropped. With ``world_size > 1``
    every rank walks the same batch sequence and loads its contiguous
    ``1 / world_size`` block of rows (its crops and augmentation drawn from
    its own stream), as the JAX iterator does."""
    rows, spk2label = read_segments(csv_path)
    seg_len = int(seg_dur * SAMPLE_RATE)
    for epoch in range(epochs):
        rng = np.random.default_rng(seed + epoch)
        order = rng.permutation(len(rows)) if shuffle else np.arange(len(rows))
        sel = order[: (len(order) // batch_size) * batch_size].reshape(-1, batch_size)
        for batch_idx in sel:
            if world_size > 1:
                local = batch_size // world_size
                batch_idx = batch_idx[rank * local:(rank + 1) * local]
            wavs = np.stack([load_segment(rows[i], seg_len, rng=rng) for i in batch_idx])
            labels = np.asarray([spk2label[rows[i]["spk_id"]] for i in batch_idx], np.int32)
            if augmenter is not None:
                wavs = augmenter(wavs)
            yield epoch, {"wavs": wavs, "labels": labels}


def n_speakers(csv_path: str) -> int:
    return len(read_segments(csv_path)[1])
