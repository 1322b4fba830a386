"""DeepSpeech2 LibriSpeech data: padded raw waveforms and character labels
(port of ``examples/deepspeech2/dataset.py``, pinned to it by
``tests/test_torch_ds2_recipe.py``).

The collate pads raw audio into a few frame buckets; the spectrogram and its
per-utterance normalization run on the card inside the train step
(``train.device_features``). Labels are the reference's 29 characters with
``_`` as the CTC blank, padded to ``MAX_LABEL_LEN``.
"""

from __future__ import annotations

import json
import os
from typing import Iterator, List, Tuple

import numpy as np

from ...data import io

__all__ = ["LABELS", "BLANK_ID", "N_FFT", "HOP", "FRAME_BUCKETS", "MAX_LABEL_LEN",
           "read_manifest", "encode_transcript", "batch_iterator"]

LABELS = [
    "'", "A", "B", "C", "D", "E", "F", "G", "H", "I", "J", "K", "L", "M",
    "N", "O", "P", "Q", "R", "S", "T", "U", "V", "W", "X", "Y", "Z", " ", "_",
]
BLANK_ID = LABELS.index("_")
CHAR2ID = {c: i for i, c in enumerate(LABELS)}

SAMPLE_RATE = 16000
WINDOW_SIZE = 0.02   # 20 ms: n_fft 320
WINDOW_STRIDE = 0.01
N_FFT = int(SAMPLE_RATE * WINDOW_SIZE)
HOP = int(SAMPLE_RATE * WINDOW_STRIDE)

FRAME_BUCKETS = (400, 800, 1250, 2000, 3500)
MAX_LABEL_LEN = 350  # the reference's TRAIN_LABEL_PAD_LENGTH


def read_manifest(manifest_json: str) -> List[Tuple[str, str]]:
    """``libri_*_manifest.json`` → ``[(wav_path, txt_path)]``, absolute."""
    with open(manifest_json, encoding="utf-8") as f:
        data = json.load(f)
    root = data["data_path"]
    return [(os.path.join(root, s["wav_path"]), os.path.join(root, s["txt_path"]))
            for s in data["samples"]]


def encode_transcript(txt_path: str) -> np.ndarray:
    """A transcript's characters (upper-cased, unknown ones dropped) as ids."""
    with open(txt_path, encoding="utf-8") as f:
        text = f.read().replace("\n", "")
    return np.asarray([CHAR2ID[c] for c in text.upper() if c in CHAR2ID], np.int32)


def _bucket_for(n_frames: int) -> int:
    for limit in FRAME_BUCKETS:
        if n_frames <= limit:
            return limit
    return FRAME_BUCKETS[-1]


def batch_iterator(manifest_json: str, batch_size: int, epochs: int = 1, seed: int = 0,
                   shuffle: bool = True, drop_last: bool = True, rank: int = 0,
                   world_size: int = 1) -> Iterator[Tuple[int, dict]]:
    """``(epoch, batch)`` of bucketed raw audio, files sorted by size.

    Batches are consecutive groups of the size-sorted files, shuffled each
    epoch with ``default_rng(seed + epoch)``. A batch holds ``wavs (B,
    bucket*HOP) float32``, ``wav_lens``, ``labels (B, MAX_LABEL_LEN)``,
    ``label_lens``, all numpy; with ``drop_last=False`` the last batch is
    padded to ``batch_size`` by repeating its last row and every batch has
    ``n_valid`` (the rows that are not repeats). With ``world_size > 1``
    every rank walks the same batch sequence, takes the bucket from the
    file headers of the whole group (the ranks agree on the global batch's
    shape) and decodes its contiguous ``1 / world_size`` block of rows, as
    the JAX iterator does.
    """
    samples = sorted(read_manifest(manifest_json), key=lambda p: os.path.getsize(p[0]))
    for epoch in range(epochs):
        rng = np.random.default_rng(seed + epoch)
        batches = [samples[i: i + batch_size]
                   for i in range(0, len(samples) - batch_size + 1, batch_size)]
        tail = len(samples) % batch_size
        tail_group_obj = None
        if tail and not drop_last:
            group = samples[-tail:]
            group = group + [group[-1]] * (batch_size - tail)
            batches.append(group)
            tail_group_obj = group
        if shuffle:
            rng.shuffle(batches)
        for group in batches:
            tail_group = group is tail_group_obj
            if world_size > 1:
                max_frames = max([1] + [1 + io.info(w)[0] // HOP for w, _ in group])
                local = len(group) // world_size
                group = group[rank * local:(rank + 1) * local]
            wavs_raw, labels_raw = [], []
            for wav_path, txt_path in group:
                x = np.asarray(io.read(wav_path)[0], np.float32)
                if x.ndim > 1:
                    x = x[:, 0]
                wavs_raw.append(x)
                labels_raw.append(encode_transcript(txt_path))
            if world_size == 1:
                max_frames = max([1] + [1 + len(x) // HOP for x in wavs_raw])
            wav_len = _bucket_for(max_frames) * HOP
            wavs = np.zeros((len(group), wav_len), np.float32)
            wav_lens = np.zeros((len(group),), np.int32)
            labels = np.zeros((len(group), MAX_LABEL_LEN), np.int32)
            label_lens = np.zeros((len(group),), np.int32)
            for i, (x, y) in enumerate(zip(wavs_raw, labels_raw)):
                n = min(len(x), wav_len)
                wavs[i, :n] = x[:n]
                wav_lens[i] = n
                m = min(len(y), MAX_LABEL_LEN)
                labels[i, :m] = y[:m]
                label_lens[i] = m
            out = {"wavs": wavs, "wav_lens": wav_lens, "labels": labels, "label_lens": label_lens}
            if not drop_last:
                out["n_valid"] = tail if tail_group else batch_size
            yield epoch, out
