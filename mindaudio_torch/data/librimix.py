"""LibriMix / wsj0-2mix style separation data: JSON lists and the batch
iterator (the port's copy of ``mindaudio_tpu.data.librimix``, pinned to it
by ``tests/test_torch_separation_recipe.py``: the same seed gives the same
batches).

Each split has ``mix.json``, ``s1.json`` and ``s2.json``, lists of
``[wav_path, n_samples]`` pairs, as the reference's
``examples/tasnet/preprocess.py`` writes them.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Iterator, Optional, Sequence

import numpy as np

from . import io

__all__ = ["preprocess_librimix", "separation_batch_iterator"]


def preprocess_librimix(in_dir: str, out_dir: str,
                        splits=("tr", "cv", "tt"),
                        parts=("mix", "s1", "s2")):
    """Scan ``<in_dir>/<split>/<part>/*.wav`` into ``<out_dir>/<split>/<part>.json``."""
    for split in splits:
        split_out = os.path.join(out_dir, split)
        os.makedirs(split_out, exist_ok=True)
        for part in parts:
            entries = []
            for wav in sorted(glob.glob(os.path.join(in_dir, split, part, "*.wav"))):
                signal, _ = io.read(wav)
                entries.append([wav, int(np.asarray(signal).shape[0])])
            with open(os.path.join(split_out, f"{part}.json"), "w") as f:
                json.dump(entries, f)


def _load(path: str) -> np.ndarray:
    x, _ = io.read(path)
    x = np.asarray(x, np.float32)
    return x[:, 0] if x.ndim > 1 else x


def separation_batch_iterator(
    json_dir: str,
    batch_size: int,
    segment_len: int,
    epochs: int = 1,
    seed: int = 0,
    rank: int = 0,
    world_size: int = 1,
    shuffle: bool = True,
    sources: Sequence[str] = ("s1", "s2"),
) -> Iterator[tuple]:
    """Yields ``(epoch, {"mix": (B, T), "src": (B, C, T), "lengths": (B,)})``.

    Utterances shorter than ``segment_len`` are zero-padded (valid length in
    ``lengths``); longer ones are cropped at a random (train) / zero (eval)
    offset — fixed shapes keep one jit signature.
    """
    with open(os.path.join(json_dir, "mix.json")) as f:
        mix_list = json.load(f)
    src_lists = []
    for s in sources:
        with open(os.path.join(json_dir, f"{s}.json")) as f:
            src_lists.append(json.load(f))
    n = len(mix_list)
    assert all(len(sl) == n for sl in src_lists)

    for epoch in range(epochs):
        rng = np.random.default_rng(seed + epoch)
        order = rng.permutation(n) if shuffle else np.arange(n)
        sel = order[: (n // batch_size) * batch_size].reshape(-1, batch_size)
        # several processes: the same batch sequence on every rank, each
        # rank loading its contiguous 1/world_size block of rows
        for batch_idx in sel:
            if world_size > 1:
                local = batch_size // world_size
                batch_idx = batch_idx[rank * local:(rank + 1) * local]
            mix = np.zeros((len(batch_idx), segment_len), np.float32)
            src = np.zeros((len(batch_idx), len(sources), segment_len), np.float32)
            lengths = np.zeros((len(batch_idx),), np.int32)
            for bi, i in enumerate(batch_idx):
                m = _load(mix_list[i][0])
                ss = [_load(sl[i][0]) for sl in src_lists]
                t = min(len(m), *(len(s) for s in ss))
                if t > segment_len:
                    off = rng.integers(0, t - segment_len + 1) if shuffle else 0
                    m = m[off: off + segment_len]
                    ss = [s[off: off + segment_len] for s in ss]
                    t = segment_len
                mix[bi, :t] = m[:t]
                for ci, s in enumerate(ss):
                    src[bi, ci, :t] = s[:t]
                lengths[bi] = t
            yield epoch, {"mix": mix, "src": src, "lengths": lengths}
