"""The DeepSpeech2 recipe's first batches worked out again from the corpus
on disk: the order its iterator walks (a frozen copy of it) and the padding
and labelling of its collate, reading the WAV files as raw 16-bit PCM.
"""

from __future__ import annotations

import json
import os

import numpy as np


def read_pcm(path):
    """The samples of a mono 16-bit PCM RIFF file (its ``data`` chunk)."""
    with open(path, "rb") as f:
        raw = f.read()
    pos = 12
    while pos + 8 <= len(raw):
        tag, size = raw[pos:pos + 4], int.from_bytes(raw[pos + 4:pos + 8], "little")
        if tag == b"data":
            return np.frombuffer(raw[pos + 8:pos + 8 + size], dtype="<i2").astype(np.int16)
        pos += 8 + size + (size & 1)
    raise ValueError(f"{path}: no data chunk")


DS2_LABELS = "'ABCDEFGHIJKLMNOPQRSTUVWXYZ _"


def ds2_batches(manifest_json, seed, batch_size, frame_buckets, max_label_len, n):
    """The first ``n`` batches of epoch 0 of the DeepSpeech2 recipe's
    iterator (seed ``seed``): files sorted by size, consecutive groups of
    ``batch_size`` (a short tail dropped), the groups shuffled; audio as
    float32 in [-1, 1) padded to the smallest frame bucket that holds the
    group's longest (``1 + samples // 160`` frames), transcripts upper-cased
    as character ids, unknown characters dropped, cut to
    ``max_label_len``."""
    with open(manifest_json, encoding="utf-8") as f:
        data = json.load(f)
    root = data["data_path"]
    samples = [(os.path.join(root, s["wav_path"]), os.path.join(root, s["txt_path"]))
               for s in data["samples"]]
    samples.sort(key=lambda s: os.path.getsize(s[0]))
    groups = [samples[i:i + batch_size]
              for i in range(0, len(samples) - batch_size + 1, batch_size)]
    np.random.default_rng(seed).shuffle(groups)
    out = []
    for group in groups[:n]:
        xs = [read_pcm(w).astype(np.float32) / 32768.0 for w, _ in group]
        longest = max(1 + len(x) // 160 for x in xs)
        wav_len = next((f for f in frame_buckets if longest <= f), frame_buckets[-1]) * 160
        b = len(group)
        wavs = np.zeros((b, wav_len), np.float32)
        wav_lens = np.zeros(b, np.int64)
        labels = np.zeros((b, max_label_len), np.int64)
        label_lens = np.zeros(b, np.int64)
        for r, (x, (_, txt)) in enumerate(zip(xs, group)):
            x = x[:wav_len]
            wavs[r, :len(x)], wav_lens[r] = x, len(x)
            with open(txt, encoding="utf-8") as f:
                text = f.read().replace("\n", "").upper()
            y = [DS2_LABELS.index(c) for c in text if c in DS2_LABELS][:max_label_len]
            labels[r, :len(y)], label_lens[r] = y, len(y)
        out.append({"wavs": wavs, "wav_lens": wav_lens, "labels": labels,
                    "label_lens": label_lens})
    return out
