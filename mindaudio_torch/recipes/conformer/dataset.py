"""Conformer ASR data pipeline: bucketed batches of raw waveforms (port of
``examples/conformer/dataset.py``).

The collate only reads, pads and tokenizes on the host; the fbank, dither,
SpecAugment and CMVN run on the card inside the train step (``train.py``).
Length buckets bound the set of batch shapes. Audio is read by the native
batch loader (``_native.wav_read_batch``, a C++ thread pool) when no speed
perturbation is asked and every file is 16 kHz, else file by file through
``data.io.read``, as the JAX recipe does.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence

import numpy as np

from ... import _native
from ...data import io
from ...data.processing import resample
from ...utils.common import IGNORE_ID, add_sos_eos, pad_sequence
from ...utils.tokenizer import CharTokenizer

SAMPLE_RATE = 16000
FRAME_SHIFT = 160   # 10 ms
FRAME_LEN = 400     # 25 ms


@dataclass
class Utt:
    utt_id: str
    wav: str
    duration: float
    text: str


def read_manifest(csv_path: str) -> List[Utt]:
    """An AISHELL-style ``ID,duration,wav,transcript`` CSV."""
    with open(csv_path, encoding="utf-8") as f:
        return [Utt(row["ID"], row["wav"], float(row["duration"]), row["transcript"])
                for row in csv.DictReader(f)]


class BucketSampler:
    """Sort-by-duration length bucketing with a batch size per bucket.

    ``frame_bucket_limit[i]`` is the largest fbank frame count of bucket i and
    ``batch_bucket_limit[i]`` its batch size (scaled by ``batch_factor``,
    at least 1). Utterances longer than
    the last bucket are dropped, as are the tails that do not fill a batch.
    """

    # the 4x-subsampled length t_sub = (frames//2 - 1)//2 of each limit is a
    # multiple of 8 (56, 104, ..., 752)
    DEFAULT_FRAME_BUCKETS = (227, 419, 611, 803, 1027, 1219, 1507, 2019, 3011)
    DEFAULT_BATCH_BUCKETS = (96, 64, 48, 32, 24, 16, 12, 8, 4)

    def __init__(self, utts: Sequence[Utt], frame_bucket_limit=DEFAULT_FRAME_BUCKETS,
                 batch_bucket_limit=DEFAULT_BATCH_BUCKETS, batch_factor: float = 1.0,
                 shuffle: bool = True, seed: int = 0, rank: int = 0,
                 world_size: int = 1, batch_multiple: int = 1):
        if len(frame_bucket_limit) != len(batch_bucket_limit):
            raise ValueError("BucketSampler: one batch size a frame bucket")
        self.frame_bucket_limit = list(frame_bucket_limit)
        # a multiple of the data axis (times the microbatches), so every
        # batch splits evenly, as in the JAX sampler
        self.batch_bucket_limit = [max(batch_multiple, int(b * batch_factor) // batch_multiple
                                       * batch_multiple) for b in batch_bucket_limit]
        self.shuffle, self.seed = shuffle, seed
        self.rank, self.world_size = rank, world_size

        buckets: List[List[Utt]] = [[] for _ in frame_bucket_limit]
        for u in sorted(utts, key=lambda u: u.duration):
            n_frames = 1 + int(u.duration * SAMPLE_RATE - FRAME_LEN) // FRAME_SHIFT
            for i, limit in enumerate(self.frame_bucket_limit):
                if n_frames <= limit:
                    buckets[i].append(u)
                    break
        self.buckets = buckets

    def __iter__(self) -> Iterator[tuple]:
        """``(bucket_idx, [Utt])`` batches. Every rank walks the same
        seeded sequence of batches and takes its contiguous ``1/world_size``
        block of rows, so that all ranks hold one bucket's shape."""
        rng = np.random.default_rng(self.seed)
        batches = []
        for i, bucket in enumerate(self.buckets):
            order = rng.permutation(len(bucket)) if self.shuffle else range(len(bucket))
            bs = self.batch_bucket_limit[i]
            chunk = []
            for j in order:
                chunk.append(bucket[j])
                if len(chunk) == bs:
                    batches.append((i, chunk))
                    chunk = []
        if self.shuffle:
            rng.shuffle(batches)
        for i, chunk in batches:
            if self.world_size > 1:
                local = len(chunk) // self.world_size
                chunk = chunk[self.rank * local:(self.rank + 1) * local]
            yield i, chunk

    def __len__(self):
        return sum(len(b) // bs for b, bs in zip(self.buckets, self.batch_bucket_limit))


def _read_one_by_one(utts, wav_len, speed_perturb, rng):
    """The batch's audio through ``data.io.read``: first channel, resampled
    to 16 kHz, speed-perturbed when asked, cut and zero-padded to
    ``wav_len``."""
    wavs = np.zeros((len(utts), wav_len), np.float32)
    wav_lens = np.zeros((len(utts),), np.int32)
    for i, u in enumerate(utts):
        x, sr = io.read(u.wav)
        x = np.asarray(x, np.float32)
        if x.ndim > 1:
            x = x[:, 0]
        if sr != SAMPLE_RATE:
            x = resample(x, sr, SAMPLE_RATE)
        if speed_perturb:
            speed = rng.choice([0.9, 1.0, 1.1])
            if speed != 1.0:
                x = resample(x, int(SAMPLE_RATE * speed), SAMPLE_RATE)
        n = min(len(x), wav_len)
        wavs[i, :n] = x[:n]
        wav_lens[i] = n
    return wavs, wav_lens


def collate(utts: Sequence[Utt], tokenizer: CharTokenizer, bucket_frames: int,
            max_label_len: int = 30, speed_perturb: bool = False,
            rng: Optional[np.random.Generator] = None):
    """Read and pad raw audio and tokenize the labels into the model's batch
    dict of numpy arrays.

    Audio is padded to the bucket's length ``bucket_frames * FRAME_SHIFT +
    FRAME_LEN`` and shipped as int16 PCM (half the bytes of float32;
    ``kaldi_fbank`` takes integer samples as they are). Without speed
    perturbation the batch is read by ``_native.wav_read_batch`` and kept
    when every file is 16 kHz (a failed build of the loader raises); else
    file by file, speed perturbation (0.9/1.0/1.1) resampling before the
    padding, as it changes the length.
    """
    rng = rng or np.random.default_rng()
    wav_len = bucket_frames * FRAME_SHIFT + FRAME_LEN
    batch = None
    if not speed_perturb:
        wavs, wav_lens, rates = _native.wav_read_batch([u.wav for u in utts], wav_len)
        if (rates == SAMPLE_RATE).all():
            batch = wavs, wav_lens
    wavs, wav_lens = batch or _read_one_by_one(utts, wav_len, speed_perturb, rng)

    labels = [np.asarray(tokenizer.encode(u.text), np.int32) for u in utts]
    wavs = np.clip(np.round(wavs * 32768.0), -32768, 32767).astype(np.int16)

    ys_pad = pad_sequence(labels, padding_value=IGNORE_ID, max_len=max_label_len)
    ys_in, ys_out = add_sos_eos(ys_pad, tokenizer.sos, tokenizer.eos)
    label_lens = np.asarray([min(len(l), max_label_len) for l in labels], np.int32)
    return {
        "wavs": wavs,
        "wav_lens": wav_lens,
        "labels": np.where(ys_pad == IGNORE_ID, 0, ys_pad).astype(np.int32),
        "label_lens": label_lens,
        "ys_in": ys_in.astype(np.int32),
        "ys_out": ys_out.astype(np.int32),
        "ys_lens": label_lens + 1,
    }


def batch_iterator(manifest_csv: str, tokenizer: CharTokenizer, epochs: int = 1, seed: int = 0,
                   rank: int = 0, world_size: int = 1, speed_perturb: bool = True,
                   batch_factor: float = 1.0, max_label_len: int = 30,
                   frame_bucket_limit=None, batch_bucket_limit=None, batch_multiple: int = 1):
    """Epoch-looped stream of ``(epoch, bucket_frames, batch dict)``; epoch
    ``e`` shuffles with seed ``seed + e``."""
    utts = read_manifest(manifest_csv)
    buckets = {}
    if frame_bucket_limit is not None:
        buckets["frame_bucket_limit"] = [int(f) for f in frame_bucket_limit]
    if batch_bucket_limit is not None:
        buckets["batch_bucket_limit"] = [int(b) for b in batch_bucket_limit]
    for epoch in range(epochs):
        sampler = BucketSampler(utts, shuffle=True, seed=seed + epoch, rank=rank,
                                world_size=world_size, batch_factor=batch_factor,
                                batch_multiple=batch_multiple, **buckets)
        rng = np.random.default_rng(seed + epoch)
        for bucket_idx, batch_utts in sampler:
            frames = sampler.frame_bucket_limit[bucket_idx]
            yield epoch, frames, collate(batch_utts, tokenizer, frames,
                                         max_label_len=max_label_len,
                                         speed_perturb=speed_perturb, rng=rng)
