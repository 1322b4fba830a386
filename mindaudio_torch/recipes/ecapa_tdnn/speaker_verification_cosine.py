"""Speaker verification: cosine scoring, optional adaptive s-norm, and the EER
(port of ``examples/ECAPA-TDNN/speaker_verification_cosine.py``).

Enrol and test utterances are embedded whole on the card: each is padded to
the next multiple of 2 s (at most 40 s) and batched 16 a bucket, with the
pooling masked to its length. Scoring runs on the host, as in the JAX
recipe: the global mean of the trial and cohort embeddings is taken out,
each trial is the cosine of its two sides, and with ``eval.score_norm`` each
side is normalized against its ``eval.cohort_size`` best-scoring cohort
embeddings (training utterances, round robin over the speakers).

Usage::

    python -m mindaudio_torch.recipes.ecapa_tdnn.speaker_verification_cosine \\
        [--config ecapatdnn.yaml] [--device cuda] [--train.ckpt_dir ...] ...
"""

from __future__ import annotations

import numpy as np
import torch

from ...data import io
from ...data.processing import resample
from ...metric.eer import get_eer
from ...train.checkpoint import load_model_state, restore_checkpoint
from .dataset import SAMPLE_RATE, load_segment, n_speakers, read_segments
from .train_speaker_embeddings import build_model, extract_features, parse_args

__all__ = ["BUCKET_STEP", "MAX_LEN", "BATCH", "make_embed_fn", "embed_rows", "training_cohort",
           "subtract_mean", "score_trials", "main"]

BUCKET_STEP = 2 * SAMPLE_RATE   # pad lengths up to a multiple of 2 s
MAX_LEN = 40 * SAMPLE_RATE      # truncate outliers at 40 s
BATCH = 16


def _bucket_len(n: int) -> int:
    n = min(max(n, 1), MAX_LEN)
    return min(-(-n // BUCKET_STEP) * BUCKET_STEP, MAX_LEN)


def make_embed_fn(model, cfg):
    """``embed(wavs (B, L), wav_lens (B,))`` → unit-norm embeddings ``(B,
    emb_dim)`` as a numpy array; ``model`` is a ``SpeakerNet``, put in eval
    mode, whose device the batch is copied to."""
    model.eval()
    device = next(model.parameters()).device
    n_mels = int(cfg.features.n_mels)

    @torch.inference_mode()
    def run(wavs, wav_lens):
        wavs = torch.as_tensor(wavs, device=device)
        wav_lens = torch.as_tensor(wav_lens, device=device).long()
        feats, feat_lens = extract_features(wavs, n_mels=n_mels, wav_lens=wav_lens)
        emb = model.embedding_model(feats, lengths=feat_lens)
        emb = emb.reshape(emb.shape[0], -1)
        emb = emb / torch.clamp_min(torch.linalg.vector_norm(emb, dim=-1, keepdim=True), 1e-12)
        return emb.cpu().numpy()

    return run


def _read_full(row) -> np.ndarray:
    """The row's ``start:stop`` span (the whole file when ``stop <= start``),
    resampled to 16 kHz when the file is not, at most :data:`MAX_LEN`
    samples."""
    start, stop = int(row.get("start", 0) or 0), int(row.get("stop", 0) or 0)
    if stop > start:
        # load_segment reads start/stop at SAMPLE_RATE and never resamples:
        # a file at another rate takes the full read with rescaled indices
        _, sr = io.read(row["wav"], duration=1.0 / SAMPLE_RATE)
        if sr == SAMPLE_RATE:
            return load_segment(row, stop - start)[:MAX_LEN]
        x, sr = io.read(row["wav"])
        x = np.asarray(x, np.float32)
        if x.ndim > 1:
            x = x[:, 0]
        x = np.asarray(resample(x, sr, SAMPLE_RATE), np.float32)
        start = int(round(start * SAMPLE_RATE / sr))
        stop = int(round(stop * SAMPLE_RATE / sr))
        x = x[start:stop]
    else:
        x, sr = io.read(row["wav"])
        x = np.asarray(x, np.float32)
        if x.ndim > 1:
            x = x[:, 0]
        if sr != SAMPLE_RATE:
            x = np.asarray(resample(x, sr, SAMPLE_RATE), np.float32)
    return x[:MAX_LEN]


def embed_rows(embed_fn, rows, loader=_read_full):
    """``{ID: embedding}`` of whole utterances, in length buckets of
    :data:`BATCH` (the last batch of a bucket padded with length-1 rows)."""
    waves = [(r["ID"], loader(r)) for r in rows]
    by_bucket: dict[int, list] = {}
    for key, x in waves:
        by_bucket.setdefault(_bucket_len(len(x)), []).append((key, x))

    embs = {}
    for blen, items in sorted(by_bucket.items()):
        for i in range(0, len(items), BATCH):
            chunk = items[i:i + BATCH]
            wavs = np.zeros((BATCH, blen), np.float32)
            lens = np.full((BATCH,), 1, np.int32)
            for j, (_, x) in enumerate(chunk):
                wavs[j, :len(x)] = x
                lens[j] = len(x)
            out = np.asarray(embed_fn(wavs, lens))
            for j, (key, _) in enumerate(chunk):
                embs[key] = out[j]
    return embs


def training_cohort(embed_fn, train_csv, pool_size: int = 0):
    """Cohort embeddings ``(N, emb_dim)`` of training utterances: all of
    them, or ``pool_size`` taken round robin over the sorted speakers."""
    rows, _ = read_segments(train_csv)
    target = len(rows) if not pool_size else min(pool_size, len(rows))
    by_spk: dict[str, list] = {}
    for r in rows:
        by_spk.setdefault(r["spk_id"], []).append(r)
    ordered = []
    idx = 0
    while len(ordered) < target:
        for spk in sorted(by_spk):
            if idx < len(by_spk[spk]):
                ordered.append(by_spk[spk][idx])
                if len(ordered) >= target:
                    break
        idx += 1

    embs = embed_rows(embed_fn, ordered)
    return np.stack([embs[r["ID"]] for r in ordered])


def subtract_mean(embs, mean):
    """Each embedding minus ``mean``, normalized again to unit length (so
    that dot products are cosines)."""
    out = {}
    for k, v in embs.items():
        c = v - mean
        out[k] = c / max(float(np.linalg.norm(c)), 1e-12)
    return out


def score_trials(embs, pairs, cohort=None, cohort_size=0):
    """``(positive scores, negative scores)`` of the ``(label, enrol, test)``
    trials whose two sides were embedded: cosines, or with ``cohort`` the
    adaptive s-norm ``0.5 (z_enrol + z_test)``, each side's mean and
    standard deviation taken over its ``cohort_size`` best cohort scores (all
    of them when 0 or at least the cohort's size)."""
    pos, neg = [], []

    def _top(scores):
        k = int(cohort_size)
        if k and k < len(scores):
            scores = np.partition(scores, len(scores) - k)[-k:]
        return scores

    for label, e_key, t_key in pairs:
        if e_key not in embs or t_key not in embs:
            continue
        e, t = embs[e_key], embs[t_key]
        score = float(np.dot(e, t))
        if cohort is not None:
            e_c = _top(cohort @ e)
            t_c = _top(cohort @ t)
            score = 0.5 * ((score - e_c.mean()) / (e_c.std() + 1e-8)
                           + (score - t_c.mean()) / (t_c.std() + 1e-8))
        (pos if label == 1 else neg).append(score)
    return pos, neg


def _key_of(rel):
    return rel.replace("/", "--").rsplit(".", 1)[0]


def read_pairs(path):
    """``[(label, enrol ID, test ID)]`` of a VoxCeleb-style trial list."""
    pairs = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) == 3:
                pairs.append((int(parts[0]), _key_of(parts[1]), _key_of(parts[2])))
    return pairs


def load_model(cfg, device):
    """The ``SpeakerNet`` of the config with the latest checkpoint of
    ``train.ckpt_dir`` loaded, in eval mode."""
    model = build_model(cfg, device, n_speakers(cfg.data.train_csv))
    load_model_state(model, restore_checkpoint(cfg.train.ckpt_dir))
    return model.eval()


def main(argv=None):
    """Embed the enrol and test sets, score the trials (s-normed when
    ``eval.score_norm``) and return the EER."""
    cfg, device = parse_args(argv)
    embed_fn = make_embed_fn(load_model(cfg, device), cfg)
    embs = embed_rows(embed_fn, read_segments(cfg.data.enrol_csv)[0])
    embs.update(embed_rows(embed_fn, read_segments(cfg.data.test_csv)[0]))
    pairs = read_pairs(cfg.data.veri_pairs)

    cohort = None
    if bool(cfg.eval.score_norm):
        cohort = training_cohort(embed_fn, cfg.data.train_csv,
                                 int(cfg.eval.get("cohort_pool", 0)))

    # one global mean over the trial sides and the cohort, taken out of both
    stack = list(embs.values()) + ([] if cohort is None else list(cohort))
    mean = np.mean(np.stack(stack), axis=0)
    embs = subtract_mean(embs, mean)
    if cohort is not None:
        cohort = cohort - mean
        cohort /= np.maximum(np.linalg.norm(cohort, axis=-1, keepdims=True), 1e-12)

    pos, neg = score_trials(embs, pairs, cohort, cohort_size=int(cfg.eval.cohort_size))
    eer, threshold = get_eer(np.asarray(pos), np.asarray(neg))
    print(f"pairs={len(pos) + len(neg)} EER={100 * eer:.2f}% thr={threshold:.4f}")
    return eer


if __name__ == "__main__":
    main()
