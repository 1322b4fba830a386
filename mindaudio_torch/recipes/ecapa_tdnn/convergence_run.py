"""Convergence run of the ECAPA-TDNN recipe on the card (port of
``examples/ECAPA-TDNN/convergence_run.py``): train to a real EER on a
synthetic multi-speaker corpus.

Each speaker is four formant resonators and a spectral tilt (its "vocal
tract"), drawn so that no two speakers are closer than 0.35 in L1 distance
of the log-formants; each utterance is a pulse train at a random f0 with
jitter and noise through the speaker's filter, with random amplitude
modulation and gain. f0 ranges overlap across speakers, so the identity is
only in the envelope, which ECAPA-TDNN embeds. ``make_corpus`` writes the
same WAVs and CSVs, byte for byte, as the JAX package's for the same seed.

Training goes through ``train_speaker_embeddings.main`` with augmentation
on, then ``speaker_verification_cosine.main`` scores every enrol × test
pair without and with adaptive s-norm. ``results.json`` (the EERs and the
run's settings) and ``scores.npz`` (the cosine scores of the positive and
negative trials after the mean subtraction) are written to
``convergence_artifacts/`` beside this file; with ``--init-seed n`` other
than 0 (the seed of the weights' generator, ``train_speaker_embeddings.
INIT_SEED``) they are ``results_seed<n>.json`` and ``scores_seed<n>.npz``,
and the checkpoints go to ``<root>/ckpt_seed<n>``, so that runs at several
seeds can share one corpus.

Usage::

    python -m mindaudio_torch.recipes.ecapa_tdnn.convergence_run [--steps 900] \\
        [--speakers 32] [--batch 64] [--n-train 14] [--n-eval 2] [--root DIR] \\
        [--init-seed 0] [--extra --device cpu ...]
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import tempfile

import numpy as np

from ...data import io
from . import speaker_verification_cosine as sv
from . import train_speaker_embeddings as tse
from .dataset import read_segments

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "convergence_artifacts")
SR = 16000


def _speaker_filter(rng, existing=None, min_dist=0.35):
    """A speaker: second-order sections of 4 formant resonators and a
    first-order low-pass tilt. Candidates are drawn again until the L1
    distance of the log-formants to every speaker in ``existing`` is at
    least ``min_dist`` (at most 1000 draws); the accepted one joins
    ``existing``."""
    from scipy.signal import butter

    for _ in range(1000):
        formants = np.sort(rng.uniform(300, 3600, size=4))
        lf = np.log(formants)
        if existing is None or not existing or min(
                float(np.abs(lf - e).sum()) for e in existing) >= min_dist:
            break
    if existing is not None:
        existing.append(lf)
    bws = rng.uniform(60, 180, size=4)
    sos = []
    for f, bw in zip(formants, bws):
        r = np.exp(-np.pi * bw / SR)
        theta = 2 * np.pi * f / SR
        # resonator biquad: poles at r*e^{±j theta}
        sos.append([1.0, 0.0, 0.0, 1.0, -2 * r * np.cos(theta), r * r])
    tilt = butter(1, rng.uniform(800, 4000) / (SR / 2), btype="low", output="sos")
    return np.concatenate([np.asarray(sos), tilt], axis=0)


def _utterance(rng, spk_sos, seconds):
    """A pulse train at an utterance-random f0 with jitter, plus noise,
    through the speaker's filter; random amplitude modulation and gain."""
    from scipy.signal import sosfilt

    n = int(seconds * SR)
    f0 = rng.uniform(85, 240)  # overlapping range: f0 is not the identity
    jitter = 1.0 + 0.02 * np.cumsum(rng.standard_normal(n)) / np.sqrt(n)
    phase = np.cumsum(f0 * jitter) / SR
    pulses = (np.diff(np.floor(phase), prepend=0.0) > 0).astype(np.float32)
    excitation = pulses + 0.05 * rng.standard_normal(n).astype(np.float32)
    x = sosfilt(spk_sos, excitation).astype(np.float32)
    am = 0.7 + 0.3 * np.sin(2 * np.pi * rng.uniform(0.5, 3.0)
                            * np.arange(n) / SR + rng.uniform(0, 6.28))
    x = x * am.astype(np.float32)
    x = x / (np.abs(x).max() + 1e-9) * rng.uniform(0.3, 0.8)
    return x.astype(np.float32)


def make_corpus(root, n_speakers, n_train=14, n_enrol=2, n_test=2, seed=0):
    """Write ``root/wav/*.wav``, ``train.csv``, ``enrol.csv``, ``test.csv``
    (utterances of 4-8 s) and ``veri_pairs.txt`` (every enrol × test pair,
    label 1 for one speaker). Returns the CSV rows by split."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "wav"), exist_ok=True)
    rows = {"train": [], "enrol": [], "test": []}
    seen_envelopes = []
    for s in range(n_speakers):
        spk = f"spk{s:03d}"
        sos = _speaker_filter(rng, existing=seen_envelopes)
        counts = [("train", n_train), ("enrol", n_enrol), ("test", n_test)]
        u = 0
        for split, cnt in counts:
            for _ in range(cnt):
                seconds = float(rng.uniform(4.0, 8.0))
                x = _utterance(rng, sos, seconds)
                utt_id = f"{spk}--u{u:03d}"
                path = os.path.join(root, "wav", f"{spk}_u{u:03d}.wav")
                io.write(path, x, SR)
                rows[split].append({
                    "ID": utt_id, "duration": f"{seconds:.2f}", "wav": path,
                    "start": "0", "stop": "0", "spk_id": spk,
                })
                u += 1
    for split, rs in rows.items():
        with open(os.path.join(root, f"{split}.csv"), "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["ID", "duration", "wav", "start", "stop", "spk_id"])
            w.writeheader()
            w.writerows(rs)

    # trials name wav-relative paths; the scorer's key maps them back to IDs
    with open(os.path.join(root, "veri_pairs.txt"), "w") as f:
        for e in rows["enrol"]:
            for t in rows["test"]:
                label = int(e["spk_id"] == t["spk_id"])
                f.write(f"{label} {e['ID'].replace('--', '/')}.wav "
                        f"{t['ID'].replace('--', '/')}.wav\n")
    return rows


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=900)
    ap.add_argument("--speakers", type=int, default=32)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--n-train", type=int, default=14,
                    help="train utterances per speaker (each a fresh f0/AM draw)")
    ap.add_argument("--n-eval", type=int, default=2, help="enrol AND test utterances per speaker")
    ap.add_argument("--gen-only", action="store_true", help="write the corpus and exit")
    ap.add_argument("--root", default=None)
    ap.add_argument("--init-seed", type=int, default=0,
                    help="seed of the weights' generator (train_speaker_embeddings.INIT_SEED)")
    ap.add_argument("--extra", nargs=argparse.REMAINDER, default=[],
                    help="flags passed through to the recipe's train and eval (e.g. --extra "
                         "--device cpu --optim.max_lr 0.002)")
    return ap.parse_args(argv)


def main(argv=None):
    """Run the protocol; returns the results written to ``results.json``."""
    args = parse_args(argv)
    root = args.root or tempfile.mkdtemp(prefix="ecapa_conv_")
    print(f"corpus -> {root}", flush=True)
    if not os.path.exists(os.path.join(root, "train.csv")):
        make_corpus(root, args.speakers, n_train=args.n_train, n_enrol=args.n_eval,
                    n_test=args.n_eval)
    if args.gen_only:
        return None
    tse.INIT_SEED = args.init_seed
    suffix = f"_seed{args.init_seed}" if args.init_seed else ""

    overrides = [
        "--data.train_csv", os.path.join(root, "train.csv"),
        "--data.enrol_csv", os.path.join(root, "enrol.csv"),
        "--data.test_csv", os.path.join(root, "test.csv"),
        "--data.veri_pairs", os.path.join(root, "veri_pairs.txt"),
        "--data.batch_size", str(args.batch),
        "--optim.epochs", "100000",
        "--optim.max_lr", "0.001",
        "--optim.cycle_steps", str(max(200, args.steps // 2)),
        "--train.ckpt_dir", os.path.join(root, "ckpt" + suffix),
        "--train.max_steps", str(args.steps),
        "--train.save_every_steps", str(args.steps),
        "--train.log_every_steps", "50",
        "--eval.cohort_size", "64",
    ] + list(args.extra)

    train = tse.main(overrides)
    results = {"steps": args.steps, "speakers": args.speakers, "batch": args.batch,
               "init_seed": args.init_seed}
    results["eer_cosine"] = float(sv.main(overrides + ["--eval.score_norm", "false"]))
    results["eer_snorm"] = float(sv.main(overrides + ["--eval.score_norm", "true"]))

    # the committed score distributions: the trial cosines after the same
    # mean subtraction as the eval path (over the trial sides only)
    cfg, device = tse.parse_args(overrides)
    embed_fn = sv.make_embed_fn(sv.load_model(cfg, device), cfg)
    embs = sv.embed_rows(embed_fn, read_segments(cfg.data.enrol_csv)[0])
    embs.update(sv.embed_rows(embed_fn, read_segments(cfg.data.test_csv)[0]))
    mean = np.mean(np.stack(list(embs.values())), axis=0)
    pos, neg = sv.score_trials(sv.subtract_mean(embs, mean), sv.read_pairs(cfg.data.veri_pairs))
    os.makedirs(OUT_DIR, exist_ok=True)
    np.savez_compressed(os.path.join(OUT_DIR, f"scores{suffix}.npz"), pos=np.asarray(pos),
                        neg=np.asarray(neg))
    results["n_pos"], results["n_neg"] = len(pos), len(neg)
    results["pos_mean"] = float(np.mean(pos))
    results["neg_mean"] = float(np.mean(neg))
    results["train_window_ms"] = train["window_ms"]
    with open(os.path.join(OUT_DIR, f"results{suffix}.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
