"""WaveGrad convergence run (port of ``examples/wavegrad/convergence_run.py``):
held-out vocoder reconstruction numbers.

The vocoder is trained by ``train.main()`` on the FastSpeech2 synthetic
corpus's wavs (``fastspeech2.convergence_run.build_corpus`` with wavs, then
``prepare_wavegrad_corpus``); :func:`evaluate` then scores it on utterances
synthesized under a fresh seed (777: phone sequences, harmonic phases and
noise the vocoder never saw): their ground-truth mels, padded to the longest
with the corpus's silence level, are vocoded in one batch by the 1000-step
and by the 6-step sampler, and the mel-L1 between the re-analyzed audio and
the conditioning mel is taken per utterance (:func:`analyze_mel`); a
white-noise "vocoder" row gives the metric's scale. Rounded as the JAX
script rounds.

Two modes:

- ``--ckpt DIR [--train_log LOG]``: the JAX script's; score the checkpoint
  under ``DIR`` (either layout) and, given the training log, write its loss
  curve (:func:`parse_loss_curve`);
- ``--root DIR``: the whole protocol in one process: the corpus (2048
  utterances, ``DIR/corpus``, written once), its WaveGrad features
  (``DIR/features``), ``--steps`` (20,000) steps of the recipe at B = 64
  with ``data.cache_features`` on and a checkpoint every 5000 into
  ``DIR/ckpt_seed<n>``, its log, then the scoring; with ``--fs2_mel`` also
  ``fastspeech2.convergence_run.vocode_e2e`` on that FastSpeech2 mel.

The JAX init (``PRNGKey(0)``) cannot be reproduced, so ``--init-seed``
seeds the port's weights. A run writes ``results.json``,
``loss_curve.json``, ``train_log.txt``, ``sample_1000step.wav``,
``sample_fast6.wav`` (one held-out utterance each) and, with ``--fs2_mel``,
``e2e.json`` and ``e2e_sample.wav`` (the last run's) into ``--out`` (default: the root, or
the checkpoint directory), with ``_seed<n>`` before the extension for a
seed other than 0. Everything runs in float32 (no TF32), or with cuDNN's
convolutions in TF32 under ``--cudnn-tf32`` (the committed runs: a
float32 step of the full model takes some 2.5x as long on an H100, about
86 minutes for 20,000 steps). Other
``--section.key`` flags override ``wavegrad.yaml`` (the CPU test's toy
widths).

Usage::

    python -m mindaudio_torch.recipes.wavegrad.convergence_run --root DIR \\
        [--steps 20000] [--init-seed 0] [--fs2_mel mel_pred.npy] [--device cuda] [--out DIR]
    python -m mindaudio_torch.recipes.wavegrad.convergence_run --ckpt DIR [--train_log LOG]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import re

import numpy as np
import torch

from ...data import io, spectrum
from ...models.wavegrad import default_noise_schedule, fast_noise_schedule, reverse_diffusion
from ...train.log import get_logger
from ..fastspeech2.convergence_run import (HOP, N_FFT, N_MELS, SR, build_corpus,
                                           fs2_mel_to_wavegrad, prepare_wavegrad_corpus,
                                           synth_utterance, vocode_e2e)
from . import train as wg_train

CORPUS_UTTS, STEPS = 2048, 20000


def parse_loss_curve(log_path):
    """``[{"step", "loss"}]`` from the recipe's log lines."""
    curve = []
    pat = re.compile(r"epoch (\d+) step (\d+) loss ([\d.]+)")
    with open(log_path) as f:
        for line in f:
            m = pat.search(line)
            if m:
                curve.append({"step": int(m.group(2)), "loss": float(m.group(3))})
    return curve


def analyze_mel(wav, n_frames):
    """The WaveGrad-convention mel ``(n_frames, N_MELS)`` of ``wav``: the
    corpus's slaney mel, ``ln``, then ``fs2_mel_to_wavegrad``."""
    m = spectrum.melspectrogram(
        wav[: n_frames * HOP], n_fft=N_FFT, hop_length=HOP, win_length=N_FFT,
        n_mels=N_MELS, sample_rate=SR, norm="slaney", mel_type="slaney",
    )[:, :n_frames]
    return fs2_mel_to_wavegrad(np.log(np.maximum(m, 1e-5))).T


def _suffix(seed):
    return "" if seed == 0 else f"_seed{seed}"


def held_out(n_utts, seed):
    """``(utterances, mel batch, rng)``: ``n_utts`` fresh utterances of 8-16
    phones as ``(frames, mel)``, their mels padded to the longest with the
    silence level, and the generator after their synthesis (the noise
    baseline continues it)."""
    rng = np.random.default_rng(seed)
    utts = []
    for _ in range(n_utts):
        n_ph = int(rng.integers(8, 17))
        phones = rng.integers(1, 41, size=n_ph).astype(np.int32)
        wav = synth_utterance(rng, phones)
        n_frames = len(wav) // HOP
        utts.append((n_frames, analyze_mel(wav, n_frames)))
    t_max = max(n for n, _ in utts)
    pad_val = float(fs2_mel_to_wavegrad(np.log(1e-5)))
    mel_batch = np.full((len(utts), t_max, utts[0][1].shape[1]), pad_val, np.float32)
    for i, (n_frames, mel) in enumerate(utts):
        mel_batch[i, :n_frames] = mel
    return utts, mel_batch, rng


def evaluate(model, device, out_dir, n_utts=32, seed=777, suffix=""):
    """Score ``model`` (a ``WaveGrad``) on ``n_utts`` held-out utterances:
    each sampler runs once over the whole batch, its draws from a generator
    seeded ``seed`` on ``device``; writes the first utterance's audio for
    each schedule into ``out_dir``. Returns the results without
    ``config``."""
    utts, mel_batch, rng = held_out(n_utts, seed)
    mel = torch.as_tensor(mel_batch, device=device)
    rows = [{"utt": i, "frames": n} for i, (n, _) in enumerate(utts)]
    for tag, betas in (("1000step", default_noise_schedule()), ("fast6", fast_noise_schedule())):
        audio_b = reverse_diffusion(model, mel, torch.Generator(device=device).manual_seed(seed),
                                    betas=betas, hop=HOP).cpu().numpy()
        for i, (n_frames, mel_gt) in enumerate(utts):
            mel_rt = analyze_mel(audio_b[i, : n_frames * HOP], n_frames)
            rows[i][f"mel_l1_{tag}"] = round(float(np.abs(mel_rt - mel_gt).mean()), 4)
        io.write(os.path.join(out_dir, f"sample_{tag}{suffix}.wav"),
                 audio_b[0, : utts[0][0] * HOP], SR)
        print(tag, "done", flush=True)
    for i, (n_frames, mel_gt) in enumerate(utts):
        noise = rng.standard_normal(n_frames * HOP).astype(np.float32) * 0.1
        rows[i]["mel_l1_noise_baseline"] = round(
            float(np.abs(analyze_mel(noise, n_frames) - mel_gt).mean()), 4)

    def stat(key):
        vals = [r[key] for r in rows]
        return round(float(np.mean(vals)), 4), round(float(np.std(vals)), 4)

    results = {"held_out_utts": len(rows)}
    for key in ("mel_l1_1000step", "mel_l1_fast6", "mel_l1_noise_baseline"):
        results[key], results[key + "_std"] = stat(key)
    results["per_utt"] = rows
    return results


def overrides(feature_dir, ckpt_dir, steps):
    """The protocol's overrides of the recipe's YAML (the JAX README's
    commands: the corpus's features, cached, ``steps`` steps; the YAML's
    B = 64 and a save every 5000)."""
    return ["--data.feature_dir", feature_dir, "--data.cache_features", "true",
            "--train.max_steps", str(steps), "--train.ckpt_dir", ckpt_dir]


def train_logged(argv, log_path, cudnn_tf32=False):
    """``train.train`` as ``train.main(argv)`` runs it, with its log lines
    also written to ``log_path``; float32, or with cuDNN's TF32 on where
    ``cudnn_tf32``."""
    get_logger(wg_train.LOGGER)  # configured first: train's own call keeps our handler
    handler = logging.FileHandler(log_path, mode="w")
    handler.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s"))
    logging.getLogger(wg_train.LOGGER).addHandler(handler)
    try:
        cfg, device, init_seed = wg_train.parse_args(argv)
        use_precision(cudnn_tf32)
        return wg_train.train(cfg, device, init_seed)
    finally:
        logging.getLogger(wg_train.LOGGER).removeHandler(handler)
        handler.close()


def use_precision(cudnn_tf32):
    """Float32 (``train.use_float32``), then cuDNN's TF32 on where
    ``cudnn_tf32``."""
    wg_train.use_float32()
    torch.backends.cudnn.allow_tf32 = bool(cudnn_tf32)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default="", help="score this checkpoint directory")
    ap.add_argument("--train_log", default="", help="its training log (for the loss curve)")
    ap.add_argument("--root", default="", help="run the whole protocol under this directory")
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--utts", type=int, default=CORPUS_UTTS)
    ap.add_argument("--init-seed", type=int, default=0, help="seed of the weights' generator")
    ap.add_argument("--fs2_mel", default="",
                    help="a FastSpeech2 mel (.npy) to vocode end to end (vocode_e2e)")
    ap.add_argument("--n_utts", type=int, default=32)
    ap.add_argument("--seed", type=int, default=777, help="fresh corpus seed: held-out utterances")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cudnn-tf32", action="store_true",
                    help="cuDNN's convolutions in TF32 (training and sampling)")
    ap.add_argument("--out", default="", help="results directory (default: --root or --ckpt)")
    args, rest = ap.parse_known_args(argv)
    if bool(args.ckpt) == bool(args.root):
        ap.error("give one of --ckpt and --root")
    return args, rest


def main(argv=None):
    """Run as the flags say; returns the results."""
    args, rest = parse_args(argv)
    suffix = _suffix(args.init_seed)
    out_dir = args.out or args.root or args.ckpt
    os.makedirs(out_dir, exist_ok=True)
    train_log = args.train_log
    if args.root:
        corpus, features = os.path.join(args.root, "corpus"), os.path.join(args.root, "features")
        if not os.path.exists(os.path.join(corpus, "train.txt")):
            print(f"building corpus ({args.utts} utts) ...", flush=True)
            build_corpus(corpus, args.utts, write_wavs=True)
        if not os.path.exists(os.path.join(features, "train.txt")):
            prepare_wavegrad_corpus(corpus, features)
        ckpt_dir = os.path.join(args.root, f"ckpt_seed{args.init_seed}")
        train_log = os.path.join(out_dir, f"train_log{suffix}.txt")
        train_logged(overrides(features, ckpt_dir, args.steps) + rest + [
            "--device", args.device, "--init-seed", str(args.init_seed)], train_log,
            args.cudnn_tf32)
    else:
        ckpt_dir = args.ckpt
    if train_log:
        with open(os.path.join(out_dir, f"loss_curve{suffix}.json"), "w") as f:
            json.dump(parse_loss_curve(train_log), f, indent=1)

    cfg, device, _ = wg_train.parse_args(rest + ["--device", args.device])
    use_precision(args.cudnn_tf32)
    model = wg_train.load_vocoder(ckpt_dir, device, cfg)
    results = evaluate(model, device, out_dir, args.n_utts, args.seed, suffix)
    results["config"] = {"ckpt": ckpt_dir, "seed": args.seed, "init_seed": args.init_seed,
                         "train_steps": args.steps, "corpus": f"fs2 synthetic ({args.utts} utts)",
                         "cudnn_tf32": torch.backends.cudnn.allow_tf32,
                         "device": torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"}
    if args.fs2_mel:
        results["e2e"] = vocode_e2e(np.load(args.fs2_mel), ckpt_dir, out_dir, device)
        with open(os.path.join(out_dir, f"e2e{suffix}.json"), "w") as f:
            json.dump(results["e2e"], f, indent=2)
    with open(os.path.join(out_dir, f"results{suffix}.json"), "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps({k: v for k, v in results.items() if k != "per_utt"}, indent=2))
    return results


if __name__ == "__main__":
    main()
