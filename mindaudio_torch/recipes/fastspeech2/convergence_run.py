"""FastSpeech2 convergence run (port of
``examples/fastspeech2/convergence_run.py``): train on a synthetic corpus
whose text → prosody mapping is learnable, then score the held-out split.

Every phone id 1-40 carries a duration, pitch and energy rule and a
spectral envelope of three formants (:func:`phone_rules`,
:func:`phone_envelope`); each utterance realizes its prosody with jitter
around the rules (:func:`realize_prosody`), and its audio is synthesized
from them at 24 kHz, hop 300, 128 mel bins (:func:`build_corpus`: the same
``.npy`` files and lists, byte for byte, as the JAX script's for the same
seed and directory). The recipe's ``train.main()`` then runs with the JAX
script's overrides (at most 24 phonemes and 320 frames, B = 32, lr 5e-4,
4000 steps, a save every quarter), and :func:`evaluate` scores the held-out
utterances at B = 1 on the card, text only through ``FastSpeech2.infer``
(duration MAE and exact rate, pitch MAE in Hz, energy MAE, each beside the
floor of predicting the rule mean; mel L1, MCD-13 and DTW-aligned MCD-13)
and teacher-forced (mel L1 and MCD-13 on exactly aligned frames).

The JAX init (``PRNGKey(0)``) cannot be reproduced, so ``--init-seed`` seeds
the port's weights. Training and scoring run in float32, as the JAX run
does (``train.use_float32``: no TF32). Runs at several seeds share one
corpus (``--corpus_dir``; ``--gen-only`` writes it and stops) and keep their
checkpoints apart (``<corpus_dir>/ckpt_seed<n>``). A run writes
``results.json``, ``loss_curve.json``, ``mel_pred.npy`` and ``mel_gt.npy`` (one held-out
utterance's free-running and ground-truth mels) into ``--out`` (default: the
corpus directory; name ``convergence_artifacts/`` beside this file only to
update the committed results), with ``_seed<n>`` before the extension for a
seed other than 0. With ``--wavegrad_ckpt`` the scoring ends in the
end-to-end leg (:func:`vocode_e2e`): the first held-out utterance's
predicted mel vocoded by that WaveGrad checkpoint, its ``e2e`` result in
``results.json`` and its audio in ``e2e_sample.wav``.

Usage::

    python -m mindaudio_torch.recipes.fastspeech2.convergence_run [--steps 4000] \\
        [--utts 2048] [--init-seed 0] [--device cuda] [--corpus_dir DIR] [--out DIR] \\
        [--wavegrad_ckpt DIR] [--gen-only]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import re
import tempfile

import numpy as np
import torch
from scipy.fftpack import dct

from ...data import io, spectrum
from ...models.wavegrad import fast_noise_schedule, reverse_diffusion
from ...train.checkpoint import restore_checkpoint
from ...train.log import get_logger
from ..wavegrad.train import load_vocoder
from . import train as fs2_train

SR = 24000
HOP = 300          # WaveGrad's fixed hop (up-factor product) → vocodable
N_FFT = 1024
N_MELS = 128       # WaveGrad default mel count
N_PHONES = 40      # phone ids 1..N_PHONES (0 = pad)
MAX_PH = 24
MAX_MEL = 320


def phone_rules(p: int):
    """Deterministic per-phone prosody means: the learnable ground truth."""
    dur = 4 + (p * 7) % 8                        # 4..11 frames
    f0 = 110.0 * 2.0 ** (((p * 5) % 13) / 13.0)  # 110..213 Hz
    energy = 0.35 + 0.6 * ((p * 3) % 9) / 8.0    # 0.35..0.95
    return dur, f0, energy


# Continuous prosody jitter around the per-phone means (realized values are
# stored as the pitch/energy targets, like f0 extraction on real speech).
# This is load-bearing for FREE-RUNNING eval, not decoration: with exactly
# N_PHONES discrete pitch values, only ~13 of the adaptor's 256 pitch
# buckets ever receive gradient, so a 3.5 Hz prediction error lands in an
# adjacent UNTRAINED N(0,1)-random embedding and corrupts that phone's
# features (measured: 50% bucket mismatch -> free-running MCD 118 dB while
# gt-pitch/energy inference scored 26 dB). Continuous jitter trains the
# bucket neighborhoods the predictor actually hits, as real speech does.
PITCH_JITTER_UTT = 0.02    # per-utterance log2-f0 scale sigma (~1.4%)
PITCH_JITTER_PHONE = 0.01  # per-phone log2-f0 sigma (~0.7%)
ENERGY_JITTER = 0.05       # per-phone multiplicative sigma


def realize_prosody(rng, phones):
    """Sample realized per-phone (f0 Hz, energy) around the rule means."""
    mean_f0 = np.array([phone_rules(int(p))[1] for p in phones])
    mean_en = np.array([phone_rules(int(p))[2] for p in phones])
    utt_scale = 2.0 ** rng.normal(0.0, PITCH_JITTER_UTT)
    f0 = mean_f0 * utt_scale * 2.0 ** rng.normal(
        0.0, PITCH_JITTER_PHONE, size=len(phones))
    en = mean_en * (1.0 + rng.normal(0.0, ENERGY_JITTER, size=len(phones)))
    return f0, np.clip(en, 0.05, 1.2)


def phone_envelope(p: int):
    """Distinct per-phone spectral envelope: 3 formant peaks."""
    rng = np.random.default_rng(1000 + p)
    formants = np.sort(rng.uniform(300.0, 7000.0, size=3))
    bws = rng.uniform(80.0, 250.0, size=3)
    amps = rng.uniform(0.4, 1.0, size=3)
    return formants, bws, amps


def synth_utterance(rng, phones, f0s=None, energies=None):
    """Audio for a phone sequence under the rules (+ realized prosody)."""
    chunks = []
    for j, p in enumerate(phones):
        dur, f0, energy = phone_rules(int(p))
        if f0s is not None:
            f0, energy = float(f0s[j]), float(energies[j])
        n = dur * HOP
        t = np.arange(n) / SR
        formants, bws, amps = phone_envelope(int(p))
        # all harmonics at once: (K, n) bank shaped by the formant envelope
        fk = np.arange(1, int(SR / 2 / f0) + 1, dtype=np.float64) * f0
        fk = fk[fk < SR / 2]
        a = (amps[None, :] * np.exp(
            -0.5 * ((fk[:, None] - formants[None, :]) / bws[None, :]) ** 2)
        ).sum(1) + 0.02  # spectral floor so every harmonic exists
        phases = rng.uniform(0, 2 * np.pi, size=len(fk))
        x = (a[:, None] * np.sin(
            2 * np.pi * fk[:, None] * t[None, :] + phases[:, None])).sum(0)
        x *= energy / (np.abs(x).max() + 1e-9)
        # 5 ms raised-cosine edges avoid clicks at phone boundaries
        edge = int(0.005 * SR)
        env = np.ones(n)
        env[:edge] = 0.5 - 0.5 * np.cos(np.pi * np.arange(edge) / edge)
        env[-edge:] = env[:edge][::-1]
        chunks.append(x * env)
    wav = np.concatenate(chunks)
    wav += 0.003 * rng.standard_normal(len(wav))
    return wav.astype(np.float32)


def build_corpus(out_dir, n_utts, seed=0, write_wavs=False):
    """Write FS2 feature .npy files (+train/dev lists, + optional wavs)."""
    os.makedirs(out_dir, exist_ok=True)
    wav_dir = os.path.join(out_dir, "wavs")
    if write_wavs:
        os.makedirs(wav_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    names = []
    for i in range(n_utts):
        n_ph = int(rng.integers(8, MAX_PH + 1))
        phones = rng.integers(1, N_PHONES + 1, size=n_ph).astype(np.int32)
        f0s, energies = realize_prosody(rng, phones)
        wav = synth_utterance(rng, phones, f0s, energies)
        durs = np.array([phone_rules(int(p))[0] for p in phones], np.int32)
        # targets are the REALIZED values, as f0/energy extraction on real
        # speech would produce — not the rule means
        pitch = np.log1p(f0s).astype(np.float32)
        energy = (energies * 5.0).astype(np.float32)
        mel = spectrum.melspectrogram(
            wav[: durs.sum() * HOP], n_fft=N_FFT, hop_length=HOP,
            win_length=N_FFT, n_mels=N_MELS, sample_rate=SR,
            norm="slaney", mel_type="slaney",
        )
        mel = np.log(np.maximum(mel, 1e-5)).T.astype(np.float32)
        name = f"utt{i:05d}"
        np.save(os.path.join(out_dir, name + ".npy"),
                {"phonemes": phones, "pitch": pitch, "energy": energy,
                 "duration": durs, "mel": mel[: durs.sum()]},
                allow_pickle=True)
        if write_wavs:
            io.write(os.path.join(wav_dir, name + ".wav"), wav, SR)
        names.append(name)
    n_dev = max(32, n_utts // 16)
    with open(os.path.join(out_dir, "train.txt"), "w") as f:
        f.write("\n".join(names[:-n_dev]))
    with open(os.path.join(out_dir, "dev.txt"), "w") as f:
        f.write("\n".join(names[-n_dev:]))
    return names[-n_dev:]


def fs2_mel_to_wavegrad(ln_mel):
    """FS2 ln(power-mel) → WaveGrad's [0,1] dB convention (the JAX recipe's
    ``generate.py``)."""
    return np.clip((10.0 * ln_mel / np.log(10.0) + 80.0) / 100.0,
                   0.0, 1.0).astype(np.float32)


def prepare_wavegrad_corpus(corpus_dir, out_dir):
    """Corpus wavs → WaveGrad (audio, mel) features in the SAME mel
    convention ``vocode_e2e`` feeds the vocoder, so the e2e leg is trained
    and driven consistently: the JAX WaveGrad recipe's preprocessing for
    the synthetic convergence corpus."""
    os.makedirs(out_dir, exist_ok=True)
    wav_dir = os.path.join(corpus_dir, "wavs")
    entries = []
    for name in sorted(os.listdir(wav_dir)):
        if not name.endswith(".wav"):
            continue
        utt = os.path.splitext(name)[0]
        wav, _ = io.read(os.path.join(wav_dir, name))
        wav = np.asarray(wav, np.float32)
        n_frames = len(wav) // HOP
        wav = wav[: n_frames * HOP]
        mel = spectrum.melspectrogram(
            wav, n_fft=N_FFT, hop_length=HOP, win_length=N_FFT,
            n_mels=N_MELS, sample_rate=SR, norm="slaney", mel_type="slaney",
        )[:, :n_frames]
        mel = fs2_mel_to_wavegrad(np.log(np.maximum(mel, 1e-5))).T
        np.save(os.path.join(out_dir, utt + ".npy"),
                {"audio": wav, "mel": mel.astype(np.float32)})
        entries.append(utt)
    with open(os.path.join(out_dir, "train.txt"), "w") as f:
        f.write("\n".join(entries))
    print(f"wrote {len(entries)} wavegrad utterances to {out_dir}")


def _cep13(a):
    return dct(a, type=2, axis=-1, norm="ortho")[:, 1:14]


def mcd_db(a, b):
    """MCD-13 (dB) between two aligned log-mel matrices (T, n_mels)."""
    ca, cb = _cep13(a), _cep13(b)
    return float((10.0 / np.log(10.0)) * np.mean(
        np.sqrt(2.0 * np.sum((ca - cb) ** 2, axis=-1))))


def mcd_dtw_db(a, b):
    """DTW-aligned MCD-13 (dB): the standard free-running TTS metric.

    Frame-wise MCD counts every frame a duration error SHIFTS as a full
    spectral error; aligning with dynamic time warping first (steps
    (1,0),(0,1),(1,1), path-length-normalized) isolates spectral quality
    from prosody-induced time drift.
    """
    ca, cb = _cep13(a), _cep13(b)
    # (T1, T2) frame-pair MCD costs
    d2 = ((ca[:, None, :] - cb[None, :, :]) ** 2).sum(-1)
    cost = (10.0 / np.log(10.0)) * np.sqrt(2.0 * np.maximum(d2, 0.0))
    t1, t2 = cost.shape

    # anti-diagonal DP (cells on diagonal i+j depend only on the previous
    # two diagonals), vectorized over each diagonal; `steps` tracks the
    # chosen path's length for the normalization
    inf = np.inf
    prev2 = np.full(t1 + 1, inf)   # accumulated cost on diagonal d-2, by i
    prev1 = np.full(t1 + 1, inf)   # diagonal d-1
    s_prev2 = np.zeros(t1 + 1, np.int64)
    s_prev1 = np.zeros(t1 + 1, np.int64)
    prev2[0] = 0.0                 # acc[0, 0]
    for d in range(2, t1 + t2 + 1):
        cur = np.full(t1 + 1, inf)
        s_cur = np.zeros(t1 + 1, np.int64)
        i = np.arange(max(1, d - t2), min(t1, d - 1) + 1)
        if i.size:
            cand = np.stack([prev1[i],       # left  (i, j-1)
                             prev1[i - 1],   # up    (i-1, j)
                             prev2[i - 1]])  # diag  (i-1, j-1)
            s_cand = np.stack([s_prev1[i], s_prev1[i - 1], s_prev2[i - 1]])
            k = np.argmin(cand, axis=0)
            cols = np.arange(i.size)
            cur[i] = cost[i - 1, d - i - 1] + cand[k, cols]
            s_cur[i] = s_cand[k, cols] + 1
        prev2, prev1 = prev1, cur
        s_prev2, s_prev1 = s_prev1, s_cur
    return float(prev1[t1] / s_prev1[t1])


def _suffix(seed):
    return "" if seed == 0 else f"_seed{seed}"


def evaluate(cfg, params, dev_names, feature_dir, out_dir, device, seed=0, wavegrad_ckpt=""):
    """Score ``params`` (a checkpoint's, either layout) on the held-out
    utterances ``dev_names`` at B = 1: free-running through ``infer`` and
    teacher-forced (the ground-truth durations, pitch and energy). Writes
    the first utterance's mels into ``out_dir``; with ``wavegrad_ckpt``
    vocodes its predicted mel (:func:`vocode_e2e`, under ``e2e``). Returns
    the metrics, rounded as the JAX script rounds them."""
    fs2, _ = fs2_train.build_model(cfg, device)
    fs2 = fs2_train.load_params(fs2, params).eval()
    max_ph = int(cfg.data.max_phoneme_len)

    def tensor(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    d_mae = d_exact = p_mae = e_mae = mel_l1 = mcd = n_ph_total = 0.0
    mel_l1_tf = mcd_tf = mcd_dtw = p_floor = e_floor = 0.0
    n_utt = 0
    sample = None
    for name in dev_names:
        s = np.load(os.path.join(feature_dir, name + ".npy"), allow_pickle=True).item()
        L = len(s["phonemes"])
        ph = np.zeros((1, max_ph), np.int64)
        ph[0, :L] = s["phonemes"]
        ph, src_lens = tensor(ph, torch.long), tensor([L], torch.long)
        mel, log_d, p_pred, e_pred, mel_len, _ = (
            t.cpu() for t in fs2.infer(ph, src_lens, MAX_MEL))
        d_pred = np.maximum(np.round(np.exp(log_d[0, :L].numpy().astype(np.float64)) - 1.0), 0)
        d_gt = s["duration"].astype(np.float64)
        d_mae += float(np.abs(d_pred - d_gt).sum())
        d_exact += float((d_pred == d_gt).sum())
        # pitch stored as log1p(Hz): report MAE in Hz
        p_hz_pred = np.expm1(p_pred[0, :L].numpy().astype(np.float64))
        p_hz_gt = np.expm1(s["pitch"].astype(np.float64))
        p_mae += float(np.abs(p_hz_pred - p_hz_gt).sum())
        e_mae += float(np.abs(e_pred[0, :L].numpy().astype(np.float64) - s["energy"]).sum())
        # the floor of text-only inference: the per-phone rule mean, against
        # targets that carry the realized jitter
        mean_f0 = np.array([phone_rules(int(p))[1] for p in s["phonemes"]])
        mean_en = np.array([phone_rules(int(p))[2] * 5.0 for p in s["phonemes"]])
        p_floor += float(np.abs(mean_f0 - p_hz_gt).sum())
        e_floor += float(np.abs(mean_en - s["energy"]).sum())
        n_ph_total += L

        t = min(int(mel_len[0]), s["mel"].shape[0], MAX_MEL)
        m_pred = mel[0, :t].numpy().astype(np.float64)
        m_gt = s["mel"][:t].astype(np.float64)
        mel_l1 += float(np.abs(m_pred - m_gt).mean())
        mcd += mcd_db(m_pred, m_gt)
        # DTW-aligned MCD on the whole predicted and ground-truth mels
        t_pred = min(int(mel_len[0]), MAX_MEL)
        mcd_dtw += mcd_dtw_db(mel[0, :t_pred].numpy().astype(np.float64),
                              s["mel"][:MAX_MEL].astype(np.float64))

        # teacher-forced: exact frame alignment
        pit = np.zeros((1, max_ph), np.float32)
        en = np.zeros((1, max_ph), np.float32)
        du = np.zeros((1, max_ph), np.int64)
        pit[0, :L], en[0, :L], du[0, :L] = s["pitch"], s["energy"], s["duration"]
        with torch.no_grad():
            mel_tf = fs2(ph, src_lens, MAX_MEL, pitch_target=tensor(pit, torch.float32),
                         energy_target=tensor(en, torch.float32),
                         duration_target=tensor(du, torch.long))[0].cpu()
        t_tf = min(int(s["duration"].sum()), s["mel"].shape[0], MAX_MEL)
        m_tf = mel_tf[0, :t_tf].numpy().astype(np.float64)
        g_tf = s["mel"][:t_tf].astype(np.float64)
        mel_l1_tf += float(np.abs(m_tf - g_tf).mean())
        mcd_tf += mcd_db(m_tf, g_tf)
        n_utt += 1
        if sample is None:
            sample = (mel[0, :t].numpy().astype(np.float32), s["mel"][:t])

    results = {
        "held_out_utts": n_utt,
        "duration_mae_frames": round(d_mae / n_ph_total, 4),
        "duration_exact_rate": round(d_exact / n_ph_total, 4),
        "pitch_mae_hz": round(p_mae / n_ph_total, 3),
        "pitch_mae_floor_hz": round(p_floor / n_ph_total, 3),
        "energy_mae": round(e_mae / n_ph_total, 4),
        "energy_mae_floor": round(e_floor / n_ph_total, 4),
        "mel_l1": round(mel_l1 / n_utt, 4),
        "mcd13_db": round(mcd / n_utt, 3),
        "mcd13_dtw_db": round(mcd_dtw / n_utt, 3),
        "mel_l1_teacher_forced": round(mel_l1_tf / n_utt, 4),
        "mcd13_db_teacher_forced": round(mcd_tf / n_utt, 3),
    }
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, f"mel_pred{_suffix(seed)}.npy"), sample[0])
    np.save(os.path.join(out_dir, f"mel_gt{_suffix(seed)}.npy"), sample[1])
    if wavegrad_ckpt:
        results["e2e"] = vocode_e2e(sample[0], wavegrad_ckpt, out_dir, device)
    return results


def vocode_e2e(fs2_mel, wavegrad_ckpt, out_dir, device):
    """FastSpeech2 mel ``(T, N_MELS)`` (``ln`` power) → the WaveGrad
    checkpoint's audio by the 6-step sampler (draws seeded 0 on ``device``)
    → the re-analyzed mel's L1 distance to ``fs2_mel``, beside that of 0.1
    white noise (``default_rng(0)``). Writes ``e2e_sample.wav`` into
    ``out_dir``."""
    wg = load_vocoder(wavegrad_ckpt, device)
    mel_db = fs2_mel_to_wavegrad(fs2_mel)
    audio = reverse_diffusion(wg, torch.as_tensor(mel_db[None], device=device),
                              torch.Generator(device=device).manual_seed(0), hop=HOP,
                              betas=fast_noise_schedule())[0].cpu().numpy()
    io.write(os.path.join(out_dir, "e2e_sample.wav"), audio, SR)

    def analyze(wav):
        m = spectrum.melspectrogram(
            wav[: len(fs2_mel) * HOP], n_fft=N_FFT, hop_length=HOP, win_length=N_FFT,
            n_mels=N_MELS, sample_rate=SR, norm="slaney", mel_type="slaney")
        return np.log(np.maximum(m, 1e-5)).T[: len(fs2_mel)]

    mel_rt = analyze(audio)
    noise = np.random.default_rng(0).standard_normal(len(fs2_mel) * HOP).astype(np.float32) * 0.1
    return {"mel_l1_roundtrip": round(float(np.abs(mel_rt - fs2_mel).mean()), 4),
            "mel_l1_noise_baseline": round(float(np.abs(analyze(noise) - fs2_mel).mean()), 4)}


def overrides(feature_dir, ckpt_dir, steps, batch, lr):
    """The JAX script's overrides of the recipe's YAML."""
    return [
        "--data.feature_dir", feature_dir,
        "--data.n_mels", str(N_MELS), "--data.hop_length", str(HOP),
        "--data.sample_rate", str(SR),
        "--data.max_phoneme_len", str(MAX_PH),
        "--data.max_mel_len", str(MAX_MEL),
        "--data.batch_size", str(batch),
        "--optim.lr", str(lr),
        "--optim.epochs", "100000",
        "--train.max_steps", str(steps),
        "--train.ckpt_dir", ckpt_dir,
        "--train.save_every_steps", str(max(steps // 4, 1)),
        "--train.log_every_steps", "50",
    ]


_LOG_LINE = re.compile(r"step (\d+) loss ([\d.]+) \(mel ([\d.]+) dur ([\d.]+) "
                       r"pitch ([\d.]+) energy ([\d.]+)\)")


def train_with_curve(argv):
    """``train.main(argv)``, with the loss curve read from its log lines (as
    the JAX script reads it); returns the curve."""
    get_logger(fs2_train.LOGGER)  # configured first: train's own call keeps our handler
    curve = []

    class _Curve(logging.Handler):
        def emit(self, record):
            m = _LOG_LINE.search(record.getMessage())
            if m:
                curve.append({"step": int(m.group(1)), "loss": float(m.group(2)),
                              "mel": float(m.group(3)), "dur": float(m.group(4)),
                              "pitch": float(m.group(5)), "energy": float(m.group(6))})

    handler = _Curve()
    logging.getLogger(fs2_train.LOGGER).addHandler(handler)
    try:
        fs2_train.main(argv)
    finally:
        logging.getLogger(fs2_train.LOGGER).removeHandler(handler)
    return curve


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--utts", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=32)
    # post-LN FFT stacks sit near a cliff at Adam 1e-3 (the JAX script's
    # measurement): 5e-4
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--init-seed", type=int, default=0, help="seed of the weights' generator")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--corpus_dir", default="", help="corpus directory (a temporary one if unset)")
    ap.add_argument("--out", default="", help="results directory (default: the corpus's)")
    ap.add_argument("--wavegrad_ckpt", default="",
                    help="trained WaveGrad checkpoint directory for the end-to-end leg")
    ap.add_argument("--write_wavs", action="store_true",
                    help="also write corpus wavs (to train a WaveGrad on)")
    ap.add_argument("--gen-only", action="store_true", help="write the corpus and stop")
    ap.add_argument("--skip_train", action="store_true")
    ap.add_argument("--prep_wavegrad", default="",
                    help="write WaveGrad (audio, mel) features for the corpus wavs to this dir "
                         "and exit")
    return ap.parse_args(argv)


def main(argv=None):
    """Run the protocol; returns the results (None for ``--gen-only`` and
    ``--prep_wavegrad``)."""
    args = parse_args(argv)
    feature_dir = args.corpus_dir or tempfile.mkdtemp(prefix="fs2_convergence_")
    out_dir = args.out or feature_dir
    if args.prep_wavegrad:
        prepare_wavegrad_corpus(feature_dir, args.prep_wavegrad)
        return None

    if not os.path.exists(os.path.join(feature_dir, "train.txt")):
        print(f"building corpus ({args.utts} utts) ...", flush=True)
        dev_names = build_corpus(feature_dir, args.utts, write_wavs=args.write_wavs)
    else:
        with open(os.path.join(feature_dir, "dev.txt")) as f:
            dev_names = f.read().split()
    if args.gen_only:
        return None

    fs2_train.use_float32()
    suffix = _suffix(args.init_seed)
    ckpt_dir = os.path.join(feature_dir, f"ckpt_seed{args.init_seed}")
    argv_train = overrides(feature_dir, ckpt_dir, args.steps, args.batch, args.lr) + [
        "--device", args.device, "--init-seed", str(args.init_seed)]
    os.makedirs(out_dir, exist_ok=True)
    if not args.skip_train:
        curve = train_with_curve(argv_train)
        with open(os.path.join(out_dir, f"loss_curve{suffix}.json"), "w") as f:
            json.dump(curve, f, indent=1)

    cfg, device, _ = fs2_train.parse_args(argv_train)
    results = evaluate(cfg, restore_checkpoint(ckpt_dir)["params"], dev_names, feature_dir,
                       out_dir, device, seed=args.init_seed, wavegrad_ckpt=args.wavegrad_ckpt)
    results["config"] = {"steps": args.steps, "utts": args.utts, "batch": args.batch,
                         "n_phones": N_PHONES, "init_seed": args.init_seed,
                         "cudnn_tf32": torch.backends.cudnn.allow_tf32,
                         "device": torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"}
    with open(os.path.join(out_dir, f"results{suffix}.json"), "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
