"""LJSpeech → FastSpeech2 features: phonemes, mel, pitch, energy and
durations (port of ``examples/fastspeech2/preprocess.py``; host NumPy, the
same files for the same corpus).

- durations and phonemes come from an MFA ``<utt>.TextGrid`` under
  ``<feature_dir>/TextGrid`` when there is one (``data/textgrid``), and the
  wav is trimmed to the aligned span; else from a ``<utt>.npy`` duration
  array there, cut or zero-padded to the transcript's phonemes; with no
  alignment at all the mel frames are split evenly over the transcript's
  phonemes (``data.pinyin`` reads the transcript as tone-numbered pinyin);
- the durations are clamped into the mel's frame count;
- pitch is the YIN f0 (``data/features.yin``) as ``log1p(Hz)``, and energy
  the RMS of each hop, both averaged over each phoneme's frames;
- the mel is ``log(max(mel, 1e-5))`` of ``data/spectrum.melspectrogram``
  (zero-padded centre frames), ``(T, n_mels)``.

Writes ``<feature_dir>/<utt>.npy`` dicts and ``train.txt``.

Usage::

    python -m mindaudio_torch.recipes.fastspeech2.preprocess [--config fastspeech2.yaml] \\
        [--data.ljspeech_dir ...] [--data.feature_dir ...]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ...data import io, spectrum
from ...data.features import yin
from ...data.textgrid import alignment_to_durations, read_textgrid
from ...train.config import get_config
from .text import load_cmudict, phones_to_sequence, pinyin_to_sequence, text_to_sequence

DEFAULT_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fastspeech2.yaml")


def phoneme_average(frame_values, durations):
    """Average frame-level values over phoneme spans (FastSpeech2 convention)."""
    out = np.zeros(len(durations), np.float32)
    pos = 0
    for i, d in enumerate(durations):
        d = int(d)
        if d > 0:
            out[i] = frame_values[pos: pos + d].mean()
        pos += d
    return out


def uniform_durations(n_phones, n_frames):
    edges = np.linspace(0, n_frames, n_phones + 1)
    return np.diff(np.round(edges)).astype(np.int32)


def features(wav, wav_sr, phonemes, durations, cfg):
    """The feature dict of one utterance: ``durations`` (None: split evenly)
    clamped into the mel's frames, the phoneme-averaged pitch and energy."""
    hop = int(cfg.data.hop_length)
    mel = spectrum.melspectrogram(
        wav, n_fft=int(cfg.data.n_fft), hop_length=hop, win_length=int(cfg.data.win_length),
        n_mels=int(cfg.data.n_mels), sample_rate=wav_sr, pad_mode="constant",
    )  # (n_mels, T)
    mel = np.log(np.maximum(mel, 1e-5)).T.astype(np.float32)  # (T, n_mels)
    n_frames = mel.shape[0]
    if durations is None:
        durations = uniform_durations(len(phonemes), n_frames)
    # clamp into the mel frame budget: durations summing past n_frames would
    # make phoneme_average take empty slices
    cum = np.cumsum(durations.astype(np.int64))
    durations = np.where(cum <= n_frames, durations,
                         np.maximum(n_frames - (cum - durations), 0)).astype(np.int32)

    # log1p keeps pitch in the variance adaptor's bucket range, and YIN's
    # unvoiced zeros stay zero
    f0_hz = yin(wav, sample_rate=wav_sr, hop_length=hop)
    f0 = np.log1p(np.pad(f0_hz, (0, max(0, n_frames - len(f0_hz))))[:n_frames])
    energy = np.sqrt(np.add.reduceat(
        np.pad(wav, (0, max(0, n_frames * hop - len(wav)))) ** 2,
        np.arange(0, n_frames * hop, hop)) / hop).astype(np.float32)
    return {"phonemes": phonemes, "mel": mel, "pitch": phoneme_average(f0, durations),
            "energy": phoneme_average(energy, durations), "duration": durations}


def utterance(utt, text, cfg, cmudict):
    """The features of one ``metadata.csv`` entry, or None when its wav is
    missing or it has no phoneme."""
    wav_path = os.path.join(cfg.data.ljspeech_dir, "wavs", utt + ".wav")
    if not os.path.exists(wav_path):
        return None
    wav, wav_sr = io.read(wav_path)
    wav = np.asarray(wav, np.float32)
    if wav.ndim > 1:
        wav = wav[:, 0]

    tg_dir = os.path.join(cfg.data.feature_dir, "TextGrid")
    tg_path = os.path.join(tg_dir, utt + ".TextGrid")
    durations = None
    if os.path.exists(tg_path):
        tiers = read_textgrid(tg_path)
        tier = tiers.get("phones") or next(iter(tiers.values()), [])
        phones, durs, start_s, end_s = alignment_to_durations(tier, wav_sr,
                                                              int(cfg.data.hop_length))
        if not phones:
            return None
        wav = wav[int(round(start_s * wav_sr)):int(round(end_s * wav_sr))]
        phonemes = np.asarray(phones_to_sequence(phones), np.int32)
        durations = np.asarray(durs, np.int32)
    elif bool(getattr(cfg.data, "pinyin", False)):
        phonemes = np.asarray(pinyin_to_sequence(text), np.int32)
    else:
        phonemes = np.asarray(text_to_sequence(text, cmudict=cmudict), np.int32)
    if len(phonemes) == 0:
        return None

    npy = os.path.join(tg_dir, utt + ".npy")
    if durations is None and os.path.exists(npy):
        durations = np.load(npy).astype(np.int32)[: len(phonemes)]
        if len(durations) < len(phonemes):
            durations = np.pad(durations, (0, len(phonemes) - len(durations)))
    return features(wav, wav_sr, phonemes, durations, cfg)


def main(argv=None):
    """Preprocess ``data.ljspeech_dir`` into ``data.feature_dir``; returns
    the utterances written."""
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--config", default=DEFAULT_CONFIG)
    args, _ = parser.parse_known_args(argv)
    cfg = get_config(args.config, argv)
    out_dir = cfg.data.feature_dir
    os.makedirs(out_dir, exist_ok=True)
    cmudict = load_cmudict(cfg.data.cmudict_path) if cfg.data.cmudict_path else None

    entries = []
    with open(os.path.join(cfg.data.ljspeech_dir, "metadata.csv"), encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split("|")
            if len(parts) < 2:
                continue
            feats = utterance(parts[0], parts[-1], cfg, cmudict)
            if feats is not None:
                np.save(os.path.join(out_dir, parts[0] + ".npy"), feats)
                entries.append(parts[0])

    with open(os.path.join(out_dir, "train.txt"), "w") as f:
        f.write("\n".join(entries))
    print(f"wrote {len(entries)} utterances to {out_dir}")
    return entries


if __name__ == "__main__":
    main()
