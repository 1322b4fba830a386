"""LJSpeech → WaveGrad training features: per utterance the audio and its
log-mel (port of ``examples/wavegrad/preprocess.py``; host NumPy, the same
files for the same corpus).

Each wav under ``<ljspeech_dir>/wavs`` is cut to a whole number of hops, so
that ``frames * hop`` is the audio's length; its mel is
``data/spectrum.melspectrogram`` of the magnitude (``power=1``, zero-padded
centre frames), in dB as ``20 log10(max(mel, 1e-5)) - 20``, mapped to
``[0, 1]`` by ``clip((dB + 100) / 100, 0, 1)`` and stored ``(frames,
n_mels)``. Writes ``<feature_dir>/<utt>.npy`` dicts ``{"audio", "mel"}``
and ``train.txt``.

Usage::

    python -m mindaudio_torch.recipes.wavegrad.preprocess [--config wavegrad.yaml] \\
        [--data.ljspeech_dir ...] [--data.feature_dir ...]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ...data import io, spectrum
from ...train.config import get_config

DEFAULT_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "wavegrad.yaml")


def features(wav, sr, cfg):
    """``{"audio", "mel"}`` of one float32 waveform."""
    hop = int(cfg.data.hop_length)
    n_frames = len(wav) // hop
    wav = wav[: n_frames * hop]
    mel = spectrum.melspectrogram(
        wav, n_fft=int(cfg.data.n_fft), hop_length=hop, win_length=int(cfg.data.win_length),
        n_mels=int(cfg.data.n_mels), sample_rate=sr, pad_mode="constant", power=1.0,
    )[:, :n_frames]
    mel = 20.0 * np.log10(np.clip(mel, 1e-5, None)) - 20.0
    mel = np.clip((mel + 100.0) / 100.0, 0.0, 1.0).T.astype(np.float32)
    return {"audio": wav, "mel": mel}


def main(argv=None):
    """Preprocess as the config says; returns the utterance names written."""
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--config", default=DEFAULT_CONFIG)
    args, _ = parser.parse_known_args(argv)
    cfg = get_config(args.config, argv)
    out_dir = cfg.data.feature_dir
    os.makedirs(out_dir, exist_ok=True)

    entries = []
    wav_dir = os.path.join(cfg.data.ljspeech_dir, "wavs")
    for name in sorted(os.listdir(wav_dir)):
        if not name.endswith(".wav"):
            continue
        utt = os.path.splitext(name)[0]
        wav, sr = io.read(os.path.join(wav_dir, name))
        wav = np.asarray(wav, np.float32)
        if wav.ndim > 1:
            wav = wav[:, 0]
        np.save(os.path.join(out_dir, utt + ".npy"), features(wav, sr, cfg))
        entries.append(utt)

    with open(os.path.join(out_dir, "train.txt"), "w") as f:
        f.write("\n".join(entries))
    print(f"wrote {len(entries)} utterances to {out_dir}")
    return entries


if __name__ == "__main__":
    main()
