"""FastSpeech2 synthesis: text → mel ``.npy`` (port of
``examples/fastspeech2/generate.py``).

The text becomes symbol ids through the recipe's front end (``--pinyin``,
or a config with ``data.pinyin: true``, reads it as tone-numbered pinyin;
``data.cmudict_path`` turns English words into ARPAbet phones), the latest
checkpoint under ``train.ckpt_dir`` (either layout: ``FastSpeech2WithLoss``'s
``model.``-scoped names or the bare model's) is loaded, and
``FastSpeech2.infer`` predicts durations, pitch and energy and the mel
``(mel_len, n_mels)``, saved to ``--output``. With ``--wavegrad_ckpt`` the
mel is also vocoded: the WaveGrad checkpoint under that directory (either
layout, ``wavegrad.train.load_vocoder``) must take this model's mel bins at
hop 300 (else the run exits with the mismatch), the ``ln`` power mel is
mapped to the vocoder's ``[0, 1]`` dB convention, ``(10 mel / ln 10 +
80) / 100`` clipped, and the 1000-step sampler (draws seeded 0) writes
``<output>.wav`` at ``data.sample_rate``.

Usage::

    python -m mindaudio_torch.recipes.fastspeech2.generate --text "hello world" \\
        [--pinyin] [--output generated_mel.npy] [--wavegrad_ckpt DIR] [--device cuda] \\
        [--train.ckpt_dir ...]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ...data import io
from ...models.wavegrad import reverse_diffusion
from ...train.checkpoint import restore_checkpoint
from ..wavegrad.train import load_vocoder
from .text import load_cmudict, pinyin_to_sequence, text_to_sequence
from .train import build_model, load_params, parse_args, use_float32


def main(argv=None):
    """Synthesize ``--text``; returns the mel ``(mel_len, n_mels)`` saved."""
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--text", default="the quick brown fox jumps over the lazy dog")
    parser.add_argument("--pinyin", action="store_true",
                        help="treat --text as tone-numbered Mandarin pinyin ('ni3 hao3')")
    parser.add_argument("--output", default="generated_mel.npy")
    parser.add_argument("--wavegrad_ckpt", default="")
    args, rest = parser.parse_known_args(argv)

    cfg, device, _ = parse_args(rest)
    use_float32()
    fs2, _ = build_model(cfg, device)
    load_params(fs2, restore_checkpoint(cfg.train.ckpt_dir)["params"])

    if args.pinyin or bool(getattr(cfg.data, "pinyin", False)):
        seq = pinyin_to_sequence(args.text)
    else:
        cmudict = load_cmudict(cfg.data.cmudict_path) if cfg.data.cmudict_path else None
        seq = text_to_sequence(args.text, cmudict=cmudict)
    phonemes = torch.tensor([seq], dtype=torch.long, device=device)
    src_lens = torch.tensor([len(seq)], dtype=torch.long, device=device)

    mel, _, _, _, mel_len, _ = fs2.infer(phonemes, src_lens, int(cfg.data.max_mel_len))
    mel = mel[0, :int(mel_len[0])].cpu().numpy()
    np.save(args.output, mel)
    print(f"mel: {mel.shape} -> {args.output}")

    if args.wavegrad_ckpt:
        wg = load_vocoder(args.wavegrad_ckpt, device)
        wg_mels = wg.u_conv.weight.shape[1]
        if int(cfg.data.hop_length) != 300 or mel.shape[-1] != wg_mels:
            raise SystemExit(
                f"vocoder mismatch: FastSpeech2 mel ({mel.shape[-1]} bins, hop "
                f"{cfg.data.hop_length}) vs WaveGrad ({wg_mels} bins, hop 300). Re-run both "
                f"preprocess steps with data.n_mels={wg_mels} and data.hop_length=300.")
        # FastSpeech2's ln(power mel) -> WaveGrad's [0, 1] dB: 10 log10(power),
        # then (dB + 80) / 100
        mel_db = np.clip((10.0 * mel / np.log(10.0) - 20.0 + 100.0) / 100.0,
                         0.0, 1.0).astype(np.float32)
        audio = reverse_diffusion(wg, torch.as_tensor(mel_db[None], device=device),
                                  torch.Generator(device=device).manual_seed(0), hop=300)
        wav_path = os.path.splitext(args.output)[0] + ".wav"
        io.write(wav_path, audio[0].cpu().numpy(), int(cfg.data.sample_rate))
        print(f"audio -> {wav_path}")
    return mel


if __name__ == "__main__":
    main()
