"""FastSpeech2 synthesis: text → mel ``.npy`` (port of
``examples/fastspeech2/generate.py``).

The text becomes symbol ids through the recipe's front end (``--pinyin``,
or a config with ``data.pinyin: true``, reads it as tone-numbered pinyin;
``data.cmudict_path`` turns English words into ARPAbet phones), the latest
checkpoint under ``train.ckpt_dir`` (either layout: ``FastSpeech2WithLoss``'s
``model.``-scoped names or the bare model's) is loaded, and
``FastSpeech2.infer`` predicts durations, pitch and energy and the mel
``(mel_len, n_mels)``, saved to ``--output``. The WaveGrad vocoder is not
ported yet: ``--wavegrad_ckpt`` raises ``NotImplementedError``.

Usage::

    python -m mindaudio_torch.recipes.fastspeech2.generate --text "hello world" \\
        [--pinyin] [--output generated_mel.npy] [--device cuda] [--train.ckpt_dir ...]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ...train.checkpoint import restore_checkpoint
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
    if args.wavegrad_ckpt:
        raise NotImplementedError("the WaveGrad vocoder is not ported to PyTorch yet "
                                  "(ROADMAP queue 1 item 7.2)")

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
    return mel


if __name__ == "__main__":
    main()
