"""WaveGrad inference: mel → audio by reverse diffusion on the card (port of
``examples/wavegrad/reverse.py``).

The mel is a ``(T, n_mels)`` ``.npy`` or a ``preprocess`` feature dict
holding ``mel``; the vocoder is the latest checkpoint under
``train.ckpt_dir`` (either layout, ``train.load_vocoder``); the sampler runs
the config's 1000-step schedule, or the 6-step one with ``--fast``, its
draws from a generator on the card seeded ``--seed``; the audio is written
as a WAV at ``data.sample_rate``.

Usage::

    python -m mindaudio_torch.recipes.wavegrad.reverse --mel features.npy \\
        [--output out.wav] [--fast] [--seed 0] [--device cuda] [--train.ckpt_dir ...]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ...data import io
from ...models.wavegrad import default_noise_schedule, fast_noise_schedule, reverse_diffusion
from .train import load_vocoder, parse_args, use_float32


def main(argv=None):
    """Vocode ``--mel``; returns the audio written (float32 numpy)."""
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--mel", required=True,
                        help=".npy with a (T, n_mels) mel, or a preprocess feature dict")
    parser.add_argument("--output", default="wavegrad_out.wav")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--fast", action="store_true",
                        help="the 6-step inference schedule (WaveGrad section 4)")
    args, rest = parser.parse_known_args(argv)

    cfg, device, _ = parse_args(rest)
    use_float32()
    data = np.load(args.mel, allow_pickle=True)
    mel = data.item()["mel"] if data.dtype == object else data
    mel = torch.as_tensor(np.asarray(mel, np.float32)[None], device=device)
    model = load_vocoder(cfg.train.ckpt_dir, device, cfg)
    if args.fast:
        betas = fast_noise_schedule()
    else:
        d = cfg.diffusion
        betas = default_noise_schedule(int(d.num_steps), float(d.beta_start), float(d.beta_end))
    audio = reverse_diffusion(model, mel, torch.Generator(device=device).manual_seed(args.seed),
                              betas=betas, hop=int(cfg.data.hop_length))
    audio = audio[0].cpu().numpy()
    io.write(args.output, audio, int(cfg.data.sample_rate))
    print(f"audio {tuple(audio.shape)} -> {args.output}")
    return audio


if __name__ == "__main__":
    main()
