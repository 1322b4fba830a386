"""TasNet (LSTM) LibriMix training on one NVIDIA GPU (port of
``examples/tasnet/train.py``).

The raw mixture is framed on the card (``TasNet.frame_waveform``),
separated, overlap-added back and cut to its length (:func:`separate_full`),
then scored by the permutation-invariant SI-SNR loss; the rest of the step
(clip, Adam, the skip of a non-finite batch), the data and the checkpoints
are the Conv-TasNet recipe's (``recipes/conv_tasnet/train.py``). The
BiLSTMs are cuDNN's fused LSTM in float32, with TF32 unless
``torch.backends.cudnn.allow_tf32`` is False.

Usage::

    python -m mindaudio_torch.recipes.tasnet.train [--config tasnet.yaml] [--device cuda] \\
        [--train.max_steps 100] [--data.train_dir ...] ...
"""

from __future__ import annotations

import os

import torch
from torch.nn import functional as F

from ...models.tasnet import TasNet
from ...parallel.mesh import init_mesh
from ..conv_tasnet import train as conv_train

DEFAULT_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tasnet.yaml")
INIT_SEED = 0


def parse_args(argv=None):
    """``(config, device)``, as the Conv-TasNet recipe's, from ``tasnet.yaml``."""
    return conv_train.parse_args(argv, default_config=DEFAULT_CONFIG)


def build_model(cfg, device):
    """The float32 ``TasNet`` of the config on ``device``, weights from
    :data:`INIT_SEED`."""
    m = cfg.model
    model = TasNet(enc_dim=int(m.enc_dim), frame_len=int(m.frame_len), num_spk=int(m.num_spk),
                   hidden=int(m.hidden), num_layers=int(m.num_layers), device=device)
    return model.reset_parameters(torch.Generator(device=device).manual_seed(INIT_SEED))


def separate_full(model, mix):
    """``(B, T)`` mixtures → ``(B, C, T)`` sources: frame, separate,
    overlap-add, cut to ``T``."""
    est = model.reconstruct(model(model.frame_waveform(mix)))
    t = mix.shape[-1]
    if est.shape[-1] < t:
        est = F.pad(est, (0, t - est.shape[-1]))
    return est[..., :t]


def main(argv=None):
    """Train as the config says; returns what ``conv_tasnet.train.train``
    returns."""
    cfg, device = parse_args(argv)
    conv_train.check_supported(cfg)
    device, _ = init_mesh(device)
    return conv_train.train(cfg, device, build_model(cfg, device), separate_full,
                            "tasnet_torch")


if __name__ == "__main__":
    main()
