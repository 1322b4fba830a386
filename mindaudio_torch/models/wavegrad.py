"""WaveGrad diffusion vocoder (port of ``mindaudio_tpu.models.wavegrad``).

A downsampling branch over the noisy audio (``d_conv``, then ``DBlock``s)
gives one FiLM ``(shift, scale)`` pair per scale, conditioned on the
continuous noise level; an upsampling branch over the mel (``u_conv``, then
``UBlock``s) consumes them from the coarsest scale up, and ``out_conv``
predicts the noise. The layout inside is channels-first, ``(B, C, T)``, so
that every convolution is a ``Conv1d``; the outside interface is the JAX
model's: ``mel (B, frames, n_mels)`` and ``noisy_audio (B, frames * hop)``
in, ``(B, frames * hop)`` out. Module names follow the flax ones
(``d_conv``, ``film_<i>.encoding_conv``/``shift_conv``/``scale_conv``,
``dblock_<i>.res_conv``/``conv1..3``, ``u_conv``,
``ublock_<i>.res_conv``/``conv1..4``, ``out_conv``), so
``convert.convert_params`` carries a JAX tree across. As in the JAX model:

- every convolution pads as flax's ``"SAME"``: ``d * (k - 1) // 2`` on each
  side (odd kernels only);
- weights are orthogonal (on the ``(out, in * k)`` view) and biases start at
  zero;
- the noise-level encoding is ``level * exp(-ln(1e4) * i / (C/2))``, sin
  then cos, with no factor on the level;
- a ``DBlock`` downsamples by taking every ``factor``-th sample, a
  ``UBlock`` upsamples by repeating each sample ``factor`` times;
- FiLM ``i`` modulates ``UBlock`` ``len(films) - 1 - i``, three times with
  the same pair; LeakyReLU slope 0.2.

:func:`reverse_diffusion` is the ancestral sampler: its ``(S, 4)`` table is
computed on the host in float64 and copied to the device once, and its loop
reads nothing back to the host.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from .. import check_generator, resolve_device

__all__ = ["PositionalEncoding", "FiLM", "DBlock", "UBlock", "WaveGrad", "WaveGradWithLoss",
           "default_noise_schedule", "fast_noise_schedule", "noise_levels", "sampler_schedule",
           "diffuse", "reverse_diffusion"]

SLOPE = 0.2


def _conv(cin, cout, kernel, dilation=1):
    """flax ``nn.Conv(padding="SAME")`` for an odd kernel."""
    return nn.Conv1d(cin, cout, kernel, dilation=dilation, padding=dilation * (kernel - 1) // 2)


def _lrelu(x):
    return F.leaky_relu(x, SLOPE)


class PositionalEncoding(nn.Module):
    """Add the noise level's sinusoidal encoding to every frame of
    ``x (B, C, T)``; ``noise_level (B,)``."""

    def __init__(self, dim):
        super().__init__()
        self.dim = dim

    def forward(self, x, noise_level):
        count = self.dim // 2
        step = torch.arange(count, dtype=torch.float32, device=x.device) / count
        encoding = noise_level[:, None] * torch.exp(-math.log(1e4) * step[None])
        encoding = torch.cat([torch.sin(encoding), torch.cos(encoding)], dim=-1)
        return x + encoding[:, :, None].to(x.dtype)


class FiLM(nn.Module):
    """``(shift, scale)``, each ``(B, out, T)``, from ``x (B, in, T)`` and
    the noise level."""

    def __init__(self, in_channels, output_size):
        super().__init__()
        self.encoding_conv = _conv(in_channels, output_size, 3)
        self.pos = PositionalEncoding(output_size)
        self.shift_conv = _conv(output_size, output_size, 3)
        self.scale_conv = _conv(output_size, output_size, 3)

    def forward(self, x, noise_scale):
        x = _lrelu(self.pos(self.encoding_conv(x), noise_scale))
        return self.shift_conv(x), self.scale_conv(x)


class DBlock(nn.Module):
    """Downsampling residual block on the noisy audio: ``(B, in, T) -> (B,
    out, T / factor)``."""

    def __init__(self, in_channels, out_channels, factor):
        super().__init__()
        self.factor = factor
        self.res_conv = _conv(in_channels, out_channels, 1)
        self.conv1 = _conv(in_channels, out_channels, 3, 1)
        self.conv2 = _conv(out_channels, out_channels, 3, 2)
        self.conv3 = _conv(out_channels, out_channels, 3, 4)

    def forward(self, x):
        res = self.res_conv(x[:, :, ::self.factor])
        y = self.conv1(_lrelu(x)[:, :, ::self.factor])
        y = self.conv2(_lrelu(y))
        y = self.conv3(_lrelu(y))
        return y + res


class UBlock(nn.Module):
    """Upsampling FiLM-modulated block on the mel branch: ``(B, in, T) ->
    (B, out, T * factor)``, each sample repeated ``factor`` times."""

    def __init__(self, in_channels, out_channels, factor, dilations=(1, 2, 4, 8)):
        super().__init__()
        self.factor = factor
        self.res_conv = _conv(in_channels, out_channels, 1)
        self.conv1 = _conv(in_channels, out_channels, 3, dilations[0])
        self.conv2 = _conv(out_channels, out_channels, 3, dilations[1])
        self.conv3 = _conv(out_channels, out_channels, 3, dilations[2])
        self.conv4 = _conv(out_channels, out_channels, 3, dilations[3])

    def forward(self, x, film_shift, film_scale):
        res = self.res_conv(torch.repeat_interleave(x, self.factor, dim=2))
        y = self.conv1(torch.repeat_interleave(_lrelu(x), self.factor, dim=2))
        y = torch.addcmul(film_shift, film_scale, y)
        y = self.conv2(_lrelu(y))
        block1 = y + res
        y = torch.addcmul(film_shift, film_scale, block1)
        y = self.conv3(_lrelu(y))
        y = torch.addcmul(film_shift, film_scale, y)
        y = self.conv4(_lrelu(y))
        return y + block1


class WaveGrad(nn.Module):
    """Mel + noisy audio + noise level → predicted noise.

    ``forward(mel, noisy_audio, noise_scale)``: mel ``(B, frames, n_mels)``,
    noisy_audio ``(B, frames * hop)``, noise_scale ``(B,)``; returns the
    predicted noise ``(B, frames * hop)``. The upsampling factors (5, 5, 3,
    2, 2) multiply to hop = 300. The defaults are the JAX model's
    (17,233,217 parameters at 128 mels).
    """

    def __init__(self, n_mels=128, up_factors=(5, 5, 3, 2, 2), down_factors=(2, 2, 3, 5),
                 down_channels=(128, 128, 256, 512), film_channels=(128, 128, 256, 512, 512),
                 up_channels=(512, 512, 256, 128, 128), device="cuda"):
        super().__init__()
        if len(film_channels) != len(down_channels) + 1 or len(up_channels) != len(film_channels):
            raise ValueError("WaveGrad: one FiLM per scale of the downsampling branch, "
                             "one UBlock per FiLM")
        self.up_factors, self.down_factors = tuple(up_factors), tuple(down_factors)
        self.hop = math.prod(self.up_factors)
        self.d_conv = _conv(1, 32, 5)
        d_in = [32] + list(down_channels)
        for i, c in enumerate(film_channels):
            setattr(self, f"film_{i}", FiLM(d_in[i], c))
        for i, (f, c) in enumerate(zip(down_factors, down_channels)):
            setattr(self, f"dblock_{i}", DBlock(d_in[i], c, f))
        self.u_conv = _conv(n_mels, 768, 3)
        u_in = [768] + list(up_channels)
        for i, (f, c) in enumerate(zip(up_factors, up_channels)):
            setattr(self, f"ublock_{i}", UBlock(u_in[i], c, f))
        self.out_conv = _conv(up_channels[-1], 1, 3)
        self.films = [getattr(self, f"film_{i}") for i in range(len(film_channels))]
        self.dblocks = [getattr(self, f"dblock_{i}") for i in range(len(down_channels))]
        self.ublocks = [getattr(self, f"ublock_{i}") for i in range(len(up_channels))]
        self.to(resolve_device(device))

    @torch.no_grad()
    def reset_parameters(self, generator):
        """flax's init from ``generator`` (on the model's device): orthogonal
        weights on the ``(out, in * k)`` view, zero biases."""
        for module in self.modules():
            if isinstance(module, nn.Conv1d):
                nn.init.orthogonal_(module.weight, generator=generator)
                module.bias.zero_()
        return self

    def forward(self, mel, noisy_audio, noise_scale):
        d = self.d_conv(noisy_audio[:, None, :])
        films = [self.films[0](d, noise_scale)]
        for dblock, film in zip(self.dblocks, self.films[1:]):
            d = dblock(d)
            films.append(film(d, noise_scale))
        u = self.u_conv(mel.transpose(1, 2))
        for i, ublock in enumerate(self.ublocks):
            u = ublock(u, *films[len(films) - 1 - i])
        return self.out_conv(u)[:, 0]


class WaveGradWithLoss(nn.Module):
    """The L1 loss of the predicted noise against ``noise_target``; the model
    is ``model`` (the JAX tree's ``model`` scope)."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, mel, noisy_audio, noise_scale, noise_target):
        return (self.model(mel, noisy_audio, noise_scale) - noise_target).abs().mean()


def default_noise_schedule(num_steps=1000, beta_start=1e-6, beta_end=0.01):
    """The linear beta schedule of training and of the 1000-step sampler
    (float64 numpy)."""
    return np.linspace(beta_start, beta_end, num_steps)


def fast_noise_schedule():
    """WaveGrad's 6-step inference schedule (Chen et al. 2020, section 4):
    the model is conditioned on the continuous noise level, so any schedule
    samples it."""
    return np.asarray([1e-4, 1e-3, 1e-2, 5e-2, 2e-1, 5e-1])


def noise_levels(betas):
    """``sqrt(cumprod(1 - betas))``, computed in float64 and rounded to
    float32 (numpy), as the JAX recipe's training table."""
    return np.sqrt(np.cumprod(1.0 - np.asarray(betas, np.float64))).astype(np.float32)


def sampler_schedule(betas):
    """The sampler's ``(S, 4)`` float32 table, in the order the loop reads
    it (``idx = S-1 ... 0``): ``c1 = 1/sqrt(alpha)``, ``c2 = beta /
    sqrt(1 - alpha_cum)``, the posterior ``sigma`` (0 at ``idx = 0``) and
    the noise level ``sqrt(alpha_cum)``; computed in float64 on the host."""
    betas = np.asarray(betas, np.float64)
    alphas = 1.0 - betas
    alphas_cum = np.cumprod(alphas)
    c1 = 1.0 / np.sqrt(alphas)
    c2 = betas / np.sqrt(1.0 - alphas_cum)
    alphas_cum_prev = np.concatenate([[alphas_cum[0]], alphas_cum[:-1]])
    sigma = np.sqrt(betas * (1.0 - alphas_cum_prev) / (1.0 - alphas_cum))
    sigma[0] = 0.0  # the last step adds no noise
    return np.stack([c1, c2, sigma, np.sqrt(alphas_cum)], 1)[::-1].astype(np.float32)


def diffuse(generator, audio, bounds):
    """q-sample with a continuous noise level: per example a scale uniform
    in ``bounds = (lo, hi)`` (floats or device scalars), then ``scale *
    audio + sqrt(1 - scale^2) * noise``. Returns ``(noisy, noise, scale)``;
    the draws come from ``generator``, which must live on ``audio``'s
    device."""
    check_generator(generator, audio.device, "diffuse")
    lo, hi = bounds
    b = audio.shape[0]
    scale = lo + torch.rand(b, generator=generator, device=audio.device) * (hi - lo)
    noise = torch.randn(audio.shape, generator=generator, device=audio.device)
    scale_ = scale[:, None]
    noisy = scale_ * audio + torch.sqrt(1.0 - scale_ ** 2) * noise
    return noisy, noise, scale


@torch.no_grad()
def reverse_diffusion(model, mel, generator=None, betas=None, hop=300, noise=None):
    """Ancestral sampling: ``mel (B, frames, n_mels)`` → audio ``(B, frames
    * hop)`` in ``[-1, 1]``, over the schedule ``betas`` (default: the
    1000-step one). The table (:func:`sampler_schedule`) is copied to the
    device once and the loop makes no host synchronisation. The S + 1
    Gaussian draws (the start, then one a step) come from ``generator`` on
    ``mel``'s device, or, where ``noise`` is given, from it in that order
    (``(S + 1, B, frames * hop)``; the parity test feeds JAX's own draws)."""
    if betas is None:
        betas = default_noise_schedule()
    sched = torch.from_numpy(sampler_schedule(betas)).to(mel.device)
    b, frames, _ = mel.shape
    shape = (b, frames * hop)
    if noise is None:
        check_generator(generator, mel.device, "reverse_diffusion")

        def draw(i):
            return torch.randn(shape, generator=generator, device=mel.device)
    else:
        if noise.shape != (len(sched) + 1,) + shape:
            raise ValueError(f"reverse_diffusion: noise {tuple(noise.shape)}, want "
                             f"{(len(sched) + 1,) + shape}")

        def draw(i):
            return noise[i].to(mel.device)
    audio = draw(0)
    ones = torch.ones(b, device=mel.device)
    for i in range(len(sched)):
        c1, c2, sigma, level = sched[i]
        eps = model(mel, audio, level * ones)
        audio = c1 * (audio - c2 * eps) + sigma * draw(i + 1)
    return audio.clamp(-1.0, 1.0)
