"""Front ends: Kaldi's log-mel fbank with dither, SpecAugment, and
DeepSpeech2's normalized log-magnitude spectrogram, with an FFT where the
port takes a DFT product. The random draws (dither, SpecAugment's bands)
are made from the generator given, in the order and shapes in which the
recipes draw them, so that a generator seeded alike gives the same noise
and the same bands.
"""

from __future__ import annotations

import math

import numpy as np
import torch

LOG_FLOOR = float(np.finfo(np.float32).eps)


def povey_window(n):
    """Kaldi's window: the symmetric Hann window to the power 0.85."""
    i = np.arange(n, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * i / (n - 1))) ** 0.85


def kaldi_mel_banks(num_bins, n_fft, sample_rate, low_freq=20.0):
    """``(n_fft//2 + 1, num_bins)``: triangles on the mel scale ``1127
    ln(1 + f/700)`` with edges uniform in mel over [low_freq, rate/2],
    evaluated at each bin's mel; the Nyquist bin gets no weight."""
    def mel(f):
        return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)

    bins = mel(sample_rate / n_fft * np.arange(n_fft // 2))
    edges = np.linspace(mel(low_freq), mel(sample_rate / 2.0), num_bins + 2)
    left, centre, right = edges[:-2, None], edges[1:-1, None], edges[2:, None]
    w = np.maximum(0.0, np.minimum((bins - left) / (centre - left),
                                   (right - bins) / (right - centre)))
    return np.concatenate([w, np.zeros((num_bins, 1))], axis=1).T


def kaldi_fbank(pcm, num_mel_bins=80, frame_length=400, frame_shift=160, sample_rate=16000,
                dither=0.0, generator=None):
    """``(B, L)`` 16-bit samples (the int16 range, as the recipe ships them)
    to ``(B, frames, num_mel_bins)`` float32 log-mel: snip-edges framing,
    dither ``N(0, 1) * dither`` per sample of each frame, DC removed,
    pre-emphasis 0.97, Povey window, |rFFT|^2 over the next power of two."""
    x = pcm.to(torch.float32)
    frames = x.unfold(-1, frame_length, frame_shift)
    if dither > 0:
        frames = frames + dither * torch.randn(frames.shape, generator=generator,
                                               device=frames.device)
    frames = frames - frames.mean(-1, keepdim=True)
    frames = frames - 0.97 * torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    frames = frames * torch.as_tensor(povey_window(frame_length), dtype=torch.float32,
                                      device=x.device)
    n_fft = 1 << (frame_length - 1).bit_length()
    power = torch.fft.rfft(frames, n=n_fft).abs().square()
    banks = torch.as_tensor(kaldi_mel_banks(num_mel_bins, n_fft, sample_rate),
                            dtype=torch.float32, device=x.device)
    return torch.log(torch.clamp_min(power @ banks, LOG_FLOOR))


def mask_bands(spec, max_width, axis, num_masks, generator):
    """``num_masks`` bands along ``axis`` of each row set to 0: widths
    uniform in [0, max_width], starts uniform over the admissible ones."""
    b, length = spec.shape[0], spec.shape[axis]
    width = torch.randint(0, max_width + 1, (b, num_masks), generator=generator,
                          device=spec.device)
    room = (length - width).clamp_min(0) + 1
    u = torch.rand((b, num_masks), generator=generator, device=spec.device)
    start = torch.minimum((u * room).long(), room - 1)
    idx = torch.arange(length, device=spec.device)
    hit = ((idx >= start[..., None]) & (idx < (start + width)[..., None])).any(1)
    shape = [b] + [1] * (spec.dim() - 1)
    shape[axis] = length
    return torch.where(hit.view(shape), torch.zeros((), dtype=spec.dtype, device=spec.device),
                       spec)


def spec_augment(feats, num_t_mask, num_f_mask, max_t, max_f, generator):
    """Time bands first, then frequency bands, on ``(B, T, F)``."""
    feats = mask_bands(feats, max_t, 1, num_t_mask, generator)
    return mask_bands(feats, max_f, 2, num_f_mask, generator)


def log_spectrogram(wavs, wav_lens, n_fft=320, hop=160):
    """DeepSpeech2's input: ``log1p |STFT|`` (periodic Hann of ``n_fft``,
    hop ``hop``, ``n_fft // 2`` zeros on both sides) normalized per
    utterance over its valid frames (``len // hop + 1``) and all bins, zero
    past them: ``(B, T, n_fft//2 + 1)`` and the frame counts."""
    half = n_fft // 2
    x = torch.nn.functional.pad(wavs.to(torch.float32), (half, half))
    frames = x.unfold(-1, n_fft, hop)
    window = 0.5 - 0.5 * torch.cos(2 * math.pi * torch.arange(n_fft, dtype=torch.float64,
                                                              device=x.device) / n_fft)
    spec = torch.fft.rfft(frames * window.to(torch.float32)).abs()
    feats = torch.log1p(spec)
    lens = wav_lens // hop + 1
    valid = (torch.arange(feats.shape[1], device=x.device)[None, :] < lens[:, None])[..., None]
    n = (lens * feats.shape[-1]).clamp_min(1)[:, None, None].to(torch.float32)
    mean = torch.where(valid, feats, 0.0).sum((1, 2), keepdim=True) / n
    var = torch.where(valid, feats - mean, 0.0).square().sum((1, 2), keepdim=True) / n
    return torch.where(valid, (feats - mean) / torch.sqrt(var + 1e-8), 0.0), lens
