"""Host-side resampling and rescaling (the port's copies of ``resample``,
``unitarize`` and ``rescale`` from ``mindaudio_tpu.data.processing``, pinned
to them by ``tests/test_torch_recipe_infra.py`` and
``tests/test_torch_ecapa_recipe.py``). The recipes' collates call
``resample`` for speed perturbation and for sources that are not at 16 kHz;
``augment.reverberate`` calls ``rescale``."""

from __future__ import annotations

from math import gcd

import numpy as np
import scipy.signal

from .spectrum import compute_amplitude, dB_to_amplitude

__all__ = ["resample", "unitarize", "rescale"]


# the kaiser filter's shape: torchaudio's defaults, as in the JAX package
_LOWPASS_FILTER_WIDTH = 6
_ROLLOFF = 0.99
_BETA = 14.769656459379492


def resample(waveform, orig_freq=16000, new_freq=16000, res_type="fft"):
    """Resample along the last axis.

    ``"fft"``/``"scipy"``: FFT resampling (``scipy.signal.resample``) to
    ``ceil(n * new / orig)`` samples. ``"kaiser"``: a polyphase
    Kaiser-windowed sinc (torchaudio's ``sinc_interp_kaiser``).
    """
    waveform = np.asarray(waveform)
    if orig_freq == new_freq:
        return waveform

    if res_type in ("scipy", "fft"):
        n_out = int(np.ceil(waveform.shape[-1] * (float(new_freq) / orig_freq)))
        res = scipy.signal.resample(waveform, n_out, axis=-1)
        return np.asarray(res, dtype=waveform.dtype)
    if res_type != "kaiser":
        raise ValueError(f"resample: unknown res_type {res_type!r}")

    g = gcd(int(orig_freq), int(new_freq))
    orig, new = int(orig_freq) // g, int(new_freq) // g
    lowpass_filter_width, rolloff, beta = _LOWPASS_FILTER_WIDTH, _ROLLOFF, _BETA
    base_freq = min(orig, new) * rolloff / 2.0  # cycles per input sample pair
    width = int(np.ceil(lowpass_filter_width * orig / (min(orig, new) * rolloff)))
    idx = np.arange(-width, width + orig, dtype=np.float64)

    kernels = []
    for p in range(new):
        # normalized lowpass time, clamped to the filter's support
        tt = (-p / new + idx / orig) * base_freq * 2
        tt = np.clip(tt, -lowpass_filter_width, lowpass_filter_width)
        window = (np.i0(beta * np.sqrt(np.clip(1 - (tt / lowpass_filter_width) ** 2, 0, 1)))
                  / np.i0(beta))
        tt_pi = tt * np.pi
        kernel = np.where(tt_pi == 0, 1.0, np.sin(tt_pi) / np.where(tt_pi == 0, 1.0, tt_pi))
        kernels.append(kernel * window * 2 * base_freq / orig)
    kernels = np.stack(kernels)  # (new, kernel_len)

    shape = waveform.shape
    x = waveform.reshape(-1, shape[-1]).astype(np.float64)
    n_in = x.shape[-1]
    xp = np.pad(x, [(0, 0), (width, width + orig)])
    n_blocks = int(np.ceil(n_in / orig))
    out = np.zeros((x.shape[0], n_blocks * new))
    klen = kernels.shape[-1]
    for b in range(n_blocks):
        seg = xp[:, b * orig: b * orig + klen]
        out[:, b * new: (b + 1) * new] = seg @ kernels.T[: seg.shape[-1]]
    target = int(np.ceil(new_freq * n_in / orig_freq))
    out = out[:, :target]
    return out.reshape(shape[:-1] + (out.shape[-1],)).astype(waveform.dtype)


def unitarize(waveforms, lengths=None, amp_type="avg", eps=1e-14):
    """Scale to unit average or peak amplitude (``spectrum.compute_amplitude``)."""
    assert amp_type in ("avg", "peak")
    waveforms = np.asarray(waveforms)
    squeeze_back = waveforms.ndim == 1
    if squeeze_back:
        waveforms = waveforms[None]
    level = compute_amplitude(waveforms, lengths, amp_type)
    scaled = waveforms / (level + eps)  # level is (B, 1): divide pre-squeeze
    return scaled[0] if squeeze_back else scaled


def rescale(waveforms, target_lvl, lengths=None, amp_type="avg", dB=False):
    """Scale to the level ``target_lvl`` (linear, or in dB with ``dB=True``);
    ``amp_type`` "max" is "peak"."""
    assert amp_type in ("max", "avg", "peak")
    kind = "peak" if amp_type == "max" else amp_type
    waveforms = np.asarray(waveforms)
    squeeze_back = waveforms.ndim == 1
    if squeeze_back:
        waveforms = waveforms[None]

    gain = (dB_to_amplitude(np.array(target_lvl), ref=1.0, power=0.5)
            if dB else target_lvl)
    leveled = gain * unitarize(waveforms, lengths=lengths, amp_type=kind)
    return leveled[0] if squeeze_back else leveled
