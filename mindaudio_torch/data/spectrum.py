"""Host-side signal levels (the port's copies of ``compute_amplitude`` and
``dB_to_amplitude`` from ``mindaudio_tpu.data.spectrum``, pinned to them by
``tests/test_torch_ecapa_recipe.py``), for the waveform augmentation."""

from __future__ import annotations

import numpy as np

__all__ = ["compute_amplitude", "dB_to_amplitude"]


def dB_to_amplitude(wavform, ref, power):
    """``ref * (10 ** (0.1 x)) ** power`` (``ref`` may be a callable of ``x``):
    ``power=1`` gives a power, ``power=0.5`` an amplitude."""
    gain = ref(wavform) if callable(ref) else abs(ref)
    return gain * 10.0 ** (np.asarray(wavform) * (0.1 * power))


def compute_amplitude(waveforms, lengths=None, amp_type="avg", dB=False):
    """Average (over ``lengths`` when given) or peak absolute amplitude over
    axis 1 of ``(time,)``, ``(batch, time)`` or ``(batch, time, channels)``,
    kept as a ``(batch, 1[, channels])`` array; ``dB`` gives ``20 log10`` of
    it, floored at -80."""
    if amp_type not in ("avg", "peak"):
        raise TypeError(f"Unsupported amplitude type {amp_type!r}")
    absx = np.abs(np.atleast_2d(np.asarray(waveforms)))
    if amp_type == "peak":
        level = absx.max(1, keepdims=True)
    else:
        level = absx.sum(1, keepdims=True)
        level /= absx.shape[1] if lengths is None else lengths
    if not dB:
        return level
    return np.clip(20 * np.log10(level), -80.0, None)
