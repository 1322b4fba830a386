"""Host-side filter design (the port's copy of ``notch_filter`` from
``mindaudio_tpu.data.filters``, pinned to it by
``tests/test_torch_ecapa_recipe.py``). ``augment.drop_freq`` composes its
band-stop kernels from it."""

from __future__ import annotations

import numpy as np

__all__ = ["notch_filter"]


def notch_filter(notch_freq, filter_width=101, notch_width=0.05):
    """Windowed-sinc band-stop kernel, shaped ``(1, filter_width, 1)`` for
    ``augment.convolve1d``: a low-pass below the notch plus a spectrally
    inverted low-pass above it (Blackman windows). ``notch_freq`` is a
    fraction of the Nyquist frequency in ``(0, 1]``."""
    assert filter_width % 2 != 0
    assert 0 < notch_freq <= 1

    pad = filter_width // 2
    notch_freq = notch_freq + notch_width
    inputs = np.arange(filter_width) - pad

    def sinc(x):
        safe = np.where(x == 0, 1.0, x)
        return np.where(x == 0, 1.0, np.sin(safe) / safe)

    hlpf = sinc(3 * (notch_freq - notch_width) * inputs)
    hlpf *= np.blackman(filter_width + 1)[:-1]
    hlpf /= np.sum(hlpf)

    hhpf = sinc(3 * (notch_freq + notch_width) * inputs)
    hhpf *= np.blackman(filter_width + 1)[:-1]
    hhpf /= -np.sum(hhpf)
    hhpf[pad] += 1

    return (hlpf + hhpf).reshape(1, -1, 1)
