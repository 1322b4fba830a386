"""Fused log-mel spectrogram (port of ``mindaudio_tpu.ops.pallas_mel``).

Framing, window*DFT, ``re^2 + im^2``, mel projection and
``log(max(mel, log_floor))``. On a CUDA tensor this is one kernel
(``csrc/logmel.cu``) that reads the signal once and never writes the frame
matrix or the spectrum to device memory; beside it stands the plain PyTorch
version, which frames the signal and runs the three products as matmuls.
Both use the same host-built tables (window times cos/sin, mel bank).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import resolve_device
from . import _build
from .filterbanks import get_window, kaldi_mel_banks, melscale_fbanks
from .spectral import frame_signal

__all__ = ["fused_logmel", "fused_logmel_reference"]


@functools.lru_cache(maxsize=16)
def _design(n_fft, win_length, window, n_mels, sample_rate, f_min, f_max, kaldi):
    """Host-side constants: ``wr, wi (n_fft, n_freq)`` = window times the rDFT
    cos/sin basis, the mel bank ``fb (n_freq, n_mels)`` (float32 numpy), and
    ``band (2, n_mels)`` int32, the rows of each mel column that are not zero.

    ``kaldi`` places a symmetric window at offset 0 and takes the kaldi mel
    bank; otherwise the periodic window is centered in the FFT frame and the
    bank is the HTK one.
    """
    n_freq = n_fft // 2 + 1
    win = np.zeros(n_fft)
    lpad = 0 if kaldi else (n_fft - win_length) // 2
    win[lpad: lpad + win_length] = get_window(window, win_length, fftbins=not kaldi)

    n = np.arange(n_fft)[:, None]
    freqs = np.arange(n_freq)[None, :]
    angle = -2.0 * np.pi * n * freqs / n_fft
    wr = (np.cos(angle) * win[:, None]).astype(np.float32)
    wi = (np.sin(angle) * win[:, None]).astype(np.float32)

    fmax = f_max if f_max is not None else sample_rate / 2.0
    if kaldi:
        fb = kaldi_mel_banks(n_mels, n_fft, sample_rate, low_freq=f_min, high_freq=fmax)
    else:
        fb = melscale_fbanks(n_freq, f_min, fmax, n_mels, sample_rate)
    fb = np.ascontiguousarray(fb, dtype=np.float32)
    # rows of each mel column that hold its triangle: [first nonzero, last + 1)
    nonzero = fb != 0
    first = np.where(nonzero.any(0), nonzero.argmax(0), 0)
    last = np.where(nonzero.any(0), n_freq - nonzero[::-1].argmax(0), 0)
    return wr, wi, fb, np.stack([first, last]).astype(np.int32)


_device_tables: dict = {}


def _tables(device, *design_args):
    key = (str(device), *design_args)
    tables = _device_tables.get(key)
    if tables is None:
        if len(_device_tables) >= 16:
            _device_tables.clear()
        tables = _device_tables[key] = tuple(
            torch.from_numpy(a).to(device) for a in _design(*design_args))
    return tables


def _library():
    lib = _build.load("logmel")
    if lib.logmel_launch.argtypes is None:  # pointers must not be cut to 32 bits
        lib.logmel_launch.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_void_p])
        lib.logmel_launch.restype = ctypes.c_int
        lib.logmel_error_string.argtypes = [ctypes.c_int]
        lib.logmel_error_string.restype = ctypes.c_char_p
    return lib


def _resolve(waveforms, n_fft, win_length, hop_length, center):
    if waveforms.dim() != 2:
        raise ValueError("fused_logmel expects (batch, time)")
    win_length = win_length or n_fft
    hop = hop_length or win_length // 2
    t = waveforms.shape[1]
    n_frames = 1 + t // hop if center else 1 + (t - n_fft) // hop
    return win_length, hop, max(n_frames, 0)


def fused_logmel_reference(waveforms, n_fft=400, win_length=None, hop_length=None,
                           window="hann", n_mels=80, sample_rate=16000, f_min=0.0,
                           f_max=None, center=True, log_floor=1e-10, kaldi=False):
    """Plain PyTorch version of :func:`fused_logmel` on ``waveforms``'
    device: pad, frame, two DFT products, power, mel product, log."""
    x = waveforms.to(torch.float32)
    win_length, hop, n_frames = _resolve(x, n_fft, win_length, hop_length, center)
    wr, wi, fb, _ = _tables(x.device, n_fft, win_length, window, n_mels, sample_rate, f_min,
                            f_max, kaldi)
    if center:
        x = torch.nn.functional.pad(x, (n_fft // 2, n_fft // 2))
    frames = frame_signal(x, n_fft, hop, n_frames)[..., :n_fft]
    real, imag = frames @ wr, frames @ wi
    mel = (real * real + imag * imag) @ fb
    return torch.log(torch.clamp_min(mel, log_floor))


def fused_logmel(waveforms, n_fft=400, win_length=None, hop_length=None, window="hann",
                 n_mels=80, sample_rate=16000, f_min=0.0, f_max=None, center=True,
                 log_floor=1e-10, block_frames=1024, kaldi=False, precision="default",
                 device="cuda"):
    """Fused log-mel spectrogram.

    Args:
        waveforms: ``(B, T)`` float32 signal (tensor or array; moved to
            ``device``).
        center: pad ``n_fft // 2`` zeros on both sides (the kernel reads them
            as zeros; no padded copy is made).
        kaldi: symmetric window at offset 0 and the kaldi mel bank.
        block_frames: the TPU kernel's frames per program; kept for the JAX
            signature and unused: the CUDA kernel's frame block is fixed in
            its source.
        precision: ``"default"`` or ``"highest"``. Both compute in float32
            here; on the TPU ``"default"`` is one bf16 pass and only looser.
        device: where to compute. The CPU takes the plain version; a CUDA
            device launches the kernel (counted in ``fused_logmel.launches``)
            or raises.

    Returns:
        ``(B, n_frames, n_mels)`` float32, ``log(max(mel, log_floor))``.
    """
    if precision not in ("default", "highest"):
        raise ValueError(f"fused_logmel: unknown precision {precision!r}")
    device = resolve_device(device)
    x = torch.as_tensor(waveforms, device=device)
    kwargs = dict(n_fft=n_fft, win_length=win_length, hop_length=hop_length, window=window,
                  n_mels=n_mels, sample_rate=sample_rate, f_min=f_min, f_max=f_max,
                  center=center, log_floor=log_floor, kaldi=kaldi)
    if x.device.type == "cpu":
        return fused_logmel_reference(x, **kwargs)
    if x.dtype != torch.float32:
        raise TypeError(f"fused_logmel: waveforms must be float32, got {x.dtype}")
    win_length, hop, n_frames = _resolve(x, n_fft, win_length, hop_length, center)
    wr, wi, fb, band = _tables(x.device, n_fft, win_length, window, n_mels, sample_rate,
                               f_min, f_max, kaldi)
    x = x.contiguous()
    b, t = x.shape
    n_freq = n_fft // 2 + 1
    if max(b, n_frames, n_fft, hop, n_mels) >= 2**31:
        raise ValueError("fused_logmel: dimensions must fit in int32")
    out = torch.empty((b, n_frames, n_mels), dtype=torch.float32, device=x.device)
    if b and n_frames:
        lib = _library()
        with torch.cuda.device(x.device):
            rc = lib.logmel_launch(
                x.data_ptr(), wr.data_ptr(), wi.data_ptr(), fb.data_ptr(), band.data_ptr(),
                out.data_ptr(),
                b, t, n_frames, n_fft, hop, n_freq, n_mels, n_fft // 2 if center else 0,
                log_floor, torch.cuda.current_stream(x.device).cuda_stream)
        if rc != 0:
            raise RuntimeError("fused_logmel kernel launch failed: "
                               f"{lib.logmel_error_string(rc).decode()} ({rc})")
        fused_logmel.launches += 1
    return out


fused_logmel.launches = 0
