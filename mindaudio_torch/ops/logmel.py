"""Fused log-mel spectrogram (port of ``mindaudio_tpu.ops.pallas_mel``).

Framing, window*DFT, ``re^2 + im^2``, mel projection and
``log(max(mel, log_floor))``. On a CUDA tensor this is one kernel
(``csrc/logmel.cu``) that reads the signal once and never writes the frame
matrix or the spectrum to device memory; beside it stands the plain PyTorch
version, which frames the signal and runs the three products as matmuls.
Both use the same host-built tables (window times cos/sin, mel bank); the
kernel takes them split and laid out for its TF32 tensor-core products
(:func:`_kernel_tables`), in the launch plan of :func:`kernel_plan`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from . import _build
from .filterbanks import get_window, kaldi_mel_banks, melscale_fbanks
from .spectral import frame_signal

__all__ = ["fused_logmel", "fused_logmel_reference", "kernel_plan", "tf32_round"]

# the kernel's fixed shapes (csrc/logmel.cu; `_library` checks that they agree)
PASS_FREQ = 104      # frequencies per tensor-core pass: product columns N = 208, cos and sin
K_ALIGN = 16         # the table's K is padded to a multiple of this
POWER_PITCH = 108    # words per row of the shared power tile
SLOT_BYTES = 13312   # one ring slot: a k8 slice of the hi and the lo table, 208 rows each
MAX_STAGES = 8       # ring slots at most
SMEM_LIMIT = 232448  # shared memory a block may use on the H100 (227 KB)


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


def tf32_round(a):
    """float32 ``a`` rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds: the low 13 bits zero."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


@functools.lru_cache(maxsize=16)
def _kernel_design(*design_args):
    """The kernel's constants from :func:`_design`'s (numpy):

    - ``table (passes * k_pad // 8, 2, 2 * PASS_FREQ, 8)`` float32: the
      split ``w = hi + lo``, ``hi = tf32(w)``, ``lo = tf32(w - hi)``, of
      ``w (passes * 2 * PASS_FREQ, k_pad)``, whose row
      ``2 * PASS_FREQ * p + 2 * j + s`` is ``(wi if s else wr)[:, f]`` at
      ``f = PASS_FREQ * p + j`` (cos and sin of a frequency adjacent), zeros
      past ``n_freq`` and past ``n_fft``; cut into the kernel's ring slots,
      pass by pass and 8 of K at a time, each slot its hi then its lo tile,
      K-major (rows of 8), the 16-byte halves of row r swapped where
      ``r & 4`` (the 32-byte swizzle its wgmma reads): one bulk copy a slot;
    - ``band (4, n_mels)`` int32: ``_design``'s two rows, each band's
      offset in ``wts``, and its column of the kernel's carry tile where it
      spans two or more passes of ``PASS_FREQ`` frequencies (else -1);
    - ``wts (nnz,)`` float32: each mel column's rows ``band[0]:band[1]``.
    """
    wr, wi, fb, band = _design(*design_args)
    n_fft, n_freq = wr.shape
    passes = -(-n_freq // PASS_FREQ)
    k_pad = -(-n_fft // K_ALIGN) * K_ALIGN
    w = np.zeros((passes * PASS_FREQ, 2, k_pad), np.float32)
    w[:n_freq, 0, :n_fft] = wr.T
    w[:n_freq, 1, :n_fft] = wi.T
    w = w.reshape(passes * 2 * PASS_FREQ, k_pad)
    hi = tf32_round(w)
    table = np.stack([_slots(hi, passes), _slots(tf32_round(w - hi), passes)], axis=1)
    wts = [fb[lo:hi_, m] for m, (lo, hi_) in enumerate(band.T)]
    offsets = np.cumsum([0] + [len(v) for v in wts[:-1]])
    spans = (band[0] < band[1]) & (band[0] // PASS_FREQ != (band[1] - 1) // PASS_FREQ)
    carry = np.where(spans, np.cumsum(spans) - 1, -1)
    bands = np.stack([band[0], band[1], offsets, carry]).astype(np.int32)
    return table, bands, np.concatenate(wts).astype(np.float32)


def _slots(a, passes):
    """``(passes * 208, k_pad)`` -> ``(passes * k_pad // 8, 208, 8)``: k8
    slices pass by pass, in the 32-byte swizzle (16-byte half h of row r at
    half ``h ^ ((r >> 2) & 1)``)."""
    rows = a.shape[0] // passes
    tiles = a.reshape(passes, rows, -1, 8).transpose(0, 2, 1, 3)
    r = np.broadcast_to(np.arange(rows)[:, None], (rows, 8))
    k = np.arange(8)[None, :]
    out = np.empty_like(tiles)
    out[..., r, ((k // 4) ^ ((r >> 2) & 1)) * 4 + k % 4] = tiles
    return out.reshape(-1, rows, 8)


class Plan(NamedTuple):
    """A launch of the kernel: frames per block (two consumer warpgroups at
    128, one at 64), span rows of ``hop`` samples ``pitch`` words apart, ring
    slots, frequency passes, padded K, and the dynamic shared memory asked."""
    fpb: int
    rows: int
    pitch: int
    stages: int
    passes: int
    k_pad: int
    smem_bytes: int


def smem_bytes(fpb, rows, pitch, n_mels, nnz, carries, stages):
    """The kernel's shared memory (``Layout`` in csrc/logmel.cu): ring,
    span, power tile, carry tile, bands, weights, two mbarriers a slot, and
    1024 bytes to align the base."""
    b = (stages * SLOT_BYTES + 4 * rows * pitch + 4 * fpb * POWER_PITCH + 4 * fpb * carries
         + 16 * n_mels)
    return (b + 4 * nnz + 7) // 8 * 8 + 16 * stages + 1024


def kernel_plan(n_fft, hop, n_mels, nnz, carries):
    """The kernel's plan for these shapes (``nnz`` mel weights, ``carries``
    bands that span passes), or ValueError where it takes none.

    128 frames a block where the span, the tiles and three ring slots fit in
    227 KB; else 64 frames and at least two slots; else refused, as is a hop
    under 8 (the A fragment's column walks 8 samples a step and wraps once).
    The ring takes as many slots as fit, up to ``MAX_STAGES``.
    """
    if hop < 8:
        raise ValueError(f"fused_logmel kernel: hop {hop} < 8 is not taken")
    n_freq = n_fft // 2 + 1
    passes = -(-n_freq // PASS_FREQ)
    k_pad = -(-n_fft // K_ALIGN) * K_ALIGN
    pitch = hop + (4 - hop % 8) % 8  # 4 (mod 8): the 8 rows of a fragment on 8 bank quads
    for fpb, least in ((128, 3), (64, 2)):
        rows = -(-((fpb - 1) * hop + k_pad) // hop)
        for stages in range(MAX_STAGES, least - 1, -1):
            need = smem_bytes(fpb, rows, pitch, n_mels, nnz, carries, stages)
            if need <= SMEM_LIMIT:
                return Plan(fpb, rows, pitch, stages, passes, k_pad, need)
    raise ValueError(f"fused_logmel kernel: n_fft {n_fft}, hop {hop}, {n_mels} mels do not "
                     f"fit in {SMEM_LIMIT} bytes of shared memory at 64 frames a block")


_device_tables: dict = {}


def _on_device(device, make, *args):
    key = (str(device), make.__name__, *args)
    tables = _device_tables.get(key)
    if tables is None:
        if len(_device_tables) >= 32:
            _device_tables.clear()
        tables = _device_tables[key] = tuple(torch.from_numpy(a).to(device) for a in make(*args))
    return tables


def _tables(device, *design_args):
    """``_design``'s tables on ``device``."""
    return _on_device(device, _design, *design_args)


def _kernel_tables(device, *design_args):
    """``_kernel_design``'s tables on ``device``."""
    return _on_device(device, _kernel_design, *design_args)


def _library():
    lib = _build.load("logmel")
    if lib.logmel_launch.argtypes is None:  # pointers must not be cut to 32 bits
        lib.logmel_constants.argtypes = [ctypes.c_void_p]
        lib.logmel_constants.restype = None
        got = (ctypes.c_int * 6)()
        lib.logmel_constants(ctypes.addressof(got))
        want = (PASS_FREQ, K_ALIGN, POWER_PITCH, SLOT_BYTES, MAX_STAGES, SMEM_LIMIT)
        if tuple(got) != want:
            raise RuntimeError(f"csrc/logmel.cu constants {tuple(got)} differ from the "
                               f"wrapper's {want}")
        lib.logmel_smem_bytes.argtypes = [ctypes.c_int] * 7
        lib.logmel_smem_bytes.restype = ctypes.c_int
        lib.logmel_launch.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 12
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
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
            signature and unused: the CUDA kernel's frames per block come
            from :func:`kernel_plan`.
        precision: ``"default"`` or ``"highest"``. Both take the same route:
            the kernel's DFT products are three TF32 tensor-core passes
            (``lo*hi + hi*lo + hi*hi`` of operands split as
            ``x = tf32(x) + tf32(x - tf32(x))``, f32 accumulation), because
            one pass misses ``rtol = atol = 1e-3`` at the mel bands one
            frequency bin wide, where a small power cancels. On the TPU
            ``"default"`` is one bf16 pass and only looser.
        device: where to compute. The CPU takes the plain version; a CUDA
            device launches the kernel (counted in ``fused_logmel.launches``)
            or raises, also for shapes :func:`kernel_plan` refuses.

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
    kernel_plan(n_fft, hop, n_mels, 0, 0)  # what cannot fit is refused before the tables
    design = (n_fft, win_length, window, n_mels, sample_rate, f_min, f_max, kaldi)
    table, band, wts = _kernel_tables(x.device, *design)
    carries = int(_kernel_design(*design)[1][3].max()) + 1
    plan = kernel_plan(n_fft, hop, n_mels, wts.numel(), carries)
    x = x.contiguous()
    b, t = x.shape
    if max(b, n_frames, n_fft, hop, n_mels) >= 2**31:
        raise ValueError("fused_logmel: dimensions must fit in int32")
    out = torch.empty((b, n_frames, n_mels), dtype=torch.float32, device=x.device)
    if b and n_frames:
        lib = _library()
        with torch.cuda.device(x.device):
            rc = lib.logmel_launch(
                x.data_ptr(), table.data_ptr(), band.data_ptr(), wts.data_ptr(), out.data_ptr(),
                b, t, n_frames, hop, n_fft // 2 if center else 0, n_mels, wts.numel(), carries,
                plan.passes, plan.k_pad, plan.fpb, plan.rows, plan.pitch, plan.stages,
                log_floor, torch.cuda.get_device_properties(x.device).multi_processor_count,
                torch.cuda.current_stream(x.device).cuda_stream)
        if rc != 0:
            raise RuntimeError("fused_logmel kernel launch failed: "
                               f"{lib.logmel_error_string(rc).decode()} ({rc})")
        fused_logmel.launches += 1
    return out


fused_logmel.launches = 0
