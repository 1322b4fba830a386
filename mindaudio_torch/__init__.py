"""PyTorch/CUDA port of ``mindaudio_tpu`` for NVIDIA Hopper (H100).

The JAX package ``mindaudio_tpu`` is the reference; this package mirrors its
module names (``ops.spectral``, ``models.conformer``, ``utils.recognize``,
...) so each counterpart is easy to find, and imports nothing of it. Plain
tensor code is PyTorch; every Pallas TPU kernel on a ported path is a CUDA
C++ kernel written for ``sm_90a`` under ``ops/csrc/``, built with ``nvcc`` at
first use.

Entry points take an explicit ``device=`` that defaults to ``"cuda"`` and
raise when no CUDA device is present; pass ``device="cpu"`` to run the plain
PyTorch versions of the kernels (the CPU tests do). Importing the package
needs neither CUDA nor ``nvcc``.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "check_generator"]


def resolve_device(device="cuda"):
    """``torch.device`` for ``device``; raises if CUDA is asked for and absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mindaudio_torch: a CUDA device was requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions"
        )
    return device


def check_generator(generator, device, name):
    """Raise unless ``generator`` lives on ``device``. Random numbers drawn on
    another device would be copied through the host inside every train step,
    silently. ``torch.Generator(device="cuda")`` reports no index, so an index
    counts only where both sides name one."""
    if generator is None:
        raise ValueError(f"{name}: needs an explicit torch.Generator")
    have, want = generator.device, torch.device(device)
    if have.type != want.type or (
            have.index is not None and want.index is not None and have.index != want.index):
        raise ValueError(f"{name}: the generator lives on {have} but the data on {want}; "
                         "make it with torch.Generator(device=...)")
