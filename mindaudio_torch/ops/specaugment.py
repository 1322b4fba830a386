"""Batched SpecAugment on the device (port of ``mindaudio_tpu.ops.specaugment``).

Masks are built from ``arange`` comparisons, a different band per batch
element, with every random number drawn on the spectrogram's device from an
explicit ``torch.Generator``: no in-place writes and no host synchronisation.
"""

from __future__ import annotations

import torch

from .. import check_generator

__all__ = ["mask_along_axis", "spec_augment"]


def mask_along_axis(spec, max_width, axis, num_masks=1, mask_value=0.0, generator=None):
    """Mask ``num_masks`` random bands along ``axis`` of ``(B, ...)``.

    Each band has a width uniform in ``[0, max_width]`` and a start uniform in
    ``[0, max(length - width, 0)]``, drawn independently per batch element.
    """
    check_generator(generator, spec.device, "mask_along_axis")
    axis = axis % spec.dim()
    length, batch = spec.shape[axis], spec.shape[0]
    width = torch.randint(0, max_width + 1, (batch, num_masks), generator=generator,
                          device=spec.device)
    room = (length - width).clamp_min(0) + 1  # number of admissible starts
    u = torch.rand((batch, num_masks), generator=generator, device=spec.device)
    start = torch.minimum((u * room).long(), room - 1)
    idx = torch.arange(length, device=spec.device)
    bands = (idx >= start[..., None]) & (idx < (start + width)[..., None])
    masks = bands.any(dim=1)  # (B, length)
    shape = [1] * spec.dim()
    shape[0], shape[axis] = batch, length
    return torch.where(masks.view(shape), torch.as_tensor(mask_value, dtype=spec.dtype,
                                                          device=spec.device), spec)


def spec_augment(spec, num_t_mask=2, num_f_mask=2, max_t=50, max_f=10, time_axis=-2,
                 freq_axis=-1, generator=None):
    """Standard SpecAugment (2 time and 2 frequency masks by default) on a
    batch of model-ready ``(B, time, freq)`` features; pass ``time_axis=-1,
    freq_axis=-2`` for ``(B, freq, time)`` spectrograms."""
    out = mask_along_axis(spec, max_t, time_axis, num_masks=num_t_mask, generator=generator)
    return mask_along_axis(out, max_f, freq_axis, num_masks=num_f_mask, generator=generator)
