"""Attention-mask builders (port of ``mindaudio_tpu.utils.mask``).

All return boolean tensors where True = attend / valid, on the device of
``lengths`` (or the given ``device``).
"""

from __future__ import annotations

import torch

__all__ = [
    "make_pad_mask",
    "make_non_pad_mask",
    "subsequent_mask",
    "subsequent_chunk_mask",
    "add_optional_chunk_mask",
]


def make_pad_mask(lengths, max_len):
    """True at padded positions: ``(B, max_len)``."""
    idx = torch.arange(max_len, device=lengths.device)[None, :]
    return idx >= lengths[:, None]


def make_non_pad_mask(lengths, max_len):
    """True at valid positions: ``(B, max_len)``."""
    return ~make_pad_mask(lengths, max_len)


def subsequent_mask(size, device=None):
    """Lower-triangular causal mask ``(size, size)``."""
    return torch.ones(size, size, dtype=torch.bool, device=device).tril()


def subsequent_chunk_mask(size, chunk_size, num_left_chunks=-1, device=None):
    """Chunked streaming mask: each frame attends to its chunk plus
    ``num_left_chunks`` previous chunks (all of them when negative)."""
    row = torch.arange(size, device=device)[:, None]
    col = torch.arange(size, device=device)[None, :]
    chunk_end = (row // chunk_size + 1) * chunk_size
    ok = col < torch.clamp_max(chunk_end, size)
    if num_left_chunks >= 0:
        start = torch.clamp_min((row // chunk_size - num_left_chunks) * chunk_size, 0)
        ok = ok & (col >= start)
    return ok


def add_optional_chunk_mask(masks, use_dynamic_chunk, decoding_chunk_size,
                            static_chunk_size, num_decoding_left_chunks):
    """Combine the ``(B, 1, T)`` pad mask with a decoding chunk mask.

    Returns a ``(B, T, T)`` mask when chunking applies, else ``masks``
    unchanged. Only the decoding branches exist here: training-time chunk
    sampling (``use_dynamic_chunk`` with ``decoding_chunk_size == 0``) raises.
    """
    size = masks.shape[-1]
    if use_dynamic_chunk:
        if decoding_chunk_size < 0:
            return masks
        if decoding_chunk_size > 0:
            cm = subsequent_chunk_mask(size, decoding_chunk_size,
                                       num_decoding_left_chunks, masks.device)
            return masks & cm[None]
        raise NotImplementedError(
            "dynamic chunk sampling is a training-time branch; pass "
            "decoding_chunk_size != 0 at inference")
    if static_chunk_size > 0:
        cm = subsequent_chunk_mask(size, static_chunk_size,
                                   num_decoding_left_chunks, masks.device)
        return masks & cm[None]
    return masks
