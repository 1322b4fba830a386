"""Attention-mask builders (port of ``mindaudio_tpu.utils.mask``).

All return boolean tensors where True = attend / valid, on the device of
``lengths`` (or the given ``device``).
"""

from __future__ import annotations

import torch

from .. import check_generator

__all__ = [
    "make_pad_mask",
    "make_non_pad_mask",
    "subsequent_mask",
    "subsequent_chunk_mask",
    "add_optional_chunk_mask",
    "mask_finished_scores",
    "mask_finished_preds",
]

NEG_INF = -1.0e9


def mask_finished_scores(score, end_flag):
    """Beam-search bookkeeping: on the rows whose hypothesis ended keep one
    branch alive, branch 0 at score 0 and the others at ``NEG_INF``.
    ``score (B*beam, beam)``, ``end_flag (B*beam, 1)`` bool."""
    first = torch.arange(score.shape[-1], device=score.device) == 0
    finished = end_flag.bool()
    return torch.where(finished & ~first, NEG_INF, torch.where(finished & first, 0.0, score))


def mask_finished_preds(pred, end_flag, eos):
    """Beam-search bookkeeping: the rows whose hypothesis ended predict
    ``eos`` on every branch. ``pred (B*beam, beam)``, ``end_flag (B*beam, 1)``."""
    return torch.where(end_flag.bool(), eos, pred)


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


def add_optional_chunk_mask(masks, use_dynamic_chunk, use_dynamic_left_chunk,
                            decoding_chunk_size, static_chunk_size,
                            num_decoding_left_chunks, generator=None):
    """Combine the ``(B, 1, T)`` pad mask with an (optionally random-size)
    chunk mask.

    Returns a ``(B, T, T)`` mask when chunking applies, else ``masks``
    unchanged. With ``use_dynamic_chunk`` and ``decoding_chunk_size == 0``
    (training) the chunk size is sampled from ``generator``, which must live
    on the masks' device: ``draw`` uniform in ``[1, T]``, full context when
    ``draw > T // 2``, else ``draw % 25 + 1``; with ``use_dynamic_left_chunk``
    the number of left chunks is uniform in ``[0, max((T-1) // chunk, 1))``.
    The sampled sizes stay on the device (no host synchronisation).
    """
    size = masks.shape[-1]
    if use_dynamic_chunk:
        if decoding_chunk_size < 0:
            return masks
        if decoding_chunk_size > 0:
            cm = subsequent_chunk_mask(size, decoding_chunk_size,
                                       num_decoding_left_chunks, masks.device)
            return masks & cm[None]
        check_generator(generator, masks.device, "dynamic chunk sampling")
        draw = torch.randint(1, size + 1, (), generator=generator, device=masks.device)
        chunk = torch.where(draw > size // 2, size, draw % 25 + 1)
        row = torch.arange(size, device=masks.device)[:, None]
        col = torch.arange(size, device=masks.device)[None, :]
        cm = col < ((row // chunk + 1) * chunk).clamp_max(size)
        if use_dynamic_left_chunk:
            max_left = ((size - 1) // chunk).clamp_min(1)
            u = torch.rand((), generator=generator, device=masks.device)
            num_left = torch.minimum((u * max_left).long(), max_left - 1)
            cm = cm & (col >= ((row // chunk - num_left) * chunk).clamp_min(0))
        return masks & cm[None]
    if static_chunk_size > 0:
        cm = subsequent_chunk_mask(size, static_chunk_size,
                                   num_decoding_left_chunks, masks.device)
        return masks & cm[None]
    return masks
