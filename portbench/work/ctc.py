"""The CTC pair's least bytes: the log-probabilities of the extended labels
are read at the valid frames only (the backward reads them and the alphas),
and the alphas (forward) and the gradients (backward) are written at every
frame, 4 bytes a state: forward ``valid + cells``, backward ``2 valid +
cells``, with ``cells = rows * frames * states`` and ``valid = sum(lens) *
states``, ``states = 2 * labels + 1``."""

from __future__ import annotations

from .peaks import BYTES_PER_S


def pair_bytes(rows, frames, valid_frames, labels):
    """Bytes the forward and backward kernels need together for one batch:
    ``rows`` sequences padded to ``frames``, ``valid_frames`` their summed
    lengths, ``labels`` the padded label width."""
    states = 2 * labels + 1
    cells, valid = rows * frames * states * 4, valid_frames * states * 4
    return (valid + cells) + (2 * valid + cells)


def pair_bound_s(rows, frames, valid_frames, labels):
    """The least seconds of the pair at the card's memory bandwidth."""
    return pair_bytes(rows, frames, valid_frames, labels) / BYTES_PER_S
