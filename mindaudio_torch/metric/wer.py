"""Word and character error rates by edit distance (the port's copy of
``mindaudio_tpu.metric.wer``, pinned to it by
``tests/test_torch_recipe_infra.py``)."""

from __future__ import annotations

import numpy as np

__all__ = ["wer", "cer"]


def _edit_distance(ref, hyp):
    m, n = len(ref), len(hyp)
    d = np.zeros((m + 1, n + 1), dtype=np.int32)
    d[:, 0] = np.arange(m + 1)
    d[0, :] = np.arange(n + 1)
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            if ref[i - 1] == hyp[j - 1]:
                d[i, j] = d[i - 1, j - 1]
            else:
                d[i, j] = 1 + min(d[i - 1, j - 1], d[i - 1, j], d[i, j - 1])
    return int(d[m, n])


def wer(references, hypotheses):
    """Total edit distance over total reference length, for one pair of
    token sequences or two lists of them."""
    if references and isinstance(references[0], (str, int)):
        references, hypotheses = [references], [hypotheses]
    if len(references) != len(hypotheses):
        raise ValueError(
            f"unpaired sequences: {len(references)} references vs "
            f"{len(hypotheses)} hypotheses"
        )
    total_err = sum(_edit_distance(list(r), list(h)) for r, h in zip(references, hypotheses))
    total_len = sum(len(r) for r in references)
    return total_err / max(total_len, 1)


def cer(references, hypotheses):
    """Character error rate: WER over character sequences."""
    return wer([list(r) for r in references], [list(h) for h in hypotheses])
