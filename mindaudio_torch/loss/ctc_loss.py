"""CTC loss (port of ``mindaudio_tpu.loss.ctc_loss``).

The on-device recursion lives in ``ops/ctc_dp.py``: two CUDA kernels (alpha
forward, beta backward) paired by an autograd Function, and beside them the
plain PyTorch version of the same extended-label recursion.

``impl`` chooses between them: ``"kernel"`` launches the CUDA kernels (CUDA
tensors only), ``"scan"`` always takes the plain version, and ``"auto"``
follows the tensor's device: a CUDA tensor launches the kernels or raises, a
CPU tensor takes the plain version. The JAX package sends ``"auto"`` to its
``lax.scan``; that choice rests on a measurement on a TPU, which does not
carry over to a GPU. Here the plain version is a Python loop of ``T`` steps of
small PyTorch operators, and ``chip_smoke.py`` measures both (and
``torch.nn.functional.ctc_loss`` as a yardstick) on the card.
"""

from __future__ import annotations

from ..ops.ctc_dp import ctc_per_seq_loss_kernel, ctc_per_seq_loss_reference

__all__ = ["ctc_loss", "ctc_per_seq_loss"]


def ctc_per_seq_loss(logits, logit_lengths, labels, label_lengths, blank_id=0, impl="auto"):
    """Per-sequence CTC negative log-likelihood, ``(B,)`` float32."""
    if impl not in ("auto", "kernel", "scan"):
        raise ValueError(f"ctc_loss: impl must be 'auto', 'kernel' or 'scan', got {impl!r}")
    if impl == "kernel" or (impl == "auto" and logits.device.type != "cpu"):
        return ctc_per_seq_loss_kernel(logits, logit_lengths, labels, label_lengths,
                                       blank_id=blank_id)
    return ctc_per_seq_loss_reference(logits, logit_lengths, labels, label_lengths,
                                      blank_id=blank_id)


def ctc_loss(logits, logit_lengths, labels, label_lengths, blank_id=0, impl="auto"):
    """Mean CTC negative log-likelihood over the batch.

    Args:
        logits: ``(B, T, vocab)`` unnormalized scores (log-softmax is applied
            inside, in float32).
        logit_lengths: ``(B,)`` valid frame counts.
        labels: ``(B, L)`` target ids padded with anything (masked by
            ``label_lengths``); no ``blank_id`` in valid slots.
        label_lengths: ``(B,)`` target lengths.
        blank_id: CTC blank index.
        impl: ``"auto"``, ``"kernel"`` or ``"scan"`` (module docstring).
    """
    return ctc_per_seq_loss(logits, logit_lengths, labels, label_lengths,
                            blank_id=blank_id, impl=impl).mean()
