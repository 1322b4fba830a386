"""FastSpeech2's multi-term loss (port of
``mindaudio_tpu.loss.fastspeech2_loss``): masked MSE on pitch and energy,
masked L1 on the log-duration and on the mel, each normalized by its mask's
count, summed."""

from __future__ import annotations

import torch

from ..parallel.mesh import data_denominator

__all__ = ["fastspeech2_loss"]


def fastspeech2_loss(mel_pred, mel_target, log_d_pred, duration_target, p_pred, p_target,
                     e_pred, e_target, src_mask, mel_mask):
    """Returns ``(total, mel_loss, duration_loss, pitch_loss, energy_loss)``.

    ``src_mask`` is ``(B, L)``, True = valid phoneme; ``mel_mask`` ``(B, T)``,
    True = valid frame. The duration target enters as ``log(d + 1)``; the mel
    term is normalized by ``max(frames, 1) * n_mels``, the others by
    ``max(phonemes, 1)``.
    """
    src_m = src_mask.float()
    mel_m = mel_mask.float()
    # counts of the global batch (summed over the data group)
    src_n = data_denominator(src_m.sum(), 1.0)
    mel_n = data_denominator(mel_m.sum(), 1.0)

    log_d_target = torch.log(duration_target.float() + 1.0)
    duration_loss = ((log_d_pred - log_d_target).abs() * src_m).sum() / src_n
    pitch_loss = ((p_pred - p_target).square() * src_m).sum() / src_n
    energy_loss = ((e_pred - e_target).square() * src_m).sum() / src_n
    mel_loss = ((mel_pred - mel_target).abs() * mel_m[..., None]).sum() / (
        mel_n * mel_pred.shape[-1])

    total = mel_loss + duration_loss + pitch_loss + energy_loss
    return total, mel_loss, duration_loss, pitch_loss, energy_loss
