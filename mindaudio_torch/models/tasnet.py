"""TasNet speech separation, the LSTM-mask variant (port of
``mindaudio_tpu.models.tasnet``).

Each ``L``-sample frame is normalized to unit L2 norm (the norm, with
``eps = 1e-8`` inside the root, is kept for the decoder), encoded by a gated
basis ``relu(U x) * sigmoid(V x)``, layer-normalized, run through a stack of
summed-bidirectional LSTMs, and turned into one mask per speaker by a
softmax over the speakers; the masked encodings are decoded by a bias-free
basis and scaled back by the norm.

Parameter names follow the flax ones (``conv1d_U``, ``conv1d_V``,
``layer_norm``, ``fc_mask``, ``basis_signals``). The LSTM cells are built in
the JAX model's own scope, so flax names them ``OptimizedLSTMCell_0`` ...
``OptimizedLSTMCell_<2n-1>``: cell ``2i`` is layer ``i``'s forward
direction and ``2i+1`` its backward one; here they are ``lstm_<i>``, a
``models.deepspeech2.BiLSTM`` each (``convert.convert_params`` stacks the
cells' gates into it). The backward direction runs over the whole padded
sequence, as flax's ``reverse=True, keep_order=True`` does with no
``seq_lengths``. flax's ``LayerNorm`` has ``eps = 1e-6`` and takes the
variance as ``E[x^2] - E[x]^2``, clamped at 0; :class:`LayerNorm` does the
same.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from .. import resolve_device
from ..ops.spectral import overlap_and_add
from .conv_tasnet import num_frames
from .deepspeech2 import BiLSTM
from .layers import lecun_normal_

__all__ = ["LayerNorm", "TasNet"]


class LayerNorm(nn.Module):
    """flax's ``nn.LayerNorm`` over the last axis (see the module docstring)."""

    def __init__(self, features, eps=1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp_min(x.square().mean(-1, keepdim=True) - mean.square(), 0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class TasNet(nn.Module):
    """``forward(mixture (B, K, L))`` on frames returns the sources' frames
    ``(B, num_spk, K, L)``; :meth:`frame_waveform` and :meth:`reconstruct`
    go from ``(B, T)`` audio to frames at hop ``L // 2`` and back.

    The defaults are the reference's: N = 500 basis signals, L = 40 samples
    (5 ms at 8 kHz), hidden 500, 4 BiLSTM layers, C = 2 speakers.
    """

    def __init__(self, enc_dim=500, frame_len=40, num_spk=2, hidden=500, num_layers=4,
                 device="cuda"):
        super().__init__()
        self.enc_dim, self.frame_len, self.num_spk = enc_dim, frame_len, num_spk
        self.num_layers = num_layers
        self.conv1d_U = nn.Linear(frame_len, enc_dim, bias=False)
        self.conv1d_V = nn.Linear(frame_len, enc_dim, bias=False)
        self.layer_norm = LayerNorm(enc_dim)
        for i in range(num_layers):
            self.add_module(f"lstm_{i}", BiLSTM(enc_dim if i == 0 else hidden, hidden))
        self.fc_mask = nn.Linear(hidden, num_spk * enc_dim)
        self.basis_signals = nn.Linear(enc_dim, frame_len, bias=False)
        self.to(resolve_device(device))

    def lstms(self):
        return [getattr(self, f"lstm_{i}") for i in range(self.num_layers)]

    @torch.no_grad()
    def reset_parameters(self, generator):
        """Random weights from ``generator`` (on the model's device), drawn
        from flax's init distributions: lecun-normal (truncated) kernels,
        the LSTMs per gate block (:meth:`BiLSTM.reset_parameters`), zero
        biases, unit layer-norm scale."""
        for module in self.modules():
            if isinstance(module, nn.Linear):
                lecun_normal_(module.weight, module.weight.shape[1], generator)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
            elif isinstance(module, BiLSTM):
                module.reset_parameters(generator)
        return self

    def forward(self, mixture):
        b, k, _ = mixture.shape
        norm_coef = torch.sqrt(mixture.square().sum(-1, keepdim=True) + 1e-8)  # (B, K, 1)
        norm_mix = mixture / norm_coef

        w = F.relu(self.conv1d_U(norm_mix)) * torch.sigmoid(self.conv1d_V(norm_mix))  # (B, K, N)
        x = self.layer_norm(w)
        for lstm in self.lstms():
            x = lstm(x)
        score = self.fc_mask(x).view(b, k, self.num_spk, self.enc_dim)
        masks = torch.softmax(score, dim=2)

        est = self.basis_signals(w[:, :, None, :] * masks) * norm_coef[:, :, None, :]
        return est.transpose(1, 2)  # (B, C, K, L)

    def frame_waveform(self, audio):
        """``(B, T) -> (B, K, L)`` frames at hop ``L // 2``, ``K`` the ceil
        count (the tail zero-padded), so that no sample is dropped."""
        L = self.frame_len
        t = audio.shape[-1]
        need = (num_frames(t, L) - 1) * (L // 2) + L
        if t < need:
            audio = F.pad(audio, (0, need - t))
        return audio.unfold(-1, L, L // 2)

    def reconstruct(self, est_source):
        """``(B, C, K, L) -> (B, C, T)`` by overlap-add at hop ``L // 2``."""
        return overlap_and_add(est_source, self.frame_len // 2)
