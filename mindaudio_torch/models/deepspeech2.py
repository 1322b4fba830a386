"""DeepSpeech2 (port of ``mindaudio_tpu.models.deepspeech2``).

Two masked 2-D convs over the spectrogram (:class:`MaskConv`), a stack of
summed-bidirectional LSTMs (:class:`BatchRNN`), a batch norm and a
projection to characters. Module and parameter names follow the flax ones
(``conv.conv1``, ``rnn_<i>.bn``, ``rnn_<i>.bilstm``, ``head_bn``, ``fc``), so
``convert.convert_params`` carries a JAX checkpoint across.

Where the JAX model's LSTM is a ``lax.scan``, here in float32 each direction
is one call of PyTorch's fused LSTM (cuDNN on the card) over the whole padded
sequence:

- the forward direction runs through the padding, as the scan does;
- the backward direction runs over :func:`flip_valid` of its input (each
  row's valid prefix reversed, the padding rotated to the tail) and its
  output is flipped back, so it starts at the last valid frame.

In another compute dtype (the JAX model's bf16 option) the fused LSTM would
keep the cell state in that dtype, so :class:`BiLSTM` runs the JAX scan
step by step instead: products and gate sums in bf16, the gates and the cell
state in float32.

Both give non-zero outputs at padded positions, as in JAX, and those enter
the next batch norm's training statistics: ``pack_padded_sequence`` (zeros
there) would change every trained weight. One bias a direction is a
parameter, as in JAX; the LSTM's second bias is a constant zero, so neither
the gradient nor the weight decay counts it twice.
"""

from __future__ import annotations

import warnings

import torch
from torch import nn
from torch.nn import functional as F

from .. import resolve_device
from ..utils.mask import make_non_pad_mask
from .layers import BatchNorm, lecun_normal_

__all__ = ["flip_valid", "BiLSTM", "BatchRNN", "MaskConv", "DeepSpeechModel"]

def flip_valid(x, lengths):
    """Reverse each row's valid prefix along time (axis 1), padding rotated to
    the tail: ``[a, b, c, p, q] -> [c, b, a, q, p]`` for length 3 (the index
    map ``(T-1-j + len) % T``, an involution). ``lengths=None`` flips all."""
    t = x.shape[1]
    if lengths is None:
        return x.flip(1)
    idx = (torch.arange(t - 1, -1, -1, device=x.device)[None, :]
           + lengths.to(x.device)[:, None]) % t
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(x.shape)
    return torch.gather(x, 1, idx)


class BiLSTM(nn.Module):
    """Bidirectional LSTM returning ``fwd + bwd`` ``(B, T, H)``.

    Parameters per direction (axis 0: forward, backward): ``weight_ih (2,
    4H, D)`` and ``weight_hh (2, 4H, H)`` with gates in the order i, f, g,
    o (flax's ``wx``/``wh`` transposed), and one ``bias (2, 4H)``. ``dtype``
    is the compute dtype of the products (the JAX model's bf16 option); the
    cell state is float32 whatever it is, and the output is in ``dtype``.
    """

    def __init__(self, input_size, hidden, dtype=torch.float32):
        super().__init__()
        self.hidden, self.dtype = hidden, dtype
        self.weight_ih = nn.Parameter(torch.zeros(2, 4 * hidden, input_size))
        self.weight_hh = nn.Parameter(torch.zeros(2, 4 * hidden, hidden))
        self.bias = nn.Parameter(torch.zeros(2, 4 * hidden))

    @torch.no_grad()
    def reset_parameters(self, generator):
        """Per gate block, as the JAX init: lecun-normal input weights,
        orthogonal recurrent weights, zero biases."""
        h, d = self.hidden, self.weight_ih.shape[2]
        for direction in range(2):
            for g in range(4):
                lecun_normal_(self.weight_ih[direction, g * h:(g + 1) * h], d, generator)
                nn.init.orthogonal_(self.weight_hh[direction, g * h:(g + 1) * h],
                                    generator=generator)
        self.bias.zero_()

    def _direction(self, x, d):
        b = x.shape[0]
        h0 = x.new_zeros(1, b, self.hidden)
        bias = self.bias[d]
        weights = [self.weight_ih[d], self.weight_hh[d], bias, torch.zeros_like(bias)]
        with warnings.catch_warnings():
            # cuDNN copies weights that are not one flat buffer into one each
            # call (a few tens of MB a layer) and warns about it once
            warnings.filterwarnings("ignore", message="RNN module weights are not part")
            out, _, _ = torch.lstm(x, (h0, h0), weights, True, 1, 0.0, self.training, False,
                                   True)
        return out

    def _scan(self, x, lengths):
        """Both directions step by step, as the JAX scan: the input products
        for all frames at once, then per frame ``gates = xz + h @ wh + bias``
        in ``dtype``, the gates and ``c`` in float32, ``h`` rounded to
        ``dtype``."""
        wx, wh, bias = (w.to(self.dtype) for w in (self.weight_ih, self.weight_hh, self.bias))
        xz = torch.einsum("btd,nkd->nbtk", x, wx)
        xz = torch.stack([xz[0], flip_valid(xz[1], lengths)])
        c = x.new_zeros((2, x.shape[0], self.hidden), dtype=torch.float32)
        hh = x.new_zeros((2, x.shape[0], self.hidden))
        ys = []
        for t in range(x.shape[1]):
            gates = xz[:, :, t] + torch.bmm(hh, wh.transpose(1, 2)) + bias[:, None]
            gi, gf, gg, go = gates.float().chunk(4, dim=-1)
            c = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
            hh = (torch.sigmoid(go) * torch.tanh(c)).to(self.dtype)
            ys.append(hh)
        ys = torch.stack(ys, 2)
        return ys[0] + flip_valid(ys[1], lengths)

    def forward(self, x, lengths=None):
        x = x.to(self.dtype)
        if self.dtype != torch.float32:
            return self._scan(x, lengths)
        fwd = self._direction(x, 0)
        bwd = self._direction(flip_valid(x, lengths), 1)
        return fwd + flip_valid(bwd, lengths)


class BatchRNN(nn.Module):
    """Batch norm (unless ``use_batch_norm`` is False) then a :class:`BiLSTM`
    with summed directions."""

    def __init__(self, input_size, hidden, use_batch_norm=True, dtype=torch.float32):
        super().__init__()
        self.bn = BatchNorm(input_size) if use_batch_norm else None
        self.bilstm = BiLSTM(input_size, hidden, dtype=dtype)

    def forward(self, x, lengths=None):
        if self.bn is not None:
            x = self.bn(x)
        return self.bilstm(x, lengths=lengths)


class MaskConv(nn.Module):
    """Two Conv2d + batch norm + hardtanh(0, 20) blocks, each output zeroed
    past the (subsampled) lengths. ``(B, T, F)`` in, ``(B, T', F', 32)`` out
    (channels last, as the flax module's NHWC) with ``T' = (T - 1)//2 + 1``,
    and the new lengths. The lengths shrink after ``conv1`` only."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(1, 32, (11, 41), stride=(2, 2), padding=(5, 20))
        self.bn1 = BatchNorm(32)
        self.conv2 = nn.Conv2d(32, 32, (11, 21), stride=(1, 2), padding=(5, 10))
        self.bn2 = BatchNorm(32)

    def _conv(self, conv, x):
        return F.conv2d(x.to(self.dtype), conv.weight.to(self.dtype), conv.bias.to(self.dtype),
                        conv.stride, conv.padding)

    @staticmethod
    def _bn_clip_mask(bn, x, lengths):
        """``(B, C, T, F)`` → channels-last ``(B, T, F, C)`` normalized,
        clipped to [0, 20] and zeroed past ``lengths``."""
        x = torch.clamp(bn(x.permute(0, 2, 3, 1)), 0.0, 20.0)
        return torch.where(make_non_pad_mask(lengths, x.shape[1])[:, :, None, None], x, 0.0)

    def forward(self, x, lengths):
        x = self._conv(self.conv1, x[:, None])
        lengths = torch.div(lengths + 2 * 5 - 11, 2, rounding_mode="floor") + 1
        x = self._bn_clip_mask(self.bn1, x, lengths)
        x = self._conv(self.conv2, x.permute(0, 3, 1, 2))
        return self._bn_clip_mask(self.bn2, x, lengths), lengths


class DeepSpeechModel(nn.Module):
    """Conv front-end → ``num_rnn_layers`` summed-BiLSTM layers (the first
    without a batch norm) → batch norm → bias-free projection to
    ``vocab_size`` in float32.

    ``forward(spect, lengths)``: ``spect (B, T, F)`` is the normalized
    log-spectrogram (``F = n_fft // 2 + 1``); returns ``(logits (B, T',
    vocab) float32, out_lengths (B,))``. ``train()`` uses and updates the
    batch statistics, ``eval()`` the running ones.
    """

    def __init__(self, vocab_size=29, hidden_size=1024, num_rnn_layers=5, n_freq=161,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        self.conv = MaskConv(dtype=dtype)
        f = (n_freq + 2 * 20 - 41) // 2 + 1
        f = (f + 2 * 10 - 21) // 2 + 1
        self.num_rnn_layers = num_rnn_layers
        for i in range(num_rnn_layers):
            self.add_module(f"rnn_{i}", BatchRNN(32 * f if i == 0 else hidden_size, hidden_size,
                                                 use_batch_norm=i != 0, dtype=dtype))
        self.head_bn = BatchNorm(hidden_size)
        self.fc = nn.Linear(hidden_size, vocab_size, bias=False)
        self.to(resolve_device(device))

    def rnns(self):
        return [getattr(self, f"rnn_{i}") for i in range(self.num_rnn_layers)]

    @torch.no_grad()
    def reset_parameters(self, generator):
        """Random weights from ``generator`` (on the model's device), drawn
        from the JAX init's distributions: lecun-normal (truncated) convs and
        projection, per-gate LSTM blocks (:meth:`BiLSTM.reset_parameters`),
        zero biases, unit batch-norm scales, running statistics 0 and 1."""
        for module in self.modules():
            if isinstance(module, (nn.Conv2d, nn.Linear)):
                lecun_normal_(module.weight, module.weight[0].numel(), generator)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, BatchNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
                module.running_mean.zero_()
                module.running_var.fill_(1.0)
            elif isinstance(module, BiLSTM):
                module.reset_parameters(generator)
        return self

    def forward(self, spect, lengths):
        x, out_lens = self.conv(spect, lengths)
        b, t, f, c = x.shape
        x = x.reshape(b, t, f * c)
        for rnn in self.rnns():
            x = rnn(x, lengths=out_lens)
        x = self.head_bn(x)
        return self.fc(x.float()), out_lens
