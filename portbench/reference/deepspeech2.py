"""DeepSpeech2 (Amodei et al., arXiv:1512.02595, as MindAudio's recipe
builds it) written out plainly, with the port's parameter names.

Two convolutions, ``(11, 41)`` stride ``(2, 2)`` pad ``(5, 20)`` and
``(11, 21)`` stride ``(1, 2)`` pad ``(5, 10)``, 32 channels, each followed by
batch norm over every other axis (biased variance, eps 1e-5), a clip to
[0, 20] and zeros past the subsampled lengths; then LSTM layers whose two
directions are summed (the first without a batch norm before it, the others
with one), the backward direction starting at each row's last valid frame,
the forward one running through the padding; a batch norm and a bias-free
projection to the characters. The LSTM: gates ``x W_ih^T + h W_hh^T + b``
in the order i, f, g, o; ``c = s(f) c + s(i) tanh(g)``, ``h = s(o)
tanh(c)``. Loss: CTC (blank 28) by ``torch.nn.functional.ctc_loss``
in float64, the mean over the batch.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from .precision import FLOAT32


class BatchNorm(nn.Module):
    def __init__(self, n):
        super().__init__()
        self.weight, self.bias = nn.Parameter(torch.empty(n)), nn.Parameter(torch.empty(n))

    def forward(self, x):
        """Normalize the last axis over all others with the batch's
        statistics (training mode)."""
        axes = tuple(range(x.dim() - 1))
        mean = x.mean(axes)
        var = torch.clamp_min(x.square().mean(axes) - mean.square(), 0.0)
        return (x - mean) * (torch.rsqrt(var + 1e-5) * self.weight) + self.bias


def flip_valid(x, lens):
    """Each row's first ``lens`` frames reversed; the padding after them,
    reversed too, follows."""
    t = x.shape[1]
    idx = (torch.arange(t - 1, -1, -1, device=x.device)[None, :] + lens[:, None]) % t
    return torch.gather(x, 1, idx[..., None].expand(x.shape))


class BiLSTM(nn.Module):
    def __init__(self, n_in, hidden):
        super().__init__()
        self.hidden = hidden
        self.weight_ih = nn.Parameter(torch.empty(2, 4 * hidden, n_in))
        self.weight_hh = nn.Parameter(torch.empty(2, 4 * hidden, hidden))
        self.bias = nn.Parameter(torch.empty(2, 4 * hidden))

    def direction(self, x, d, prec):
        """One direction over every frame. In float32 on a card this is
        cuDNN's fused LSTM (the same recurrence, run with TF32 off; a CPU
        test holds the two equal), else the loop over frames below."""
        if x.is_cuda and prec.name == "float32":
            h0 = x.new_zeros(1, x.shape[0], self.hidden)
            weights = [self.weight_ih[d], self.weight_hh[d], self.bias[d],
                       torch.zeros_like(self.bias[d])]
            return torch.lstm(x, (h0, h0), weights, True, 1, 0.0, True, False, True)[0]
        return self.loop(x, d, prec)

    def loop(self, x, d, prec):
        b, t, _ = x.shape
        xz = prec.linear(x, self.weight_ih[d], self.bias[d])
        h = x.new_zeros(b, self.hidden)
        c = x.new_zeros(b, self.hidden)
        w_hh = prec.operand(self.weight_hh[d]).t()
        out = []
        for i in range(t):
            gi, gf, gg, go = (xz[:, i] + prec.output(prec.operand(h) @ w_hh)).chunk(4, -1)
            c = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
            h = torch.sigmoid(go) * torch.tanh(c)
            out.append(h)
        return torch.stack(out, 1)

    def forward(self, x, lens, prec):
        fwd = self.direction(x, 0, prec)
        return fwd + flip_valid(self.direction(flip_valid(x, lens), 1, prec), lens)


class DeepSpeech2(nn.Module):
    def __init__(self, vocab_size=29, hidden_size=1024, num_rnn_layers=5, n_freq=161, **_):
        super().__init__()
        self.conv = nn.Module()
        self.conv.conv1 = nn.Conv2d(1, 32, (11, 41), stride=(2, 2), padding=(5, 20))
        self.conv.bn1 = BatchNorm(32)
        self.conv.conv2 = nn.Conv2d(32, 32, (11, 21), stride=(1, 2), padding=(5, 10))
        self.conv.bn2 = BatchNorm(32)
        f = (n_freq + 2 * 20 - 41) // 2 + 1
        f = (f + 2 * 10 - 21) // 2 + 1
        self.num_rnn_layers = num_rnn_layers
        for i in range(num_rnn_layers):
            layer = nn.Module()
            if i:
                layer.bn = BatchNorm(hidden_size)
            layer.bilstm = BiLSTM(32 * f if i == 0 else hidden_size, hidden_size)
            self.add_module(f"rnn_{i}", layer)
        self.head_bn = BatchNorm(hidden_size)
        self.fc = nn.Module()
        self.fc.weight = nn.Parameter(torch.empty(vocab_size, hidden_size))

    def init_spec(self):
        """``(name, shape, kind, fan_in)`` of every parameter, in order."""
        out = []
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                out.append((name, tuple(p.shape), "zeros", 0))
            elif p.dim() == 1:
                out.append((name, tuple(p.shape), "ones", 0))
            elif "bilstm" in name:
                out.append((name, tuple(p.shape), "normal", p.shape[-1]))
            else:
                out.append((name, tuple(p.shape), "normal", p[0].numel()))
        return out

    def logits(self, spect, lens, prec=FLOAT32):
        def conv_block(x, conv, bn, lens):
            x = prec.conv2d(x, conv.weight, conv.bias, stride=conv.stride, padding=conv.padding)
            x = torch.clamp(bn(x.permute(0, 2, 3, 1)), 0.0, 20.0)
            valid = torch.arange(x.shape[1], device=x.device)[None, :] < lens[:, None]
            return torch.where(valid[:, :, None, None], x, 0.0)

        x = spect[:, None]
        lens = (lens + 2 * 5 - 11) // 2 + 1
        x = conv_block(x, self.conv.conv1, self.conv.bn1, lens)
        x = conv_block(x.permute(0, 3, 1, 2), self.conv.conv2, self.conv.bn2, lens)
        b, t, f, c = x.shape
        x = x.reshape(b, t, f * c)
        for i in range(self.num_rnn_layers):
            layer = getattr(self, f"rnn_{i}")
            if i:
                x = layer.bn(x)
            x = layer.bilstm(x, lens, prec)
        return prec.linear(self.head_bn(x), self.fc.weight), lens

    def row_losses(self, batch, prec=FLOAT32):
        return self.ctc_losses(*self.logits(batch["feats"], batch["feat_lens"], prec), batch)

    @staticmethod
    def ctc_losses(logits, lens, batch):
        """Each row's CTC loss on ``logits`` over its ``lens`` frames."""
        logp = F.log_softmax(logits.double(), -1)
        return F.ctc_loss(logp.transpose(0, 1), batch["labels"], lens, batch["label_lens"],
                          blank=28, reduction="none", zero_infinity=False).float()
