"""The hybrid CTC/attention Conformer (WeNet's ``ASRModel``: Conformer
encoder, Transformer decoder, CTC head) written out plainly, with the port's
parameter names so that one set of seeded weights loads into both.

Encoder: 4x conv subsampling (two 3x3 stride-2 convs, ReLU, a projection of
the ``(F', C)`` flattening), ``x * sqrt(d)`` and dropout; N macaron blocks
(half-step FFN, relative-position self-attention with u/v biases scored as
``[q+u; q+v] . [k; p] / sqrt(d_k)``, convolution module pointwise-GLU-
depthwise-LayerNorm-Swish-pointwise, half-step FFN, final LayerNorm; pre-
norm, LayerNorm eps 1e-6, masked scores -1e9). Decoder: embedding
``* sqrt(d)`` plus sinusoidal positions, N pre-norm blocks of causal
self-attention, cross-attention and a ReLU FFN, LayerNorm, output layer.
Loss: ``w * CTC + (1 - w) * KL(label-smoothed targets)``, each over the
batch's rows (CTC by ``torch.nn.functional.ctc_loss`` in float64).

Dropout keeps a value where a uniform byte is at least ``round(256 r)`` and
divides by the kept share; the bytes come from :class:`Dropout`, which draws
them at the whole batch's shape in the order the blocks call it, so that a
generator seeded alike gives the recipe's masks, and the batch can run in
blocks of rows.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from .precision import FLOAT32

LN_EPS = 1e-6
MASK = -1e9


class Dropout:
    """The dropout bytes of one step: drawn at ``(rows,) + shape[1:]`` on
    first use of each call site, sliced to the block's rows after."""

    def __init__(self, rate, generator, rows):
        self.thresh = int(round(rate * 256.0))
        self.generator, self.rows = generator, rows
        self.bits, self.i, self.block = [], 0, slice(None)

    def start(self, block):
        self.i, self.block = 0, block

    def __call__(self, x):
        if self.thresh <= 0 or self.generator is None:
            return x
        if self.i == len(self.bits):
            self.bits.append(torch.randint(0, 256, (self.rows,) + tuple(x.shape[1:]),
                                           generator=self.generator, device=x.device,
                                           dtype=torch.uint8))
        bits = self.bits[self.i][self.block]
        self.i += 1
        return torch.where(bits >= self.thresh, x / (1.0 - self.thresh / 256.0), 0.0)


def sinusoids(length, d):
    pos = np.arange(length)[:, None].astype(np.float64)
    div = np.exp(np.arange(0, d, 2) * -(np.log(10000.0) / d))
    table = np.zeros((length, d))
    table[:, 0::2], table[:, 1::2] = np.sin(pos * div), np.cos(pos * div)
    return torch.as_tensor(table, dtype=torch.float32)


def layer_norm(x, norm):
    return F.layer_norm(x, x.shape[-1:], norm.weight, norm.bias, LN_EPS)


def heads(x, h):
    b, t, d = x.shape
    return x.view(b, t, h, d // h).transpose(1, 2)


def merge(x):
    b, h, t, dk = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dk)


class Linear(nn.Module):
    def __init__(self, n_in, n_out, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_out, n_in))
        self.bias = nn.Parameter(torch.empty(n_out)) if bias else None

    def forward(self, x, prec):
        return prec.linear(x, self.weight, self.bias)


class Norm(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.weight, self.bias = nn.Parameter(torch.empty(d)), nn.Parameter(torch.empty(d))


class FFN(nn.Module):
    def __init__(self, d, hidden):
        super().__init__()
        self.w_1, self.w_2 = Linear(d, hidden), Linear(hidden, d)

    def forward(self, x, act, drop, prec):
        return self.w_2(drop(act(self.w_1(x, prec))), prec)


class Attention(nn.Module):
    def __init__(self, d, h, rel=False):
        super().__init__()
        self.h = h
        self.linear_q, self.linear_k = Linear(d, d), Linear(d, d)
        self.linear_v, self.linear_out = Linear(d, d), Linear(d, d)
        if rel:
            self.linear_pos = Linear(d, d)
            self.pos_bias_u = nn.Parameter(torch.empty(h, d // h))
            self.pos_bias_v = nn.Parameter(torch.empty(h, d // h))

    def forward(self, q_in, kv_in, mask, prec, pos=None):
        q = heads(self.linear_q(q_in, prec), self.h)
        k = heads(self.linear_k(kv_in, prec), self.h)
        v = heads(self.linear_v(kv_in, prec), self.h)
        dk = q.shape[-1]
        if pos is not None:
            p = heads(self.linear_pos(pos, prec), self.h)
            q = torch.cat([q + self.pos_bias_u[None, :, None], q + self.pos_bias_v[None, :, None]],
                          -1)
            k = torch.cat([k, p.expand_as(k)], -1)
        scores = prec.matmul(q, k.transpose(-2, -1)) / math.sqrt(dk)
        scores = scores.masked_fill(~mask[:, None], MASK)
        return self.linear_out(merge(prec.matmul(torch.softmax(scores, -1), v)), prec)


class ConvModule(nn.Module):
    def __init__(self, d, kernel):
        super().__init__()
        self.pointwise_conv1 = Linear(d, 2 * d)
        self.depthwise_conv = nn.Module()
        self.depthwise_conv.weight = nn.Parameter(torch.empty(d, 1, kernel))
        self.depthwise_conv.bias = nn.Parameter(torch.empty(d))
        self.norm = Norm(d)
        self.pointwise_conv2 = Linear(d, d)

    def forward(self, x, valid, prec):
        x = x.masked_fill(~valid[..., None], 0.0)
        a, g = self.pointwise_conv1(x, prec).chunk(2, -1)
        x = a * torch.sigmoid(g)
        k = self.depthwise_conv.weight.shape[-1]
        x = prec.conv1d(F.pad(x.transpose(1, 2), ((k - 1) // 2, (k - 1) // 2)),
                        self.depthwise_conv.weight, self.depthwise_conv.bias,
                        groups=x.shape[-1]).transpose(1, 2)
        x = layer_norm(x, self.norm)
        x = self.pointwise_conv2(x * torch.sigmoid(x), prec)
        return x.masked_fill(~valid[..., None], 0.0)


def swish(x):
    return x * torch.sigmoid(x)


class EncoderLayer(nn.Module):
    def __init__(self, d, h, ffn, kernel):
        super().__init__()
        self.norm_ff_macaron, self.feed_forward_macaron = Norm(d), FFN(d, ffn)
        self.norm_mha, self.self_attn = Norm(d), Attention(d, h, rel=True)
        self.norm_conv, self.conv_module = Norm(d), ConvModule(d, kernel)
        self.norm_ff, self.feed_forward = Norm(d), FFN(d, ffn)
        self.norm_final = Norm(d)

    def forward(self, x, mask, pos, drop, prec):
        ff = self.feed_forward_macaron(layer_norm(x, self.norm_ff_macaron), swish, drop, prec)
        x = x + 0.5 * drop(ff)
        y = layer_norm(x, self.norm_mha)
        x = x + drop(self.self_attn(y, y, mask, prec, pos=pos))
        x = x + drop(self.conv_module(layer_norm(x, self.norm_conv), mask[:, 0], prec))
        x = x + 0.5 * drop(self.feed_forward(layer_norm(x, self.norm_ff), swish, drop, prec))
        return layer_norm(x, self.norm_final)


class DecoderLayer(nn.Module):
    def __init__(self, d, h, ffn):
        super().__init__()
        self.norm1, self.self_attn = Norm(d), Attention(d, h)
        self.norm2, self.src_attn = Norm(d), Attention(d, h)
        self.norm3, self.feed_forward = Norm(d), FFN(d, ffn)

    def forward(self, x, tgt_mask, memory, mem_mask, drop, prec):
        y = layer_norm(x, self.norm1)
        x = x + drop(self.self_attn(y, y, tgt_mask, prec))
        y = layer_norm(x, self.norm2)
        x = x + drop(self.src_attn(y, memory, mem_mask, prec))
        return x + drop(self.feed_forward(layer_norm(x, self.norm3), F.relu, drop, prec))


class Conformer(nn.Module):
    def __init__(self, vocab_size, input_dim=80, d_model=256, head_num=4, ffn_dim=2048,
                 num_encoder_layers=12, num_decoder_layers=6, kernel_size=15, ctc_weight=0.3,
                 lsm_weight=0.1, dropout_rate=0.1, **_):
        super().__init__()
        d = d_model
        self.d, self.vocab = d, vocab_size
        self.ctc_weight, self.lsm_weight, self.dropout_rate = ctc_weight, lsm_weight, dropout_rate
        self.encoder = nn.Module()
        self.encoder.embed = nn.Module()
        self.encoder.embed.conv1 = nn.Conv2d(1, d, 3, stride=2)
        self.encoder.embed.conv2 = nn.Conv2d(d, d, 3, stride=2)
        self.encoder.embed.out = Linear(d * (((input_dim - 1) // 2 - 1) // 2), d)
        self.encoder.layers = nn.ModuleList(EncoderLayer(d, head_num, ffn_dim, kernel_size)
                                            for _ in range(num_encoder_layers))
        self.decoder = nn.Module()
        self.decoder.embed = nn.Embedding(vocab_size, d)
        self.decoder.layers = nn.ModuleList(DecoderLayer(d, head_num, ffn_dim)
                                            for _ in range(num_decoder_layers))
        self.decoder.after_norm = Norm(d)
        self.decoder.output_layer = Linear(d, vocab_size)
        self.ctc_proj = Linear(d, vocab_size)

    def init_spec(self):
        """``(name, shape, kind, fan_in)`` of every parameter, in order: the
        rule :func:`portbench.weights.make` draws the seeded weights by."""
        out = []
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name.endswith(("pos_bias_u", "pos_bias_v")):
                out.append((name, tuple(p.shape), "uniform", sum(p.shape)))
            elif leaf == "bias" or (leaf == "weight" and p.dim() == 1):
                out.append((name, tuple(p.shape), "zeros" if leaf == "bias" else "ones", 0))
            elif name == "decoder.embed.weight":
                out.append((name, tuple(p.shape), "normal", p.shape[1]))
            else:
                out.append((name, tuple(p.shape), "normal", p[0].numel()))
        return out

    def encode(self, feats, feat_lens, drop, prec=FLOAT32):
        emb = self.encoder.embed
        x = F.relu(prec.conv2d(feats[:, None], emb.conv1.weight, emb.conv1.bias, stride=2))
        x = F.relu(prec.conv2d(x, emb.conv2.weight, emb.conv2.bias, stride=2))
        b, c, t, f = x.shape
        x = emb.out(x.permute(0, 2, 3, 1).reshape(b, t, f * c), prec)
        x = drop(x * math.sqrt(self.d))
        pos = sinusoids(t, self.d).to(x.device)[None]
        lens = ((feat_lens - 1) // 2 - 1) // 2
        mask = (torch.arange(t, device=x.device)[None, :] < lens[:, None])[:, None]
        for layer in self.encoder.layers:
            x = layer(x, mask, pos, drop, prec)
        return x, mask

    def decode(self, memory, mem_mask, ys_in, ys_lens, drop, prec=FLOAT32):
        length = ys_in.shape[1]
        x = self.decoder.embed.weight[ys_in] * math.sqrt(self.d)
        x = drop(x + sinusoids(length, self.d).to(x.device)[None])
        valid = torch.arange(length, device=x.device)[None, :] < ys_lens[:, None]
        causal = torch.ones(length, length, dtype=torch.bool, device=x.device).tril()
        tgt_mask = valid[:, None, :] & causal[None]
        for layer in self.decoder.layers:
            x = layer(x, tgt_mask, memory, mem_mask, drop, prec)
        return self.decoder.output_layer(layer_norm(x, self.decoder.after_norm), prec)

    def row_losses(self, batch, drop, prec=FLOAT32, keep=None):
        """Each row's ``w * ctc + (1 - w) * kl`` (a batch's loss is their
        mean); ``keep``, a list, gets the CTC head's logits and the
        encoder's valid frames, on the host."""
        enc, mask = self.encode(batch["feats"], batch["feat_lens"], drop, prec)
        enc_lens = mask[:, 0].sum(-1)
        ctc_logits = self.ctc_proj(enc, prec)
        if keep is not None:
            keep.append((ctc_logits.detach().float().cpu(), enc_lens.cpu()))
        logp = F.log_softmax(ctc_logits.double(), -1)
        ctc = F.ctc_loss(logp.transpose(0, 1), batch["labels"], enc_lens, batch["label_lens"],
                         blank=0, reduction="none", zero_infinity=False)
        logits = self.decode(enc, mask, batch["ys_in"], batch["ys_lens"], drop, prec)
        kl = smoothed_kl(logits, batch["ys_out"], self.lsm_weight)
        return self.ctc_weight * ctc.float() + (1.0 - self.ctc_weight) * kl


def smoothed_kl(logits, targets, smoothing, ignore_id=-1):
    """Per row: the sum over its target positions of KL(smoothed one-hot ||
    softmax(logits)), the smoothed target ``1 - s`` on the label and ``s /
    (V - 1)`` elsewhere."""
    v = logits.shape[-1]
    valid = targets != ignore_id
    true = torch.full_like(logits, smoothing / (v - 1), dtype=torch.float32)
    true.scatter_(-1, torch.where(valid, targets, 0)[..., None], 1.0 - smoothing)
    kl = (true * (true.log() - F.log_softmax(logits.float(), -1))).sum(-1)
    return torch.where(valid, kl, 0.0).sum(-1)
