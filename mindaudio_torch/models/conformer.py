"""Conformer encoder + Transformer decoder (port of ``mindaudio_tpu.models.conformer``).

The dense, full-context path: no MoE, sequence parallelism, pipeline or
int8 FFN training knobs, and no streaming ``forward_chunk`` yet.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..utils.mask import add_optional_chunk_mask, make_non_pad_mask, subsequent_mask
from .layers import (
    LN_EPS,
    Conv2dSubsampling4,
    ConvolutionModule,
    FastDropout,
    GlobalCMVN,
    MultiHeadedAttention,
    PositionalEncoding,
    PositionwiseFeedForward,
    RelPositionMultiHeadedAttention,
    Swish,
)

__all__ = ["ConformerEncoderLayer", "ConformerEncoder", "DecoderLayer",
           "TransformerDecoder"]


class ConformerEncoderLayer(nn.Module):
    """Macaron FFN → rel-pos MHSA → conv module → FFN → LayerNorm, pre-norm,
    with half-step FFN residuals."""

    def __init__(self, d_model, head_num, ffn_dim, dropout_rate=0.1,
                 attention_dropout_rate=0.0, kernel_size=15, causal_conv=False):
        super().__init__()
        self.norm_ff_macaron = nn.LayerNorm(d_model, eps=LN_EPS)
        self.feed_forward_macaron = PositionwiseFeedForward(
            d_model, ffn_dim, dropout_rate, activation=Swish())
        self.norm_mha = nn.LayerNorm(d_model, eps=LN_EPS)
        self.self_attn = RelPositionMultiHeadedAttention(
            d_model, head_num, attention_dropout_rate)
        self.norm_conv = nn.LayerNorm(d_model, eps=LN_EPS)
        self.conv_module = ConvolutionModule(d_model, kernel_size, causal=causal_conv)
        self.norm_ff = nn.LayerNorm(d_model, eps=LN_EPS)
        self.feed_forward = PositionwiseFeedForward(
            d_model, ffn_dim, dropout_rate, activation=Swish())
        self.norm_final = nn.LayerNorm(d_model, eps=LN_EPS)
        self.dropout = FastDropout(dropout_rate)

    def forward(self, x, mask, pos_emb, mask_pad=None):
        x = x + 0.5 * self.dropout(self.feed_forward_macaron(self.norm_ff_macaron(x)))
        y = self.norm_mha(x)
        x = x + self.dropout(self.self_attn(y, y, y, mask=mask, pos_emb=pos_emb))
        x = x + self.dropout(self.conv_module(self.norm_conv(x), mask_pad=mask_pad))
        x = x + 0.5 * self.dropout(self.feed_forward(self.norm_ff(x)))
        return self.norm_final(x)


class ConformerEncoder(nn.Module):
    """CMVN → Conv2d 4x subsampling → N Conformer blocks.

    ``forward`` returns ``(encoder_out, encoder_mask)`` with
    ``encoder_mask: (B, 1, T')`` True at valid subsampled frames.
    """

    def __init__(self, input_dim=80, d_model=256, head_num=4, ffn_dim=2048,
                 num_layers=12, dropout_rate=0.1, attention_dropout_rate=0.0,
                 kernel_size=15, use_dynamic_chunk=False, static_chunk_size=0,
                 causal_conv=False, cmvn_mean=None, cmvn_istd=None):
        super().__init__()
        self.use_dynamic_chunk = use_dynamic_chunk
        self.static_chunk_size = static_chunk_size
        self.global_cmvn = (GlobalCMVN(cmvn_mean, cmvn_istd)
                            if cmvn_mean is not None else None)
        self.embed = Conv2dSubsampling4(input_dim, d_model, dropout_rate,
                                        pos_enc="rel_pos")
        self.layers = nn.ModuleList(
            ConformerEncoderLayer(d_model, head_num, ffn_dim, dropout_rate,
                                  attention_dropout_rate, kernel_size, causal_conv)
            for _ in range(num_layers)
        )

    def forward(self, xs, xs_lens, decoding_chunk_size=0, num_decoding_left_chunks=-1):
        if self.global_cmvn is not None:
            xs = self.global_cmvn(xs)
        # compute dtype = parameter dtype (the subsampling convs are never
        # swapped for int8 modules)
        xs, pos_emb = self.embed(xs.to(self.embed.conv1.weight.dtype))

        t_sub = xs.shape[1]
        sub_lens = ((xs_lens - 1) // 2 - 1) // 2
        masks = make_non_pad_mask(sub_lens, t_sub)[:, None, :]  # (B, 1, T')
        chunk_masks = add_optional_chunk_mask(
            masks, self.use_dynamic_chunk, decoding_chunk_size,
            self.static_chunk_size, num_decoding_left_chunks)
        mask_pad = masks[:, 0, :]
        for layer in self.layers:
            xs = layer(xs, chunk_masks, pos_emb, mask_pad)
        return xs, masks


class DecoderLayer(nn.Module):
    """Pre-norm self-attn → cross-attn → FFN decoder block."""

    def __init__(self, d_model, head_num, ffn_dim, dropout_rate=0.1,
                 attention_dropout_rate=0.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.self_attn = MultiHeadedAttention(d_model, head_num, attention_dropout_rate)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.src_attn = MultiHeadedAttention(d_model, head_num, attention_dropout_rate)
        self.norm3 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.feed_forward = PositionwiseFeedForward(d_model, ffn_dim, dropout_rate)
        self.dropout = FastDropout(dropout_rate)

    def forward(self, tgt, tgt_mask, memory, memory_mask):
        y = self.norm1(tgt)
        x = tgt + self.dropout(self.self_attn(y, y, y, mask=tgt_mask))
        y = self.norm2(x)
        x = x + self.dropout(self.src_attn(y, memory, memory, mask=memory_mask))
        return x + self.dropout(self.feed_forward(self.norm3(x)))


class TransformerDecoder(nn.Module):
    """Embedding + absolute positions + N cross-attention blocks + output head.

    ``forward(memory, memory_mask, ys_in, ys_in_lens)`` returns logits
    ``(B, L, vocab)``.
    """

    def __init__(self, vocab_size, d_model=256, head_num=4, ffn_dim=2048,
                 num_layers=6, dropout_rate=0.1, attention_dropout_rate=0.0):
        super().__init__()
        self.embed = nn.Embedding(vocab_size, d_model)
        self.pos_enc = PositionalEncoding(d_model, dropout_rate)
        self.layers = nn.ModuleList(
            DecoderLayer(d_model, head_num, ffn_dim, dropout_rate, attention_dropout_rate)
            for _ in range(num_layers)
        )
        self.after_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.output_layer = nn.Linear(d_model, vocab_size)

    def forward(self, memory, memory_mask, ys_in, ys_in_lens):
        length = ys_in.shape[1]
        x, _ = self.pos_enc(self.embed(ys_in))
        tgt_mask = (make_non_pad_mask(ys_in_lens, length)[:, None, :]
                    & subsequent_mask(length, ys_in.device)[None])
        for layer in self.layers:
            x = layer(x, tgt_mask, memory, memory_mask)
        return self.output_layer(self.after_norm(x))

    def forward_one_step(self, memory, memory_mask, ys):
        """Log-softmax (float32) of the last position's logits, for each
        full prefix in ``ys``."""
        lens = torch.full((ys.shape[0],), ys.shape[1], dtype=torch.long,
                          device=ys.device)
        logits = self(memory, memory_mask, ys, lens)
        return F.log_softmax(logits[:, -1].float(), dim=-1)
