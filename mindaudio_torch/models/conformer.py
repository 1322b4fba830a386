"""Conformer encoder + Transformer decoder (port of ``mindaudio_tpu.models.conformer``).

The dense path, for decoding, streaming decode (``forward_chunk``) and
training, with the JAX module's training knobs ``remat`` (each encoder
block's activations recomputed in the backward) and ``int8_ffn`` (both FFNs
of every block W8A8 on the int8 tensor cores), the conv module's
``norm_type``, and its parallel ones (``parallel/``): MoE blocks
(``moe_experts``), sequence parallelism over the ``seq`` group
(``sp_mesh``) and a GPipe pipeline of the blocks over ``pipe``
(``pipeline_mesh``). Megatron tensor parallelism is applied to a built model
by ``parallel.shardings.apply_tensor_parallel``.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..parallel.collectives import all_gather, scatter
from ..parallel.mesh import batch_stat_axes
from ..parallel.moe import MoEFeedForward
from ..parallel.pipeline import pipeline_apply
from ..parallel.shardings import set_partial
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
    column_head,
    remat_call,
    sinusoid_table,
)

__all__ = ["ConformerEncoderLayer", "ConformerEncoder", "DecoderLayer",
           "TransformerDecoder"]


class ConformerEncoderLayer(nn.Module):
    """Macaron FFN → rel-pos MHSA → conv module → FFN → LayerNorm, pre-norm,
    with half-step FFN residuals; ``use_macaron=False`` drops the macaron FFN
    (and its norm) and takes the final FFN's whole step.

    Streaming: with ``att_cache`` (the ``(k, v)`` of the frames before this
    chunk) and ``cnn_cache`` (the conv module's left context) the layer
    returns ``(x, new_att_cache, new_cnn_cache)``. ``int8_ffn`` runs both
    FFNs' forwards W8A8 (``layers.Int8Dense``).

    ``moe_experts > 0`` makes the final FFN a ``parallel.moe.MoEFeedForward``
    (MoE-Conformer), and with ``moe_macaron`` the macaron FFN one too (U2++
    MoE, every FFN of the block); ``moe_capacity_factor=None`` is the
    dropless MoE."""

    def __init__(self, d_model, head_num, ffn_dim, dropout_rate=0.1,
                 attention_dropout_rate=0.0, kernel_size=15, causal_conv=False,
                 norm_type="layer_norm", int8_ffn=False, moe_experts=0, moe_top_k=2,
                 moe_capacity_factor=1.25, moe_mesh=None, use_macaron=True, moe_macaron=False):
        super().__init__()

        def ffn(moe):
            if moe:
                return MoEFeedForward(d_model, moe_experts, ffn_dim, dropout_rate,
                                      top_k=moe_top_k, capacity_factor=moe_capacity_factor,
                                      activation=Swish(), mesh=moe_mesh)
            return PositionwiseFeedForward(d_model, ffn_dim, dropout_rate, activation=Swish(),
                                           int8=int8_ffn)

        self.use_macaron = use_macaron
        # which FFNs are MoE blocks (they take the padding mask)
        self.moe_ff, self.moe_macaron = moe_experts > 0, moe_experts > 0 and moe_macaron
        if use_macaron:
            self.norm_ff_macaron = nn.LayerNorm(d_model, eps=LN_EPS)
            self.feed_forward_macaron = ffn(self.moe_macaron)
        self.norm_mha = nn.LayerNorm(d_model, eps=LN_EPS)
        self.self_attn = RelPositionMultiHeadedAttention(
            d_model, head_num, attention_dropout_rate)
        self.norm_conv = nn.LayerNorm(d_model, eps=LN_EPS)
        self.conv_module = ConvolutionModule(d_model, kernel_size, causal=causal_conv,
                                             norm_type=norm_type)
        self.norm_ff = nn.LayerNorm(d_model, eps=LN_EPS)
        self.feed_forward = ffn(self.moe_ff)
        self.norm_final = nn.LayerNorm(d_model, eps=LN_EPS)
        self.dropout = FastDropout(dropout_rate)

    def forward(self, x, mask, pos_emb, mask_pad=None, att_cache=None, cnn_cache=None):
        streaming = att_cache is not None
        if self.use_macaron:
            y = self.norm_ff_macaron(x)
            y = (self.feed_forward_macaron(y, mask_pad) if self.moe_macaron
                 else self.feed_forward_macaron(y))
            x = self.dropout.drop_add(x, y, 0.5)
        y = self.norm_mha(x)
        y = self.self_attn(y, y, y, mask=mask, pos_emb=pos_emb, kv_cache=att_cache)
        if streaming:
            y, new_att_cache = y
        x = self.dropout.drop_add(x, y)
        y = self.conv_module(self.norm_conv(x), mask_pad=mask_pad, cache=cnn_cache)
        if cnn_cache is not None:
            y, new_cnn_cache = y
        x = self.dropout.drop_add(x, y)
        y = self.norm_ff(x)
        y = self.feed_forward(y, mask_pad) if self.moe_ff else self.feed_forward(y)
        x = self.dropout.drop_add(x, y, 0.5 if self.use_macaron else 1.0)
        out = self.norm_final(x)
        if streaming:
            return out, new_att_cache, new_cnn_cache if cnn_cache is not None else None
        return out


class ConformerEncoder(nn.Module):
    """CMVN → Conv2d 4x subsampling → N Conformer blocks.

    ``forward`` returns ``(encoder_out, encoder_mask)`` with
    ``encoder_mask: (B, 1, T')`` True at valid subsampled frames.
    :meth:`forward_chunk` encodes a stream chunk by chunk.

    ``remat`` recomputes each block's activations in the backward of a
    training step (``layers.remat_call``: the same dropout masks, running
    statistics moved once), as JAX's ``nn.remat`` per block; ``int8_ffn``
    runs every block's FFNs W8A8; ``norm_type`` is the conv module's norm.

    ``moe_experts > 0`` makes every block's final FFN an
    ``parallel.moe.MoEFeedForward`` (its experts split over ``moe_mesh``'s
    ``model`` group when given), ``moe_macaron`` the macaron FFN too;
    ``moe_capacity_factor=None`` makes them dropless. ``sp_mesh``: the
    blocks run on this rank's frames of the ``seq`` group, self-attention
    through ring or Ulysses attention (``sp_variant``), the conv module's
    halo from the other ranks' frames; full-context attention only, and the
    subsampled length must be a multiple of the group size (both raise
    otherwise). ``pipeline_mesh``: the blocks run as a GPipe pipeline over
    its ``pipe`` group with ``pipeline_microbatches`` microbatches, the
    masks cut alongside.
    """

    def __init__(self, input_dim=80, d_model=256, head_num=4, ffn_dim=2048,
                 num_layers=12, dropout_rate=0.1, attention_dropout_rate=0.0,
                 kernel_size=15, use_dynamic_chunk=False, static_chunk_size=0,
                 causal_conv=False, cmvn_mean=None, cmvn_istd=None,
                 use_dynamic_left_chunk=False, remat=False, int8_ffn=False,
                 norm_type="layer_norm", moe_experts=0, moe_top_k=2,
                 moe_capacity_factor=1.25, moe_mesh=None, sp_mesh=None, sp_variant="ring",
                 pipeline_mesh=None, pipeline_microbatches=4, moe_macaron=False):
        super().__init__()
        if pipeline_mesh is not None and moe_experts > 0:
            raise ValueError("the pipeline runs dense blocks; it does not take MoE blocks")
        self.remat = remat
        self.d_model, self.head_num, self.kernel_size = d_model, head_num, kernel_size
        self.causal_conv = causal_conv
        self.use_dynamic_chunk = use_dynamic_chunk
        self.use_dynamic_left_chunk = use_dynamic_left_chunk
        self.static_chunk_size = static_chunk_size
        self.global_cmvn = (GlobalCMVN(cmvn_mean, cmvn_istd)
                            if cmvn_mean is not None else None)
        self.embed = Conv2dSubsampling4(input_dim, d_model, dropout_rate,
                                        pos_enc="rel_pos")
        self.layers = nn.ModuleList(
            ConformerEncoderLayer(d_model, head_num, ffn_dim, dropout_rate,
                                  attention_dropout_rate, kernel_size, causal_conv,
                                  norm_type=norm_type, int8_ffn=int8_ffn,
                                  moe_experts=moe_experts, moe_top_k=moe_top_k,
                                  moe_capacity_factor=moe_capacity_factor, moe_mesh=moe_mesh,
                                  moe_macaron=moe_macaron)
            for _ in range(num_layers)
        )
        self.sp_group = None if sp_mesh is None else sp_mesh.group("seq")
        self.sp_size = 1 if sp_mesh is None else sp_mesh.size("seq")
        self.pipeline_mesh, self.pipeline_microbatches = pipeline_mesh, pipeline_microbatches
        for layer in self.layers:
            if self.sp_group is not None:
                layer.self_attn.sp = (self.sp_group, sp_variant)
                layer.conv_module.sp_group = self.sp_group
            # each rank's gradient is a part (its frames, its stage's blocks);
            # the depthwise conv runs on the whole sequence on every rank
            whole = set(layer.conv_module.depthwise_conv.parameters())
            for p in layer.parameters():
                if self.sp_group is not None and p not in whole:
                    set_partial(p, "seq")
                if pipeline_mesh is not None and pipeline_mesh.size("pipe") > 1:
                    set_partial(p, "pipe")

    def forward(self, xs, xs_lens, decoding_chunk_size=0, num_decoding_left_chunks=-1,
                chunk_generator=None):
        """``chunk_generator`` feeds the training-time chunk sampling of a
        ``use_dynamic_chunk`` encoder called with ``decoding_chunk_size=0``."""
        if self.global_cmvn is not None:
            xs = self.global_cmvn(xs)
        # compute dtype = parameter dtype (the subsampling convs are never
        # swapped for int8 modules)
        xs, pos_emb = self.embed(xs.to(self.embed.conv1.weight.dtype))
        if self.sp_group is not None:
            if self.use_dynamic_chunk or self.static_chunk_size > 0:
                raise ValueError("sequence parallelism requires full-context attention; "
                                 "disable dynamic/static chunking")
            if xs.shape[1] % self.sp_size:
                raise ValueError(f"subsampled length {xs.shape[1]} not divisible by 'seq' "
                                 f"axis size {self.sp_size}; pad the bucket")

        t_sub = xs.shape[1]
        sub_lens = ((xs_lens - 1) // 2 - 1) // 2
        masks = make_non_pad_mask(sub_lens, t_sub)[:, None, :]  # (B, 1, T')
        chunk_masks = add_optional_chunk_mask(
            masks, self.use_dynamic_chunk, self.use_dynamic_left_chunk,
            decoding_chunk_size, self.static_chunk_size, num_decoding_left_chunks,
            generator=chunk_generator)
        mask_pad = masks[:, 0, :]

        def layer_fn(i, h, pos_emb, chunk_masks, mask_pad):
            layer = self.layers[i]
            if self.remat:
                return remat_call(layer, h, chunk_masks, pos_emb, mask_pad)
            return layer(h, chunk_masks, pos_emb, mask_pad)

        if self.sp_group is not None:
            return self._sequence_parallel(layer_fn, xs, pos_emb, chunk_masks, masks)
        if self.pipeline_mesh is not None:
            xs = pipeline_apply(layer_fn, len(self.layers), xs, self.pipeline_mesh,
                                num_microbatches=self.pipeline_microbatches,
                                extras=(pos_emb,), batched_extras=(chunk_masks, mask_pad))
            return xs, masks
        for i in range(len(self.layers)):
            xs = layer_fn(i, xs, pos_emb, chunk_masks, mask_pad)
        return xs, masks

    def _sequence_parallel(self, layer_fn, xs, pos_emb, chunk_masks, masks):
        """The blocks on this rank's frames of the ``seq`` group; the
        frames are gathered back after the last block."""
        g = self.sp_group
        xs, pos_emb = scatter(xs, g, dim=1), scatter(pos_emb, g, dim=1)
        local = scatter(masks, g, dim=2)
        with batch_stat_axes("data", "seq"):
            for i in range(len(self.layers)):
                xs = layer_fn(i, xs, pos_emb, local, local[:, 0, :])
        return all_gather(xs, g, dim=1, grad="slice"), masks

    def forward_chunk(self, xs, att_caches=None, cnn_caches=None, required_cache_size=-1):
        """Streaming: encode ONE raw-feature chunk with per-layer caches.

        Args:
            xs: ``(B, raw_T, F)`` features. For ``C`` subsampled frames a
                chunk feed ``raw_T = 4*C + 3`` frames stepping ``4*C`` (the
                subsampling's receptive field looks 3 frames back).
            att_caches: per layer the ``(k, v)`` of all earlier frames
                (``(B, heads, T_cache, d_k)`` each), or None at the start.
            cnn_caches: per layer the conv module's ``(B, kernel-1,
                d_model)`` left context, or None at the start.
            required_cache_size: cap on the attention cache (subsampled
                frames): ``-1`` keeps all of it (exact: equal to the full
                encoder with chunk masks of size ``C`` and full left
                context), ``0`` none, ``n > 0`` the last ``n``.

        Returns:
            ``(ys (B, C, d_model), att_caches, cnn_caches)``.

        Needs ``causal_conv=True``; decode in eval mode (dropout follows the
        module's mode).
        """
        if not self.causal_conv:
            raise ValueError("forward_chunk: streaming needs causal_conv=True")
        if self.global_cmvn is not None:
            xs = self.global_cmvn(xs)
        dtype = self.embed.conv1.weight.dtype
        xs, _ = self.embed(xs.to(dtype))

        b, dev = xs.shape[0], xs.device
        if att_caches is None:
            empty = torch.zeros((b, self.head_num, 0, self.d_model // self.head_num),
                                dtype=dtype, device=dev)
            att_caches = [(empty, empty)] * len(self.layers)
        if cnn_caches is None:
            cnn_caches = [torch.zeros((b, self.kernel_size - 1, self.d_model), dtype=dtype,
                                      device=dev)] * len(self.layers)
        # positions 0 .. cache + chunk - 1: the rows of the embed's table
        t_total = max(att_caches[0][0].shape[2] + xs.shape[1], 1)
        table = self.embed.pos_enc.pe
        if t_total > table.shape[0]:
            table = torch.from_numpy(sinusoid_table(t_total, self.d_model)).to(dev)
        pos_emb = table[None, :t_total].to(dtype)

        new_att, new_cnn = [], []
        for layer, a_c, c_c in zip(self.layers, att_caches, cnn_caches):
            xs, (k, v), c_new = layer(xs, None, pos_emb, None, att_cache=a_c, cnn_cache=c_c)
            if required_cache_size >= 0:  # the WeNet cap; 0 keeps no left context
                keep = k.shape[2] - min(required_cache_size, k.shape[2])
                k, v = k[:, :, keep:], v[:, :, keep:]
            new_att.append((k, v))
            new_cnn.append(c_new)
        return xs, new_att, new_cnn


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
        x = self.dropout.drop_add(tgt, self.self_attn(y, y, y, mask=tgt_mask))
        y = self.norm2(x)
        x = self.dropout.drop_add(x, self.src_attn(y, memory, memory, mask=memory_mask))
        return self.dropout.drop_add(x, self.feed_forward(self.norm3(x)))


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
        return column_head(self.output_layer, self.after_norm(x))

    def forward_one_step(self, memory, memory_mask, ys):
        """Log-softmax (float32) of the last position's logits, for each
        full prefix in ``ys``."""
        lens = torch.full((ys.shape[0],), ys.shape[1], dtype=torch.long,
                          device=ys.device)
        logits = self(memory, memory_mask, ys, lens)
        return F.log_softmax(logits[:, -1].float(), dim=-1)
