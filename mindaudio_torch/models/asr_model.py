"""Hybrid CTC/attention ASR model (port of
``mindaudio_tpu.models.asr_model.ASRModel``).

A Conformer encoder, a Transformer decoder with label-smoothing loss and a
CTC head, combined as ``loss = w * loss_ctc + (1 - w) * loss_att`` in
``forward``. ``encode``, ``ctc_log_probs``, ``decode_step``,
``decoder_logits`` and, streaming, ``encode_chunk`` are the pieces that
decoding calls. ``remat`` and ``int8_ffn`` are the JAX module's training
knobs (``int8_ffn`` also runs the CTC projection W8A8); ``moe_*``,
``sp_mesh``/``sp_variant`` and ``pipeline_*`` its parallel ones
(``models.conformer.ConformerEncoder``). With MoE blocks, a trainer reads
the blocks' Switch losses of the last ``forward`` through
``parallel.moe.moe_aux_losses(model)`` (stacked, with their gradient; the JAX
model sows them) and weights them into its loss; they are computed only
when read.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from .. import resolve_device
from ..loss.ctc_loss import ctc_loss
from ..loss.label_smoothing_loss import IGNORE_ID, label_smoothing_loss
from ..parallel.mesh import data_denominator
from .conformer import ConformerEncoder, TransformerDecoder
from ..parallel.moe import MoEFeedForward
from .layers import FastDropout, Int8Dense, column_head

__all__ = ["ASRModel"]


class ASRModel(nn.Module):
    """Conformer encoder + Transformer decoder + CTC head.

    Parameters are created float32 on ``device`` (CUDA unless the caller
    asks for the CPU). Their values come from :meth:`reset_parameters` or
    from a converted JAX checkpoint (``mindaudio_torch.convert``).

    ``forward`` takes a batch dict and returns ``(loss, metrics)``. Training
    is ``model.train()`` (the JAX ``deterministic=False``) after
    :meth:`set_dropout_generator`. ``ctc_impl`` is ``"auto"``, ``"kernel"``
    or ``"scan"`` (``loss/ctc_loss.py``). ``remat`` rematerializes the
    encoder blocks in the backward; ``int8_ffn`` runs the encoder's FFNs and
    the CTC projection W8A8 with the same parameter names as the float model,
    so one checkpoint serves both.
    """

    def __init__(self, vocab_size, input_dim=80, d_model=256, head_num=4,
                 ffn_dim=2048, num_encoder_layers=12, num_decoder_layers=6,
                 dropout_rate=0.1, attention_dropout_rate=0.0, kernel_size=15,
                 ctc_weight=0.3, ctc_impl="auto", lsm_weight=0.1,
                 use_dynamic_chunk=False, static_chunk_size=0, causal_conv=False,
                 cmvn_mean=None, cmvn_istd=None, remat=False, int8_ffn=False,
                 moe_experts=0, moe_top_k=2, moe_capacity_factor=1.25, moe_mesh=None,
                 sp_mesh=None, sp_variant="ring", pipeline_mesh=None, pipeline_microbatches=4,
                 moe_macaron=False, device="cuda"):
        super().__init__()
        self.vocab_size = vocab_size
        self.ctc_weight = ctc_weight
        self.ctc_impl = ctc_impl
        self.lsm_weight = lsm_weight
        self.encoder = ConformerEncoder(
            input_dim=input_dim, d_model=d_model, head_num=head_num,
            ffn_dim=ffn_dim, num_layers=num_encoder_layers,
            dropout_rate=dropout_rate,
            attention_dropout_rate=attention_dropout_rate,
            kernel_size=kernel_size, use_dynamic_chunk=use_dynamic_chunk,
            static_chunk_size=static_chunk_size, causal_conv=causal_conv,
            cmvn_mean=cmvn_mean, cmvn_istd=cmvn_istd, remat=remat, int8_ffn=int8_ffn,
            moe_experts=moe_experts, moe_top_k=moe_top_k,
            moe_capacity_factor=moe_capacity_factor, moe_mesh=moe_mesh, sp_mesh=sp_mesh,
            sp_variant=sp_variant, pipeline_mesh=pipeline_mesh,
            pipeline_microbatches=pipeline_microbatches, moe_macaron=moe_macaron,
        )
        self.decoder = TransformerDecoder(
            vocab_size, d_model=d_model, head_num=head_num, ffn_dim=ffn_dim,
            num_layers=num_decoder_layers, dropout_rate=dropout_rate,
            attention_dropout_rate=attention_dropout_rate,
        )
        self.ctc_proj = (Int8Dense if int8_ffn else nn.Linear)(d_model, vocab_size)
        self.to(resolve_device(device))

    @torch.no_grad()
    def reset_parameters(self, generator):
        """Random weights from ``generator``, scaled as flax initializes
        them: normal matrices and convs with std ``1/sqrt(fan_in)`` (flax's
        lecun-normal, untruncated), zero biases, unit LayerNorm scales,
        xavier-uniform rel-pos biases, std ``1/sqrt(d)`` embeddings."""
        for module in self.modules():
            if isinstance(module, (nn.Linear, nn.Conv1d, nn.Conv2d)):
                fan_in = module.weight[0].numel()
                module.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
                module.bias.zero_()
            elif isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
            elif isinstance(module, nn.Embedding):
                module.weight.normal_(0.0, 1.0 / math.sqrt(module.embedding_dim),
                                      generator=generator)
            elif isinstance(module, MoEFeedForward):
                module.reset_parameters(generator)
        for name, p in self.named_parameters():
            if name.endswith(("pos_bias_u", "pos_bias_v")):
                bound = math.sqrt(6.0 / sum(p.shape))
                p.uniform_(-bound, bound, generator=generator)
        return self

    def set_dropout_generator(self, generator):
        """Make every dropout of the model draw from ``generator`` (on the
        parameters' device), so that training needs no global RNG state."""
        for module in self.modules():
            if isinstance(module, FastDropout):
                module.generator = generator
        return self

    def forward(self, batch, chunk_generator=None):
        """Hybrid training loss: ``(loss, metrics)``.

        ``batch`` keys: ``feats (B, T, F)`` float32, ``feat_lens (B,)``,
        ``ys_in (B, L+1)`` decoder input with sos, ``ys_out (B, L+1)`` decoder
        target with eos and ``IGNORE_ID`` pads, ``ys_lens (B,)`` = label
        length + 1, ``labels (B, L)`` CTC targets (no sos/eos), ``label_lens
        (B,)``. Both losses are computed in float32 whatever the compute
        dtype. Without a ``chunk_generator`` a dynamic-chunk model runs with
        full context.
        """
        enc_out, enc_mask = self.encoder(
            batch["feats"], batch["feat_lens"],
            decoding_chunk_size=0 if chunk_generator is not None else -1,
            chunk_generator=chunk_generator)
        enc_lens = enc_mask[:, 0, :].sum(-1)

        zero = torch.zeros((), dtype=torch.float32, device=enc_out.device)
        loss_att = acc_att = loss_ctc = zero
        if self.ctc_weight < 1.0:
            dec_logits = self.decoder(enc_out, enc_mask, batch["ys_in"], batch["ys_lens"])
            ys_out = batch["ys_out"]
            loss_att = label_smoothing_loss(dec_logits, ys_out, smoothing=self.lsm_weight)
            valid = ys_out != IGNORE_ID
            hits = (dec_logits.argmax(-1) == ys_out) & valid
            acc_att = hits.sum() / data_denominator(valid.sum())
        if self.ctc_weight > 0.0:
            loss_ctc = ctc_loss(column_head(self.ctc_proj, enc_out), enc_lens, batch["labels"],
                                batch["label_lens"], impl=self.ctc_impl)

        loss = self.ctc_weight * loss_ctc + (1.0 - self.ctc_weight) * loss_att
        metrics = {"loss_att": loss_att, "loss_ctc": loss_ctc, "acc_att": acc_att}
        return loss, metrics

    def encode(self, feats, feat_lens, decoding_chunk_size=-1,
               num_decoding_left_chunks=-1):
        return self.encoder(feats, feat_lens, decoding_chunk_size=decoding_chunk_size,
                            num_decoding_left_chunks=num_decoding_left_chunks)

    def encode_chunk(self, xs, att_caches=None, cnn_caches=None, required_cache_size=-1):
        """Streaming: one encoder chunk (``ConformerEncoder.forward_chunk``)
        and its float32 CTC log-probs: ``(log_probs (B, C, vocab),
        att_caches, cnn_caches)``. Needs ``causal_conv=True``."""
        ys, att_caches, cnn_caches = self.encoder.forward_chunk(
            xs, att_caches, cnn_caches, required_cache_size)
        return self.ctc_log_probs(ys), att_caches, cnn_caches

    def ctc_log_probs(self, enc_out):
        """(B, T', vocab) float32 log-softmax CTC posterior."""
        return F.log_softmax(column_head(self.ctc_proj, enc_out).float(), dim=-1)

    def decode_step(self, enc_out, enc_mask, ys):
        """Log-probs of the next token for each full hypothesis prefix."""
        return self.decoder.forward_one_step(enc_out, enc_mask, ys)

    def decoder_logits(self, enc_out, enc_mask, ys_in, ys_lens):
        """Full decoder pass (attention rescoring scores one pass per hyp set)."""
        return self.decoder(enc_out, enc_mask, ys_in, ys_lens)
