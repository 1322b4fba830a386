"""Hybrid CTC/attention ASR model, inference side (port of
``mindaudio_tpu.models.asr_model.ASRModel``).

A Conformer encoder, a Transformer decoder and a CTC head. This slice ports
the pieces the decode drivers use (``encode``, ``ctc_log_probs``,
``decode_step``, ``decoder_logits``); the hybrid training loss comes with
the training slice.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from .. import resolve_device
from .conformer import ConformerEncoder, TransformerDecoder

__all__ = ["ASRModel"]


class ASRModel(nn.Module):
    """Conformer encoder + Transformer decoder + CTC head.

    Parameters are created float32 on ``device`` (CUDA unless the caller
    asks for the CPU). Their values come from :meth:`reset_parameters` or
    from a converted JAX checkpoint (``mindaudio_torch.convert``).
    """

    def __init__(self, vocab_size, input_dim=80, d_model=256, head_num=4,
                 ffn_dim=2048, num_encoder_layers=12, num_decoder_layers=6,
                 dropout_rate=0.1, attention_dropout_rate=0.0, kernel_size=15,
                 use_dynamic_chunk=False, static_chunk_size=0, causal_conv=False,
                 cmvn_mean=None, cmvn_istd=None, device="cuda"):
        super().__init__()
        self.vocab_size = vocab_size
        self.encoder = ConformerEncoder(
            input_dim=input_dim, d_model=d_model, head_num=head_num,
            ffn_dim=ffn_dim, num_layers=num_encoder_layers,
            dropout_rate=dropout_rate,
            attention_dropout_rate=attention_dropout_rate,
            kernel_size=kernel_size, use_dynamic_chunk=use_dynamic_chunk,
            static_chunk_size=static_chunk_size, causal_conv=causal_conv,
            cmvn_mean=cmvn_mean, cmvn_istd=cmvn_istd,
        )
        self.decoder = TransformerDecoder(
            vocab_size, d_model=d_model, head_num=head_num, ffn_dim=ffn_dim,
            num_layers=num_decoder_layers, dropout_rate=dropout_rate,
            attention_dropout_rate=attention_dropout_rate,
        )
        self.ctc_proj = nn.Linear(d_model, vocab_size)
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
        for name, p in self.named_parameters():
            if name.endswith(("pos_bias_u", "pos_bias_v")):
                bound = math.sqrt(6.0 / sum(p.shape))
                p.uniform_(-bound, bound, generator=generator)
        return self

    def encode(self, feats, feat_lens, decoding_chunk_size=-1,
               num_decoding_left_chunks=-1):
        return self.encoder(feats, feat_lens, decoding_chunk_size=decoding_chunk_size,
                            num_decoding_left_chunks=num_decoding_left_chunks)

    def ctc_log_probs(self, enc_out):
        """(B, T', vocab) float32 log-softmax CTC posterior."""
        return F.log_softmax(self.ctc_proj(enc_out).float(), dim=-1)

    def decode_step(self, enc_out, enc_mask, ys):
        """Log-probs of the next token for each full hypothesis prefix."""
        return self.decoder.forward_one_step(enc_out, enc_mask, ys)

    def decoder_logits(self, enc_out, enc_mask, ys_in, ys_lens):
        """Full decoder pass (attention rescoring scores one pass per hyp set)."""
        return self.decoder(enc_out, enc_mask, ys_in, ys_lens)
