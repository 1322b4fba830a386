"""FastSpeech2 text-to-speech (port of ``mindaudio_tpu.models.fastspeech2``).

An FFT-block encoder over the phonemes, a variance adaptor (duration, pitch
and energy predictors, bucketized pitch and energy embeddings, and the
length regulator that expands phonemes to frames on the device), an
FFT-block decoder over the frames and a linear mel head. The layout is
channels-last ``(B, T, D)`` as in flax; the convolutions run on a
transposed view. Module and parameter names follow the flax ones
(``src_embed``, ``enc_<i>`` and ``dec_<i>`` with ``w_q``/``w_k``/``w_v``/
``fc``/``attn_norm``/``conv1``/``conv2``/``ffn_norm``, ``variance_adaptor``
with ``duration_predictor``/``pitch_predictor``/``energy_predictor``
holding ``conv1``/``ln1``/``conv2``/``ln2``/``linear``, ``pitch_embedding``,
``energy_embedding``, ``mel_linear``), so ``convert.convert_params``
carries a JAX checkpoint across; :class:`FastSpeech2WithLoss` keeps the
model under ``model``, as the JAX module's scope does.

As in the JAX model:

- attention scores of padded keys are replaced by ``-1e9`` (not ``-inf``),
  so a row with no valid key (``mel_len = 0`` from a collapsed duration
  predictor) gets a uniform softmax and finite values; padded query rows
  attend to every valid key and are zeroed after each norm;
- LayerNorm's epsilon is flax's 1e-6;
- the variance predictors' dropout is 0.5 whatever the model's rate;
- the bucket edges are float32 ``jnp.linspace(lo, hi, 255)`` to the bit
  (:func:`jax_linspace`), and a value takes bucket ``#{edges < value}``;
- predicted durations are ``round((exp(log_d) - 1) * d_control)`` in float32,
  half to even, floored at 0 and zeroed on padding;
- the pitch embedding is added before the energy predictor runs;
- ``src_embed`` and the pitch and energy embeddings are N(0, 1), denses and
  convolutions flax's lecun-normal with zero biases (:meth:`reset_parameters`).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from .. import resolve_device
from ..loss.fastspeech2_loss import fastspeech2_loss
from ..utils.mask import make_non_pad_mask
from .layers import LN_EPS, FastDropout, _score_scale, _split_heads, apply_mask, \
    lecun_normal_, sinusoid_table

__all__ = ["FFTBlock", "VariancePredictor", "LengthRegulator", "VarianceAdaptor",
           "FastSpeech2", "FastSpeech2WithLoss", "jax_linspace"]

N_BINS = 256
PITCH_RANGE = (-2.917, 11.391)  # LJSpeech statistics of log1p(f0 Hz), as the JAX model's
ENERGY_RANGE = (-1.431, 8.184)


def jax_linspace(lo, hi, num):
    """``jnp.linspace(lo, hi, num)`` in float32, bit for bit, as JAX computes
    it on the CPU outside a jit: XLA rewrites ``i / (num - 1)`` into
    ``i * c`` with ``c = 1 / (num - 1)`` rounded to float32 and forms
    ``start * (1 - i c) + i (stop c)`` with the last product fused into a
    multiply-add (emulated in float64, where the float32 product is exact).
    ``torch.linspace`` rounds differently at about half of the 255 edges,
    and so does JAX inside a jit, where the same formula is folded without
    the fused multiply-add: the JAX recipe trains, scores and serves under
    jit, so its edges are those, one ulp of the range's largest magnitude
    from these at 89 of the 255 pitch edges and 85 of the energy edges.
    The eager bits are the ones pinned here, as ``np.asarray(jnp.linspace(
    ...))`` gives them."""
    f32 = np.float32
    i = np.arange(num - 1, dtype=f32)
    c = f32(1) / f32(num - 1)
    start, stop = f32(lo), f32(hi)
    head = i.astype(np.float64) * np.float64(stop * c) + (start * (f32(1) - i * c)).astype(
        np.float64)
    return np.append(head.astype(f32), stop)


def _conv(x, conv):
    """``conv`` (a channels-first ``Conv1d``) over channels-last ``x``."""
    return conv(x.transpose(1, 2)).transpose(1, 2)


class FFTBlock(nn.Module):
    """Multi-head self-attention and a conv feed-forward (kernels 9 and 1),
    each with a post-norm residual; padded rows are zeroed after each norm.
    ``mask`` is ``(B, T)``, True = valid."""

    def __init__(self, d_model, head_num, conv_filter, conv_kernels=(9, 1), dropout_rate=0.1):
        super().__init__()
        self.head_num = head_num
        self.w_q = nn.Linear(d_model, d_model)
        self.w_k = nn.Linear(d_model, d_model)
        self.w_v = nn.Linear(d_model, d_model)
        self.fc = nn.Linear(d_model, d_model)
        self.attn_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        k1, k2 = conv_kernels
        self.conv1 = nn.Conv1d(d_model, conv_filter, k1, padding=k1 // 2)
        self.conv2 = nn.Conv1d(conv_filter, d_model, k2, padding=k2 // 2)
        self.ffn_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.attn_dropout = FastDropout(dropout_rate)
        self.fc_dropout = FastDropout(dropout_rate)
        self.ffn_dropout = FastDropout(dropout_rate)

    def forward(self, x, mask=None):
        q, k, v = (_split_heads(f(x), self.head_num) for f in (self.w_q, self.w_k, self.w_v))
        scores = (q @ k.transpose(-2, -1)) / _score_scale(q.shape[-1], q.dtype)
        if mask is not None:
            scores = apply_mask(scores, mask[:, None, None, :])
        attn = self.attn_dropout(torch.softmax(scores, dim=-1))
        y = (attn @ v).transpose(1, 2).reshape(x.shape)
        x = self.attn_norm(x + self.fc_dropout(self.fc(y)))
        if mask is not None:
            x = torch.where(mask[..., None], x, 0.0)

        y = _conv(F.relu(_conv(x, self.conv1)), self.conv2)
        x = self.ffn_norm(x + self.ffn_dropout(y))
        if mask is not None:
            x = torch.where(mask[..., None], x, 0.0)
        return x


class VariancePredictor(nn.Module):
    """Two (conv → ReLU → LayerNorm → dropout) stages and a scalar head,
    ``(B, L, D) -> (B, L)``, zero where ``mask`` is False."""

    def __init__(self, d_in, filter_size=256, kernel_size=3, dropout_rate=0.5):
        super().__init__()
        self.conv1 = nn.Conv1d(d_in, filter_size, kernel_size, padding=kernel_size // 2)
        self.ln1 = nn.LayerNorm(filter_size, eps=LN_EPS)
        self.conv2 = nn.Conv1d(filter_size, filter_size, kernel_size, padding=kernel_size // 2)
        self.ln2 = nn.LayerNorm(filter_size, eps=LN_EPS)
        self.linear = nn.Linear(filter_size, 1)
        self.dropout1 = FastDropout(dropout_rate)
        self.dropout2 = FastDropout(dropout_rate)

    def forward(self, x, mask=None):
        y = self.dropout1(self.ln1(F.relu(_conv(x, self.conv1))))
        y = self.dropout2(self.ln2(F.relu(_conv(y, self.conv2))))
        y = self.linear(y)[..., 0]
        return y if mask is None else torch.where(mask, y, 0.0)


class LengthRegulator(nn.Module):
    """Expand phoneme features by their durations on the device: output
    frame ``t`` takes phoneme ``#{i : cumsum(dur)[i] <= t}`` (a sorted
    search, so durations must not be negative), clamped to the last one;
    frames at or after the total are zeroed. ``forward(x (B, L, D),
    durations (B, L), max_len)`` returns ``(expanded (B, max_len, D),
    mel_len (B,) = min(total, max_len))``."""

    def forward(self, x, durations, max_len):
        cum = torch.cumsum(durations.long(), dim=-1)
        total = cum[:, -1]
        frames = torch.arange(max_len, device=x.device).expand(x.shape[0], max_len)
        idx = torch.searchsorted(cum, frames.contiguous(), right=True).clamp_max(x.shape[1] - 1)
        expanded = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
        valid = frames < total[:, None]
        return torch.where(valid[..., None], expanded, 0.0), torch.clamp_max(total, max_len)


class VarianceAdaptor(nn.Module):
    """Duration, pitch and energy prediction with bucketized pitch and
    energy embeddings (phoneme-level features), then the length regulator.
    ``forward`` returns ``(x (B, max_mel_len, D), log_d_pred, p_pred, e_pred,
    mel_len)``; a target given replaces its prediction downstream."""

    def __init__(self, d_model=256, n_bins=N_BINS, pitch_range=PITCH_RANGE,
                 energy_range=ENERGY_RANGE):
        super().__init__()
        self.duration_predictor = VariancePredictor(d_model)
        self.pitch_predictor = VariancePredictor(d_model)
        self.energy_predictor = VariancePredictor(d_model)
        self.length_regulator = LengthRegulator()
        self.pitch_embedding = nn.Embedding(n_bins, d_model)
        self.energy_embedding = nn.Embedding(n_bins, d_model)
        self.register_buffer("pitch_bins", torch.from_numpy(
            jax_linspace(*pitch_range, n_bins - 1)), persistent=False)
        self.register_buffer("energy_bins", torch.from_numpy(
            jax_linspace(*energy_range, n_bins - 1)), persistent=False)

    @staticmethod
    def bucketize(values, bins):
        """``#{bins < value}`` for each value (a value on an edge stays
        below it)."""
        return torch.bucketize(values.contiguous(), bins, right=False)

    def forward(self, x, src_mask, max_mel_len, pitch_target=None, energy_target=None,
                duration_target=None, p_control=1.0, e_control=1.0, d_control=1.0):
        log_d_pred = self.duration_predictor(x, src_mask)
        p_pred = self.pitch_predictor(x, src_mask)
        pitch = pitch_target if pitch_target is not None else p_pred * p_control
        x = x + self.pitch_embedding(self.bucketize(pitch, self.pitch_bins))
        e_pred = self.energy_predictor(x, src_mask)
        energy = energy_target if energy_target is not None else e_pred * e_control
        x = x + self.energy_embedding(self.bucketize(energy, self.energy_bins))

        if duration_target is not None:
            dur = duration_target
        else:
            dur = torch.round((torch.exp(log_d_pred) - 1.0) * d_control)
            dur = torch.where(src_mask, torch.clamp_min(dur, 0.0).long(), 0)
        x, mel_len = self.length_regulator(x, dur, max_mel_len)
        return x, log_d_pred, p_pred, e_pred, mel_len


class FastSpeech2(nn.Module):
    """FFT encoder → variance adaptor → FFT decoder → mel head.

    ``forward(phonemes (B, L), src_lens (B,), max_mel_len, ...)`` returns
    ``(mel (B, max_mel_len, n_mels), log_d_pred, p_pred, e_pred, mel_len,
    mel_mask)``. The sinusoid table of ``max_seq_len`` rows is added to the
    encoder's and the decoder's inputs. Training is ``model.train()`` (the
    JAX ``deterministic=False``) after :meth:`set_dropout_generator`.
    """

    def __init__(self, vocab_size=365, d_model=256, n_mels=80, encoder_layers=4,
                 decoder_layers=6, head_num=2, conv_filter=1024, max_seq_len=2000,
                 dropout_rate=0.1, device="cuda"):
        super().__init__()
        self.encoder_layers, self.decoder_layers = encoder_layers, decoder_layers
        self.src_embed = nn.Embedding(vocab_size, d_model)
        for i in range(encoder_layers):
            self.add_module(f"enc_{i}", FFTBlock(d_model, head_num, conv_filter,
                                                 dropout_rate=dropout_rate))
        self.variance_adaptor = VarianceAdaptor(d_model)
        for i in range(decoder_layers):
            self.add_module(f"dec_{i}", FFTBlock(d_model, head_num, conv_filter,
                                                 dropout_rate=dropout_rate))
        self.mel_linear = nn.Linear(d_model, n_mels)
        self.register_buffer("pos", torch.from_numpy(sinusoid_table(max_seq_len, d_model)),
                             persistent=False)
        self.to(resolve_device(device))

    def blocks(self, prefix):
        n = self.encoder_layers if prefix == "enc" else self.decoder_layers
        return [getattr(self, f"{prefix}_{i}") for i in range(n)]

    @torch.no_grad()
    def reset_parameters(self, generator):
        """Random weights from ``generator`` (on the model's device), drawn
        as flax initializes the JAX model: lecun-normal (truncated) denses
        and convolutions with zero biases, unit LayerNorm scales, N(0, 1)
        embeddings."""
        for module in self.modules():
            if isinstance(module, (nn.Linear, nn.Conv1d)):
                lecun_normal_(module.weight, module.weight[0].numel(), generator)
                module.bias.zero_()
            elif isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
            elif isinstance(module, nn.Embedding):
                module.weight.normal_(0.0, 1.0, generator=generator)
        return self

    def set_dropout_generator(self, generator):
        """Make every dropout of the model draw from ``generator`` (on the
        parameters' device)."""
        for module in self.modules():
            if isinstance(module, FastDropout):
                module.generator = generator
        return self

    def forward(self, phonemes, src_lens, max_mel_len, pitch_target=None, energy_target=None,
                duration_target=None, p_control=1.0, e_control=1.0, d_control=1.0):
        src_mask = make_non_pad_mask(src_lens, phonemes.shape[1])
        x = self.src_embed(phonemes) + self.pos[:phonemes.shape[1]]
        for block in self.blocks("enc"):
            x = block(x, src_mask)

        x, log_d, p_pred, e_pred, mel_len = self.variance_adaptor(
            x, src_mask, max_mel_len, pitch_target=pitch_target, energy_target=energy_target,
            duration_target=duration_target, p_control=p_control, e_control=e_control,
            d_control=d_control)

        mel_mask = make_non_pad_mask(mel_len, max_mel_len)
        x = x + self.pos[:max_mel_len]
        for block in self.blocks("dec"):
            x = block(x, mel_mask)
        return self.mel_linear(x), log_d, p_pred, e_pred, mel_len, mel_mask

    @torch.no_grad()
    def infer(self, phonemes, src_lens, max_mel_len, p_control=1.0, e_control=1.0,
              d_control=1.0):
        """Text-only synthesis: the forward with predicted durations, pitch
        and energy, without dropout whatever the module's mode."""
        was_training = self.training
        self.eval()
        try:
            return self(phonemes, src_lens, max_mel_len, p_control=p_control,
                        e_control=e_control, d_control=d_control)
        finally:
            self.train(was_training)


class FastSpeech2WithLoss(nn.Module):
    """The model and its multi-term loss: ``forward(phonemes, src_lens,
    mel_target, pitch, energy, duration)`` returns ``(total, mel_loss,
    duration_loss, pitch_loss, energy_loss)`` (``loss/fastspeech2_loss``),
    teacher-forced at ``max_mel_len = mel_target.shape[1]``."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, phonemes, src_lens, mel_target, pitch, energy, duration):
        mel, log_d, p_pred, e_pred, _, mel_mask = self.model(
            phonemes, src_lens, mel_target.shape[1], pitch_target=pitch,
            energy_target=energy, duration_target=duration)
        src_mask = make_non_pad_mask(src_lens, phonemes.shape[1])
        return fastspeech2_loss(mel, mel_target, log_d, duration, p_pred, pitch, e_pred, energy,
                                src_mask, mel_mask)
