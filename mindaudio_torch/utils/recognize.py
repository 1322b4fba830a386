"""ASR decode drivers: CTC greedy / CTC prefix beam / attention beam /
attention rescoring (port of ``mindaudio_tpu.utils.recognize``).

The encoder, the per-frame top-k, the attention beam step, rescoring and
the streaming chunk step run on the model's device; the CTC prefix-beam
dynamic program runs on the host over the device's top-k, in C++
(``_native.ctc_prefix_beam_batch``, one thread per utterance).
:func:`ctc_prefix_beam_dp` is its plain Python version, which the tests hold
it against. The module-level functions at the end keep the reference's calling
convention (the model passed on every call).
"""

from __future__ import annotations

import copy
from collections import defaultdict
from typing import List, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from .. import _native
from ..ops.quant import quantize_dense_params, swap_quantized
from .common import add_sos_eos, log_add, pad_sequence, remove_duplicates_and_blank

__all__ = ["ASRInference", "ctc_prefix_beam_dp", "ctc_greedy_search",
           "ctc_prefix_beam_search", "recognize", "attention_rescoring"]

NEG_INF = -1.0e9


def ctc_prefix_beam_dp(
    top_k_logp: np.ndarray,
    top_k_index: np.ndarray,
    n_valid: int,
    beam_size: int,
    blank_id: int = 0,
) -> List[Tuple[Tuple[int, ...], float]]:
    """Host CTC prefix beam search over per-frame top-k posteriors.

    Args:
        top_k_logp/top_k_index: ``(T, K)`` per-frame top-k log-probs and ids.
        n_valid: number of valid frames.
        beam_size: prefixes kept per step.

    Returns:
        list of ``(prefix_tuple, log_prob)`` sorted best-first.
    """
    cur_hyps: List[Tuple[Tuple[int, ...], Tuple[float, float]]] = [
        (tuple(), (0.0, -float("inf")))
    ]
    for t in range(int(n_valid)):
        next_hyps = defaultdict(lambda: (-float("inf"), -float("inf")))
        for ps, s in zip(top_k_logp[t].tolist(), top_k_index[t].tolist()):
            s = int(s)
            for prefix, (pb, pnb) in cur_hyps:
                last = prefix[-1] if prefix else None
                if s == blank_id:
                    n_pb, n_pnb = next_hyps[prefix]
                    next_hyps[prefix] = (log_add([n_pb, pb + ps, pnb + ps]), n_pnb)
                elif s == last:
                    # *ss -> *s (repeat merged into the non-blank path)
                    n_pb, n_pnb = next_hyps[prefix]
                    next_hyps[prefix] = (n_pb, log_add([n_pnb, pnb + ps]))
                    # *s-s -> *ss (blank separated the repeat)
                    n_prefix = prefix + (s,)
                    n_pb, n_pnb = next_hyps[n_prefix]
                    next_hyps[n_prefix] = (n_pb, log_add([n_pnb, pb + ps]))
                else:
                    n_prefix = prefix + (s,)
                    n_pb, n_pnb = next_hyps[n_prefix]
                    next_hyps[n_prefix] = (n_pb, log_add([n_pnb, pb + ps, pnb + ps]))
        cur_hyps = sorted(
            next_hyps.items(), key=lambda x: log_add(list(x[1])), reverse=True
        )[:beam_size]
    return [(p, log_add(list(v))) for p, v in cur_hyps]


def _check_batch_1(feats, batch_method):
    if feats.shape[0] != 1:
        raise ValueError(f"batch of {feats.shape[0]}: use {batch_method} for B > 1")


class ASRInference:
    """Decode front-ends over a hybrid ASR model (``models.asr_model.ASRModel``).

    Runs on the model's device. ``weight_quant="int8"`` serves every Linear
    with at least ``weight_quant_min_size`` weights from int8 tables through
    the int8 GEMM kernel (quantized from the weights as given); ``dtype``
    (e.g. ``torch.bfloat16``) then casts the remaining parameters to the
    compute dtype. Either option works on a private copy of the model; the
    caller's model is left as it was.
    """

    def __init__(self, model, beam_size=10, ctc_weight=0.3, max_tgt_len=50,
                 blank_id=0, sos=None, eos=None, weight_quant="none",
                 weight_quant_min_size=65536, dtype=None):
        if weight_quant not in ("none", "int8"):
            raise ValueError(f"unknown weight_quant {weight_quant!r}")
        if weight_quant == "int8" or dtype is not None:
            model = copy.deepcopy(model)
        if weight_quant == "int8":
            swap_quantized(model, quantize_dense_params(model, weight_quant_min_size))
        if dtype is not None:
            for p in model.parameters():
                p.data = p.data.to(dtype)
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.beam_size = beam_size
        self.ctc_weight = ctc_weight
        self.max_tgt_len = max_tgt_len
        self.blank_id = blank_id
        self.sos = model.vocab_size - 1 if sos is None else sos
        self.eos = model.vocab_size - 1 if eos is None else eos

    # ---- device programs ----

    def _encode(self, feats, feat_lens):
        feats = torch.as_tensor(feats, dtype=torch.float32, device=self.device)
        feat_lens = torch.as_tensor(feat_lens, dtype=torch.long, device=self.device)
        enc_out, enc_mask = self.model.encode(feats, feat_lens)
        return enc_out, enc_mask, self.model.ctc_log_probs(enc_out)

    def _beam_search(self, enc_out, enc_mask):
        """Attention beam search for every utterance of the batch at once:
        ``B * beam`` hypotheses go through the decoder together; each
        utterance's bookkeeping is the JAX per-utterance loop's. Stops early
        once every hypothesis has ended (later steps only append eos)."""
        b, beam, maxlen = enc_out.shape[0], self.beam_size, self.max_tgt_len
        vocab, eos, dev = self.model.vocab_size, self.eos, self.device
        memory = enc_out.repeat_interleave(beam, dim=0)
        mem_mask = enc_mask.repeat_interleave(beam, dim=0)

        hyps = torch.full((b, beam, maxlen + 1), eos, dtype=torch.long, device=dev)
        hyps[:, :, 0] = self.sos
        scores = torch.full((b, beam), NEG_INF, dtype=torch.float32, device=dev)
        scores[:, 0] = 0.0
        end_flag = torch.zeros((b, beam), dtype=torch.bool, device=dev)
        eos_only = torch.full((vocab,), NEG_INF, dtype=torch.float32, device=dev)
        eos_only[eos] = 0.0

        for i in range(maxlen):
            # logits at position i predict token i+1; later positions are
            # masked out of position i's attention, so the prefix suffices
            ys = hyps[:, :, : i + 1].reshape(b * beam, i + 1)
            lens = torch.full((b * beam,), i + 1, dtype=torch.long, device=dev)
            logits = self.model.decoder_logits(memory, mem_mask, ys, lens)
            step_logp = F.log_softmax(logits[:, i].float(), dim=-1).view(b, beam, vocab)
            step_logp = torch.where(end_flag[..., None], eos_only, step_logp)

            top_logp, top_idx = step_logp.topk(beam, dim=-1)  # (B, beam, beam)
            cand = (scores[..., None] + top_logp).view(b, beam * beam)
            scores, best_flat = cand.topk(beam, dim=-1)
            src_beam = best_flat // beam
            tokens = top_idx.view(b, beam * beam).gather(1, best_flat)
            hyps = hyps.gather(1, src_beam[..., None].expand(-1, -1, maxlen + 1))
            hyps[:, :, i + 1] = tokens
            end_flag = end_flag.gather(1, src_beam) | (tokens == eos)
            if bool(end_flag.all()):
                break
        best = scores.argmax(dim=-1)
        rows = torch.arange(b, device=dev)
        return hyps[rows, best], scores[rows, best]

    def _rescore(self, enc_out, enc_mask, hyps_in, hyps_out, hyps_lens):
        """One decoder pass over ``B * beam`` hypotheses (grouped per
        utterance); returns each one's attention log-prob
        ``sum_j logp[j, hyps_out[j]]`` over its first ``hyps_lens`` positions,
        scored on the device."""
        beam = hyps_in.shape[0] // enc_out.shape[0]
        memory = enc_out.repeat_interleave(beam, dim=0)
        mem_mask = enc_mask.repeat_interleave(beam, dim=0)
        logits = self.model.decoder_logits(memory, mem_mask, hyps_in, hyps_lens)
        logp = F.log_softmax(logits.float(), dim=-1)
        tok_lp = logp.gather(-1, hyps_out[..., None])[..., 0]
        pos = torch.arange(hyps_in.shape[1], device=self.device)[None, :]
        return torch.where(pos < hyps_lens[:, None], tok_lp, 0.0).sum(-1)

    # ---- host drivers ----

    @torch.inference_mode()
    def ctc_greedy_search(self, feats, feat_lens):
        """Best CTC path per utterance, repeats and blanks collapsed.
        Returns ``(hyps, scores)``."""
        _, enc_mask, log_probs = self._encode(feats, feat_lens)
        best_p, best = log_probs.max(dim=-1)
        valid = enc_mask[:, 0, :]
        best = torch.where(valid, best, self.blank_id).cpu().numpy()
        score = (best_p * valid).sum(-1).cpu().numpy()
        valid = valid.cpu().numpy()
        hyps = [remove_duplicates_and_blank(row[v].tolist(), self.blank_id)
                for row, v in zip(best, valid)]
        return hyps, score

    @torch.inference_mode()
    def ctc_prefix_beam_search_batch(self, feats, feat_lens):
        """One encoder + top-k pass for the batch, then the native host DP
        (one thread per utterance). Returns ``(batch_hyps, enc_out,
        enc_mask)`` with ``batch_hyps[b]`` the best-first ``[(prefix,
        log_prob), ...]``."""
        enc_out, enc_mask, log_probs = self._encode(feats, feat_lens)
        top_logp, top_idx = log_probs.topk(self.beam_size, dim=-1)
        valid = enc_mask[:, 0, :].sum(-1).cpu().numpy()
        batch_hyps = _native.ctc_prefix_beam_batch(
            top_logp.cpu().numpy(), top_idx.cpu().numpy(), valid, self.beam_size,
            self.blank_id)
        return batch_hyps, enc_out, enc_mask

    def ctc_prefix_beam_search(self, feats, feat_lens):
        """Batch-1 prefix beam search: ``(hyps, enc_out, enc_mask)``."""
        _check_batch_1(feats, "ctc_prefix_beam_search_batch")
        batch_hyps, enc_out, enc_mask = self.ctc_prefix_beam_search_batch(
            feats, feat_lens)
        return batch_hyps[0], enc_out, enc_mask

    def _hyp_to_tokens(self, hyp):
        out = []
        for tok in hyp[1:].tolist():  # drop sos
            if tok == self.eos:
                break
            out.append(int(tok))
        return out

    @torch.inference_mode()
    def recognize_batch(self, feats, feat_lens):
        """Attention beam search; returns ``[(tokens, score), ...]``."""
        enc_out, enc_mask, _ = self._encode(feats, feat_lens)
        hyps, scores = self._beam_search(enc_out, enc_mask)
        hyps, scores = hyps.cpu().numpy(), scores.cpu().numpy()
        return [(self._hyp_to_tokens(h), float(s)) for h, s in zip(hyps, scores)]

    def recognize(self, feats, feat_lens):
        """Batch-1 attention beam search; returns ``(tokens, score)``."""
        _check_batch_1(feats, "recognize_batch")
        return self.recognize_batch(feats, feat_lens)[0]

    @torch.inference_mode()
    def streaming_ctc_greedy(self, feat_chunks, required_cache_size=-1):
        """Streaming CTC greedy over an iterable of raw-feature chunks, one
        utterance: each chunk is ``(1, 4*C + 3, F)`` frames, stepping ``4*C``
        (``models.conformer.ConformerEncoder.forward_chunk``). Tokens of a
        chunk are final once it is processed. The model must be built with
        ``causal_conv=True``.

        ``required_cache_size`` caps the attention left context (subsampled
        frames; 0 keeps none). The default ``-1`` keeps the whole history:
        exact, equal to the chunk-masked full encode, but the cache and the
        cost of a chunk grow with every chunk; long streams pass a cap.

        Returns the collapsed token list.
        """
        att_caches = cnn_caches = None
        hyp: List[int] = []
        prev = self.blank_id
        for chunk in feat_chunks:
            chunk = torch.as_tensor(chunk, dtype=torch.float32, device=self.device)
            log_probs, att_caches, cnn_caches = self.model.encode_chunk(
                chunk, att_caches, cnn_caches, required_cache_size)
            for tok in log_probs[0].argmax(-1).tolist():
                if tok != prev and tok != self.blank_id:
                    hyp.append(tok)
                prev = tok
        return hyp

    @torch.inference_mode()
    def attention_rescoring_batch(self, feats, feat_lens):
        """Prefix-beam candidates for the batch, ONE decoder pass over all
        ``B * beam`` hypotheses, best per utterance by
        ``attention + ctc_weight * ctc``. Returns ``[(tokens, score), ...]``."""
        batch_hyps, enc_out, enc_mask = self.ctc_prefix_beam_search_batch(
            feats, feat_lens)
        max_tgt, beam = self.max_tgt_len, self.beam_size
        # truncate CTC prefixes to max_tgt_len and pad each utterance's list
        # to exactly `beam` rows (the DP can return fewer)
        batch_hyps = [
            ([(h[:max_tgt], s) for h, s in hyps]
             + [((), -float("inf"))] * (beam - len(hyps)))[:beam]
            for hyps in batch_hyps
        ]
        flat = [h for hyps in batch_hyps for h in hyps]
        hyps_lens = np.array([len(h[0]) for h in flat], np.int64)
        padded = pad_sequence([np.array(h[0], np.int64) for h in flat],
                              padding_value=-1, max_len=max_tgt)
        hyps_in, hyps_out = add_sos_eos(padded, self.sos, self.eos)
        hyps_out = np.where(hyps_out < 0, 0, hyps_out)  # pads → safe gather
        att_scores = self._rescore(
            enc_out, enc_mask,
            torch.as_tensor(hyps_in, device=self.device),
            torch.as_tensor(hyps_out, device=self.device),
            torch.as_tensor(hyps_lens + 1, device=self.device),
        ).cpu().numpy()

        results = []
        for b, hyps in enumerate(batch_hyps):
            best_score, best_index = -float("inf"), 0
            for i, (prefix, ctc_score) in enumerate(hyps):
                score = float(att_scores[b * beam + i]) + ctc_score * self.ctc_weight
                if score > best_score:
                    best_score, best_index = score, i
            results.append((list(hyps[best_index][0]), float(best_score)))
        return results

    def attention_rescoring(self, feats, feat_lens):
        """Batch-1 attention rescoring: ``(tokens, score)``."""
        _check_batch_1(feats, "attention_rescoring_batch")
        return self.attention_rescoring_batch(feats, feat_lens)[0]


# ---- reference-name module-level decode functions ----
#
# The reference passes the model to a free function on every call. Each
# (model, options) pair gets one ASRInference, kept in a small LRU, so that a
# decode loop over one model builds (and, for int8, quantizes) it once. The
# entry holds the model itself, so its id cannot be reused while cached, and
# the weights' fingerprint: an instance that decodes a private copy (int8 or
# another dtype) is built anew once the caller changes a weight in place
# (``load_state_dict``, an optimizer step) or replaces it.

_INFERENCE_LRU_MAX = 8
_inference_cache: dict = {}


def _weights_fingerprint(model):
    """Each parameter's and buffer's storage address and version counter,
    which every in-place change advances."""
    return tuple((t.data_ptr(), 0 if t.is_inference() else t._version)
                 for t in (*model.parameters(), *model.buffers()))


def _cached_inference(model, **opts):
    key = (id(model), tuple(sorted(opts.items())))
    fingerprint = _weights_fingerprint(model)
    entry = _inference_cache.pop(key, None)
    if entry is None or entry[1] != fingerprint:
        entry = (model, fingerprint, ASRInference(model, **opts))
    _inference_cache[key] = entry  # re-inserted: the most recently used
    while len(_inference_cache) > _INFERENCE_LRU_MAX:
        _inference_cache.pop(next(iter(_inference_cache)))
    return entry[2]


def ctc_greedy_search(model, feats, feat_lens, **opts):
    """:meth:`ASRInference.ctc_greedy_search` of a cached instance."""
    return _cached_inference(model, **opts).ctc_greedy_search(feats, feat_lens)


def ctc_prefix_beam_search(model, feats, feat_lens, beam_size=10, **opts):
    """Prefix beam search; batch 1 as :meth:`ASRInference.ctc_prefix_beam_search`,
    a larger batch as ``ctc_prefix_beam_search_batch``."""
    inf = _cached_inference(model, beam_size=beam_size, **opts)
    if feats.shape[0] == 1:
        return inf.ctc_prefix_beam_search(feats, feat_lens)
    return inf.ctc_prefix_beam_search_batch(feats, feat_lens)


def recognize(model, feats, feat_lens, beam_size=10, **opts):
    """Attention beam search; batch 1 as :meth:`ASRInference.recognize`, a
    larger batch as ``recognize_batch``."""
    inf = _cached_inference(model, beam_size=beam_size, **opts)
    if feats.shape[0] == 1:
        return inf.recognize(feats, feat_lens)
    return inf.recognize_batch(feats, feat_lens)


def attention_rescoring(model, feats, feat_lens, beam_size=10, ctc_weight=0.3, **opts):
    """CTC prefix beam and decoder rescoring; batch 1 as
    :meth:`ASRInference.attention_rescoring`, a larger batch as
    ``attention_rescoring_batch``."""
    inf = _cached_inference(model, beam_size=beam_size, ctc_weight=ctc_weight, **opts)
    if feats.shape[0] == 1:
        return inf.attention_rescoring(feats, feat_lens)
    return inf.attention_rescoring_batch(feats, feat_lens)
