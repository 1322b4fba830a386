"""Conformer AISHELL-1 decoding and CER on one NVIDIA GPU (port of
``examples/conformer/predict.py``).

Loads the latest checkpoint, or the average of the ``decode.average_num``
best by dev loss (the last N when training recorded no scores), decodes the
test manifest in batches of ``decode.batch_size`` utterances grouped by
length bucket with one of ``ctc_greedy``, ``ctc_prefix_beam``, ``attention``
or ``attention_rescoring`` (or, with ``streaming``, one utterance at a time in
chunks of ``decode.chunk_size`` subsampled frames with the attention cache
capped at ``decode.streaming_cache_size``; the model needs ``causal_conv``),
writes ``<utt> <hypothesis>`` lines to the result file and returns the CER.

Usage::

    python -m mindaudio_torch.recipes.conformer.predict --config conformer.yaml \\
        [--device cuda] [--decode.mode ctc_greedy] [--decode.average_num 5]
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ...data import io
from ...data.processing import resample
from ...metric.wer import cer
from ...ops.spectral import kaldi_fbank
from ...train.checkpoint import average_checkpoints, list_steps, load_scores, restore_checkpoint
from ...utils.recognize import ASRInference
from ...utils.tokenizer import CharTokenizer
from .dataset import FRAME_LEN, FRAME_SHIFT, SAMPLE_RATE, BucketSampler, read_manifest
from .train import build_model, load_params, parse_args

BUCKET_FRAMES = BucketSampler.DEFAULT_FRAME_BUCKETS
MODES = ("ctc_greedy", "ctc_prefix_beam", "attention", "attention_rescoring", "streaming")


def select_steps(ckpt_dir, avg_n, average_best=True):
    """The checkpoints to average: the ``avg_n`` of lowest recorded dev loss
    still on disk, or the last ``avg_n`` without scores (or with
    ``average_best`` off); the latest alone when ``avg_n <= 1``."""
    on_disk = list_steps(ckpt_dir)
    if avg_n <= 1:
        return on_disk[-1:]
    scores = load_scores(ckpt_dir)
    if average_best and scores:
        ranked = [s for s, _ in sorted(scores.items(), key=lambda kv: kv[1]) if s in on_disk]
        return sorted(ranked[:avg_n])
    return on_disk[-avg_n:]


def load_wav(path):
    """Mono float32 at 16 kHz, as the training collate reads it."""
    x, sr = io.read(path)
    x = np.asarray(x, np.float32)
    if x.ndim > 1:
        x = x[:, 0]
    if sr != SAMPLE_RATE:
        x = resample(x, sr, SAMPLE_RATE)
    return x


def stream_chunks(feats, n_frames, chunk_size):
    """The streaming chunks of one utterance's ``(1, T, F)`` features with
    ``n_frames`` valid: ``4*C + 3`` frames stepping ``4*C`` for ``C =
    chunk_size`` subsampled frames, each starting at least 7 frames before
    the end (the last one may be shorter), as the JAX recipe cuts them."""
    step = 4 * chunk_size
    return [feats[:, lo: lo + step + 3] for lo in range(0, max(n_frames - 3, 1), step)
            if lo + 7 <= n_frames]


def main(argv=None):
    cfg, device = parse_args(argv)
    mode = cfg.decode.mode
    if mode not in MODES:
        raise ValueError(f"unknown decode mode {mode}")
    if mode == "streaming" and not cfg.model.get("causal_conv", False):
        raise ValueError("decode.mode streaming needs a model with model.causal_conv true")
    tokenizer = CharTokenizer.from_file(cfg.data.vocab_file)
    model = build_model(cfg, tokenizer.vocab_size, device, training=False)

    ckpt_dir = cfg.train.ckpt_dir
    steps = select_steps(ckpt_dir, int(cfg.decode.average_num),
                         bool(cfg.decode.get("average_best", True)))
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    if len(steps) > 1:
        print(f"averaging checkpoints: {steps}")
        ckpt = average_checkpoints(ckpt_dir, steps)
    else:
        ckpt = restore_checkpoint(ckpt_dir, steps[0])
    load_params(model, ckpt["params"])
    del ckpt

    inference = ASRInference(
        model, beam_size=int(cfg.decode.beam_size), ctc_weight=float(cfg.decode.ctc_weight),
        max_tgt_len=int(cfg.decode.max_tgt_len), sos=tokenizer.sos, eos=tokenizer.eos,
        dtype=torch.bfloat16 if cfg.optim.bf16 else None)

    def fbank(wavs):
        with torch.no_grad():
            return kaldi_fbank(torch.from_numpy(wavs).to(device),
                               num_mel_bins=cfg.features.num_mel_bins,
                               frame_length_ms=cfg.features.frame_length_ms,
                               frame_shift_ms=cfg.features.frame_shift_ms, device=device)

    result_path = str(cfg.decode.get("result_file", "")) or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "result.txt")
    utts = read_manifest(cfg.data.test_csv)

    # utterances grouped into (bucket, batch) groups: one encoder pass per
    # group, and for rescoring one decoder pass over its B * beam hypotheses;
    # streaming decodes one utterance at a time
    decode_bs = 1 if mode == "streaming" else int(cfg.decode.get("batch_size", 16))
    by_bucket = {}
    for u in utts:
        x = load_wav(u.wav)
        n_frames = max(1, 1 + (len(x) - FRAME_LEN) // FRAME_SHIFT)
        for limit in BUCKET_FRAMES:
            if n_frames <= limit:
                break
        if n_frames > limit:
            print(f"WARNING: {u.utt_id} is {n_frames} frames; decoding only the first "
                  f"{limit} (~{limit // 100} s)", file=sys.stderr)
        by_bucket.setdefault(limit, []).append((u, x))

    results = {}
    for limit, items in sorted(by_bucket.items()):
        wav_len = limit * FRAME_SHIFT + FRAME_LEN
        for i in range(0, len(items), decode_bs):
            chunk = items[i:i + decode_bs]
            wavs = np.zeros((len(chunk), wav_len), np.float32)
            lens = np.zeros((len(chunk),), np.int64)
            for j, (_, x) in enumerate(chunk):
                n = min(len(x), wav_len)
                wavs[j, :n] = x[:n]
                lens[j] = n
            feats = fbank(wavs)
            feat_lens = 1 + (lens - FRAME_LEN) // FRAME_SHIFT
            if mode == "ctc_greedy":
                batch_hyps = inference.ctc_greedy_search(feats, feat_lens)[0]
            elif mode == "ctc_prefix_beam":
                bh, _, _ = inference.ctc_prefix_beam_search_batch(feats, feat_lens)
                batch_hyps = [list(h[0][0]) for h in bh]
            elif mode == "attention":
                batch_hyps = [h for h, _ in inference.recognize_batch(feats, feat_lens)]
            elif mode == "attention_rescoring":
                batch_hyps = [h for h, _ in inference.attention_rescoring_batch(feats, feat_lens)]
            else:
                chunks = stream_chunks(feats, int(feat_lens[0]),
                                       int(cfg.decode.get("chunk_size", 16)))
                batch_hyps = [inference.streaming_ctc_greedy(
                    chunks, required_cache_size=int(cfg.decode.get("streaming_cache_size", 128)))]
            for (u, _), hyp_ids in zip(chunk, batch_hyps):
                results[u.utt_id] = hyp_ids

    refs, hyps = [], []
    with open(result_path, "w", encoding="utf-8") as out:
        for u in utts:
            hyp = tokenizer.decode(results[u.utt_id])
            refs.append("".join(u.text.split()))
            hyps.append(hyp)
            out.write(f"{u.utt_id} {hyp}\n")
    score = cer(refs, hyps)
    print(f"mode={mode} utts={len(refs)} CER={100 * score:.2f}%")
    return score


if __name__ == "__main__":
    main()
