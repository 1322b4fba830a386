#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mindaudio_torch``) on one NVIDIA GPU.

Run from the root of the repository, with no arguments::

    python3 chip_smoke.py

(``python3 chip_smoke.py --profile-train`` instead profiles a few train steps
with ``torch.profiler`` and prints the device's busy share and the kernels by
device time; ``--profile-separation`` does the same for the Conv-TasNet and
TasNet steps of phase 13, ``--profile-tts`` for the FastSpeech2 step of
phase 14, ``--profile-vocoder`` for the WaveGrad step of phase 15 with
cuDNN's TF32 off and on; none of them checks anything.)

Phases, each of which fails the run (non-zero exit) when it does not hold:

1. the card's name and power limit, from ``nvidia-smi``;
2. build every CUDA kernel under ``mindaudio_torch/ops/csrc/`` with ``nvcc``
   for ``sm_90a`` (one process per source, all at once);
3. hold the int8 weight-only GEMM against its plain PyTorch version at every
   ``(M, K, N)`` the serving path launches, in bf16 and f32, plus a ragged
   shape; time kernel (and, where K is split, its sum pass), plain version,
   ``torch.matmul`` (the yardstick, never called by the port) and the bound,
   beside the first int8 kernel's time from ``FIRST_INT8_MS``; then the edge
   cases (M 1/63/65/1001, K 200/4864, N 8/4233/2048, x views off 16-byte
   alignment), untimed; split-K shapes run twice and must be bit-identical;
4. serve the flagship Conformer at full width (``conformer.yaml``: 80 mel
   bins, d_model 256, 4 heads, FFN 2048, 12 encoder and 6 decoder layers,
   kernel 15, vocab 4233; random weights from a seeded ``torch.Generator``)
   with int8 weights and bf16 compute: 16 synthetic 10 s waveforms through
   ``kaldi_fbank``, ``ctc_greedy_search`` and ``attention_rescoring_batch``
   (beam 10, 50 tokens). The launch count of the int8 kernel in that run
   must equal the count of quantized layers on the path, and that of its
   split-K sum pass the count of those whose K is split. The native
   prefix-beam DP that rescoring runs (``mindaudio_torch/_native``, built
   with ``g++``) is held against the Python DP and both are timed, on the
   served batch's own top-k and on the float32 model's: every row must be
   equal (prefixes, and scores within 1e-4), rows whose top-k holds an exact
   tie (bf16 logits) included and counted. Then one request (B=1, float32
   model) is held against the same weights on the CPU through the plain
   versions;
5. run the CTC chain-latency ladder (``csrc/ctc_probe.cu``: the least
   latency of one dependent step of the recursion, then what shared memory
   and a barrier, a log-prob load one step ahead and a store of the row each
   add; and, at DeepSpeech2's (64, 626, 701), the band path's step: 11 warps
   a sequence passing edge states through a ring), one line per rung; then
   hold the CTC forward and backward kernels
   against the plain PyTorch recursion, in value and in gradient at
   ``logp_ext`` and at the logits, at the flagship train shape, the recipe's
   longest labels, the long bucket and the edge cases (ragged lengths with
   repeated labels, an empty label, ``T = 2L+1``, full length, blank as the
   last class, one frame, S = 63/65/127/129 at the lane and register edges,
   S = 255/257 at the one-warp path's end, the band path's edges (S = 319,
   321, 767, 769 and 1023, where its warps change), S = 1025, 1201 and
   12001 on the block path, rows that cannot be aligned (a loss near 1e5)
   on every path, B = 5, T not a multiple of the chunk and shorter than one,
   a zero length beside a full one, both at S = 701 too, lengths that differ
   per row) and DeepSpeech2's train shapes on the band path (B = 64, S = 701,
   T' = 626 and 1001, ragged lengths, 80-350 labels), printing each case's
   launch plan; time forward and backward at the train shapes (the
   Conformer's three and DeepSpeech2's two), the plain version and
   ``F.ctc_loss``'s device time (the yardstick, never called by the port),
   beside the byte bound and the chain floor (the longest length times the
   ladder's least measured step latency, rung (a); for the band path also
   times rung (e), its own step at S = 701) and, for DeepSpeech2's shapes,
   the first design's block kernels, held against the plain version and
   timed on the same inputs in this run (PR 8's reading of them,
   ``BLOCK_PATH_MS``, logged beside);
6. hold the fused log-mel kernel (three TF32 tensor-core passes) against its
   plain version at both precisions: at the bench shape ``(128, 160000)``,
   at the FastSpeech2 and WaveGrad front ends at ``(16, 220500)`` (the
   kernel at their shapes; the FastSpeech2 recipe of phase 14 does not use
   this entry point: its mels are host NumPy, as in JAX), at
   ``(3, 16037)`` with 40 mels, with ``kaldi=True`` and with
   ``center=False``, with hop 100 and a hamming window, and on a signal
   shorter than a frame; time the kernel and the plain version in turns
   (plain, kernel, kernel, plain) at the first three, beside the bound of
   three TF32 passes (and, printed only, the float32 CUDA-core and one-pass
   TF32 bounds), and hold both against float64 on four rows of the bench
   shape; then drive the log-mel entry point as the bench does and count
   its launches;
7. train the flagship Conformer at full width and depth as the train bench
   builds the step: B=32, the 1027-frame bucket holding 10 s of seeded noise,
   20 labels, dither, SpecAugment, dropout, bf16 autocast, ``ctc_impl="kernel"``,
   AdamW (bf16 first moment), clip 5.0, one batch repeated. Every loss must be
   finite, the last below the first, the parameters moved, and the CTC
   kernels' launch counts equal to the number of steps; the same step with
   the plain CTC recursion is timed beside it;
8. one deterministic float32 step (B=2) on the card with the CTC kernels
   against the CPU with the plain recursion; and a poisoned batch, which must
   leave parameters, moments and AdamW's count as they were (as optax's
   state stays in the JAX package);
9. the Conformer recipe (``mindaudio_torch/recipes/conformer``) as a user
   runs it, at the full width and depth of ``conformer.yaml``: ``gen`` a
   cipher corpus (256/64/32 utterances) into a temporary directory, CMVN
   stats, ``train.main()`` for 40 steps at B=64 x 227 frames with a dev
   evaluation and a save every 20, then ``main()`` again with
   ``--train.resume true`` for 10 more (it must start at the last saved
   global step with the schedule's learning rate there, and its checkpoint
   must carry that name, step and AdamW count), the best-2 average held
   against the mean of the two files, and ``predict.main()`` with
   ``ctc_greedy`` and ``attention_rescoring``; then 5 steps of the
   streaming-ready model (causal conv, sampled chunk masks) into a
   checkpoint directory of its own, decoded with ``streaming``. Prints ms per
   step (host clock, ten steps ending in the metrics' read-back), the dev
   losses, the CERs (not judged this early) and the bytes of a checkpoint;
   the CTC kernels must have launched once forward and once backward a train
   step and once forward a dev batch in the first two runs;
10. streaming decode: the 16 served utterances through
   ``ASRInference.streaming_ctc_greedy`` on the flagship with a causal conv
   (seeded weights, int8 weights, bf16 compute), in chunks of 16
   subsampled frames (67 raw frames stepping 64, ``predict.stream_chunks``),
   at cache cap 128 and with the whole history. Prints the latency of a
   chunk (median, p90, max; host clock, each ending in the read-back of its
   tokens) and the real-time factor; the int8 kernel must launch 134 times a
   chunk, and every GEMM shape the streams met (M = 16, the last partial
   chunks, ``linear_pos`` at M = cache + chunk) is held against the plain
   version and timed as in phase 3. In float32 the whole-history stream's
   log-probs must agree with the chunk-masked full encode of the same model
   within 1e-4, and with int8 weights under phase 4's rule;
11. the DeepSpeech2 recipe (``mindaudio_torch/recipes/deepspeech2``) as a
   user runs it, at the full width of ``deepspeech2.yaml`` (hidden 1024, 5
   summed-BiLSTM layers, 29 characters, 86.6 M parameters, float32): write a
   synthetic corpus in LibriSpeech's layout (``synthetic.gen``: 64
   utterances in each of the 800, 1250 and 2000-frame buckets, 64 test
   utterances up to the 3500 bucket), ``train.main()`` for 20 steps at B = 64
   with a save every 10, and ``eval.main()`` (CER/WER printed, not judged).
   Every loss must be finite, the last loss in the first step's bucket below
   the first, and the CTC kernels (the band path, S = 701) must launch once
   forward and once backward a step. Prints ms per step at the 1250 bucket
   (host clock, ten steps ending in a read-back) with cuDNN's TF32 off and
   on, the peak memory and the bytes of a checkpoint; then holds one float32
   step at full width (B = 2) on the card against the CPU's plain versions
   from the same weights and AdamW state: loss, gradient norm, each
   parameter's update and the running statistics, against stated
   tolerances or 4x the CPU's own spread, the larger (see 13);
12. the ECAPA-TDNN recipe (``mindaudio_torch/recipes/ecapa_tdnn``) as a user
   runs it, at the full width of ``ecapatdnn.yaml`` (channels 512 x 4 and
   1536, Res2Net scale 8, embedding 192, 6.21 M parameters with 32
   speakers, 31 batch norms, float32): write the convergence corpus
   (``convergence_run.make_corpus``: 32 speakers, 12 train, 2 enrol and 2
   test utterances each, 4-8 s), ``train_speaker_embeddings.main()`` for 20
   steps at B = 192 x 3 s crops with augmentation on and a save at step 20
   (the learning rate peaking at 1e-3 at step 10), then
   ``speaker_verification_cosine.main()`` without and with adaptive s-norm
   (EERs printed, not judged). Every loss must be finite, the last below the
   first, no running statistic NaN, the checkpoint must restore to the
   trained model's embeddings, and none of the port's kernels may launch
   (the path has no TPU kernel: its fbank is plain PyTorch). Prints the
   recipe's ms per step (the host's collate and augmentation in the
   prefetch thread), the host's collate and augmentation ms per batch
   measured apart, ms per step on one batch with cuDNN's TF32 off and on,
   the peak memory, the bytes of a checkpoint and the embedding ms of a 16
   x 8 s bucket batch; then holds one float32 step at full width (B = 2,
   TF32 off) on the card against the CPU (loss, gradient norm, each
   parameter's update, the 62 running statistics, each against a stated
   tolerance or 4x the CPU's own spread, the larger: see 13) and one bucket
   batch's embeddings, against a stated tolerance;
13. the separation recipes (``mindaudio_torch/recipes/conv_tasnet`` and
   ``recipes/tasnet``) as a user runs them, at the full width of their
   YAMLs (Conv-TasNet: N 512, L 16, bottleneck 128, hidden 512, X 8, R 3,
   gLN, ReLU masks, 3,445,808 parameters; TasNet: N 500, L 40, 4 summed
   BiLSTM layers of 500, 16,578,000 parameters; float32): write 32
   training and 8 test mixtures of 4 s at 8 kHz (``convergence_run
   .make_corpus``; LibriMix is not in the repository), then for each model
   ``train.main()`` at B = 16 x 4 s (Conv-TasNet 20 steps, TasNet 10) with
   a save at the last step and ``eval.main()`` on 4 test mixtures (SI-SNRi
   and BSS Eval SDRi printed, not judged). Every loss must be finite and
   one after the first below it, the checkpoint must hold the trained
   parameters, and none of the port's kernels may launch (the JAX models
   run no Pallas kernel). Prints the recipe's ms per step (the collate in
   the prefetch thread), the host's collate apart, ms per step on one batch
   with cuDNN's TF32 off and on, the peak memory, the bytes of a
   checkpoint and the separation latency of one mixture and of a batch of
   16; then holds one float32 step at full width (B = 2 x 4 s, TF32 off)
   on the card against the CPU: the loss within 1e-5 relative and the
   gradient norm within 1e-4, or 4x the CPU's own spread over one-ulp moves
   of the input, the larger; each update within 1e-4 of its leaf's largest
   or 4x that leaf's own spread, the larger;
14. the FastSpeech2 recipe (``mindaudio_torch/recipes/fastspeech2``) as a
   user runs it, at the full width of ``fastspeech2.yaml`` (d_model 256, 2
   heads, FFN 1024 with kernel 9, 4 + 6 FFT blocks, 80 mels, 288 symbols,
   30,279,507 parameters, float32): write 96 utterances in LJSpeech's
   layout at 22.05 kHz (``synthetic.gen``: half with MFA-style TextGrid
   alignments, the rest split evenly; 43-207 phonemes and up to about
   1,100 frames, so the truncation to 160 phonemes and the clamp into
   1000 frames run), ``preprocess.main()`` (YIN pitch, RMS energy, mels
   on the host), ``train.main()`` for 20 steps at B = 32 x 160 x 1000 with
   a save at the last (warm-up 10 steps: the YAML's 1000 would hold the
   learning rate at 2e-5 or less), then ``generate.main()`` for an English
   sentence and for ``--pinyin`` text. Every loss must be finite, the mean
   of the last five below the first five's, the parameters moved (the
   first update moves nothing: the schedule is 0 at step 0), the
   checkpoint restored into a fresh model must give the trained model's
   parameters and output, each mel finite with at most 1000 frames, and
   none of the port's kernels may launch. Prints the recipe's ms per step,
   the host's collate apart, ms per step on one batch with cuDNN's TF32 off
   and on, the peak memory, the bytes of a checkpoint and ``infer``'s
   latency for one sentence and a batch of 16; then holds one float32 step
   at full width (B = 2, dropout off, TF32 off) on the card against the CPU
   under the rule of 13;
15. the WaveGrad recipe (``mindaudio_torch/recipes/wavegrad``) as a user
   runs it, at the full width of ``wavegrad.yaml`` (17,233,217 parameters,
   128 mels, hop 300, float32): write 128 utterances in LJSpeech's layout
   at 22.05 kHz (``fastspeech2.synthetic.gen``), ``preprocess.main()``
   (magnitude mels on the host, dB mapped to [0, 1]), ``train.main()`` for
   20 steps at B = 64 x 30-frame crops with a save at the last (warm-up 10
   steps: the YAML's 1000 would hold the learning rate at 4e-6 or less),
   the checkpoint read back by ``train.load_vocoder``, and
   ``reverse.main(--fast)`` on one utterance's features. Every loss must be
   finite (not judged further: each step's loss follows the one noise
   level its batch draws), the parameters moved, the restored model must
   give the trained model's output, the audio must have the mel's length
   (the samples of a net trained 20 steps may run away: the protocol
   judges quality), the sampler's last 20 steps on the card must agree
   with the CPU's on the same draws within 1e-4, and none of the port's
   kernels may launch. Prints the recipe's ms per step, the host's crops
   apart, ms per step on one batch with cuDNN's TF32 off and on beside the
   bound of the step's convolutions, the peak memory, the bytes of a
   checkpoint, and ``reverse_diffusion``'s time and real-time factor for
   30 frames at B = 1 over the 1000-step and the 6-step schedules and at
   B = 16 over the 6-step one; then holds one float32 step at full width
   (B = 4, TF32 off, the diffusion draws fixed in the batch) on the card
   against the CPU under the rule of 13;
16. the Conformer recipe trained W8A8 with rematerialized encoder blocks
   (``--model.int8_ffn true --model.remat true``) as a user runs it, at the
   full width and depth of ``conformer.yaml`` on phase 9's cipher corpus
   (B = 64 x 227 frames, bf16 autocast): ``train.main()`` for 30 steps with
   a save, ``predict.main()`` with ``ctc_greedy``, the checkpoint loaded
   into the float model unchanged. Every logged loss must be finite and the
   last five's mean below the first five's; the CTC kernels must launch
   once forward and once backward a step (and once forward a dev batch),
   the int8 GEMM and the log-mel never; the W8A8 products (``torch._int_mm``)
   once forward per W8A8 layer a step, the 48 encoder layers' twice (the
   recomputation), two backward products per layer. Then ms a step and the
   peak memory on one batch for int8_ffn off/on x remat off/on (remat must
   lower the peak); remat on against off on the card with dropout on and
   the same seeds, for the flagship's float32 step and a full-width encoder
   with the conv module's batch norm (updates, gradients and running
   statistics within 4x the spread of two remat-off runs); one float32
   remat step (B = 8, dropout off) against the CPU under the rule of 13;
   the W8A8 product at the path's shapes against float64 (exact on the
   int32 accumulators), timed beside ``torch.matmul`` in bf16 and its own
   quantization passes; and ``resample``, ``istft``, ``mfcc`` and
   ``sliding_window_cmn`` on the card against the CPU's float64 at the
   stated tolerances, then with TF32 (reported);
17. the parallel layer (``mindaudio_torch/parallel``) on the one card: the
   Conformer recipe's ``train.main()`` at full width with ZeRO-1 on two
   ranks (global B = 32 x 227 frames, 16 a rank, two steps; both ranks must
   log the same losses), its checkpoint resumed by one process (at the
   global step, AdamW's count two further); then, at two ranks, each layout
   of ``PAR_TWO_RANKS`` (float32, TF32 off, dropout off) held against one
   process on the global batch: data parallel at flagship width on the train
   bench's B = 32 x 10 s, three train steps with ZeRO-1 and three with
   replicated moments (bit for bit under deterministic algorithms, with the
   replicated run twice as the control; half the moment bytes a rank; the
   first update against one process's, stated 1e-2 of a leaf's largest);
   DeepSpeech2 (B = 64 x 400 frames) and ECAPA-TDNN (B = 32 x 3 s) data
   parallel with their batch norms' statistics; and at flagship width on B
   = 8 x 10 s MoE (8 experts, top-2, split over ``model`` with Megatron
   TP), TP = 2, SP = 2 (ring and Ulysses) and PP = 2 (four microbatches),
   one forward and backward each. The loss within 1e-5 relative and each
   gradient leaf (and running statistic) within stated of its largest
   (1e-3; 1e-4; a gradient leaf's largest taken as at least 1e-6 of the
   model's largest gradient, for the leaves whose exact gradient is zero),
   or 4x the step's spread over one-ulp input moves, the larger; the CTC
   pair must launch on every rank (ECAPA-TDNN's path has no
   kernel). Prints ms a step on each rank beside one process's.

   Two ranks share the one card: the machine has one H100, and NCCL refuses
   two ranks on one device, so the ranks run over gloo with CUDA tensors
   (``PAR_BACKEND``; the port's code is backend-agnostic). gloo takes CUDA
   tensors in all_reduce, all_gather, broadcast and all_to_all_single, the
   collectives the layer is written in (it has no point-to-point on CUDA:
   ``collectives.permute`` is an all_to_all_single). A layout listed in
   ``PAR_ONE_RANK`` would run the same code at world size 1 over NCCL. Two
   processes on one card, their collectives copied through the host by
   gloo, measure correctness and the layer's overheads, not a multi-GPU
   speed. The ranks are this script run as ``--parallel-worker``.

The last two lines are a JSON object ``{"kernels": [...]}`` and the result
line ``{"ok": true, "device": {...}}``. Float32 comparisons run with TF32 off
for both matrix products and cuDNN convolutions.
"""

import collections
import copy
import functools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_BF16_FLOP_PER_S = 989e12  # dense bf16 tensor cores, at 700 W
H100_TF32_FLOP_PER_S = 495e12  # dense TF32 tensor cores
H100_F32_FLOP_PER_S = 67e12  # float32 outside the tensor cores
H100_INT8_OP_PER_S = 1979e12  # dense int8 tensor cores

VOCAB, N_MELS, D_MODEL, HEADS, FFN = 4233, 80, 256, 4, 2048
ENC_LAYERS, DEC_LAYERS, CONV_KERNEL = 12, 6, 15
BATCH, BEAM, MAX_TGT = 16, 10, 50
SAMPLE_RATE, SAMPLES = 16000, 164720  # the 10 s bucket: 1028 frames, T' = 256
QUANT_MIN = 65536  # weight_quant_min_size, as the JAX package serves
# the train bench: B=32, 10 s of audio in the 1027-frame bucket (T' = 256)
TRAIN_BATCH, TRAIN_LABELS, TRAIN_SAMPLES, TRAIN_TRUE_SAMPLES = 32, 20, 1027 * 160 + 400, 160000
TRAIN_WARMUP_STEPS, TRAIN_TIMED_STEPS, PLAIN_CTC_STEPS = 2, 10, 5
# the recipe phase: train/dev/test utterances of the cipher corpus, B = 64
RECIPE_UTTS, RECIPE_STEPS, RECIPE_RESUME_STEPS, RECIPE_SAVE_EVERY = (256, 64, 32), 40, 10, 20
RECIPE_STREAM_STEPS = 5  # the causal-conv model that the streaming decode reads
LOGMEL_BATCH, LOGMEL_SAMPLES, LOGMEL_CALLS = 128, 160000, 8  # the log-mel bench shape
# DeepSpeech2 (recipes/deepspeech2/deepspeech2.yaml): B = 64, 29 characters,
# labels padded to 350; phase 11 trains 20 steps on a synthetic corpus of 64
# utterances in each of the 800, 1250 and 2000-frame buckets (3 batches an
# epoch) and decodes 64 test utterances in the 3500 bucket
DS2_BATCH, DS2_VOCAB, DS2_LABELS = 64, 29, 350
DS2_STEPS, DS2_SAVE_EVERY, DS2_TIMED_STEPS = 20, 10, 10
# ECAPA-TDNN (recipes/ecapa_tdnn/ecapatdnn.yaml, full width, 3 s crops):
# phase 12 writes 32 speakers x (12 train + 2 enrol + 2 test) utterances,
# two batches of 192 an epoch, and trains 20 steps with a save at the last
ECAPA_SPEAKERS, ECAPA_TRAIN, ECAPA_EVAL = 32, 12, 2
ECAPA_BATCH, ECAPA_STEPS, ECAPA_TIMED_STEPS, ECAPA_HOST_BATCHES = 192, 20, 10, 3
# Conv-TasNet and TasNet (recipes/conv_tasnet, recipes/tasnet, full width):
# phase 13 writes 32 training mixtures of 4 s (two batches of 16 an epoch)
# and trains Conv-TasNet 20 steps and TasNet 10, each with a save at the last
SEP_BATCH, SEP_SAMPLES, SEP_TRAIN_UTTS = 16, 32000, 32
SEP_CONV_STEPS, SEP_TASNET_STEPS, SEP_TIMED_STEPS, SEP_HOST_BATCHES = 20, 10, 10, 3
# FastSpeech2 (recipes/fastspeech2/fastspeech2.yaml, full width): phase 14
# writes 96 utterances in LJSpeech's layout (three batches of 32 an epoch)
# and trains 20 steps at 160 phonemes x 1000 frames with a save at the last
FS2_UTTS, FS2_BATCH, FS2_PHONEMES, FS2_FRAMES = 96, 32, 160, 1000
FS2_STEPS, FS2_TIMED_STEPS, FS2_HOST_BATCHES, FS2_PARAMS = 20, 10, 3, 30_279_507
FS2_WARMUP = 10  # the YAML's 1000 would hold the learning rate at 2e-5 or less
FS2_TEXT = "Printing, in the only sense with which we are at present concerned, differs " \
           "from most if not from all the arts and crafts represented in the Exhibition."
FS2_PINYIN = "zhong1 guo2 ren2 min2 yin2 hang2 fa1 xing2 de5 ren2 min2 bi4"
# WaveGrad (recipes/wavegrad/wavegrad.yaml, full width): phase 15 writes 128
# utterances in LJSpeech's layout (two batches of 64 an epoch) and trains 20
# steps at B = 64 x 30 frames x hop 300 with a save at the last; one float32
# step at B = 4 against the CPU; the samplers at B = 1 and 16 x 30 frames
WG_UTTS, WG_BATCH, WG_FRAMES, WG_HOP, WG_SR = 128, 64, 30, 300, 22050
WG_STEPS, WG_TIMED_STEPS, WG_HOST_BATCHES, WG_PARAMS = 20, 10, 3, 17_233_217
WG_WARMUP = 10  # the YAML's 1000 would hold the learning rate at 4e-6 or less
WG_CHECK_BATCH, WG_SAMPLE_BATCH = 4, 16
# W8A8 training with rematerialized blocks (phase 16): the recipe's steps on
# phase 9's corpus (one save at the last), and the steps timed on one batch
# for each of the four int8_ffn x remat settings
I8_STEPS, I8_TIMED_STEPS = 30, 10
# the parallel layer (phase 17): two ranks share the one card over gloo,
# which takes CUDA tensors in all_reduce, all_gather, broadcast and
# all_to_all_single (established on the card: it refuses send/recv, and
# collectives.permute is an all_to_all_single for that reason). Every layout
# runs at two ranks; a layout moved to PAR_ONE_RANK would run the same code
# at world size 1 over NCCL (degenerate groups), its two-rank form held by
# the CPU tests alone
PAR_TWO_RANKS = ("data_zero1", "deepspeech2", "ecapa_tdnn", "moe_expert", "tensor",
                 "sequence_ring", "sequence_ulysses", "pipeline")
PAR_ONE_RANK = ()
PAR_NO_KERNEL = ("ecapa_tdnn",)  # no TPU kernel on its path (phase 12)
PAR_BACKEND, PAR_DEVICE = "gloo", "cuda"
PAR_STEPS, PAR_TIMED, PAR_MICRO, PAR_EXPERTS = 3, 2, 4, 8
PAR_BATCH = 8  # the model-parallel layouts' global batch (x 10 s)
PAR_DS2_BATCH, PAR_DS2_FRAMES, PAR_DS2_LABELS = 64, 400, 60
PAR_ECAPA_BATCH = 32
PAR_RECIPE_UTTS, PAR_RECIPE_STEPS = (64, 16, 8), 2
# streaming: conformer.yaml's decode.chunk_size and decode.streaming_cache_size
STREAM_CHUNK, STREAM_CAP = 16, 128
# int8 layers per pass at d_model 256: an encoder block has 11 (two FFNs,
# q/k/v/out/pos, both pointwise convs), a decoder block 10 (two attentions'
# q/k/v/out and the FFN), plus embed.out, ctc_proj and output_layer
ENCODE_LAUNCHES = ENC_LAYERS * 11 + 2
DECODE_LAUNCHES = DEC_LAYERS * 10 + 1


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, iters=20):
    """Device time of one call of ``fn`` in ms: ``iters`` calls captured in a
    CUDA graph and replayed between two CUDA events, so that the host's
    per-call cost (Python, argument checks, the launch) is not counted."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):  # warm-up outside the graph: handles, workspaces
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms_by_name(fn, iters=10, attempts=3):
    """Device time per call of ``fn`` in ms for each CUDA kernel it launches,
    by name: ``torch.profiler`` over ``iters`` eager calls after one warm-up.
    ``fn`` launches at least one kernel, so a capture that holds no device
    event at all is the profiler's failure, not ``fn``'s (CUPTI now and then
    hands back an empty trace): it is logged and the capture is made again,
    up to ``attempts`` times in all, and an error if every one is empty."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out = collections.defaultdict(float)
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                out[e.name] += e.device_time / 1e3 / iters
        if out:
            return out
        log(f"profiler: capture {attempt} of {attempts} holds no device event; "
            + ("capturing again" if attempt < attempts else "giving up"))
    raise AssertionError(f"the profiler captured no device event in {attempts} attempts")


def device_ms(fn, iters=10):
    """Device time of one call of ``fn`` in ms: the durations of all the
    kernels and copies it puts on the card, summed (``kernel_ms_by_name``);
    the host's gaps between them are not counted."""
    return sum(kernel_ms_by_name(fn, iters).values())


def bf16_ulp(v):
    """One bf16 ulp of ``v`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(max(abs(v), np.finfo(np.float32).tiny))) - 7)


def gemm_bound(m, k, n, x_bytes):
    """Least time (ms) for y = x @ dequant(w): each input read once, y written
    once, 2·M·N·K operations at the bf16 tensor-core peak."""
    moved = m * k * x_bytes + k * n + 4 * n + m * n * x_bytes
    t_bytes, t_ops = moved / H100_BYTES_PER_S, 2.0 * m * n * k / H100_BF16_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# the first int8 kernel (WMMA, no pipelining; commit 39ee133) at each shape of
# phase 3, ms per launch, x bf16 unless f32: the per-shape table of the first
# slice in PERF.md §6, measured by this script on NVIDIA H100 80GB HBM3, 700 W
FIRST_INT8_MS = {
    (4096, 4864, 256, "bfloat16"): 0.2344, (4096, 256, 2048, "bfloat16"): 0.1009,
    (4096, 2048, 256, "bfloat16"): 0.0715, (4096, 256, 256, "bfloat16"): 0.0196,
    (256, 256, 256, "bfloat16"): 0.0148, (4096, 256, 512, "bfloat16"): 0.0347,
    (4096, 256, 4233, "bfloat16"): 0.2499, (8160, 256, 256, "bfloat16"): 0.0312,
    (40960, 256, 256, "bfloat16"): 0.1315, (8160, 256, 2048, "bfloat16"): 0.1880,
    (8160, 2048, 256, "bfloat16"): 0.1083, (8160, 256, 4233, "bfloat16"): 0.4700,
    (256, 4864, 256, "float32"): 0.1563,
}


def check_int8_gemm(quant, m, k, n, dtype, gen, timed=True, x_offset=0):
    """Kernel vs plain version at one shape, with the weight held as
    ``Int8Linear`` holds it (rows padded to 16 bytes); times and bound.
    ``x_offset`` elements in front of x make its address not 16-byte aligned.
    Where the wrapper splits K, the kernel runs twice and must give the same
    bits, and the timed case also reads the split-K sum pass's own device time
    (``reduce_ms``, part of ``ms``) from the profiler."""
    x = torch.randn(m * k + x_offset, device="cuda", generator=gen).to(dtype)[x_offset:]
    x = x.view(m, k)
    v, s = quant.quantize_int8(0.05 * torch.randn(k, n, device="cuda", generator=gen))
    w = quant.pad_int8_rows(v)[:, :n]
    got = quant.int8_matmul(x, w, s)
    want = quant.int8_matmul_reference(x, v, s)
    splits = quant.split_k(m, n, k, torch.cuda.get_device_properties(0).multi_processor_count)
    again = quant.int8_matmul(x, w, s) if splits > 1 else got
    torch.cuda.synchronize()
    name = f"int8_matmul {(m, k, n)} {dtype} x_offset={x_offset}"
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: split-K ({splits}) output differs between two runs")
    err = (got.float() - want.float()).abs().max().item()
    peak = want.float().abs().max().item()
    # same bf16 products summed in f32 in another order: f32 out agrees to
    # float32 rounding, bf16 out is that sum rounded once (one ulp apart)
    tol = 1e-5 * peak if dtype == torch.float32 else bf16_ulp(peak)
    if not err <= tol:
        raise AssertionError(f"{name}: max err {err} > tol {tol}")
    result = {"m": m, "k": k, "n": n, "dtype": str(dtype).replace("torch.", ""),
              "x_offset": x_offset, "splits": splits, "max_abs_err": err,
              "max_rel_err": err / peak, "tol": tol}
    if not timed:
        return result
    xb, wb = x.to(torch.bfloat16), (v.to(torch.bfloat16) * s.to(torch.bfloat16))
    bound, bound_by = gemm_bound(m, k, n, x.element_size())
    result.update(
        ms=cuda_ms(lambda: quant.int8_matmul(x, w, s)),
        plain_ms=cuda_ms(lambda: quant.int8_matmul_reference(x, v, s), iters=5),
        library_ms=cuda_ms(lambda: torch.matmul(xb, wb)),
        bound_ms=bound, bound_by=bound_by)
    result["bound_share"] = bound / result["ms"]
    if splits > 1:
        by_name = kernel_ms_by_name(lambda: quant.int8_matmul(x, w, s))
        result["reduce_ms"] = sum(t for name, t in by_name.items() if "splitk_reduce" in name)
        if not result["reduce_ms"] > 0:
            raise AssertionError(f"{name}: the profiler saw no split-K sum pass: {dict(by_name)}")
    return result


def count_gemm_shapes(model, quant, shapes):
    """Forward pre-hooks that count each int8 layer call in ``shapes``, a
    ``Counter`` keyed by (M, K, N, dtype)."""
    def hook(mod, args):
        x = args[0]
        dtype = str(x.dtype).replace("torch.", "")
        shapes[(x.numel() // x.shape[-1], mod.in_features, mod.out_features, dtype)] += 1
    return [m.register_forward_pre_hook(hook) for m in model.modules()
            if isinstance(m, quant.Int8Linear)]


def synthetic_speech(n, seed):
    """``n`` voiced-like waveforms (harmonics of a random f0 under a syllable
    envelope, plus noise) of 8 s to 10.3 s, zero-padded to ``SAMPLES``."""
    rng = np.random.default_rng(seed)
    t = np.arange(SAMPLES) / SAMPLE_RATE
    lens = rng.integers(8 * SAMPLE_RATE, SAMPLES + 1, n)
    lens[0] = SAMPLES
    wav = np.zeros((n, SAMPLES), np.float32)
    for i in range(n):
        f0 = rng.uniform(90.0, 250.0)
        voiced = sum(a * np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 2 * np.pi))
                     for h, a in enumerate((0.3, 0.15, 0.08, 0.04), start=1))
        env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(2.0, 5.0) * t)
        x = voiced * env + 0.01 * rng.standard_normal(SAMPLES)
        wav[i, : lens[i]] = x[: lens[i]]
    frames = 1 + (lens - 400) // 160  # snip-edges 25 ms / 10 ms frames
    return wav, frames


def event_ms(fn, iters, phases=1):
    """Eager time of ``fn`` in ms between CUDA events, over ``iters`` calls
    after one warm-up: the host's launch cost counts, as it does for code
    that cannot be captured in a graph (a Python loop with autograd, a call
    that reads lengths on the host). ``fn`` takes a ``mark`` callback and calls
    it between its phases; the result is one time per phase."""
    totals = [0.0] * phases
    for it in range(iters + 1):
        events = [torch.cuda.Event(enable_timing=True)]
        events[0].record()

        def mark():
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()

        fn(mark)
        mark()
        torch.cuda.synchronize()
        if it:  # the first call warms up
            for i in range(phases):
                totals[i] += events[i].elapsed_time(events[i + 1])
    return [t / iters for t in totals]


def ctc_case(name, gen):
    """Inputs of one CTC check on the card: ``(logits, lens, labels, llens,
    blank)``. The first three are the train step's shapes; the rest are the
    edge cases the dynamic program is most likely to get wrong."""
    def draw(b, t, l, v, lens=None, llens=None, blank=0, repeats=()):
        logits = torch.randn(b, t, v, device="cuda", generator=gen)
        low, high = (1, v) if blank == 0 else (0, v - 1)
        labels = torch.randint(low, high, (b, l), device="cuda", generator=gen)
        for row, col in repeats:
            labels[row, col] = labels[row, col - 1]
        lens = torch.tensor(lens if lens is not None else [t] * b, device="cuda")
        llens = torch.tensor(llens if llens is not None else [l] * b, device="cuda")
        return logits, lens, labels, llens, blank

    t_sub = 256
    if name == "flagship":  # B=32, T'=256, L=20: the train step (10 s: 249 valid frames)
        return draw(TRAIN_BATCH, t_sub, TRAIN_LABELS, VOCAB,
                    lens=[((998 - 1) // 2 - 1) // 2] * TRAIN_BATCH)
    if name == "longest_labels":
        return draw(32, t_sub, 30, VOCAB)
    if name == "long_bucket":
        return draw(8, 752, 30, VOCAB)
    if name == "mixed_lengths_and_repeats":
        return draw(4, 37, 9, 11, lens=[37, 25, 10, 30], llens=[9, 5, 2, 4],
                    repeats=[(0, 2), (3, 1)])
    if name == "empty_label":
        return draw(3, 17, 5, 7, lens=[17, 9, 3], llens=[0, 3, 0])
    if name == "minimal_fit":
        return draw(2, 9, 4, 6)
    if name == "full_length":
        return draw(2, 24, 6, 8, llens=[6, 4])
    if name == "blank_is_last_class":
        return draw(2, 19, 5, 9, lens=[19, 12], llens=[5, 3], blank=8)
    if name == "single_frame":
        return draw(2, 1, 1, 5, llens=[1, 0])
    # the one-warp kernel's lane and register edges (S = 63, 65, 127, 129),
    # its last width and the band path's first (S = 255, 257), the band
    # path's edges where its warps change (319/321: 5 to 6 warps; 767/769: 12
    # to 13; 1023: 16) and the block path's first width (1025)
    if name.startswith("width_"):
        s = int(name.split("_")[1])
        return draw(2, s + 4, (s - 1) // 2, 300, llens=[(s - 1) // 2, (s - 1) // 4])
    if name == "wider_than_a_block":  # S = 1201, infeasible at T = 40: a loss near 1e5
        return draw(2, 40, 600, 50, llens=[600, 3])
    # S = 12001: the block path's three shared rows need 144 KB; 6000 labels
    # in 12 frames cannot be aligned (a loss near 1e5)
    if name == "widest_rows":
        return draw(2, 12, 6000, 50, lens=[12, 9], llens=[6000, 7])
    # rows that cannot be aligned (T < L + repeats) on both paths
    if name == "unalignable_rows":
        return draw(3, 6, 5, 7, lens=[6, 4, 2], llens=[5, 5, 3], repeats=[(0, 1), (0, 2)])
    if name == "unalignable_wide_rows":  # S = 281
        return draw(3, 16, 140, 20, lens=[16, 12, 6], llens=[140, 100, 20])
    # DeepSpeech2's S = 701 and vocabulary on the band path: rows that cannot
    # be aligned beside one that can; a zero length beside full ones; lengths
    # 45 and 38: the forward's groups of 4 steps end short, the backward's
    # (after its first step) short at 38 and whole at 45
    if name == "unalignable_wide_rows_701":
        return draw(3, 30, DS2_LABELS, DS2_VOCAB, lens=[30, 24, 12], llens=[350, 100, 5],
                    blank=DS2_VOCAB - 1)
    if name == "wide_zero_length_beside_full_length":
        return draw(4, 40, DS2_LABELS, DS2_VOCAB, lens=[40, 0, 40, 21], llens=[15, 350, 0, 10],
                    blank=DS2_VOCAB - 1, repeats=[(0, 2)])
    if name == "wide_t_not_a_multiple_of_the_chunk":
        return draw(3, 45, DS2_LABELS, DS2_VOCAB, lens=[45, 45, 38], llens=[20, 14, 9],
                    blank=DS2_VOCAB - 1)
    if name == "batch_of_five":
        return draw(5, 30, 6, 20, lens=[30, 22, 30, 17, 9], llens=[6, 4, 5, 3, 2])
    if name == "t_not_a_multiple_of_the_chunk":
        return draw(4, 45, 10, 20, lens=[45, 45, 39, 33])
    if name == "t_shorter_than_a_chunk":
        return draw(3, 13, 4, 9)
    if name == "zero_length_beside_full_length":
        return draw(4, 40, 8, 15, lens=[40, 0, 40, 21], llens=[8, 3, 0, 5])
    if name == "lengths_differ_per_row":
        return draw(4, 50, 12, 30, lens=[50, 33, 41, 26], llens=[12, 7, 10, 3])
    # DeepSpeech2's train step: B=64, labels padded to 350 (S = 701, the band
    # path), vocabulary 29 with the blank last, T' = 626 (the 1250-frame
    # bucket) or 1001 (the 2000-frame bucket); ragged lengths of 3/4 T' to
    # T' and 80-350 labels, each row with one full length and label
    if name.startswith("deepspeech2_"):
        t = int(name.split("_")[1])
        rng = np.random.default_rng(t)
        lens = [t] + rng.integers(3 * t // 4, t + 1, DS2_BATCH - 1).tolist()
        llens = [DS2_LABELS] + rng.integers(80, DS2_LABELS + 1, DS2_BATCH - 1).tolist()
        return draw(DS2_BATCH, t, DS2_LABELS, DS2_VOCAB, lens=lens, llens=llens,
                    blank=DS2_VOCAB - 1)
    raise KeyError(name)


CTC_CASES = ["flagship", "longest_labels", "long_bucket", "mixed_lengths_and_repeats",
             "empty_label", "minimal_fit", "full_length", "blank_is_last_class",
             "single_frame", "width_63", "width_65", "width_127", "width_129", "width_255",
             "width_257", "width_319", "width_321", "width_767", "width_769", "width_1023",
             "width_1025", "wider_than_a_block", "widest_rows", "unalignable_rows",
             "unalignable_wide_rows", "unalignable_wide_rows_701", "batch_of_five",
             "t_not_a_multiple_of_the_chunk", "t_shorter_than_a_chunk",
             "zero_length_beside_full_length", "wide_zero_length_beside_full_length",
             "wide_t_not_a_multiple_of_the_chunk", "lengths_differ_per_row",
             "deepspeech2_626", "deepspeech2_1001"]
CTC_TIMED = CTC_CASES[:3] + CTC_CASES[-2:]


# csrc/ctc_probe.cu's variants, in its order: each adds one part of a step;
# the last is the band path's step, at DeepSpeech2's (B, T', S)
CTC_LADDER = [
    ("a", "row in registers, one warp a sequence, shuffles; lse3 + a log-prob in a register"),
    ("a_fast", "(a) with __expf/__logf (not used by the port)"),
    ("b", "row in shared memory, one thread a state, one __syncthreads() a step"),
    ("c", "(b) + the log-prob loaded from device memory one step ahead"),
    ("d", "(c) + the alpha row stored: the block kernels' step"),
    ("a_store", "(a) + the alpha row stored to device memory every step (not staged)"),
    ("e", "band path: 11 warps of 64 states a sequence, each stepping as (a), edge states "
          "passed up through a ring of tagged words, a wait every 4 steps"),
]
CTC_BAND_RUNG_SHAPE = (64, 626, 701)  # DeepSpeech2's train step at the 1250-frame bucket

# the first design's block path (one block of 704 threads a sequence, the row
# in shared memory, a barrier a step; commit 4549bc6) at DeepSpeech2's shapes
# of phase 5, ms per launch (forward, backward), measured by this script on
# NVIDIA H100 80GB HBM3, 700 W when it was the path S = 701 took: logged
# beside this run's times of the same kernels (``ctc_dp.block_plan``)
BLOCK_PATH_MS = {"deepspeech2_626": (0.3878, 0.4508), "deepspeech2_1001": (0.6187, 0.7186)}


def ctc_chain_ladder(build, b=TRAIN_BATCH, t=256, s=41, launches=5):
    """Latency of one dependent step of the CTC recursion, variant by variant
    (``csrc/ctc_probe.cu``), at the flagship's B and S (the band rung at
    ``CTC_BAND_RUNG_SHAPE``): per launch the median over blocks of the loop's
    %globaltimer ns and clock64 cycles over ``t``; the median of
    ``launches`` launches after one warm-up; and, to check the stamps, a
    launch's device time over ``t`` (which adds the launch)."""
    import ctypes

    lib = build.load("ctc_probe")
    lib.ctc_probe_launch.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                                     + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.ctc_probe_launch.restype = ctypes.c_int
    lib.ctc_probe_error_string.argtypes = [ctypes.c_int]
    lib.ctc_probe_error_string.restype = ctypes.c_char_p
    if lib.ctc_probe_variants() != len(CTC_LADDER):
        raise AssertionError("ctc_probe.cu and CTC_LADDER disagree on the variants")
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows = {}
    for variant, (name, what) in enumerate(CTC_LADDER):
        if name == "e":
            b, t, s = CTC_BAND_RUNG_SHAPE
        logp = torch.log_softmax(torch.randn(b, t, s, device="cuda", generator=gen), -1)
        out, alphas = torch.empty(b, s, device="cuda"), torch.empty(b, t, s, device="cuda")
        ns, cycles = (torch.empty(b, dtype=torch.int64, device="cuda") for _ in range(2))
        per_launch = []
        for _ in range(launches + 1):
            rc = lib.ctc_probe_launch(variant, logp.data_ptr(), out.data_ptr(), alphas.data_ptr(),
                                      ns.data_ptr(), cycles.data_ptr(), b, t, s,
                                      torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"ctc_probe {name}: {lib.ctc_probe_error_string(rc).decode()}")
            torch.cuda.synchronize()
            if not torch.isfinite(out).all():
                raise AssertionError(f"ctc_probe {name}: non-finite row")
            per_launch.append((ns.double().median().item() / t / 1e3,
                               cycles.double().median().item() / t))
        per_launch = per_launch[1:]

        def launch():
            lib.ctc_probe_launch(variant, logp.data_ptr(), out.data_ptr(), alphas.data_ptr(),
                                 ns.data_ptr(), cycles.data_ptr(), b, t, s,
                                 torch.cuda.current_stream().cuda_stream)

        # the stamps against the whole launch's device time over t
        rows[name] = {"what": what, "shape": [b, t, s],
                      "us_per_step": statistics.median(p[0] for p in per_launch),
                      "cycles_per_step": statistics.median(p[1] for p in per_launch),
                      "launch_us_per_step": 1e3 * cuda_ms(launch, iters=5) / t}
    for r in rows.values():  # against the block kernels' step at the same shape
        same = r["shape"] == rows["d"]["shape"]
        r["share_of_d"] = r["us_per_step"] / rows["d"]["us_per_step"] if same else None
    return {"shape": rows["a"]["shape"], "variants": rows}


def check_ctc(ctc_dp, name, gen, floor_us=None):
    """CTC kernels vs the plain recursion at one case: value and gradient at
    ``logp_ext`` and at the logits; for the train shapes also the times, the
    byte bound and the chain floor (the longest length times ``floor_us``,
    the ladder's least measured latency of one step: not a lower bound)."""
    import torch.nn.functional as F

    logits, lens, labels, llens, blank = ctc_case(name, gen)
    b, t, v = logits.shape
    g = 0.5 + torch.rand(b, device="cuda", generator=gen)  # upstream cotangent

    # at logp_ext: the two kernels alone against autograd through the plain loop
    logp_ext, allowed = ctc_dp.extended_log_probs(logits, labels, blank)
    s = logp_ext.shape[2]
    lens32, llens32, allowed8 = lens.int(), llens.int(), allowed.to(torch.uint8)
    loss_k, alphas = ctc_dp.ctc_dp_fwd(logp_ext, lens32, allowed8, llens32)
    grad_k = ctc_dp.ctc_dp_bwd(logp_ext, alphas, lens32, allowed8, llens32, loss_k, g)
    ref_in = logp_ext.detach().requires_grad_()
    loss_p = ctc_dp.ctc_dp_reference(ref_in, lens, allowed, llens)
    (grad_p,) = torch.autograd.grad(loss_p, ref_in, g)

    # at the logits: through log-softmax and the gather, as the loss calls it
    def at_logits(fn):
        x = logits.detach().requires_grad_()
        loss = fn(x, lens, labels, llens, blank_id=blank)
        return loss.detach(), torch.autograd.grad(loss, x, g)[0]

    loss_kl, glogit_k = at_logits(ctc_dp.ctc_per_seq_loss_kernel)
    loss_pl, glogit_p = at_logits(ctc_dp.ctc_per_seq_loss_reference)
    torch.cuda.synchronize()

    peak = loss_p.abs().max().item()
    errs = {
        "loss": (loss_k - loss_p).abs().max().item(),
        "loss_at_logits": (loss_kl - loss_pl).abs().max().item(),
        "grad_logp_ext": (grad_k - grad_p).abs().max().item(),
        "grad_logits": (glogit_k - glogit_p).abs().max().item(),
    }
    # float32 on both sides. A value is a chain of T log-sum-exps at magnitude
    # |loss|, each rounded to an ulp of it: 16 ulps of the largest loss. A
    # gradient is exp(alpha + beta + loss) <= 1.5 (times g), whose exponent
    # carries that absolute error, so it is relative to the gradient: the same
    # bound on the exponent, times the largest cotangent. The scatter-add at
    # the logits sums the blank positions of a frame in another order (atomics)
    # but adds nothing of another size.
    eps = float(np.finfo(np.float32).eps)
    tol_value = 16 * eps * max(peak, 1.0)
    tol_grad = max(tol_value, 1e-6) * 1.5
    ok = (all(torch.isfinite(x).all() for x in (loss_k, grad_k, glogit_k))
          and errs["loss"] <= tol_value and errs["loss_at_logits"] <= tol_value
          and errs["grad_logp_ext"] <= tol_grad and errs["grad_logits"] <= tol_grad)
    plan = ctc_dp.kernel_plan(b, t, s)
    result = {"case": name, "shape": [b, t, s, v], "max_abs_err": errs, "max_loss": peak,
              "tol_value": tol_value, "tol_grad": tol_grad, "plan": plan._asdict()}
    if not ok:
        raise AssertionError(f"ctc_dp {name}: kernels and plain version disagree: {result}")
    if name not in CTC_TIMED:
        return result

    # times: each kernel alone in a CUDA graph; the plain pair eagerly
    # (forward, backward); F.ctc_loss's device time, its lengths as CUDA tensors
    fwd_ms = cuda_ms(lambda: ctc_dp.ctc_dp_fwd(logp_ext, lens32, allowed8, llens32))
    bwd_ms = cuda_ms(lambda: ctc_dp.ctc_dp_bwd(logp_ext, alphas, lens32, allowed8, llens32,
                                               loss_k, g))
    if name in BLOCK_PATH_MS:  # S = 701: the first design's block kernels on these inputs
        block = ctc_dp.block_plan(s)
        loss_b, alphas_b = ctc_dp.launch_fwd(block, logp_ext, lens32, allowed8, llens32)
        grad_b = ctc_dp.launch_bwd(block, logp_ext, alphas_b, lens32, allowed8, llens32, loss_b, g)
        result["block_path_max_abs_err"] = {"loss": (loss_b - loss_p).abs().max().item(),
                                            "grad_logp_ext": (grad_b - grad_p).abs().max().item()}
        if not (result["block_path_max_abs_err"]["loss"] <= tol_value
                and result["block_path_max_abs_err"]["grad_logp_ext"] <= tol_grad):
            raise AssertionError(f"ctc_dp {name}: block path and plain version disagree: {result}")
        result["block_path_fwd_ms"] = cuda_ms(
            lambda: ctc_dp.launch_fwd(block, logp_ext, lens32, allowed8, llens32))
        result["block_path_bwd_ms"] = cuda_ms(
            lambda: ctc_dp.launch_bwd(block, logp_ext, alphas_b, lens32, allowed8, llens32,
                                      loss_b, g))

    def plain(mark):
        loss = ctc_dp.ctc_dp_reference(ref_in, lens, allowed, llens)
        mark()
        torch.autograd.grad(loss, ref_in, g)

    log_probs = F.log_softmax(logits, -1).transpose(0, 1).contiguous().requires_grad_()

    def library():
        return F.ctc_loss(log_probs, labels, lens, llens, blank=blank, reduction="none")

    plain_fwd, plain_bwd = event_ms(plain, iters=2, phases=2)
    lib_fwd = device_ms(library)
    lib_bwd = device_ms(lambda: torch.autograd.grad(library(), log_probs, g)) - lib_fwd
    result["library_max_abs_err"] = (library().detach() - loss_k).abs().max().item()
    if not result["library_max_abs_err"] <= tol_value:
        raise AssertionError(f"ctc_dp {name}: F.ctc_loss disagrees: {result}")
    # bytes this run's data needs: log-probs (and, backward, alphas) are read
    # at the valid frames only; alphas and gradients are written at every frame
    cells, valid = b * t * s * 4, int(lens.clamp(0, t).sum().item()) * s * 4
    steps = int(lens.max().item())
    result.update(
        fwd_ms=fwd_ms, bwd_ms=bwd_ms,
        plain_fwd_ms=plain_fwd, plain_bwd_ms=plain_bwd,
        library_fwd_ms=lib_fwd, library_bwd_ms=lib_bwd,
        fwd_bound_ms=1e3 * (valid + cells) / H100_BYTES_PER_S,
        bwd_bound_ms=1e3 * (2 * valid + cells) / H100_BYTES_PER_S,
        chain_steps=steps, fwd_us_per_step=1e3 * fwd_ms / steps,
        bwd_us_per_step=1e3 * bwd_ms / steps)
    if floor_us is not None:  # both chains are one lse3 and one add a step
        result["chain_floor_ms"] = steps * floor_us / 1e3
    return result


def logmel_plan(logmel, n_fft=400, win_length=None, hop_length=None, window="hann",
                n_mels=80, sample_rate=16000, f_min=0.0, f_max=None, kaldi=False, **_):
    """The kernel's launch plan and host tables at these arguments."""
    design = (n_fft, win_length or n_fft, window, n_mels, sample_rate, f_min, f_max, kaldi)
    table, bands, wts = logmel._kernel_design(*design)
    hop = hop_length or (win_length or n_fft) // 2
    carries = int(bands[3].max()) + 1
    return logmel.kernel_plan(n_fft, hop, n_mels, wts.size, carries), table, bands, wts, carries


def check_logmel(logmel, shape, gen, timed=False, **kw):
    """Log-mel kernel vs its plain version at one shape, at both precisions
    (one route: the outputs must be equal); times in turns and the bound."""
    x = torch.randn(*shape, device="cuda", generator=gen)
    got = logmel.fused_logmel(x, **kw)
    want = logmel.fused_logmel_reference(x, **kw)
    again = logmel.fused_logmel(x, precision="highest", **kw)
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"fused_logmel {shape} {kw}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}, or non-finite values")
    if not torch.equal(got, again):
        raise AssertionError(f"fused_logmel {shape} {kw}: precision 'default' and 'highest' "
                             "differ; both take the three-pass route")
    err = (got - want).abs()
    # the tolerance the JAX package holds its own kernel to: rtol = atol = 1e-3
    tol = 1e-3 + 1e-3 * want.abs()
    excess = (err - tol).max().item()
    result = {"shape": list(shape), "args": {k: str(v) for k, v in kw.items()},
              "precisions": ["default", "highest"], "out_shape": list(got.shape),
              "max_abs_err": err.max().item(), "max_err_over_tol": (err / tol).max().item(),
              "tol": "1e-3 + 1e-3*|plain|"}
    if not excess <= 0:
        raise AssertionError(f"fused_logmel {shape} {kw}: exceeds tolerance by {excess}: {result}")
    if timed:
        plan, table, bands, wts, _ = logmel_plan(logmel, **kw)
        b, n_frames, n_mels = got.shape
        n_fft = kw.get("n_fft", 400)
        n_freq, frames = n_fft // 2 + 1, b * n_frames
        dft = 2.0 * frames * n_fft * 2 * n_freq  # re and im, one pass
        mel_banded = 2.0 * frames * wts.size
        mel_dense = 2.0 * frames * n_freq * n_mels
        moved = 4.0 * (x.numel() + got.numel()) + table.nbytes + bands.nbytes + wts.nbytes
        t_bytes = moved / H100_BYTES_PER_S
        t_ops = 3 * dft / H100_TF32_FLOP_PER_S + mel_banded / H100_F32_FLOP_PER_S
        plain = functools.partial(logmel.fused_logmel_reference, x, **kw)
        turns = (plain, functools.partial(logmel.fused_logmel, x, precision="default", **kw),
                 functools.partial(logmel.fused_logmel, x, precision="highest", **kw), plain)
        times = [cuda_ms(f, iters=5) for f in turns]
        result.update(
            ms=(times[1] + times[2]) / 2, plain_ms=(times[0] + times[3]) / 2, turns_ms=times,
            bound_ms=1e3 * max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            passes=3, operations=3 * dft + mel_banded, bytes=moved,
            bound_ms_f32_cuda_cores=1e3 * max((dft + mel_dense) / H100_F32_FLOP_PER_S, t_bytes),
            bound_ms_one_tf32_pass=1e3 * max(dft / H100_TF32_FLOP_PER_S
                                             + mel_banded / H100_F32_FLOP_PER_S, t_bytes),
            frames_per_block=plan.fpb, ring_slots=plan.stages, smem_bytes=plan.smem_bytes)
    return result


def logmel_against_f64(logmel, x, **kw):
    """Max |err| / (1e-3 + 1e-3 |exact|) of the kernel and of the plain
    version against the same function in float64 on the CPU."""
    wr, wi, fb, _ = logmel._design(kw["n_fft"], kw["n_fft"], "hann", kw["n_mels"], 16000, 0.0,
                                   None, False)
    xd = torch.nn.functional.pad(x.double().cpu(), (kw["n_fft"] // 2, kw["n_fft"] // 2))
    n_frames = 1 + x.shape[1] // kw["hop_length"]
    frames = xd.unfold(-1, kw["n_fft"], kw["hop_length"])[:, :n_frames]
    w64 = lambda a: torch.from_numpy(a.astype(np.float64))  # noqa: E731
    re, im = frames @ w64(wr), frames @ w64(wi)
    exact = torch.log(torch.clamp_min((re * re + im * im) @ w64(fb), 1e-10))
    out = {}
    for name, fn in (("kernel", logmel.fused_logmel), ("plain", logmel.fused_logmel_reference)):
        got = fn(x, **kw).double().cpu()
        out[name] = ((got - exact).abs() / (1e-3 + 1e-3 * exact.abs())).max().item()
    return out


def train_batch(batch_size, seed, device):
    """The train bench's batch: 10 s of seeded noise at amplitude 0.1 in the
    1027-frame bucket, ``TRAIN_LABELS`` random labels, sos = eos = vocab - 1."""
    from mindaudio_torch.utils.common import add_sos_eos

    rng = np.random.default_rng(seed)
    wavs = np.zeros((batch_size, TRAIN_SAMPLES), np.float32)
    wavs[:, :TRAIN_TRUE_SAMPLES] = 0.1 * rng.standard_normal(
        (batch_size, TRAIN_TRUE_SAMPLES)).astype(np.float32)
    labels = rng.integers(1, VOCAB - 1, (batch_size, TRAIN_LABELS))
    ys_in, ys_out = add_sos_eos(labels, VOCAB - 1, VOCAB - 1)
    batch = {
        "wavs": torch.from_numpy(wavs),
        "wav_lens": torch.full((batch_size,), TRAIN_TRUE_SAMPLES),
        "labels": torch.from_numpy(labels),
        "label_lens": torch.full((batch_size,), TRAIN_LABELS),
        "ys_in": torch.from_numpy(np.asarray(ys_in)).long(),
        "ys_out": torch.from_numpy(np.asarray(ys_out)).long(),
        "ys_lens": torch.full((batch_size,), TRAIN_LABELS + 1),
    }
    return {k: v.to(device) for k, v in batch.items()}


def new_model(ctc_impl, device, seed=0):
    """The flagship Conformer at full width and depth, seeded random weights."""
    from mindaudio_torch.models.asr_model import ASRModel

    gen = torch.Generator(device=device).manual_seed(seed)
    return ASRModel(VOCAB, input_dim=N_MELS, d_model=D_MODEL, head_num=HEADS, ffn_dim=FFN,
                    num_encoder_layers=ENC_LAYERS, num_decoder_layers=DEC_LAYERS,
                    kernel_size=CONV_KERNEL, ctc_weight=0.3, ctc_impl=ctc_impl,
                    device=device).reset_parameters(gen)


def make_trainer():
    """The train bench's step on the card: ``(model, optimizer, step, batch)``."""
    from mindaudio_torch.ops.specaugment import spec_augment
    from mindaudio_torch.ops.spectral import kaldi_fbank
    from mindaudio_torch.train.optim import AdamW
    from mindaudio_torch.train.state import make_train_step

    model = new_model("kernel", "cuda").train()
    gen = torch.Generator(device="cuda").manual_seed(1)
    model.set_dropout_generator(gen)
    optimizer = AdamW(model.named_parameters(), 1e-3, weight_decay=1e-2,
                      mu_dtype=torch.bfloat16)

    def features(batch):
        feats = kaldi_fbank(batch["wavs"], num_mel_bins=N_MELS, dither=0.1, generator=gen,
                            device="cuda")
        return spec_augment(feats, generator=gen), 1 + (batch["wav_lens"] - 400) // 160

    step = make_train_step(model, optimizer, features, grad_clip_norm=5.0,
                           autocast_dtype=torch.bfloat16)
    return model, optimizer, step, train_batch(TRAIN_BATCH, seed=0, device="cuda")


def profile_steps(label, step, batch, warmup=TRAIN_WARMUP_STEPS, steps=3, rows=25, by_op=True):
    """``torch.profiler`` over ``steps`` steady calls of ``step(batch)``
    after ``warmup``. Prints the device's busy share of the window, the
    device kernels by time (grouped by name from the device events) and,
    with ``by_op``, the profiler's table by operator (slow to tabulate over
    a step of tens of thousands of kernels)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)  # before the profiler's own wrap-up
    t1 = time.perf_counter()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time for e in events)
    log(f"profile {label}: {steps} train steps, {wall_ms:.1f} ms of host time with the "
        f"profiler on, {len(events)} device operations ({len(events) / steps:.0f} per step), "
        f"device busy {busy_us / 1e3:.1f} ms = {100 * busy_us / 1e3 / wall_ms:.1f}% of the "
        f"window (events read in {time.perf_counter() - t1:.1f} s)")
    by_name, calls = collections.Counter(), collections.Counter()
    for e in events:
        by_name[e.name] += e.device_time
        calls[e.name] += 1
    log(f"profile {label}: device kernels by time (ms over the {steps} steps | share of the "
        "device time | launches | name):")
    for name, us in by_name.most_common(rows):
        log(f"  {us / 1e3:10.3f} | {100 * us / busy_us:5.1f}% | {calls[name]:7d} | {name[:100]}")
    if by_op:
        log(prof.key_averages().table(sort_by="device_time_total", row_limit=rows,
                                      max_name_column_width=60))


def profile_train():
    """``--profile-train``: the Conformer's train step (phase 7's)."""
    _, _, step, batch = make_trainer()
    profile_steps("conformer", step, batch)


def profile_separation():
    """``--profile-separation``: the Conv-TasNet and TasNet recipes' train
    steps at full width on one batch of B = 16 x 4 s of seeded noise
    (cuDNN TF32 off)."""
    from mindaudio_torch.recipes.conv_tasnet import train as conv_train
    from mindaudio_torch.recipes.tasnet import train as tas_train

    rng = np.random.default_rng(0)
    src = rng.standard_normal((SEP_BATCH, 2, SEP_SAMPLES)).astype(np.float32)
    batch = sep_batch_to({"mix": src.sum(1), "src": src,
                          "lengths": np.full(SEP_BATCH, SEP_SAMPLES, np.int32)}, "cuda")
    for name, recipe, separate_fn in (("conv_tasnet", conv_train, conv_train.separate),
                                      ("tasnet", tas_train, tas_train.separate_full)):
        cfg, _ = recipe.parse_args([])
        model = recipe.build_model(cfg, "cuda").train()
        step = conv_train.make_step(cfg, model, conv_train.make_optimizer(cfg, model),
                                    separate_fn)
        # TasNet's step is some 65,000 kernels: one step, no table by operator
        profile_steps(name, step, batch, steps=1 if name == "tasnet" else 3,
                      by_op=name != "tasnet")
        del model, step
        torch.cuda.empty_cache()


def train_phase(ctc_dp, ctc_times):
    """Phase 7 and the poisoned batch of phase 8. Returns the launch counts of
    the CTC kernels over the train steps."""
    model, optimizer, step, batch = make_trainer()
    start = [p.detach().clone() for p in model.parameters()]

    def run(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = [step(batch) for _ in range(n)]
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0) / n

    torch.cuda.reset_peak_memory_stats()
    ctc_dp.ctc_dp_fwd.launches = ctc_dp.ctc_dp_bwd.launches = 0
    metrics, _ = run(TRAIN_WARMUP_STEPS)
    timed = {"kernel": [], "scan": []}
    for impl, n in (("kernel", TRAIN_TIMED_STEPS), ("scan", PLAIN_CTC_STEPS),
                    ("scan", PLAIN_CTC_STEPS), ("kernel", TRAIN_TIMED_STEPS)):
        model.ctc_impl = impl
        out, ms = run(n)
        metrics += out
        timed[impl].append(ms)
    model.ctc_impl = "kernel"
    launches = (ctc_dp.ctc_dp_fwd.launches, ctc_dp.ctc_dp_bwd.launches)
    kernel_steps = TRAIN_WARMUP_STEPS + 2 * TRAIN_TIMED_STEPS

    losses = [m["loss"].item() for m in metrics]
    first, last = metrics[0], metrics[-1]
    log("train: loss per step " + " ".join(f"{v:.2f}" for v in losses))
    log(f"train: first step loss_ctc {first['loss_ctc'].item():.2f} loss_att "
        f"{first['loss_att'].item():.2f} grad_norm {first['grad_norm'].item():.2f}; last step "
        f"loss_ctc {last['loss_ctc'].item():.2f} loss_att {last['loss_att'].item():.2f} "
        f"acc_att {last['acc_att'].item():.3f} grad_norm {last['grad_norm'].item():.2f}")
    step_ms = min(timed["kernel"])
    ctc_ms = ctc_times["fwd_ms"] + ctc_times["bwd_ms"]
    log(f"train: B={TRAIN_BATCH} x 10 s, bf16 autocast, ctc_impl=kernel: "
        f"{' / '.join(f'{v:.2f}' for v in timed['kernel'])} ms per step over "
        f"{TRAIN_TIMED_STEPS} steps (best {TRAIN_BATCH / step_ms * 1e3:.1f} utterances/s); "
        f"ctc_impl=scan (plain recursion): {' / '.join(f'{v:.2f}' for v in timed['scan'])} "
        f"ms per step over {PLAIN_CTC_STEPS} steps; CTC kernels {ctc_ms:.4f} ms = "
        f"{100 * ctc_ms / step_ms:.3f}% of the step; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"train: ctc_dp_fwd launches {launches[0]}, ctc_dp_bwd launches {launches[1]} "
        f"(expected {kernel_steps} each)")
    if not np.isfinite(losses).all():
        raise AssertionError("train: a loss is not finite")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: loss did not fall: {losses[0]} -> {losses[-1]}")
    if launches != (kernel_steps, kernel_steps):
        raise AssertionError(f"train: CTC kernel launches {launches}, expected {kernel_steps}")
    if not all((a != b).any() for a, b in zip(start, model.parameters())):
        raise AssertionError("train: some parameter did not move")
    if optimizer.count.item() != len(losses):
        raise AssertionError("train: the step counter does not equal the steps taken")
    del start

    # a poisoned batch: one utterance holds an inf in every second of audio
    # (two SpecAugment time masks cannot cover them all)
    before = [t.clone() for t in (*model.parameters(), *optimizer.mu, *optimizer.nu)]
    count = optimizer.count.item()
    bad = dict(batch, wavs=batch["wavs"].clone())
    bad["wavs"][3, 777::SAMPLE_RATE] = float("inf")
    bad_loss = step(bad)["loss"].item()
    same = all(torch.equal(a, b) for a, b in
               zip(before, (*model.parameters(), *optimizer.mu, *optimizer.nu)))
    log(f"poisoned batch: loss {bad_loss}, parameters and moments bit-equal {same}, "
        f"AdamW count {count} -> {optimizer.count.item()}")
    if np.isfinite(bad_loss) or not same or optimizer.count.item() != count:
        raise AssertionError("poisoned batch: the update was not skipped cleanly")
    return launches


def card_against_cpu_step():
    """One deterministic float32 step, B=2: the card with the CTC kernels
    against the CPU with the plain recursion, on the same features."""
    from mindaudio_torch.ops.spectral import kaldi_fbank
    from mindaudio_torch.train.state import clip_by_global_norm

    gpu = new_model("kernel", "cuda").eval()  # dropout off
    cpu = copy.deepcopy(gpu).cpu()
    cpu.ctc_impl = "scan"
    batch = train_batch(2, seed=1, device="cpu")
    batch["feats"] = kaldi_fbank(batch["wavs"], num_mel_bins=N_MELS, device="cpu")
    batch["feat_lens"] = 1 + (batch["wav_lens"] - 400) // 160
    out = {}
    for name, model in (("card", gpu), ("cpu", cpu)):
        dev = next(model.parameters()).device
        loss, metrics = model({k: v.to(dev) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out[name] = {"loss": loss.item(), "loss_ctc": metrics["loss_ctc"].item(),
                     "loss_att": metrics["loss_att"].item(),
                     "grad_norm": clip_by_global_norm(list(grads), 5.0)[1].item()}
    # float32 on both sides, sums in another order through 12 + 6 blocks: the
    # served request agreed to 4e-6 at the log-probs; the losses are sums of
    # hundreds of them (1e-4 relative) and the gradient norm passes through
    # the whole backward (1e-3 relative)
    tols = {"loss": 1e-4, "loss_ctc": 1e-4, "loss_att": 1e-4, "grad_norm": 1e-3}
    rel = {k: abs(out["card"][k] - out["cpu"][k]) / abs(out["cpu"][k]) for k in tols}
    log("one float32 step, B=2, card (ctc kernels) vs CPU (plain): "
        + "; ".join(f"{k} {out['card'][k]:.6f} vs {out['cpu'][k]:.6f} (rel {rel[k]:.2e}, "
                    f"tol {tols[k]})" for k in tols))
    if not all(rel[k] <= tols[k] for k in tols):
        raise AssertionError(f"card and CPU steps differ: {rel}")


def same_dp_results(native, python, rows, tol=1e-4):
    """Raise unless the native prefix-beam DP's hypotheses equal the Python
    DP's at ``rows``: equal prefixes in equal order, scores within ``tol``
    plus one float32 ulp of the score (the native DP rounds its float64 sum
    to float32). Returns the largest score difference and the number of
    scores equal to the Python DP's rounded to float32, of how many."""
    worst, same, count = 0.0, 0, 0
    for row in rows:
        got, want = native[row], python[row]
        if [p for p, _ in got] != [p for p, _ in want]:
            raise AssertionError(f"native DP row {row}: prefixes differ: {got[:2]} vs {want[:2]}")
        for (_, gs), (_, ws) in zip(got, want):
            worst = max(worst, abs(gs - ws))
            same, count = same + (gs == float(np.float32(ws))), count + 1
            if not abs(gs - ws) <= tol + float(np.spacing(np.float32(abs(ws)))):
                raise AssertionError(f"native DP row {row}: score {gs} vs {ws}")
    return worst, same, count


def dp_check(name, model, feats, lens):
    """Both prefix-beam DPs on ``model``'s top-k of the batch (beam ``BEAM``,
    the served decode's), timed on the host clock. The native DP follows the
    Python DP's arithmetic and tie order, so every row must be equal
    (:func:`same_dp_results`), rows whose top-k holds an exact tie in some
    valid frame (counted) included."""
    from mindaudio_torch import _native
    from mindaudio_torch.utils.recognize import ctc_prefix_beam_dp

    with torch.inference_mode():
        enc_out, enc_mask = model.encode(feats, lens)
        top_logp, top_idx = model.ctc_log_probs(enc_out).topk(BEAM, dim=-1)
        valid = enc_mask[:, 0].sum(-1).cpu().numpy()
    top_logp, top_idx = top_logp.cpu().numpy(), top_idx.cpu().numpy()

    t = time.perf_counter()
    native = _native.ctc_prefix_beam_batch(top_logp, top_idx, valid, BEAM)
    native_ms = 1e3 * (time.perf_counter() - t)
    t = time.perf_counter()
    python = [ctc_prefix_beam_dp(top_logp[b], top_idx[b], int(valid[b]), BEAM)
              for b in range(len(valid))]
    python_ms = 1e3 * (time.perf_counter() - t)
    tied = sum(any(len(set(top_logp[b, t].tolist())) < BEAM for t in range(int(valid[b])))
               for b in range(len(valid)))
    worst, same, count = same_dp_results(native, python, range(len(valid)))
    log(f"prefix-beam DP on {name} top-k {tuple(top_logp.shape)}: native {native_ms:.2f} ms, "
        f"Python {python_ms:.1f} ms ({python_ms / native_ms:.0f}x); all {len(valid)} rows "
        f"equal (largest score difference {worst:.3e}, tol 1e-4 + a float32 ulp; {same} of "
        f"{count} scores the Python DP's rounded to float32), {tied} of them with an exact "
        f"tie in their top-k")
    return {"top_k": list(top_logp.shape), "native_ms": native_ms, "python_ms": python_ms,
            "rows_with_tied_top_k": tied, "rows_equal": len(valid), "max_score_diff": worst,
            "scores_bit_equal": same, "scores": count}


def streamed_log_probs(model, chunks, cap):
    """The CTC log-probs of one utterance's stream, chunk by chunk through
    ``encode_chunk``, concatenated."""
    att = cnn = None
    out = []
    for chunk in chunks:
        lp, att, cnn = model.encode_chunk(chunk, att, cnn, cap)
        out.append(lp)
    return torch.cat(out, dim=1)


def streaming_phase(quant, wav_np, frames):
    """Phase 10: streaming decode of the served utterances on a causal-conv
    flagship (seeded weights), chunks of ``STREAM_CHUNK`` subsampled frames
    (``predict.stream_chunks``), int8 weights and bf16 compute, at cap
    ``STREAM_CAP`` and with the whole history. Returns a summary and the
    int8 GEMM results at the shapes the stream met."""
    from mindaudio_torch.models.asr_model import ASRModel
    from mindaudio_torch.ops.spectral import kaldi_fbank
    from mindaudio_torch.recipes.conformer.predict import stream_chunks
    from mindaudio_torch.utils.recognize import ASRInference

    gen = torch.Generator(device="cuda").manual_seed(5)
    model = ASRModel(VOCAB, input_dim=N_MELS, d_model=D_MODEL, head_num=HEADS, ffn_dim=FFN,
                     num_encoder_layers=ENC_LAYERS, num_decoder_layers=DEC_LAYERS,
                     kernel_size=CONV_KERNEL, causal_conv=True, use_dynamic_chunk=True,
                     device="cuda").reset_parameters(gen).eval()
    serving = ASRInference(model, weight_quant="int8", weight_quant_min_size=QUANT_MIN,
                           dtype=torch.bfloat16)
    with torch.inference_mode():
        feats = kaldi_fbank(torch.from_numpy(wav_np).cuda(), num_mel_bins=N_MELS, device="cuda")
    utts = [feats[i:i + 1, : int(frames[i])] for i in range(len(frames))]
    streams = [stream_chunks(u, u.shape[1], STREAM_CHUNK) for u in utts]
    n_chunks = sum(len(c) for c in streams)
    audio_s = float(sum((int(n) - 1) * 160 + 400 for n in frames)) / SAMPLE_RATE

    def timed(chunks, times):
        # streaming_ctc_greedy reads a chunk's tokens back (a synchronise)
        # before it asks for the next: the host time between two asks is
        # one chunk's
        for chunk in chunks:
            t = time.perf_counter()
            yield chunk
            times.append(time.perf_counter() - t)

    serving.streaming_ctc_greedy(streams[0], required_cache_size=STREAM_CAP)  # warm-up
    shapes = collections.Counter()
    hooks = count_gemm_shapes(serving.model, quant, shapes)
    runs = {}
    for cap in (STREAM_CAP, -1):
        quant.int8_matmul.launches = quant.int8_matmul.reduce_launches = 0
        times, hyps = [], []
        t = time.perf_counter()
        for chunks in streams:
            hyps.append(serving.streaming_ctc_greedy(timed(chunks, times),
                                                     required_cache_size=cap))
        total = time.perf_counter() - t
        runs[cap] = {"launches": quant.int8_matmul.launches,
                     "reduce_launches": quant.int8_matmul.reduce_launches,
                     "chunks": len(times), "chunk_ms_median": 1e3 * statistics.median(times),
                     "chunk_ms_p90": 1e3 * float(np.percentile(times, 90)),
                     "chunk_ms_max": 1e3 * max(times), "seconds": total,
                     "rtf": total / audio_s, "hyp_lens": [len(h) for h in hyps]}
        r = runs[cap]
        log(f"stream, cap {cap}: {r['chunks']} chunks of {STREAM_CHUNK} frames over {len(utts)} "
            f"utterances ({audio_s:.1f} s of audio): per chunk {r['chunk_ms_median']:.2f} ms "
            f"median, {r['chunk_ms_p90']:.2f} p90, {r['chunk_ms_max']:.2f} max (host clock, "
            f"each ending in the read-back of its tokens); {total:.3f} s in all, real-time "
            f"factor {r['rtf']:.4f}; int8_matmul launches {r['launches']} "
            f"({r['launches'] / r['chunks']:.1f} a chunk, expected {ENCODE_LAUNCHES}), split-K "
            f"sum passes {r['reduce_launches']}; hypothesis lengths {r['hyp_lens']}")
        if r["chunks"] != n_chunks or r["launches"] != ENCODE_LAUNCHES * n_chunks:
            raise AssertionError(f"stream, cap {cap}: {r['launches']} int8 launches over "
                                 f"{r['chunks']} chunks, expected {ENCODE_LAUNCHES} a chunk")
        if any(not 0 < tok < VOCAB for h in hyps for tok in h) or not any(hyps):
            raise AssertionError(f"stream, cap {cap}: no tokens, or a token out of range")
    served_shapes = dict(shapes)

    # float32 on the card: the whole-history stream against the chunk-masked
    # full encode of the same model (the same arithmetic cut differently:
    # 1e-4); with int8 weights, the same two under phase 4's rule (0.1, and
    # a differing best token only at a near-tie of the encode's top two)
    exact = {}
    q32 = ASRInference(model, weight_quant="int8", weight_quant_min_size=QUANT_MIN)
    hooks += count_gemm_shapes(q32.model, quant, shapes)
    for name, m, tol in (("float32", model, 1e-4), ("int8", q32.model, 0.1)):
        err, differ, decided = 0.0, 0, 0
        with torch.inference_mode():
            for u, chunks in zip(utts, streams):
                got = streamed_log_probs(m, chunks, -1)[0]
                enc_out, _ = m.encode(u, torch.tensor([u.shape[1]], device="cuda"),
                                      decoding_chunk_size=STREAM_CHUNK)
                want = m.ctc_log_probs(enc_out)[0]
                if got.shape != want.shape or not torch.isfinite(got).all():
                    raise AssertionError(f"stream {name}: {tuple(got.shape)} vs "
                                         f"{tuple(want.shape)}, or non-finite values")
                err = max(err, (got - want).abs().max().item())
                top2 = want.topk(2, dim=-1).values
                diff = got.argmax(-1) != want.argmax(-1)
                differ += diff.sum().item()
                decided += (diff & (top2[:, 0] - top2[:, 1] > 2 * tol)).sum().item()
        exact[name] = {"max_abs_err": err, "tol": tol, "frames_best_differs": differ,
                       "of_them_not_near_ties": decided}
        log(f"stream, whole history, {name} on the card vs the chunk-masked encode: log-prob "
            f"max abs err {err:.3e} (tol {tol}); frames whose best token differs {differ} "
            f"(near-ties {differ - decided})")
        if not err <= tol or decided:
            raise AssertionError(f"stream {name}: {exact[name]}")
    for h in hooks:
        h.remove()

    # the int8 GEMM at every shape the streams met, against its plain version
    gen = torch.Generator(device="cuda").manual_seed(6)
    results = []
    for (m, k, n, dtype), count in sorted(shapes.items()):
        results.append(check_int8_gemm(quant, m, k, n, getattr(torch, dtype), gen,
                                       timed=(m, k, n, dtype) in served_shapes))
        results[-1]["launches"] = count
    checked = {(r["m"], r["k"], r["n"], r["dtype"]): r for r in results}
    if set(shapes) - set(checked):
        raise AssertionError(f"stream GEMM shapes not checked: {set(shapes) - set(checked)}")
    expected_reduce = sum(n for s, n in served_shapes.items() if checked[s]["splits"] > 1)
    reduce_launches = sum(r["reduce_launches"] for r in runs.values())
    log(f"stream split-K sum pass launches {reduce_launches} (expected {expected_reduce})")
    if reduce_launches != expected_reduce:
        raise AssertionError(f"stream: split-K sum pass launched {reduce_launches} times, "
                             f"expected {expected_reduce}")
    worst = max(r["max_abs_err"] / r["tol"] for r in results)
    log(f"stream int8_matmul vs plain: {len(results)} shapes met, all agree (worst max_abs/tol "
        f"{worst:.3f}); the float32 ones (the int8 check above) untimed; the served ones: M K N "
        "splits launches | max_abs tol | kernel plain library bound (ms) | bound/kernel")
    for r in results:
        if "ms" in r:
            log(f"  {r['m']} {r['k']} {r['n']} {r['splits']} {r['launches']} | "
                f"{r['max_abs_err']:.3e} {r['tol']:.3e} | {r['ms']:.4f} {r['plain_ms']:.4f} "
                f"{r['library_ms']:.4f} {r['bound_ms']:.5f} ({r['bound_by']}) | "
                f"{r['bound_share']:.3f}")
    per_chunk = {key: sum(r[key] * served_shapes[(r["m"], r["k"], r["n"], r["dtype"])]
                          for r in results if "ms" in r) / sum(runs[c]["chunks"] for c in runs)
                 for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    log("stream int8 GEMM device time per chunk (times x launches, both caps): "
        + ", ".join(f"{key} {value:.4f}" for key, value in per_chunk.items())
        + f"; kernel / library {per_chunk['ms'] / per_chunk['library_ms']:.2f}")
    del serving, q32, model
    torch.cuda.empty_cache()
    return {"runs": {str(c): r for c, r in runs.items()}, "exact": exact,
            "gemm_ms_per_chunk": per_chunk, "shapes_checked": len(results),
            "worst_err_over_tol": worst}, results


def recipe_phase(ctc_dp):
    """Phase 9: the Conformer recipe (``mindaudio_torch/recipes/conformer``)
    as a user runs it, at the full width and depth of ``conformer.yaml``, on
    a small cipher corpus in a temporary directory: CMVN stats, training with
    dev-scored checkpoints, a resumed run in the same process, a best-2
    average, two decodes, and the streaming decode of a short causal-conv
    run. Returns ``(ctc launches, summary)``."""
    import tempfile

    from mindaudio_torch.recipes.conformer import compute_cmvn_stats, convergence_run
    from mindaudio_torch.recipes.conformer import predict as rpredict
    from mindaudio_torch.recipes.conformer import train as rtrain
    from mindaudio_torch.scheduler.schedules import asr_warmup_lr
    from mindaudio_torch.train import checkpoint

    with tempfile.TemporaryDirectory(prefix="chip_smoke_recipe_") as root:
        t = time.perf_counter()
        convergence_run.gen(root, n_train=RECIPE_UTTS[0], n_dev=RECIPE_UTTS[1],
                            n_test=RECIPE_UTTS[2])
        gen_s = time.perf_counter() - t
        ckpt_dir = f"{root}/ckpt"
        # the convergence run's flags; batch_factor 0.67 puts 64 utterances in
        # the 227-frame bucket (the run's 1.34 would put 128, more than the dev set)
        extra = ["--data.batch_factor", "0.67", "--train.log_every_steps", "10",
                 "--train.save_every_steps", str(RECIPE_SAVE_EVERY),
                 "--train.keep_checkpoint_max", "4"]

        def args(max_steps):
            return convergence_run._args(root, max_steps) + extra

        t = time.perf_counter()
        compute_cmvn_stats.main(args(RECIPE_STEPS))
        cmvn_s = time.perf_counter() - t
        cfg, _ = rtrain.parse_args(args(RECIPE_STEPS))
        schedule = asr_warmup_lr(cfg.optim.lr, cfg.optim.warmup_steps)

        ctc_dp.ctc_dp_fwd.launches = ctc_dp.ctc_dp_bwd.launches = 0
        t = time.perf_counter()
        first = rtrain.main(args(RECIPE_STEPS))
        train_s = time.perf_counter() - t
        launches = (ctc_dp.ctc_dp_fwd.launches, ctc_dp.ctc_dp_bwd.launches)
        saved = checkpoint.list_steps(ckpt_dir)
        t = time.perf_counter()
        second = rtrain.main(args(RECIPE_STEPS + RECIPE_RESUME_STEPS))
        resume_s = time.perf_counter() - t
        launches = (ctc_dp.ctc_dp_fwd.launches, ctc_dp.ctc_dp_bwd.launches,
                    launches[0], launches[1])
        steps = first["steps"] + second["steps"]
        evals = len(first["dev_losses"]) + len(second["dev_losses"])
        log(f"recipe: gen {sum(RECIPE_UTTS)} utterances {gen_s:.1f} s, CMVN {cmvn_s:.1f} s; "
            f"train {first['steps']} steps {train_s:.1f} s, dev loss "
            f"{first['dev_losses']}, steps saved {saved}; resumed at global step "
            f"{second['start_step']} (lr {second['first_lr']:.6e}) for {second['steps']} "
            f"steps {resume_s:.1f} s, dev loss {second['dev_losses']}, steps saved "
            f"{checkpoint.list_steps(ckpt_dir)}")
        log(f"recipe: ms per step (host clock, 10 steps ending in the metrics' read-back) "
            f"{' / '.join(f'{v:.2f}' for v in first['window_ms'] + second['window_ms'])} at "
            f"B=64 x 227 frames, full width and depth, bf16 autocast")
        log(f"recipe: ctc_dp_fwd launches {launches[0]}, ctc_dp_bwd launches {launches[1]} "
            f"over {steps} train steps and {evals} dev evaluations of one batch")
        if launches[:2] != (steps + evals, steps) or launches[2:] != (
                first["steps"] + len(first["dev_losses"]), first["steps"]):
            raise AssertionError(f"recipe: CTC launches {launches}, expected one forward and "
                                 f"one backward a train step, one forward a dev batch")
        if (first["steps"], second["steps"]) != (RECIPE_STEPS, RECIPE_RESUME_STEPS):
            raise AssertionError(f"recipe: ran {first['steps']} and {second['steps']} steps")
        if second["start_step"] != RECIPE_STEPS or saved[-1] != RECIPE_STEPS:
            raise AssertionError(f"recipe: resumed at {second['start_step']}, last save {saved}")
        if abs(second["first_lr"] - float(schedule(RECIPE_STEPS))) > 1e-12:
            raise AssertionError(f"recipe: the schedule did not continue: {second['first_lr']}")
        final = checkpoint.restore_checkpoint(ckpt_dir)
        if not (int(final["step"]) == int(final["opt_state"]["count"])
                == RECIPE_STEPS + RECIPE_RESUME_STEPS == checkpoint.list_steps(ckpt_dir)[-1]):
            raise AssertionError("recipe: the last checkpoint's step, count and name differ")
        dev = list(first["dev_losses"].values()) + list(second["dev_losses"].values())
        if not np.isfinite(dev).all():
            raise AssertionError(f"recipe: a dev loss is not finite: {dev}")

        # the best-2 average against the mean of the two files
        best = rpredict.select_steps(ckpt_dir, 2)
        avg = checkpoint.average_checkpoints(ckpt_dir, best)
        a, b = (checkpoint.restore_checkpoint(ckpt_dir, s) for s in best)
        worst = 0.0
        for name, p in avg["params"].items():
            mean = (a["params"][name].double() + b["params"][name].double()) / 2
            worst = max(worst, (p.double() - mean).abs().max().item()
                        / max(mean.abs().max().item(), 1e-30))
        mu = next(iter(avg["opt_state"]["mu"].values()))
        if not (worst <= 2.0**-24 and mu.dtype == torch.bfloat16
                and torch.equal(avg["step"], b["step"])
                and torch.equal(avg["rng"]["dropout"], b["rng"]["dropout"])):
            raise AssertionError(f"recipe: the average of {best} is not the mean of the files "
                                 f"(worst relative error {worst})")
        ckpt_bytes = os.path.getsize(os.path.join(ckpt_dir, f"step_{best[-1]}",
                                                  checkpoint.STATE_FILE))
        log(f"recipe: best-2 by dev loss {best}: average within {worst:.2e} of the files' "
            f"float64 mean (relative), bf16 moments stay bf16, step and generators from step "
            f"{best[-1]}; {ckpt_bytes} bytes a checkpoint")
        del avg, a, b, final

        # streaming decodes a model with a causal conv: a short run of the
        # streaming-ready model (causal conv, sampled chunk masks) into a
        # checkpoint directory of its own, decoded from its last checkpoint
        stream_flags = ["--model.causal_conv", "true", "--model.use_dynamic_chunk", "true",
                        "--train.ckpt_dir", f"{root}/ckpt_stream"]
        t = time.perf_counter()
        causal = rtrain.main(args(RECIPE_STREAM_STEPS) + stream_flags)
        causal_s = time.perf_counter() - t
        log(f"recipe: the causal-conv model trained {causal['steps']} steps, {causal_s:.1f} s "
            f"(steps saved {checkpoint.list_steps(f'{root}/ckpt_stream')})")
        if causal["steps"] != RECIPE_STREAM_STEPS:
            raise AssertionError(f"recipe: the causal-conv run took {causal['steps']} steps")

        cers = {}
        for mode, flags in (("ctc_greedy", ["--decode.average_num", "2"]),
                            ("attention_rescoring", ["--decode.average_num", "2"]),
                            ("streaming", ["--decode.average_num", "1"] + stream_flags)):
            t = time.perf_counter()
            cers[mode] = rpredict.main(args(0) + flags + ["--decode.mode", mode])
            what = "best-2 average" if mode != "streaming" else "the causal-conv model"
            log(f"recipe: decode {mode} of {RECIPE_UTTS[2]} test utterances, {what}: "
                f"CER {100 * cers[mode]:.2f}% (not judged this early), "
                f"{time.perf_counter() - t:.1f} s")
            with open(f"{root}/result.txt", encoding="utf-8") as f:
                lines = f.read().splitlines()
            if len(lines) != RECIPE_UTTS[2] or not 0 <= cers[mode] < float("inf"):
                raise AssertionError(f"recipe: decode {mode}: {len(lines)} lines, CER {cers[mode]}")
    torch.cuda.empty_cache()
    return launches, {"steps": steps, "window_ms": first["window_ms"] + second["window_ms"],
                      "dev_losses": dev, "cer": cers, "checkpoint_bytes": ckpt_bytes}


def step_ms(step, batch, n):
    """ms per train step on one fixed ``batch`` on the card (host clock,
    ``n`` steps after two warm-up steps, ending in the loss's read-back),
    with cuDNN's TF32 off and then on; the matrix products' TF32 stays off
    (PyTorch's default)."""
    out = {}
    try:
        for tf32 in (False, True):
            torch.backends.cudnn.allow_tf32 = tf32
            for _ in range(2):
                step(batch)
            float(step(batch)["loss"])
            t = time.perf_counter()
            for _ in range(n):
                metrics = step(batch)
            loss = float(metrics["loss"])
            out["tf32_on" if tf32 else "tf32_off"] = {
                "ms": 1e3 * (time.perf_counter() - t) / n, "loss": loss}
    finally:
        torch.backends.cudnn.allow_tf32 = False
    return out


def card_against_cpu(label, build, make_optimizer, make_step, batch, key, to_device, stated,
                     stats=None):
    """One deterministic float32 train step at full width, cuDNN TF32 off:
    the card against the CPU, from the same weights (``build(device)``) and
    the same running AdamW state (count 3, seeded moments, so that the
    update is smooth in the gradient). ``make_step(model, optimizer)`` is
    the recipe's step; ``to_device(batch, device)`` moves the numpy
    ``batch``; ``stats(model)``, where given, lists tensors that the step
    updates in place (running statistics), held like the updates.

    The CPU step runs three times: on the batch, and with every sample of
    ``batch[key]`` moved one float32 ulp up or down (two draws); how far
    those move the CPU's own results is float32's spread for this batch.
    The loss and the gradient norm (relative errors) are held to the
    ``stated`` tolerance or 4x their spread, the larger. Each update is
    held to ``stated["update"]`` of its own leaf's largest update or 4x that
    leaf's own spread, the larger, and each statistic likewise. The worst
    ratio of error to limit is printed with its leaf and the limit that
    applied there. Returns the errors, the spreads and the limits."""
    rng = np.random.default_rng(13)
    card = build("cuda").train()
    init = copy.deepcopy(card).cpu()
    names = {"update": [n for n, _ in card.named_parameters()]}
    if stats:
        ids = {id(b): n for n, b in card.named_buffers()}
        names["stats"] = [ids[id(b)] for b in stats(card)]
    moments = {"count": 3,
               "mu": {n: torch.from_numpy(0.01 * rng.standard_normal(p.shape).astype(np.float32))
                      for n, p in card.named_parameters()},
               "nu": {n: torch.from_numpy((1e-4 * (1 + rng.random(p.shape))).astype(np.float32))
                      for n, p in card.named_parameters()}}
    x = batch[key]
    ulp = np.spacing(np.abs(x)).astype(np.float32)
    runs = [("card", card, "cuda", x), ("cpu", init, "cpu", x)] + [
        (f"cpu_ulp{seed}", copy.deepcopy(init), "cpu",
         x + ulp * np.random.default_rng(seed).choice([-1.0, 1.0], x.shape).astype(np.float32))
        for seed in (1, 2)]
    out = {}
    for run, model, device, xs in runs:
        opt = make_optimizer(model)
        opt.load_state_dict(moments)
        before = [p.detach().clone() for p in model.parameters()]
        metrics = make_step(model, opt)(to_device(dict(batch, **{key: xs}), device))
        out[run] = {"loss": metrics["loss"].item(), "grad_norm": metrics["grad_norm"].item(),
                    "update": [(p.detach() - b).cpu() for p, b in zip(model.parameters(), before)]}
        if stats:
            out[run]["stats"] = [t.cpu() for t in stats(model)]

    def errors(a, b):
        return ({k: abs(a[k] - b[k]) / abs(b[k]) for k in ("loss", "grad_norm")},
                {k: np.array([((x - y).abs().max() / y.abs().max()).item()
                              for x, y in zip(a[k], b[k])]) for k in names})

    a, b = out["card"], out["cpu"]
    err, err_t = errors(a, b)
    spreads = [errors(out[f"cpu_ulp{seed}"], b) for seed in (1, 2)]
    spread = {k: max(s[0][k] for s in spreads) for k in err}
    tols = {k: max(stated[k], 4 * spread[k]) for k in err}
    applied = {k: "stated" if tols[k] == stated[k] else "4x spread" for k in err}
    per_leaf = {}
    for k in names:
        leaf_spread = np.maximum(*(s[1][k] for s in spreads))
        limit = np.maximum(stated[k], 4 * leaf_spread)
        i = int(np.argmax(err_t[k] / limit))
        per_leaf[k] = {"worst_ratio": float(err_t[k][i] / limit[i]), "worst": names[k][i],
                       "error": float(err_t[k][i]), "spread": float(leaf_spread[i]),
                       "limit": float(limit[i]),
                       "applied": "stated" if limit[i] == stated[k] else "4x spread",
                       "largest_error": float(err_t[k].max()),
                       "largest_in": names[k][int(np.argmax(err_t[k]))],
                       "leaves": len(names[k]), "spread_applied": int((limit > stated[k]).sum())}
    log(f"{label}, card vs CPU: loss {a['loss']:.6f} vs {b['loss']:.6f}, grad_norm "
        f"{a['grad_norm']:.4f} vs {b['grad_norm']:.4f}; error | the CPU's spread over one-ulp "
        "input moves | stated tol | tol (which applied): "
        + ", ".join(f"{k} {err[k]:.3e} | {spread[k]:.3e} | {stated[k]} | {tols[k]:.3e} "
                    f"({applied[k]})" for k in err)
        + "".join(f"; {k}, each leaf against its own limit (stated {stated[k]} of the leaf's "
                  f"largest, or 4x its spread): worst error/limit {v['worst_ratio']:.3f} in "
                  f"{v['worst']} (error {v['error']:.3e}, spread {v['spread']:.3e}, limit "
                  f"{v['limit']:.3e}, {v['applied']}), largest error {v['largest_error']:.3e} in "
                  f"{v['largest_in']}, 4x spread applied to {v['spread_applied']} of "
                  f"{v['leaves']} leaves" for k, v in per_leaf.items()))
    if not all(err[k] <= tols[k] for k in err) or any(
            v["worst_ratio"] > 1 for v in per_leaf.values()):
        raise AssertionError(f"{label}: card and CPU steps differ: {err}, tolerances {tols}, "
                             f"per leaf {per_leaf}")
    return {"errors": err, "cpu_spread": spread, "stated_tolerances": stated,
            "tolerances": tols, "applied": applied, "per_leaf": per_leaf,
            "loss": [a["loss"], b["loss"]]}


def ds2_batch_to(batch, device):
    """A DeepSpeech2 numpy batch as tensors on ``device`` (int32 → int64)."""
    return {k: (torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v))
            .to(device) for k, v in batch.items() if k != "n_valid"}


def ds2_card_against_cpu(ds_train, cfg):
    """Phase 11's float32 step at full width, B=2 (390 and 300 frames in the
    400 bucket): the card with the CTC kernels against the CPU with the
    plain recursion (:func:`card_against_cpu`). The stated tolerances: the
    losses as phase 8 holds them (1e-4 relative), the gradient norm 1e-3;
    an update differs from the CPU's by the gradients' error through Adam's
    smooth quotient (1e-2 of the leaf's largest update); the running
    statistics carry the activations' error (1e-4 of the leaf's largest)."""
    from mindaudio_torch.models.layers import running_stats
    from mindaudio_torch.recipes.deepspeech2 import dataset as ds
    from mindaudio_torch.recipes.deepspeech2 import synthetic

    rng = np.random.default_rng(11)
    wavs = np.zeros((2, 400 * ds.HOP), np.float32)
    labels = np.zeros((2, ds.MAX_LABEL_LEN), np.int32)
    wav_lens, label_lens = np.zeros(2, np.int32), np.zeros(2, np.int32)
    for i, frames in enumerate((390, 300)):
        wav, text = synthetic._utterance(rng, frames)
        ids = [ds.CHAR2ID[c] for c in text]
        wavs[i, :len(wav)], wav_lens[i] = wav, len(wav)
        labels[i, :len(ids)], label_lens[i] = ids, len(ids)
    return card_against_cpu(
        "deepspeech2: one float32 step at full width, B=2, ctc kernels on the card, the plain "
        "recursion on the CPU", lambda device: ds_train.build_model(cfg, device),
        lambda model: ds_train.make_optimizer(cfg, model),
        lambda model, opt: ds_train.make_step(cfg, model, opt),
        {"wavs": wavs, "wav_lens": wav_lens, "labels": labels, "label_lens": label_lens},
        "wavs", ds2_batch_to, {"loss": 1e-4, "grad_norm": 1e-3, "update": 1e-2, "stats": 1e-4},
        stats=running_stats)


def deepspeech2_phase(ctc_dp):
    """Phase 11: the DeepSpeech2 recipe (``mindaudio_torch/recipes/deepspeech2``)
    as a user runs it, at the full width of ``deepspeech2.yaml``, on a
    synthetic corpus in LibriSpeech's layout in a temporary directory:
    ``train.main()`` with saves, ``eval.main()``, the step's time with cuDNN
    TF32 off and on, and one float32 step against the CPU. Returns
    ``(ctc launches, summary)``."""
    import tempfile

    from mindaudio_torch.recipes.deepspeech2 import dataset as ds
    from mindaudio_torch.recipes.deepspeech2 import eval as ds_eval
    from mindaudio_torch.recipes.deepspeech2 import synthetic
    from mindaudio_torch.recipes.deepspeech2 import train as ds_train
    from mindaudio_torch.train import checkpoint

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ds2_") as root:
        t = time.perf_counter()
        train_json, test_json = synthetic.gen(root, n_train=DS2_BATCH, n_test=DS2_BATCH)
        gen_s = time.perf_counter() - t
        ckpt_dir = f"{root}/ckpt"
        args = ["--data.train_manifest", train_json, "--data.test_manifest", test_json,
                "--data.batch_size", str(DS2_BATCH), "--train.ckpt_dir", ckpt_dir,
                "--train.max_steps", str(DS2_STEPS),
                "--train.log_every_steps", "1", "--train.save_every_steps", str(DS2_SAVE_EVERY),
                "--optim.epochs", str(-(-DS2_STEPS // 3))]
        cfg, _ = ds_train.parse_args(args)
        ctc_dp.ctc_dp_fwd.launches = ctc_dp.ctc_dp_bwd.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = ds_train.main(args)
        train_s = time.perf_counter() - t
        launches = (ctc_dp.ctc_dp_fwd.launches, ctc_dp.ctc_dp_bwd.launches)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        losses, buckets = out["losses"], out["buckets"]
        saved = checkpoint.list_steps(ckpt_dir)
        ckpt_bytes = os.path.getsize(os.path.join(ckpt_dir, f"step_{saved[-1]}",
                                                  checkpoint.STATE_FILE))
        final = checkpoint.restore_checkpoint(ckpt_dir)
        log(f"deepspeech2: gen {3 * DS2_BATCH} + {DS2_BATCH} utterances {gen_s:.1f} s; train "
            f"{out['steps']} steps {train_s:.1f} s at B={DS2_BATCH}, full width "
            f"({sum(t.numel() for t in final['params'].values()) / 1e6:.2f} M params), float32; "
            f"peak memory {peak_gib:.2f} GiB; steps saved {saved}, {ckpt_bytes} bytes a "
            f"checkpoint with {len(final['buffers'])} running statistics")
        log("deepspeech2: loss per step (bucket) " + " ".join(
            f"{losses[s]:.2f} ({buckets[s]})" for s in sorted(losses)))
        log(f"deepspeech2: ctc_dp_fwd launches {launches[0]}, ctc_dp_bwd launches {launches[1]} "
            f"over {out['steps']} train steps (expected one each a step)")
        first_bucket = buckets[1]
        same = [s for s in sorted(losses) if buckets[s] == first_bucket]
        if out["steps"] != DS2_STEPS or launches != (DS2_STEPS, DS2_STEPS):
            raise AssertionError(f"deepspeech2: {out['steps']} steps, CTC launches {launches}")
        if not np.isfinite(list(losses.values())).all():
            raise AssertionError(f"deepspeech2: a loss is not finite: {losses}")
        if set(buckets.values()) != {800, 1250, 2000} or len(same) < 2:
            raise AssertionError(f"deepspeech2: buckets met {buckets}")
        if not losses[same[-1]] < losses[same[0]]:
            raise AssertionError(f"deepspeech2: the loss in the {first_bucket} bucket did not "
                                 f"fall: {[losses[s] for s in same]}")
        if saved != [DS2_SAVE_EVERY, DS2_STEPS] or int(final["step"]) != DS2_STEPS or len(
                final["buffers"]) != 14:
            raise AssertionError(f"deepspeech2: checkpoints {saved}, step {int(final['step'])}, "
                                 f"{len(final['buffers'])} buffers")
        del final

        t = time.perf_counter()
        result = ds_eval.main(args)
        eval_s = time.perf_counter() - t
        log(f"deepspeech2: eval of {result['utts']} test utterances (3500-frame bucket) "
            f"{eval_s:.1f} s: CER {100 * result['cer']:.2f}% WER {100 * result['wer']:.2f}% "
            "(not judged after 20 steps)")
        if result["utts"] != DS2_BATCH or not 0 <= result["cer"] < float("inf"):
            raise AssertionError(f"deepspeech2: eval {result}")

        batch = next(b for _, b in ds.batch_iterator(train_json, DS2_BATCH, shuffle=False)
                     if b["wavs"].shape[1] // ds.HOP == 1250)
        model = ds_train.build_model(cfg, "cuda").train()
        timing = step_ms(ds_train.make_step(cfg, model, ds_train.make_optimizer(cfg, model)),
                         ds2_batch_to(batch, "cuda"), DS2_TIMED_STEPS)
        del model
        log(f"deepspeech2: ms per step at B={DS2_BATCH} x 1250 frames (T' = 626; host clock, "
            f"{DS2_TIMED_STEPS} steps ending in a read-back): cuDNN TF32 off "
            f"{timing['tf32_off']['ms']:.2f}, on {timing['tf32_on']['ms']:.2f}; "
            f"recipe log windows {' / '.join(f'{v:.1f}' for v in out['window_ms'])}")
    check = ds2_card_against_cpu(ds_train, cfg)
    torch.cuda.empty_cache()
    return launches, {"steps": out["steps"], "losses": losses, "buckets": buckets,
                      "window_ms": out["window_ms"], "step_ms_1250": timing,
                      "peak_gib": peak_gib, "checkpoint_bytes": ckpt_bytes, "eval": result,
                      "card_against_cpu": check}


def ecapa_host_ms(ds, cfg):
    """The host's ms per batch of ``ECAPA_BATCH``, measured apart from the
    card: the collate (WAV reads and random crops) and the augmentation
    (speed perturbation, ``drop_freq``, ``drop_chunk``), over
    ``ECAPA_HOST_BATCHES`` batches."""
    it = ds.batch_iterator(cfg.data.train_csv, ECAPA_BATCH, seg_dur=float(cfg.data.seg_dur),
                           epochs=ECAPA_HOST_BATCHES)
    aug = ds.Augmenter(cfg, np.random.default_rng(1))
    collate, augment = [], []
    for _ in range(ECAPA_HOST_BATCHES):
        t = time.perf_counter()
        _, batch = next(it)
        collate.append(1e3 * (time.perf_counter() - t))
        t = time.perf_counter()
        aug(batch["wavs"])
        augment.append(1e3 * (time.perf_counter() - t))
    return {"collate_ms": collate, "augment_ms": augment,
            "total_ms": statistics.median(c + a for c, a in zip(collate, augment))}


def ecapa_card_against_cpu(tse, cfg, n_classes, wavs, labels):
    """Phase 12's float32 step at full width, B=2 (:func:`card_against_cpu`),
    at a learning rate of 0.01 (the schedule's 1e-6 at count 3 would move a
    parameter by a few of its float32 ulps, and the update would measure
    their rounding). A batch norm over two rows (``asp_bn`` normalizes 2
    values a channel) turns one rounding of the input into up to 1e-4 of
    the loss, which the one-ulp spread measures. The stated tolerances:
    float32 on both sides, sums in another order (cuDNN's convs against the
    CPU's)."""
    from mindaudio_torch.models.layers import running_stats

    cfg = copy.deepcopy(cfg)
    cfg.optim.min_lr = cfg.optim.max_lr = 0.01
    check = card_against_cpu(
        "ecapa: one float32 step at full width, B=2",
        lambda device: tse.build_model(cfg, device, n_classes),
        lambda model: tse.make_optimizer(cfg, model),
        lambda model, opt: tse.make_step(cfg, model, opt), {"wavs": wavs, "labels": labels},
        "wavs", lambda b, device: {"wavs": torch.from_numpy(b["wavs"]).to(device),
                                   "labels": torch.from_numpy(b["labels"]).long().to(device)},
        {"loss": 1e-5, "grad_norm": 1e-4, "update": 1e-3, "stats": 1e-4}, stats=running_stats)
    if check["per_leaf"]["stats"]["leaves"] != 62:
        raise AssertionError(f"ecapa: {check['per_leaf']['stats']['leaves']} running statistics")
    return check


def ecapa_phase(launch_counters, card):
    """Phase 12: the ECAPA-TDNN recipe (``mindaudio_torch/recipes/ecapa_tdnn``)
    as a user runs it, at the full width of ``ecapatdnn.yaml``, on the
    convergence corpus in a temporary directory: ``train_speaker_embeddings
    .main()`` with augmentation on and a save, ``speaker_verification_cosine
    .main()`` with s-norm and without, the checkpoint restored to the same
    embeddings, the step's time with cuDNN TF32 off and on, the host's
    collate and augmentation, the embedding time of a bucket batch, and one
    float32 step and one bucket's embeddings against the CPU.
    ``launch_counters`` are the port's kernel wrappers: the path runs none of
    them. Every measured line names ``card`` (the card's name and power
    limit). Returns the summary."""
    import tempfile

    from mindaudio_torch.recipes.ecapa_tdnn import convergence_run, dataset
    from mindaudio_torch.recipes.ecapa_tdnn import speaker_verification_cosine as sv
    from mindaudio_torch.recipes.ecapa_tdnn import train_speaker_embeddings as tse
    from mindaudio_torch.train import checkpoint

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ecapa_") as root:
        t = time.perf_counter()
        convergence_run.make_corpus(root, ECAPA_SPEAKERS, n_train=ECAPA_TRAIN,
                                    n_enrol=ECAPA_EVAL, n_test=ECAPA_EVAL)
        gen_s = time.perf_counter() - t
        ckpt_dir = f"{root}/ckpt"
        # the recipe's flags, with the convergence protocol's peak learning
        # rate reached at step 10 (the YAML's cycle is 65,000 steps long)
        args = ["--data.train_csv", f"{root}/train.csv", "--data.enrol_csv", f"{root}/enrol.csv",
                "--data.test_csv", f"{root}/test.csv", "--data.veri_pairs",
                f"{root}/veri_pairs.txt", "--train.ckpt_dir", ckpt_dir,
                "--train.max_steps", str(ECAPA_STEPS), "--train.log_every_steps", "1",
                "--train.save_every_steps", str(ECAPA_STEPS),
                "--optim.epochs", str(ECAPA_STEPS), "--optim.max_lr", "0.001",
                "--optim.cycle_steps", str(ECAPA_STEPS // 2), "--eval.cohort_size", "64"]
        cfg, _ = tse.parse_args(args)
        n_classes = dataset.n_speakers(cfg.data.train_csv)
        if (int(cfg.data.batch_size), tuple(cfg.model.channels), n_classes) != (
                ECAPA_BATCH, (512, 512, 512, 512, 1536), ECAPA_SPEAKERS):
            raise AssertionError(f"ecapa: not the full-width recipe: {cfg.model}, {n_classes}")
        for counter in launch_counters:
            counter.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = tse.main(args)
        train_s = time.perf_counter() - t
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        model, losses, window_ms = out["model"], out["losses"], out["window_ms"]
        saved = checkpoint.list_steps(ckpt_dir)
        ckpt_bytes = os.path.getsize(os.path.join(ckpt_dir, f"step_{saved[-1]}",
                                                  checkpoint.STATE_FILE))
        final = checkpoint.restore_checkpoint(ckpt_dir)
        n_params = sum(t.numel() for t in final["params"].values())
        log(f"ecapa: gen {ECAPA_SPEAKERS} speakers x {ECAPA_TRAIN + 2 * ECAPA_EVAL} utterances "
            f"{gen_s:.1f} s; train {out['steps']} steps {train_s:.1f} s at B={ECAPA_BATCH} x 3 s, "
            f"full width ({n_params / 1e6:.3f} M params, {len(final['buffers'])} running "
            f"statistics), augmentation on; peak memory {peak_gib:.2f} GiB; steps saved {saved}, "
            f"{ckpt_bytes} bytes a checkpoint ({card})")
        log("ecapa: loss per step " + " ".join(f"{losses[s]:.3f}" for s in sorted(losses)))
        log("ecapa: the recipe's ms per step (host clock, each step ending in the loss's "
            "read-back, the collate and augmentation in the prefetch thread): "
            + " ".join(f"{v:.1f}" for v in window_ms)
            + f"; median {statistics.median(window_ms):.1f} ({card})")
        stats_finite = all(torch.isfinite(b).all().item() for b in final["buffers"].values())
        if out["steps"] != ECAPA_STEPS or len(losses) != ECAPA_STEPS:
            raise AssertionError(f"ecapa: {out['steps']} steps, losses {losses}")
        if not np.isfinite(list(losses.values())).all():
            raise AssertionError(f"ecapa: a loss is not finite: {losses}")
        if not losses[ECAPA_STEPS] < losses[1]:
            raise AssertionError(f"ecapa: the loss did not fall: {losses[1]} -> "
                                 f"{losses[ECAPA_STEPS]}")
        if not stats_finite or len(final["buffers"]) != 62 or saved != [ECAPA_STEPS]:
            raise AssertionError(f"ecapa: running statistics finite {stats_finite}, "
                                 f"{len(final['buffers'])} buffers, steps saved {saved}")
        launches = {c.__name__: c.launches for c in launch_counters}
        log(f"ecapa: kernel launches over the train run {launches} (the path has no TPU kernel: "
            "its fbank is plain PyTorch, as the JAX package's is XLA)")
        if any(launches.values()):
            raise AssertionError(f"ecapa: a kernel launched on the ECAPA path: {launches}")

        t = time.perf_counter()
        eer_cos = sv.main(args + ["--eval.score_norm", "false"])
        cos_s = time.perf_counter() - t
        t = time.perf_counter()
        eer_snorm = sv.main(args + ["--eval.score_norm", "true"])
        snorm_s = time.perf_counter() - t
        n_eval = ECAPA_SPEAKERS * ECAPA_EVAL
        log(f"ecapa: verification, {n_eval} x {n_eval} trials: EER {100 * eer_cos:.2f}% cosine "
            f"({cos_s:.1f} s), {100 * eer_snorm:.2f}% adaptive s-norm against the "
            f"{ECAPA_SPEAKERS * ECAPA_TRAIN} training utterances, top 64 ({snorm_s:.1f} s); "
            "not judged after 20 steps")
        if not (0 <= eer_cos <= 1 and 0 <= eer_snorm <= 1):
            raise AssertionError(f"ecapa: EERs {eer_cos}, {eer_snorm}")

        # the checkpoint restores to the same embeddings; one 8 s bucket batch
        # of mixed lengths, timed, then against the CPU
        rows = dataset.read_segments(cfg.data.test_csv)[0][:sv.BATCH]
        waves = [sv._read_full(r) for r in rows]
        blen = max(sv._bucket_len(len(x)) for x in waves)
        wavs = np.zeros((sv.BATCH, blen), np.float32)
        lens = np.full(sv.BATCH, 1, np.int32)
        for i, x in enumerate(waves):
            wavs[i, :len(x)], lens[i] = x, len(x)
        restored = sv.load_model(cfg, "cuda")
        embed = sv.make_embed_fn(restored, cfg)
        emb_restored = embed(wavs, lens)
        emb_trained = sv.make_embed_fn(model, cfg)(wavs, lens)
        restore_err = float(np.abs(emb_restored - emb_trained).max())
        t = time.perf_counter()
        for _ in range(ECAPA_TIMED_STEPS):
            embed(wavs, lens)
        embed_ms = 1e3 * (time.perf_counter() - t) / ECAPA_TIMED_STEPS
        emb_cpu = sv.make_embed_fn(copy.deepcopy(restored).cpu(), cfg)(wavs, lens)
        embed_err = float(np.abs(emb_restored - emb_cpu).max())
        log(f"ecapa: embeddings of a {sv.BATCH} x {blen / 16000:.0f} s bucket batch (lengths "
            f"{lens.min() / 16000:.2f}-{lens.max() / 16000:.2f} s): {embed_ms:.2f} ms a batch "
            f"(host clock, ending in the copy to the host); restored checkpoint vs the trained "
            f"model max abs err {restore_err:.3e} (tol 1e-6); card vs CPU {embed_err:.3e} "
            f"(tol 1e-4) ({card})")
        if not restore_err <= 1e-6 or not embed_err <= 1e-4:
            raise AssertionError(f"ecapa: embeddings differ: restored {restore_err}, "
                                 f"cpu {embed_err}")
        del model, restored, out

        host = ecapa_host_ms(dataset, cfg)
        log(f"ecapa: the host's ms per batch of {ECAPA_BATCH} x 3 s (apart from the card): "
            f"collate {' '.join(f'{v:.1f}' for v in host['collate_ms'])}, augmentation "
            f"{' '.join(f'{v:.1f}' for v in host['augment_ms'])}; median total "
            f"{host['total_ms']:.1f} ({card})")
        _, batch = next(dataset.batch_iterator(cfg.data.train_csv, ECAPA_BATCH,
                                               augmenter=dataset.Augmenter(
                                                   cfg, np.random.default_rng(0))))
        model = tse.build_model(cfg, "cuda", n_classes).train()
        timing = step_ms(tse.make_step(cfg, model, tse.make_optimizer(cfg, model)),
                         {"wavs": torch.from_numpy(batch["wavs"]).cuda(),
                          "labels": torch.from_numpy(batch["labels"]).long().cuda()},
                         ECAPA_TIMED_STEPS)
        del model
        log(f"ecapa: ms per step at B={ECAPA_BATCH} x 3 s on one batch (host clock, "
            f"{ECAPA_TIMED_STEPS} steps ending in a read-back): cuDNN TF32 off "
            f"{timing['tf32_off']['ms']:.2f}, on {timing['tf32_on']['ms']:.2f} ({card})")
        check = ecapa_card_against_cpu(tse, cfg, n_classes, batch["wavs"][:2],
                                       batch["labels"][:2])
    torch.cuda.empty_cache()
    return {"steps": ECAPA_STEPS, "losses": losses, "window_ms": window_ms, "params": n_params,
            "peak_gib": peak_gib, "checkpoint_bytes": ckpt_bytes,
            "eer": {"cosine": eer_cos, "snorm": eer_snorm}, "step_ms": timing, "host_ms": host,
            "embed_ms": embed_ms, "launches": launches, "card_against_cpu": check}


def sep_batch_to(batch, device):
    """A separation numpy batch as tensors on ``device`` (lengths int64)."""
    return {k: torch.from_numpy(v).long().to(device) if k == "lengths"
            else torch.from_numpy(v).to(device) for k, v in batch.items()}


def sep_latency_ms(model, separate_fn, mix):
    """ms to separate ``mix`` (host clock from the copy to the card to the
    sources' copy back, median of ``SEP_TIMED_STEPS`` after a warm-up)."""
    model.eval()
    times = []
    with torch.no_grad():
        for i in range(SEP_TIMED_STEPS + 1):
            t = time.perf_counter()
            separate_fn(model, torch.from_numpy(mix).cuda()).cpu()
            if i:
                times.append(1e3 * (time.perf_counter() - t))
    model.train()
    return statistics.median(times)


def sep_card_against_cpu(name, recipe, cfg, separate_fn, batch):
    """Phase 13's float32 step of the recipe at full width, B=2 x 4 s
    (:func:`card_against_cpu`), at a learning rate of 0.01 (against 1e-3 an
    update would be a few float32 ulps of some parameters). The stated
    tolerances: loss 1e-5 relative, each update 1e-4 of its leaf's largest,
    the gradient norm 1e-4."""
    from mindaudio_torch.recipes.conv_tasnet import train as conv_train

    cfg = copy.deepcopy(cfg)
    cfg.optim.lr = 0.01
    return card_against_cpu(
        f"{name}: one float32 step at full width, B=2 x 4 s",
        lambda device: recipe.build_model(cfg, device),
        lambda model: conv_train.make_optimizer(cfg, model),
        lambda model, opt: conv_train.make_step(cfg, model, opt, separate_fn), batch, "mix",
        sep_batch_to, {"loss": 1e-5, "grad_norm": 1e-4, "update": 1e-4})


def separation_model_phase(name, recipe, evaluator, separate_fn, steps, n_params, root,
                           launch_counters, card):
    """One model of phase 13: ``recipe.main()`` for ``steps`` steps at the
    full width and batch of its YAML on the corpus under ``root``, with a
    save at the last step, ``evaluator.main()`` on the 4 test mixtures of
    ``root/tt4``, then the timings and the float32 step against the CPU.
    Returns the summary."""
    from mindaudio_torch.data.librimix import separation_batch_iterator
    from mindaudio_torch.recipes.conv_tasnet import train as conv_train
    from mindaudio_torch.train import checkpoint

    ckpt_dir = f"{root}/ckpt_{name}"
    args = ["--data.train_dir", f"{root}/tr", "--data.test_dir", f"{root}/tt4",
            "--train.ckpt_dir", ckpt_dir, "--train.max_steps", str(steps),
            "--train.log_every_steps", "1", "--train.save_every_steps", str(steps)]
    cfg, _ = recipe.parse_args(args)
    seg = int(float(cfg.data.segment_seconds) * int(cfg.data.sample_rate))
    if (int(cfg.data.batch_size), seg) != (SEP_BATCH, SEP_SAMPLES):
        raise AssertionError(f"{name}: not the recipe's batch: {cfg.data}")
    for counter in launch_counters:
        counter.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out = recipe.main(args)
    train_s = time.perf_counter() - t
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    t = time.perf_counter()
    scores = evaluator.main(args)
    eval_s = time.perf_counter() - t
    launches = {c.__name__: c.launches for c in launch_counters}

    model, losses, window_ms = out["model"], out["losses"], out["window_ms"]
    saved = checkpoint.list_steps(ckpt_dir)
    ckpt_bytes = os.path.getsize(os.path.join(ckpt_dir, f"step_{saved[-1]}",
                                              checkpoint.STATE_FILE))
    final = checkpoint.restore_checkpoint(ckpt_dir)
    count = sum(t.numel() for t in final["params"].values())
    restored = all(torch.equal(final["params"][n], p.detach().cpu())
                   for n, p in model.named_parameters())
    log(f"{name}: train {out['steps']} steps {train_s:.1f} s at B={SEP_BATCH} x 4 s, full width "
        f"({count} params); peak memory {peak_gib:.2f} GiB; steps saved {saved}, {ckpt_bytes} "
        f"bytes a checkpoint, restores to the trained parameters {restored} ({card})")
    log(f"{name}: -SI-SNR per step " + " ".join(f"{losses[s]:.3f}" for s in sorted(losses)))
    log(f"{name}: the recipe's ms per step (host clock, each step ending in the loss's "
        "read-back, the collate in the prefetch thread): "
        + " ".join(f"{v:.1f}" for v in window_ms)
        + f"; median {statistics.median(window_ms):.1f} ({card})")
    log(f"{name}: eval on {scores['utts']} test mixtures of 4 s: SI-SNRi {scores['si_snri']:.2f} "
        f"dB, SDRi {scores['sdri']:.2f} dB ({eval_s:.1f} s, BSS Eval on the host); not judged "
        f"after {steps} steps")
    log(f"{name}: kernel launches over train and eval {launches} (the path has no TPU kernel: "
        "the JAX model is XLA code throughout)")
    later = [losses[s] for s in sorted(losses) if s > 1]
    if out["steps"] != steps or len(losses) != steps or not np.isfinite(list(losses.values())).all():
        raise AssertionError(f"{name}: {out['steps']} steps, losses {losses}")
    if not min(later) < losses[1]:
        raise AssertionError(f"{name}: the loss did not fall below the first step's: {losses}")
    if count != n_params or saved != [steps] or not restored:
        raise AssertionError(f"{name}: {count} params, steps saved {saved}, restored {restored}")
    if scores["utts"] != 4 or not np.isfinite([scores["si_snri"], scores["sdri"]]).all():
        raise AssertionError(f"{name}: eval {scores}")
    if any(launches.values()):
        raise AssertionError(f"{name}: a kernel launched on the separation path: {launches}")

    it = separation_batch_iterator(cfg.data.train_dir, SEP_BATCH, seg, epochs=SEP_HOST_BATCHES)
    collate = []
    for _ in range(SEP_HOST_BATCHES):
        t = time.perf_counter()
        _, batch = next(it)
        collate.append(1e3 * (time.perf_counter() - t))
    log(f"{name}: the host's collate ms per batch of {SEP_BATCH} x 4 s (apart from the card): "
        + " ".join(f"{v:.1f}" for v in collate))
    latency = {"one": sep_latency_ms(model, separate_fn, batch["mix"][:1]),
               "batch": sep_latency_ms(model, separate_fn, batch["mix"])}
    log(f"{name}: separation latency, host clock from the mixture's copy to the card to the "
        f"sources' copy back: one 4 s mixture {latency['one']:.2f} ms, a batch of {SEP_BATCH} "
        f"{latency['batch']:.2f} ms ({card})")
    del model, out
    torch.cuda.empty_cache()
    model = recipe.build_model(cfg, "cuda").train()
    timing = step_ms(conv_train.make_step(cfg, model, conv_train.make_optimizer(cfg, model),
                                          separate_fn), sep_batch_to(batch, "cuda"),
                     SEP_TIMED_STEPS)
    del model
    torch.cuda.empty_cache()
    log(f"{name}: ms per step at B={SEP_BATCH} x 4 s on one batch (host clock, {SEP_TIMED_STEPS} "
        f"steps ending in a read-back): cuDNN TF32 off {timing['tf32_off']['ms']:.2f}, on "
        f"{timing['tf32_on']['ms']:.2f} ({card})")
    check = sep_card_against_cpu(name, recipe, cfg, separate_fn,
                                 {k: v[:2] for k, v in batch.items()})
    torch.cuda.empty_cache()
    return {"steps": steps, "params": count, "losses": losses, "window_ms": window_ms,
            "peak_gib": peak_gib, "checkpoint_bytes": ckpt_bytes, "eval": scores,
            "eval_s": eval_s, "collate_ms": collate, "latency_ms": latency, "step_ms": timing,
            "launches": launches, "card_against_cpu": check}


def separation_phase(launch_counters, card):
    """Phase 13: the Conv-TasNet and TasNet recipes (``mindaudio_torch/
    recipes/conv_tasnet``, ``recipes/tasnet``) as a user runs them, at the
    full width of their YAMLs, on a corpus of 4 s mixtures from
    ``convergence_run.make_corpus`` in a temporary directory (LibriMix is
    not in the repository). ``launch_counters`` are the port's kernel
    wrappers: the path runs none of them. Returns the summary by model."""
    import tempfile

    from mindaudio_torch.recipes.conv_tasnet import convergence_run
    from mindaudio_torch.recipes.conv_tasnet import eval as conv_eval
    from mindaudio_torch.recipes.conv_tasnet import train as conv_train
    from mindaudio_torch.recipes.tasnet import eval as tas_eval
    from mindaudio_torch.recipes.tasnet import train as tas_train

    with tempfile.TemporaryDirectory(prefix="chip_smoke_sep_") as root:
        t = time.perf_counter()
        convergence_run.make_corpus(root, n_utts=SEP_TRAIN_UTTS, seconds=4.0)
        os.makedirs(f"{root}/tt4")
        for part in ("mix", "s1", "s2"):
            with open(f"{root}/tt/{part}.json") as f:
                entries = json.load(f)[:4]
            with open(f"{root}/tt4/{part}.json", "w") as f:
                json.dump(entries, f)
        log(f"separation: gen {SEP_TRAIN_UTTS} training and 8 test mixtures of 4 s at 8 kHz "
            f"{time.perf_counter() - t:.1f} s")
        return {
            "conv_tasnet": separation_model_phase(
                "conv_tasnet", conv_train, conv_eval, conv_train.separate, SEP_CONV_STEPS,
                3_445_808, root, launch_counters, card),
            "tasnet": separation_model_phase(
                "tasnet", tas_train, tas_eval, tas_train.separate_full, SEP_TASNET_STEPS,
                16_578_000, root, launch_counters, card),
        }


def fs2_batch_to(batch, device):
    """A FastSpeech2 numpy batch as tensors on ``device`` (int32 → int64)."""
    return {k: (torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v))
            .to(device) for k, v in batch.items()}


def fs2_random_batch(b, seed=0):
    """A batch at the recipe's bounds from seeded noise: every row 160
    phonemes of 1-10 frames, clamped into 1000 frames as the batch iterator
    clamps them."""
    rng = np.random.default_rng(seed)
    dur = rng.integers(1, 11, (b, FS2_PHONEMES))
    cum = np.cumsum(dur, 1)
    dur = np.where(cum <= FS2_FRAMES, dur, np.maximum(FS2_FRAMES - (cum - dur), 0))
    return {"phonemes": rng.integers(1, 288, (b, FS2_PHONEMES)).astype(np.int32),
            "src_lens": np.full(b, FS2_PHONEMES, np.int32),
            "mel": rng.standard_normal((b, FS2_FRAMES, 80)).astype(np.float32),
            "pitch": rng.uniform(4.5, 5.5, (b, FS2_PHONEMES)).astype(np.float32),
            "energy": rng.uniform(0.0, 1.0, (b, FS2_PHONEMES)).astype(np.float32),
            "duration": dur.astype(np.int32)}


def profile_tts():
    """``--profile-tts``: the FastSpeech2 recipe's train step at full width
    on one seeded batch of B = 32 x 160 phonemes x 1000 frames (cuDNN TF32
    off)."""
    from mindaudio_torch.recipes.fastspeech2 import train as fs2_train

    cfg, _, _ = fs2_train.parse_args([])
    fs2, net = fs2_train.build_model(cfg, "cuda")
    net.train()
    fs2.set_dropout_generator(torch.Generator(device="cuda").manual_seed(7))
    step = fs2_train.make_step(cfg, net, fs2_train.make_optimizer(cfg, net))
    profile_steps("fastspeech2", step, fs2_batch_to(fs2_random_batch(FS2_BATCH), "cuda"))


def fs2_step_flops(cfg, batch):
    """Operations of one FastSpeech2 train step on ``batch`` (2 per
    multiply-add; the backward's two products make it 3x the forward's):
    every block's kernel-9 and kernel-1 convs, four projections and two
    attention products at the padded lengths, the three variance
    predictors (two kernel-3 convs of 256 filters) and the mel head."""
    m = cfg.model
    d, f, n_mels = int(m.d_model), int(m.conv_filter), int(cfg.data.n_mels)
    b, length = batch["phonemes"].shape
    frames = batch["mel"].shape[1]

    def block(t):
        return 2 * t * (d * f * 9 + f * d + 4 * d * d) + 4 * t * t * d

    forward = b * (int(m.encoder_layers) * block(length) + int(m.decoder_layers) * block(frames)
                   + 3 * 2 * length * (d * 256 * 3 + 256 * 256 * 3 + 256)
                   + 2 * frames * d * n_mels)
    return 3 * forward


def fs2_infer_ms(fs2, phonemes, lens):
    """ms of ``infer`` at 1000 frames (host clock from the phonemes' copy to
    the card to the read-back of ``mel_len``, median of
    ``FS2_TIMED_STEPS`` after a warm-up)."""
    times = []
    for i in range(FS2_TIMED_STEPS + 1):
        t = time.perf_counter()
        out = fs2.infer(torch.from_numpy(phonemes).long().cuda(),
                        torch.from_numpy(lens).long().cuda(), FS2_FRAMES)
        out[4].cpu()
        if i:
            times.append(1e3 * (time.perf_counter() - t))
    return statistics.median(times)


def fs2_card_against_cpu(fs2_train, cfg, batch):
    """Phase 14's float32 step at full width, B = 2, dropout off
    (:func:`card_against_cpu`, one-ulp moves of the pitch targets for the
    CPU's spread), at a learning rate of 0.05 with a warm-up of 4 steps
    (0.0375 at AdamW's count 3: against the recipe's 3e-6 there an update
    would be a few float32 ulps of some parameters). The stated
    tolerances: loss 1e-5 relative, each update 1e-4 of its leaf's largest,
    the gradient norm 1e-4."""
    cfg = copy.deepcopy(cfg)
    cfg.optim.lr, cfg.optim.warmup_steps = 0.05, 4

    from mindaudio_torch.models.layers import FastDropout

    def build(device):
        fs2, net = fs2_train.build_model(cfg, device)
        for m in net.modules():
            if isinstance(m, FastDropout):  # the predictors' fixed 0.5 too
                m.rate = 0.0
        return net

    return card_against_cpu(
        "fastspeech2: one float32 step at full width, B=2, dropout off", build,
        lambda net: fs2_train.make_optimizer(cfg, net),
        lambda net, opt: fs2_train.make_step(cfg, net, opt), batch, "pitch", fs2_batch_to,
        {"loss": 1e-5, "grad_norm": 1e-4, "update": 1e-4})


def fastspeech2_phase(launch_counters, card):
    """Phase 14: the FastSpeech2 recipe (``mindaudio_torch/recipes/
    fastspeech2``) as a user runs it, at the full width of
    ``fastspeech2.yaml``, on a corpus in LJSpeech's layout that
    ``synthetic.gen`` writes into a temporary directory (LJSpeech is not in
    the repository): ``preprocess.main()``, ``train.main()`` with a save at
    the last step, the checkpoint restored to the trained model's output,
    ``generate.main()`` for English and pinyin text, the timings, and one
    float32 step against the CPU. ``launch_counters`` are the port's kernel
    wrappers: the path runs none of them. Returns the summary."""
    import tempfile

    from mindaudio_torch.recipes.fastspeech2 import generate, preprocess, synthetic
    from mindaudio_torch.recipes.fastspeech2 import train as fs2_train
    from mindaudio_torch.train import checkpoint

    with tempfile.TemporaryDirectory(prefix="chip_smoke_fs2_") as root:
        for counter in launch_counters:
            counter.launches = 0
        t = time.perf_counter()
        lj, feature_dir = synthetic.gen(root, n_utts=FS2_UTTS)
        gen_s = time.perf_counter() - t
        t = time.perf_counter()
        entries = preprocess.main(["--data.ljspeech_dir", lj, "--data.feature_dir", feature_dir])
        prep_s = time.perf_counter() - t
        feats = [np.load(f"{feature_dir}/{e}.npy", allow_pickle=True).item() for e in entries]
        n_ph = [len(f["phonemes"]) for f in feats]
        n_fr = [f["mel"].shape[0] for f in feats]
        aligned = len(os.listdir(f"{feature_dir}/TextGrid"))
        log(f"fastspeech2: gen {FS2_UTTS} utterances in LJSpeech's layout at 22.05 kHz "
            f"({aligned} with TextGrid alignments) {gen_s:.1f} s; preprocess (YIN pitch, RMS "
            f"energy, mels on the host) {prep_s:.1f} s: {len(entries)} utterances, "
            f"{min(n_ph)}-{max(n_ph)} phonemes, {min(n_fr)}-{max(n_fr)} frames")
        if len(entries) != FS2_UTTS or max(n_ph) <= FS2_PHONEMES or max(n_fr) <= FS2_FRAMES:
            raise AssertionError("fastspeech2: the corpus does not reach the recipe's bounds: "
                                 f"{len(entries)} utterances, {max(n_ph)} phonemes, "
                                 f"{max(n_fr)} frames")

        ckpt_dir = f"{root}/ckpt"
        args = ["--data.feature_dir", feature_dir, "--train.ckpt_dir", ckpt_dir,
                "--train.max_steps", str(FS2_STEPS), "--train.log_every_steps", "1",
                "--train.save_every_steps", str(FS2_STEPS),
                "--optim.warmup_steps", str(FS2_WARMUP)]
        cfg, _, _ = fs2_train.parse_args(args)
        d = cfg.data
        if (int(d.batch_size), int(d.max_phoneme_len), int(d.max_mel_len)) != (
                FS2_BATCH, FS2_PHONEMES, FS2_FRAMES):
            raise AssertionError(f"fastspeech2: not the recipe's batch: {d}")
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = fs2_train.main(args)
        train_s = time.perf_counter() - t
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        mels = {}
        t = time.perf_counter()
        for name, extra in (("english", ["--text", FS2_TEXT]),
                            ("pinyin", ["--text", FS2_PINYIN, "--pinyin"])):
            mels[name] = generate.main(extra + ["--output", f"{root}/{name}.npy"] + args)
        generate_s = time.perf_counter() - t
        launches = {c.__name__: c.launches for c in launch_counters}

        fs2, net, losses, window_ms = out["model"], out["net"], out["losses"], out["window_ms"]
        n_params = sum(p.numel() for p in fs2.parameters())
        saved = checkpoint.list_steps(ckpt_dir)
        ckpt_bytes = os.path.getsize(os.path.join(ckpt_dir, f"step_{saved[-1]}",
                                                  checkpoint.STATE_FILE))
        restored, _ = fs2_train.build_model(cfg, "cuda", init_seed=1)
        fs2_train.load_params(restored, checkpoint.restore_checkpoint(ckpt_dir)["params"])
        init, _ = fs2_train.build_model(cfg, "cuda")
        moved = sum(not torch.equal(a, b) for a, b in zip(init.parameters(), fs2.parameters()))
        del init
        batch = next(fs2_train.batches(cfg))[1]
        ph = torch.from_numpy(batch["phonemes"][:4]).long().cuda()
        lens = torch.from_numpy(batch["src_lens"][:4]).long().cuda()
        want, got = fs2.infer(ph, lens, FS2_FRAMES), restored.infer(ph, lens, FS2_FRAMES)
        same_output = all(torch.equal(a, b) for a, b in zip(restored.parameters(),
                                                             fs2.parameters())) and all(
            torch.allclose(a.float(), b.float(), rtol=0, atol=1e-6 * (1 + b.abs().max().item()))
            for a, b in zip(got, want))
        del restored
        curve = [losses[s]["loss"] for s in sorted(losses)]
        log(f"fastspeech2: train {out['steps']} steps {train_s:.1f} s at B={FS2_BATCH} x "
            f"{FS2_PHONEMES} phonemes x {FS2_FRAMES} frames, full width ({n_params} params, "
            f"{moved} of {len(list(fs2.parameters()))} tensors moved); peak memory "
            f"{peak_gib:.2f} GiB; steps saved {saved}, {ckpt_bytes} bytes a checkpoint, "
            f"restores to the trained model's output {same_output} ({card})")
        log("fastspeech2: loss per step " + " ".join(f"{v:.3f}" for v in curve))
        log("fastspeech2: the recipe's ms per step (host clock, each step ending in the "
            "metrics' read-back, the collate in the prefetch thread): "
            + " ".join(f"{v:.1f}" for v in window_ms)
            + f"; median {statistics.median(window_ms):.1f} ({card})")
        log(f"fastspeech2: generate {generate_s:.1f} s (two runs, each building and loading "
            f"the model): English {mels['english'].shape}, pinyin {mels['pinyin'].shape} "
            "(mel_len x n_mels; not judged after "
            f"{FS2_STEPS} steps)")
        log(f"fastspeech2: kernel launches over gen, preprocess, train and generate "
            f"{launches} (the path has no TPU kernel: the JAX model is XLA code, its mels "
            "host NumPy)")
        if (out["steps"] != FS2_STEPS or len(curve) != FS2_STEPS
                or not np.isfinite(curve).all()):
            raise AssertionError(f"fastspeech2: {out['steps']} steps, losses {curve}")
        if not np.mean(curve[-5:]) < np.mean(curve[:5]):
            raise AssertionError(f"fastspeech2: the loss did not fall: {curve}")
        if n_params != FS2_PARAMS or saved != [FS2_STEPS] or not same_output or moved == 0:
            raise AssertionError(f"fastspeech2: {n_params} params, steps saved {saved}, "
                                 f"restored {same_output}, {moved} tensors moved")
        for name, mel in mels.items():
            if mel.ndim != 2 or mel.shape[0] > FS2_FRAMES or mel.shape[1] != 80 or not (
                    np.isfinite(mel).all()):
                raise AssertionError(f"fastspeech2: generate {name}: {mel.shape}")
        if any(launches.values()):
            raise AssertionError(f"fastspeech2: a kernel launched on the TTS path: {launches}")

        it = fs2_train.batches(cfg)
        collate = []
        for _ in range(FS2_HOST_BATCHES):
            t = time.perf_counter()
            _, batch = next(it)
            collate.append(1e3 * (time.perf_counter() - t))
        log(f"fastspeech2: the host's collate ms per batch of {FS2_BATCH} (apart from the "
            "card): " + " ".join(f"{v:.1f}" for v in collate))
        latency = {"one": fs2_infer_ms(fs2, batch["phonemes"][:1], batch["src_lens"][:1]),
                   "batch": fs2_infer_ms(fs2, batch["phonemes"][:16], batch["src_lens"][:16])}
        log(f"fastspeech2: infer latency (host clock from the phonemes' copy to the card to the "
            f"read-back of mel_len, 1000 frames): one sentence {latency['one']:.2f} ms, a batch "
            f"of 16 {latency['batch']:.2f} ms ({card})")
        del fs2, net, out
        torch.cuda.empty_cache()
        fs2, net = fs2_train.build_model(cfg, "cuda")
        net.train()
        fs2.set_dropout_generator(torch.Generator(device="cuda").manual_seed(7))
        timing = step_ms(fs2_train.make_step(cfg, net, fs2_train.make_optimizer(cfg, net)),
                         fs2_batch_to(batch, "cuda"), FS2_TIMED_STEPS)
        del fs2, net
        torch.cuda.empty_cache()
        flops = fs2_step_flops(cfg, batch)
        bound = {"f32": 1e3 * flops / H100_F32_FLOP_PER_S,
                 "tf32": 1e3 * flops / H100_TF32_FLOP_PER_S}
        log(f"fastspeech2: ms per step at B={FS2_BATCH} on one batch (host clock, "
            f"{FS2_TIMED_STEPS} steps ending in a read-back): cuDNN TF32 off "
            f"{timing['tf32_off']['ms']:.2f}, on {timing['tf32_on']['ms']:.2f}; the step's "
            f"products {flops:.4g} FLOP, {bound['f32']:.2f} ms at float32's peak "
            f"({bound['f32'] / timing['tf32_off']['ms']:.3f} of the TF32-off step), "
            f"{bound['tf32']:.2f} ms at TF32's ({card})")
        check = fs2_card_against_cpu(fs2_train, cfg, {k: v[:2] for k, v in batch.items()})
        torch.cuda.empty_cache()
    return {"steps": FS2_STEPS, "params": n_params, "losses": curve, "window_ms": window_ms,
            "peak_gib": peak_gib, "checkpoint_bytes": ckpt_bytes, "gen_s": gen_s,
            "preprocess_s": prep_s, "train_s": train_s, "generate_s": generate_s,
            "mel_shapes": {k: list(v.shape) for k, v in mels.items()}, "collate_ms": collate,
            "infer_ms": latency, "step_ms": timing, "step_flops": flops,
            "step_bound_ms": bound, "launches": launches,
            "card_against_cpu": check}


def wg_batch_to(batch, device):
    """A WaveGrad numpy batch as float32 tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


def wg_step_flops(model, batch):
    """Operations of one WaveGrad train step on ``batch`` (2 per
    multiply-add; the backward's two products make it 3x the forward's):
    every convolution's ``2 x output elements x Cin x kernel``, counted by
    hooks over one forward on the card."""
    counts = []

    def hook(mod, args, out):
        counts.append(2 * out.numel() * mod.in_channels * mod.kernel_size[0])

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, torch.nn.Conv1d)]
    try:
        with torch.no_grad():
            model(batch["mel"], batch["audio"], torch.full((len(batch["mel"]),), 0.5,
                                                           device=batch["mel"].device))
    finally:
        for h in hooks:
            h.remove()
    return 3 * sum(counts)


def wg_fixed_step(wg_train, cfg):
    """The recipe's step (``train.make_step``) with the diffusion draws
    taken from the batch (``noise``, ``scale``) instead of a generator, so
    that the card and the CPU take the same step."""
    from mindaudio_torch.train.state import make_train_step

    def make(net, optimizer):
        def objective(net, b):
            s = b["scale"][:, None]
            noisy = s * b["audio"] + torch.sqrt(1.0 - s ** 2) * b["noise"]
            return net(b["mel"], noisy, b["scale"], b["noise"]), {}

        return make_train_step(net, optimizer, grad_clip_norm=float(cfg.optim.grad_clip),
                               loss_fn=objective)
    return make


def wg_card_against_cpu(wg_train, cfg, batch):
    """Phase 15's float32 step at full width, B = 4 (:func:`card_against_cpu`,
    one-ulp moves of the audio for the CPU's spread; the diffusion draws
    fixed in the batch), at a learning rate of 0.01 with a warm-up of 4
    steps (0.0075 at AdamW's count 3: against the recipe's 6e-7 there an
    update would be a few float32 ulps of some parameters). The stated
    tolerances: loss 1e-5 relative, each update 1e-4 of its leaf's largest,
    the gradient norm 1e-4."""
    cfg = copy.deepcopy(cfg)
    cfg.optim.lr, cfg.optim.warmup_steps = 0.01, 4
    return card_against_cpu(
        f"wavegrad: one float32 step at full width, B={WG_CHECK_BATCH}",
        lambda device: wg_train.build_model(cfg, device)[1],
        lambda net: wg_train.make_optimizer(cfg, net), wg_fixed_step(wg_train, cfg), batch,
        "audio", wg_batch_to, {"loss": 1e-5, "grad_norm": 1e-4, "update": 1e-4})


def wg_sample_ms(model, mel, betas, runs):
    """ms of ``reverse_diffusion`` on ``mel`` (host clock from the call to
    the read-back of the audio), the least of ``runs`` after one warm-up
    run of the 6-step schedule; and the last audio."""
    from mindaudio_torch.models import wavegrad as wg_model

    gen = torch.Generator(device="cuda").manual_seed(0)
    wg_model.reverse_diffusion(model, mel, gen, betas=wg_model.fast_noise_schedule()).cpu()
    times = []
    for _ in range(runs):
        t = time.perf_counter()
        audio = wg_model.reverse_diffusion(model, mel, gen, betas=betas).cpu()
        times.append(1e3 * (time.perf_counter() - t))
    return min(times), audio


def wg_sampler_against_cpu(model, mel, steps=20):
    """The sampler on the card against the CPU, from the same weights and
    the same draws (``reverse_diffusion(noise=...)``, seeded numpy), over
    the last ``steps`` steps of the 1000-step schedule, where even an
    untrained net's samples stay bounded: within 1e-4 of the CPU's
    largest sample (TF32 off; each step feeds the next), and finite."""
    from mindaudio_torch.models import wavegrad as wg_model

    betas = wg_model.default_noise_schedule()[:steps]
    mel = np.asarray(mel[:1], np.float32)
    noise = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (steps + 1, 1, mel.shape[1] * WG_HOP)).astype(np.float32))
    card = wg_model.reverse_diffusion(model, torch.from_numpy(mel).cuda(), betas=betas,
                                      noise=noise).cpu()
    cpu_model = copy.deepcopy(model).cpu()
    cpu = wg_model.reverse_diffusion(cpu_model, torch.from_numpy(mel), betas=betas, noise=noise)
    err = (card - cpu).abs().max().item()
    tol = 1e-4 * cpu.abs().max().item()
    log(f"wavegrad: the sampler's last {steps} steps on the card against the CPU (the same "
        f"weights and draws, TF32 off): max |diff| {err:.3e}, tolerance {tol:.3e} (1e-4 of the "
        f"largest sample {cpu.abs().max().item():.4f})")
    if not torch.isfinite(card).all() or not err <= tol:
        raise AssertionError(f"wavegrad: sampler on the card differs from the CPU: {err} > {tol}")
    return {"steps": steps, "max_abs_err": err, "tolerance": tol}


def profile_vocoder():
    """``--profile-vocoder``: the WaveGrad recipe's train step at full width
    on one seeded batch of B = 64 x 30 frames (cuDNN TF32 off), then the
    same with TF32 on."""
    from mindaudio_torch.recipes.wavegrad import train as wg_train

    cfg, _, _ = wg_train.parse_args([])
    rng = np.random.default_rng(0)
    batch = wg_batch_to({"mel": rng.uniform(0, 1, (WG_BATCH, WG_FRAMES, 128)).astype(np.float32),
                         "audio": rng.uniform(-0.5, 0.5, (WG_BATCH, WG_FRAMES * WG_HOP))
                         .astype(np.float32)}, "cuda")
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        _, net = wg_train.build_model(cfg, "cuda")
        net.train()
        step = wg_train.make_step(cfg, net, wg_train.make_optimizer(cfg, net),
                                  torch.Generator(device="cuda").manual_seed(3))
        profile_steps(f"wavegrad (cuDNN TF32 {'on' if tf32 else 'off'})", step, batch,
                      by_op=not tf32)
        del net, step
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False


def wavegrad_phase(launch_counters, card):
    """Phase 15: the WaveGrad recipe (``mindaudio_torch/recipes/wavegrad``)
    as a user runs it, at the full width of ``wavegrad.yaml``, on a corpus
    in LJSpeech's layout that ``fastspeech2.synthetic.gen`` writes into a
    temporary directory: ``preprocess.main()``, ``train.main()`` with a save
    at the last step, the checkpoint read back by ``train.load_vocoder`` to
    the trained model's output, ``reverse.main()`` (6 steps) on one
    utterance's features, the timings (steps with cuDNN's TF32 off and on,
    the host's crops, both samplers), and one float32 step against the CPU.
    ``launch_counters`` are the port's kernel wrappers: the path runs none
    of them. Returns the summary."""
    import tempfile

    from mindaudio_torch.models import wavegrad as wg_model
    from mindaudio_torch.recipes.fastspeech2 import synthetic
    from mindaudio_torch.recipes.wavegrad import preprocess, reverse
    from mindaudio_torch.recipes.wavegrad import train as wg_train
    from mindaudio_torch.train import checkpoint

    with tempfile.TemporaryDirectory(prefix="chip_smoke_wg_") as root:
        for counter in launch_counters:
            counter.launches = 0
        t = time.perf_counter()
        lj, _ = synthetic.gen(root, n_utts=WG_UTTS)
        gen_s = time.perf_counter() - t
        feature_dir = f"{root}/wavegrad"
        t = time.perf_counter()
        entries = preprocess.main(["--data.ljspeech_dir", lj, "--data.feature_dir", feature_dir])
        prep_s = time.perf_counter() - t
        n_fr = [np.load(f"{feature_dir}/{e}.npy", allow_pickle=True).item()["mel"].shape[0]
                for e in entries]
        log(f"wavegrad: gen {WG_UTTS} utterances in LJSpeech's layout at 22.05 kHz "
            f"{gen_s:.1f} s; preprocess (magnitude mels on the host, dB to [0, 1]) "
            f"{prep_s:.1f} s: {len(entries)} utterances, {min(n_fr)}-{max(n_fr)} frames")
        if len(entries) != WG_UTTS or min(n_fr) <= WG_FRAMES:
            raise AssertionError(f"wavegrad: corpus of {len(entries)} utterances, "
                                 f"{min(n_fr)}-{max(n_fr)} frames")

        ckpt_dir = f"{root}/ckpt"
        args = ["--data.feature_dir", feature_dir, "--train.ckpt_dir", ckpt_dir,
                "--train.max_steps", str(WG_STEPS), "--train.log_every_steps", "1",
                "--train.save_every_steps", str(WG_STEPS),
                "--optim.warmup_steps", str(WG_WARMUP)]
        cfg, _, _ = wg_train.parse_args(args)
        d = cfg.data
        if (int(d.batch_size), int(d.crop_frames), int(d.hop_length)) != (
                WG_BATCH, WG_FRAMES, WG_HOP):
            raise AssertionError(f"wavegrad: not the recipe's batch: {d}")
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = wg_train.main(args)
        train_s = time.perf_counter() - t
        peak_gib = torch.cuda.max_memory_allocated() / 2**30

        wg, losses, window_ms = out["model"], out["losses"], out["window_ms"]
        n_params = sum(p.numel() for p in wg.parameters())
        saved = checkpoint.list_steps(ckpt_dir)
        ckpt_bytes = os.path.getsize(os.path.join(ckpt_dir, f"step_{saved[-1]}",
                                                  checkpoint.STATE_FILE))
        restored = wg_train.load_vocoder(ckpt_dir, "cuda", cfg)
        init, _ = wg_train.build_model(cfg, "cuda")
        moved = sum(not torch.equal(a, b) for a, b in zip(init.parameters(), wg.parameters()))
        del init
        _, batch = next(wg_train.crop_iterator(cfg, WG_BATCH, 1))
        dev_batch = wg_batch_to(batch, "cuda")
        probe = (dev_batch["mel"][:4], dev_batch["audio"][:4],
                 torch.linspace(0.2, 0.9, 4, device="cuda"))
        with torch.no_grad():
            want, got = wg(*probe), restored(*probe)
        same_output = all(torch.equal(a, b) for a, b in zip(restored.parameters(),
                                                             wg.parameters())) and bool(
            torch.allclose(got, want, rtol=0, atol=1e-6 * (1 + want.abs().max().item())))
        del restored
        np.save(f"{root}/mel.npy", np.load(f"{feature_dir}/{entries[0]}.npy",
                                           allow_pickle=True).item()["mel"])
        t = time.perf_counter()
        vocoded = reverse.main(["--mel", f"{root}/mel.npy", "--output", f"{root}/out.wav",
                                "--fast", "--train.ckpt_dir", ckpt_dir])
        reverse_s = time.perf_counter() - t
        curve = [losses[s]["loss"] for s in sorted(losses)]
        log(f"wavegrad: train {out['steps']} steps {train_s:.1f} s at B={WG_BATCH} x "
            f"{WG_FRAMES} frames x hop {WG_HOP}, full width ({n_params} params, {moved} of "
            f"{len(list(wg.parameters()))} tensors moved); peak memory {peak_gib:.2f} GiB; "
            f"steps saved {saved}, {ckpt_bytes} bytes a checkpoint, restores to the trained "
            f"model's output {same_output} ({card})")
        log("wavegrad: loss per step " + " ".join(f"{v:.4f}" for v in curve))
        log("wavegrad: the recipe's ms per step (host clock, each step ending in the metrics' "
            "read-back, the crops in the prefetch thread, cuDNN TF32 off): "
            + " ".join(f"{v:.1f}" for v in window_ms)
            + f"; median {statistics.median(window_ms):.1f} ({card})")
        log(f"wavegrad: reverse.main --fast on {entries[0]} ({n_fr[0]} frames) {reverse_s:.1f} s "
            f"(building and loading the model included): {vocoded.shape} samples, "
            f"{np.isfinite(vocoded).mean():.4f} of them finite (an untrained net's samples "
            "run away; the protocol judges quality)")
        if (out["steps"] != WG_STEPS or len(curve) != WG_STEPS
                or not np.isfinite(curve).all()):
            raise AssertionError(f"wavegrad: {out['steps']} steps, losses {curve}")
        if n_params != WG_PARAMS or saved != [WG_STEPS] or not same_output or moved == 0:
            raise AssertionError(f"wavegrad: {n_params} params, steps saved {saved}, "
                                 f"restored {same_output}, {moved} tensors moved")
        if vocoded.shape != (n_fr[0] * WG_HOP,):
            raise AssertionError(f"wavegrad: reverse gave {vocoded.shape}")
        sampler_check = wg_sampler_against_cpu(wg, batch["mel"][:1])

        it = wg_train.crop_iterator(cfg, WG_BATCH, WG_HOST_BATCHES)
        collate = []
        for _ in range(WG_HOST_BATCHES):
            t = time.perf_counter()
            next(it)
            collate.append(1e3 * (time.perf_counter() - t))
        log(f"wavegrad: the host's crop and collate ms per batch of {WG_BATCH} (apart from the "
            "card, features read from disk): " + " ".join(f"{v:.1f}" for v in collate))

        wg.eval()
        audio_s = WG_FRAMES * WG_HOP / WG_SR
        sampling = {}
        for name, b, betas, runs in (
                ("steps_1000_b1", 1, wg_model.default_noise_schedule(), 2),
                ("steps_6_b1", 1, wg_model.fast_noise_schedule(), 5),
                (f"steps_6_b{WG_SAMPLE_BATCH}", WG_SAMPLE_BATCH, wg_model.fast_noise_schedule(),
                 3)):
            ms, audio = wg_sample_ms(wg, dev_batch["mel"][:b], betas, runs)
            if audio.shape != (b, WG_FRAMES * WG_HOP):
                raise AssertionError(f"wavegrad: sampler {name} gave {tuple(audio.shape)}")
            sampling[name] = {"ms": ms, "rtf": ms / 1e3 / (b * audio_s)}
        log(f"wavegrad: sampling {WG_FRAMES} frames ({audio_s:.4f} s of audio an utterance; host "
            "clock to the read-back, the least of a few runs, cuDNN TF32 off): "
            + ", ".join(f"{k} {v['ms']:.1f} ms (real-time factor {v['rtf']:.4f})"
                        for k, v in sampling.items()) + f" ({card})")
        launches = {c.__name__: c.launches for c in launch_counters}
        log(f"wavegrad: kernel launches over gen, preprocess, train, reverse and sampling "
            f"{launches} (the path has no TPU kernel: the JAX model is XLA convolutions, its "
            "mels host NumPy)")
        if any(launches.values()):
            raise AssertionError(f"wavegrad: a kernel launched on the vocoder path: {launches}")
        del wg, out
        torch.cuda.empty_cache()

        _, net = wg_train.build_model(cfg, "cuda")
        net.train()
        timing = step_ms(wg_train.make_step(cfg, net, wg_train.make_optimizer(cfg, net),
                                            torch.Generator(device="cuda").manual_seed(3)),
                         dev_batch, WG_TIMED_STEPS)
        flops = wg_step_flops(net.model, dev_batch)
        del net
        torch.cuda.empty_cache()
        bound = {"f32": 1e3 * flops / H100_F32_FLOP_PER_S,
                 "tf32": 1e3 * flops / H100_TF32_FLOP_PER_S}
        log(f"wavegrad: ms per step at B={WG_BATCH} on one batch (host clock, "
            f"{WG_TIMED_STEPS} steps ending in a read-back): cuDNN TF32 off "
            f"{timing['tf32_off']['ms']:.2f}, on {timing['tf32_on']['ms']:.2f}; the step's "
            f"convolutions {flops:.4g} FLOP, {bound['f32']:.2f} ms at float32's peak "
            f"({bound['f32'] / timing['tf32_off']['ms']:.3f} of the TF32-off step), "
            f"{bound['tf32']:.2f} ms at TF32's ({bound['tf32'] / timing['tf32_on']['ms']:.3f} "
            f"of the TF32-on step) ({card})")
        rng = np.random.default_rng(5)
        check_batch = {k: v[:WG_CHECK_BATCH] for k, v in batch.items()}
        check_batch["noise"] = rng.standard_normal(check_batch["audio"].shape).astype(np.float32)
        check_batch["scale"] = rng.uniform(0.3, 0.95, WG_CHECK_BATCH).astype(np.float32)
        check = wg_card_against_cpu(wg_train, cfg, check_batch)
        torch.cuda.empty_cache()
    return {"steps": WG_STEPS, "params": n_params, "losses": curve, "window_ms": window_ms,
            "peak_gib": peak_gib, "checkpoint_bytes": ckpt_bytes, "gen_s": gen_s,
            "preprocess_s": prep_s, "train_s": train_s, "reverse_s": reverse_s,
            "collate_ms": collate, "sampling": sampling, "sampler_against_cpu": sampler_check,
            "step_ms": timing,
            "step_flops": flops, "step_bound_ms": bound, "launches": launches,
            "card_against_cpu": check}


def i8_recipe_args(root, steps, *flags):
    """Phase 9's flags (the convergence run's, 64 utterances in the
    227-frame bucket) with ``flags`` appended."""
    from mindaudio_torch.recipes.conformer import convergence_run

    return convergence_run._args(root, steps) + ["--data.batch_factor", "0.67"] + list(flags)


def i8_fixed_batch(cfg, device, n=None):
    """The first training batch of the recipe's iterator (no speed
    perturbation), as tensors on ``device``; the first ``n`` utterances."""
    from mindaudio_torch.recipes.conformer import dataset
    from mindaudio_torch.recipes.conformer import train as rtrain

    tok = rtrain.build_tokenizer(cfg)
    _, _, batch = next(dataset.batch_iterator(
        cfg.data.train_csv, tok, epochs=1, speed_perturb=False,
        batch_factor=float(cfg.data.batch_factor), max_label_len=int(cfg.data.max_label_len)))
    batch = {k: v[:n] for k, v in batch.items()}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).long() if v.dtype == np.int32
            else torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}, tok


def i8_setting_ms(root, int8_ffn, remat, n=I8_TIMED_STEPS):
    """The recipe's step (bf16 autocast, dither, dropout) on one fixed batch
    of 64 x 227 frames at full width with ``model.int8_ffn`` and
    ``model.remat`` as given: ms a step (host clock, ``n`` steps after two
    warm-up steps, ending in the loss's read-back), the peak memory over
    those steps and the int8 products a step."""
    from mindaudio_torch.ops import quant
    from mindaudio_torch.recipes.conformer import train as rtrain

    cfg, device = rtrain.parse_args(i8_recipe_args(
        root, 0, "--model.int8_ffn", str(int8_ffn).lower(), "--model.remat", str(remat).lower()))
    batch, tok = i8_fixed_batch(cfg, "cpu")
    batch = {k: v.to(device) for k, v in batch.items()}
    model = rtrain.build_model(cfg, tok.vocab_size, device).train()
    gens = {k: torch.Generator(device=device).manual_seed(s) for k, s in
            (("dropout", rtrain.DROPOUT_SEED), ("features", rtrain.FEATURES_SEED))}
    model.set_dropout_generator(gens["dropout"])
    step, _ = rtrain.make_step(cfg, model, rtrain.make_optimizer(cfg, model), gens)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        step(batch)
    float(step(batch)["loss"])
    quant.int8_mm.launches = 0
    t = time.perf_counter()
    for _ in range(n):
        metrics = step(batch)
    loss = float(metrics["loss"])
    ms = 1e3 * (time.perf_counter() - t) / n
    out = {"int8_ffn": int8_ffn, "remat": remat, "ms": ms, "loss": loss,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "int8_mm_per_step": quant.int8_mm.launches / n, "batch": list(batch["wavs"].shape)}
    del model, step, batch
    torch.cuda.empty_cache()
    return out


def i8_float32_step(root, remat, dropout):
    """``(build, make_optimizer, make_step, batch, cfg)`` of the recipe's step
    in float32 (no autocast) at full width on the first 8 utterances of the
    fixed batch, the wavs as float32, dither and SpecAugment off, with
    ``model.remat`` and ``model.dropout_rate`` as given."""
    from mindaudio_torch.recipes.conformer import train as rtrain

    cfg, _ = rtrain.parse_args(i8_recipe_args(
        root, 0, "--model.remat", str(remat).lower(), "--model.dropout_rate", str(dropout),
        "--optim.bf16", "false", "--features.dither", "0.0"))
    batch, tok = i8_fixed_batch(cfg, "cpu", n=8)
    batch = {k: v.numpy() for k, v in batch.items()}
    batch["wavs"] = (batch["wavs"] / 32768.0).astype(np.float32)  # kaldi_fbank scales it back

    def build(device):
        return rtrain.build_model(cfg, tok.vocab_size, torch.device(device))

    def make_step(model, opt):
        device = next(model.parameters()).device
        gens = {k: torch.Generator(device=device).manual_seed(s) for k, s in
                (("dropout", rtrain.DROPOUT_SEED), ("features", rtrain.FEATURES_SEED))}
        model.set_dropout_generator(gens["dropout"])
        return rtrain.make_step(cfg, model, opt, gens)[0]

    return build, lambda model: rtrain.make_optimizer(cfg, model), make_step, batch, cfg


def i8_batch_to(batch, device):
    return {k: torch.from_numpy(v).to(device).long() if v.dtype.kind == "i"
            else torch.from_numpy(v).to(device) for k, v in batch.items()}


def leaf_errors(a, b):
    """Per leaf ``max |a - b| / max |b|``."""
    return np.array([((x - y).abs().max() / y.abs().max().clamp_min(1e-30)).item()
                     for x, y in zip(a, b)])


def remat_pairs(root):
    """Remat on against remat off on the card, dropout on, the same
    generator seeds: (a) the flagship's float32 loss and gradients on the
    recipe's features (B = 8, dither and SpecAugment off) and the dropout
    generator's state after the backward, (b) a full-width
    ``ConformerEncoder`` with the conv module's batch norm: the gradients of
    ``sum(out^2)`` and the running statistics after one step. The step's
    own spread is measured on the card: a second remat-off run, and one
    with every input sample moved one float32 ulp; each leaf's limit is 4x
    the larger of the two, or 1e-6 of the leaf's largest value where that
    is smaller. A recomputation with other dropout masks, or one that moved
    the statistics again, misses it by orders."""
    from mindaudio_torch.models.conformer import ConformerEncoder
    from mindaudio_torch.models.layers import FastDropout, running_stats
    from mindaudio_torch.recipes.conformer import train as rtrain

    build, _, _, batch, cfg = i8_float32_step(root, True, 0.1)
    base = build("cuda")
    wavs = batch["wavs"]
    ulp = np.spacing(np.abs(wavs)) * np.random.default_rng(6).choice([-1.0, 1.0], wavs.shape)
    variants = (("off", False, wavs), ("off_again", False, wavs),
                ("off_ulp", False, (wavs + ulp).astype(np.float32)), ("on", True, wavs))
    runs = {}
    for name, remat, x in variants:
        model = copy.deepcopy(base).train()
        model.encoder.remat = remat
        gens = {k: torch.Generator(device="cuda").manual_seed(s) for k, s in
                (("dropout", rtrain.DROPOUT_SEED), ("features", rtrain.FEATURES_SEED))}
        model.set_dropout_generator(gens["dropout"])
        b = i8_batch_to(dict(batch, wavs=x), "cuda")
        feats, feat_lens = rtrain.device_features(cfg, b["wavs"], b["wav_lens"],
                                                  gens["features"])
        loss, _ = model(dict(b, feats=feats, feat_lens=feat_lens))
        grads = torch.autograd.grad(loss, list(model.parameters()))
        runs[name] = {"loss": loss.item(), "gen": gens["dropout"].get_state(), "grads": grads}
        del model
    enc_base = ConformerEncoder(input_dim=N_MELS, d_model=D_MODEL, head_num=HEADS, ffn_dim=FFN,
                                num_layers=ENC_LAYERS, kernel_size=CONV_KERNEL,
                                norm_type="batch_norm").cuda()
    with torch.no_grad():
        g = torch.Generator(device="cuda").manual_seed(3)
        for p in enc_base.parameters():
            p.normal_(0.0, 0.05, generator=g)
    feats = torch.randn(16, 227, N_MELS, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(4))
    feats_ulp = feats + torch.from_numpy(
        np.spacing(np.abs(feats.cpu().numpy())) * np.random.default_rng(7).choice(
            [-1.0, 1.0], tuple(feats.shape))).float().cuda()
    lens = torch.full((16,), 227, device="cuda")
    enc_runs = {}
    for name, remat, x in (("off", False, feats), ("off_again", False, feats),
                           ("off_ulp", False, feats_ulp), ("on", True, feats)):
        enc = copy.deepcopy(enc_base).train()
        enc.remat = remat
        gen = torch.Generator(device="cuda").manual_seed(5)
        for m in enc.modules():
            if isinstance(m, FastDropout):
                m.generator = gen
        out, _ = enc(x, lens)
        grads = torch.autograd.grad(out.float().square().sum(), list(enc.parameters()))
        enc_runs[name] = {"grads": grads, "stats": [t.clone() for t in running_stats(enc)]}
        del enc
    moved = leaf_errors(enc_runs["off"]["stats"], running_stats(enc_base)).min()

    stat_names = [n for n, b in enc_base.named_buffers() if n.endswith(("running_mean",
                                                                        "running_var"))]
    checks = {"asr_grads": (runs, "grads", [n for n, _ in base.named_parameters()]),
              "encoder_grads": (enc_runs, "grads", [n for n, _ in enc_base.named_parameters()]),
              "encoder_stats": (enc_runs, "stats", stat_names)}
    summary = {}
    for key, (res, field, names) in checks.items():
        off = res["off"][field]
        spread = np.maximum(leaf_errors(res["off_again"][field], off),
                            leaf_errors(res["off_ulp"][field], off))
        err = leaf_errors(res["on"][field], off)
        limit = np.maximum(4 * spread, 1e-6)
        i = int(np.argmax(err / limit))
        summary[key] = {"worst_ratio": float(err[i] / limit[i]), "worst": names[i],
                        "error": float(err[i]), "spread": float(spread[i]),
                        "largest_error": float(err.max()), "leaves": len(names),
                        "exact_leaves": int((err == 0).sum())}
    summary["loss"] = {k: r["loss"] for k, r in runs.items()}
    summary["statistics_moved_by_at_least"] = float(moved)
    log("int8/remat: remat on vs off on the card, dropout on, the same seeds (limit per leaf: "
        "4x the step's spread, a second remat-off run and one-ulp input moves, at least 1e-6 "
        "of the leaf's largest): "
        + "; ".join(f"{k} worst error/limit {v['worst_ratio']:.3f} in {v['worst']} (error "
                    f"{v['error']:.3e}, spread {v['spread']:.3e}), largest error "
                    f"{v['largest_error']:.3e}, {v['exact_leaves']} of {v['leaves']} leaves "
                    "bit-equal" for k, v in summary.items()
                    if isinstance(v, dict) and "worst" in v)
        + f"; losses {summary['loss']}; the statistics moved by at least {moved:.3e} of "
          "their largest in one step")
    if any(v["worst_ratio"] > 1 for v in summary.values() if isinstance(v, dict) and "worst" in v):
        raise AssertionError(f"int8/remat: remat on and off differ: {summary}")
    loss = summary["loss"]
    if abs(loss["on"] - loss["off"]) > max(4 * abs(loss["off_ulp"] - loss["off"]),
                                           1e-6 * abs(loss["off"])) or not torch.equal(
            runs["on"]["gen"], runs["off"]["gen"]):
        raise AssertionError(f"int8/remat: the remat step's loss {loss} or generator state "
                             "differs")
    if not moved > 1e-4:
        raise AssertionError(f"int8/remat: the running statistics did not move ({moved})")
    return summary


I8_SHAPES = [(m, k, n) for m in (64 * 56, 32 * 249) for k, n in ((256, 2048), (2048, 256),
                                                                  (256, 4233))]


def w8a8_products(card):
    """The W8A8 product at the path's shapes (M = 64 x 56 rows of the recipe's
    batch and 32 x 249 of the train bench's, against the FFNs' (256, 2048),
    (2048, 256) and the CTC projection's (256, 4233)): ``int8_mm`` held
    against the float64 product of the same int8 operands (exact on the
    int32 accumulators), timed (CUDA graph, N = 4233 padded to 4240 every
    call, as on the path) beside ``torch.matmul`` in bf16, the quantization
    passes (``w8a8_operands``: both operands' scales and roundings) and the
    whole ``w8a8_apply``. Nothing is claimed; the numbers go to PERF.md."""
    from mindaudio_torch.ops import quant

    rows = []
    for m, k, n in I8_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(m + k + n)
        x = torch.randn(m, k, device="cuda", generator=g).to(torch.bfloat16)
        w = 0.05 * torch.randn(n, k, device="cuda", generator=g)
        xq, sx, wq, sw = quant.w8a8_operands(x, w)
        acc = quant.int8_mm(xq, wq.t())
        exact = xq.double() @ wq.double().t()
        mismatches = int((acc.double() != exact).sum())
        if acc.dtype != torch.int32 or acc.shape != (m, n) or mismatches:
            raise AssertionError(f"int8_mm at {(m, k, n)}: {mismatches} accumulators differ "
                                 f"from the float64 product")
        xb, wb = x, w.to(torch.bfloat16).t()
        row = {"m": m, "k": k, "n": n,
               "int8_mm_ms": cuda_ms(lambda: quant.int8_mm(xq, wq.t())),
               "bf16_matmul_ms": cuda_ms(lambda: torch.matmul(xb, wb)),
               "quantize_ms": cuda_ms(lambda: quant.w8a8_operands(x, w)),
               "w8a8_apply_ms": cuda_ms(lambda: quant.w8a8_apply(x, w)),
               "int8_bound_ms": 1e3 * max((m * k + k * n + 4 * m * n) / H100_BYTES_PER_S,
                                          2 * m * k * n / H100_INT8_OP_PER_S),
               "bf16_bound_ms": 1e3 * max(2 * (m * k + k * n + m * n) / H100_BYTES_PER_S,
                                          2 * m * k * n / H100_BF16_FLOP_PER_S),
               "max_abs_err": 0.0}
        rows.append(row)
        log(f"W8A8 product {m}x{k}x{n}: int8 accumulators equal to float64 on every element; "
            f"int8_mm {row['int8_mm_ms']:.4f} ms (bound {row['int8_bound_ms']:.4f}), bf16 "
            f"torch.matmul {row['bf16_matmul_ms']:.4f} (bound {row['bf16_bound_ms']:.4f}), the "
            f"quantization passes {row['quantize_ms']:.4f}, w8a8_apply whole "
            f"{row['w8a8_apply_ms']:.4f} ({card})")
    return rows


def dsp_on_card(card):
    """The DSP ops of ``ops.spectral`` and ``ops.resample`` on the card at a
    realistic size against the same ops on the CPU in float64, at the
    module's "highest" precision (TF32 off, held to the tolerance stated
    per op) and once at "high" (TF32 on: reported, held only to be
    finite)."""
    from mindaudio_torch.ops import resample as rs
    from mindaudio_torch.ops import spectral as sp

    rng = np.random.default_rng(21)
    wav16, _ = synthetic_speech(16, 22)
    wav16 = torch.from_numpy(wav16[:, :160000])
    cases = []
    for orig in (44100, 14400, 17600):
        x = torch.from_numpy((0.1 * rng.standard_normal((16, orig * 10))).astype(np.float32))
        cases.append((f"resample {orig}->16000 (16 x 10 s)", 1e-5, x,
                      functools.partial(rs.resample, orig_freq=orig, new_freq=16000)))
    spec = sp.stft(torch.from_numpy(rng.standard_normal((16, 128000))).double(), n_fft=512,
                   device="cpu").float()
    cases.append(("istft (16, 257, 1001)", 1e-5, spec,
                  functools.partial(sp.istft, n_fft=512, device=None)))
    cases.append(("mfcc (16 x 10 s)", 1e-3, wav16, functools.partial(sp.mfcc, device=None)))
    feats = torch.from_numpy((5.0 + 3.0 * rng.standard_normal((16, 1001, 80))).astype(np.float32))
    cases.append(("sliding_window_cmn (16, 1001, 80)", 1e-5, feats,
                  functools.partial(sp.sliding_window_cmn)))
    rows = []
    for name, tol, x, fn in cases:
        def call(t, device, **kw):
            if "device" in getattr(fn, "keywords", {}):
                return fn(t, device=device, **kw)
            return fn(t.to(device), **kw)

        ref = call(x.double(), "cpu").numpy()
        scale = float(np.abs(ref).max())
        row = {"op": name, "tol": tol}
        for level in ("highest", "high"):
            kw = {} if fn.func is sp.sliding_window_cmn else {"precision": level}
            got = call(x, "cuda", **kw).cpu().double().numpy()
            if got.shape != ref.shape or not np.isfinite(got).all():
                raise AssertionError(f"{name}: shape {got.shape} vs {ref.shape}, or not finite")
            row[f"rel_err_{level}"] = float(np.abs(got - ref).max() / scale)
        rows.append(row)
        log(f"DSP on the card, {name}: max |card - CPU float64| / max |ref| "
            f"{row['rel_err_highest']:.3e} at precision highest (tol {tol}), "
            f"{row['rel_err_high']:.3e} with TF32 ({card})")
        if row["rel_err_highest"] > tol:
            raise AssertionError(f"{name}: {row['rel_err_highest']} over {tol}")
    return rows


def int8_remat_phase(launch_counters, card):
    """Phase 16: the Conformer recipe trained W8A8 with rematerialized
    blocks (``--model.int8_ffn true --model.remat true``) as a user runs it,
    at the full width and depth of ``conformer.yaml`` on phase 9's cipher
    corpus (B = 64 x 227 frames, bf16 autocast): ``train.main()`` for
    ``I8_STEPS`` steps with a save, ``predict.main()`` with ``ctc_greedy``,
    the checkpoint loaded into the float model; then the four settings'
    step times and peaks, remat against the plain step on the card, one
    float32 remat step against the CPU, the W8A8 product at the path's
    shapes and the DSP ops on the card. ``launch_counters`` are the four
    kernel wrappers (int8 GEMM, CTC forward and backward, log-mel), set to 0
    just before the recipe runs and read just after. Returns the summary."""
    import tempfile

    from mindaudio_torch.models.layers import Int8Dense
    from mindaudio_torch.ops import quant
    from mindaudio_torch.recipes.conformer import compute_cmvn_stats, convergence_run
    from mindaudio_torch.recipes.conformer import predict as rpredict
    from mindaudio_torch.recipes.conformer import train as rtrain
    from mindaudio_torch.train import checkpoint

    i8 = quant.int8_training_matmul
    with tempfile.TemporaryDirectory(prefix="chip_smoke_int8_") as root:
        convergence_run.gen(root, n_train=RECIPE_UTTS[0], n_dev=RECIPE_UTTS[1],
                            n_test=RECIPE_UTTS[2])
        flags = ["--model.int8_ffn", "true", "--model.remat", "true",
                 "--train.log_every_steps", "1", "--train.save_every_steps", str(I8_STEPS),
                 "--train.keep_checkpoint_max", "2", "--train.ckpt_dir", f"{root}/ckpt"]
        compute_cmvn_stats.main(i8_recipe_args(root, I8_STEPS, *flags))
        cfg, _ = rtrain.parse_args(i8_recipe_args(root, I8_STEPS, *flags))
        model = rtrain.build_model(cfg, 4233, torch.device("cuda"))
        n_w8a8 = sum(isinstance(m, Int8Dense) for m in model.modules())
        n_enc = sum(isinstance(m, Int8Dense) for m in model.encoder.modules())
        if (cfg.model.d_model, cfg.model.ffn_dim, cfg.model.num_encoder_layers,
                n_w8a8, n_enc) != (D_MODEL, FFN, ENC_LAYERS, 4 * ENC_LAYERS + 1, 4 * ENC_LAYERS):
            raise AssertionError(f"int8/remat: not the full-width W8A8 model: {cfg.model}")
        del model

        # the main path: the counts set to 0 just before it and read just after
        for counter in launch_counters:
            counter.launches = 0
        quant.int8_mm.launches = i8.fwd_launches = i8.bwd_launches = 0
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = rtrain.main(i8_recipe_args(root, I8_STEPS, *flags))
        train_s = time.perf_counter() - t
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        train_counts = {c.__name__: c.launches for c in launch_counters}
        train_i8 = {"int8_mm": quant.int8_mm.launches, "fwd": i8.fwd_launches,
                    "bwd": i8.bwd_launches}
        quant.int8_mm.launches = i8.fwd_launches = i8.bwd_launches = 0
        t = time.perf_counter()
        cer = rpredict.main(i8_recipe_args(root, 0, *flags, "--decode.mode", "ctc_greedy",
                                           "--decode.average_num", "1",
                                           "--decode.result_file", f"{root}/result.txt"))
        predict_s = time.perf_counter() - t
        counts = {c.__name__: c.launches for c in launch_counters}
        predict_i8 = {"int8_mm": quant.int8_mm.launches, "fwd": i8.fwd_launches,
                      "bwd": i8.bwd_launches}

        steps, evals = out["steps"], len(out["dev_losses"])
        losses = out["losses"]
        log(f"int8/remat recipe: train {steps} steps in {train_s:.1f} s (W8A8 layers "
            f"{n_w8a8}, {n_enc} in the encoder, rematerialized), losses {losses[0]:.4f} .. "
            f"{losses[-1]:.4f} (first five {np.mean(losses[:5]):.4f}, last five "
            f"{np.mean(losses[-5:]):.4f}), dev loss {out['dev_losses']}, ms per step (host "
            f"clock, one step ending in the loss's read-back) median "
            f"{statistics.median(out['window_ms']):.2f}, peak {peak_gib:.2f} GiB; predict "
            f"ctc_greedy CER {100 * cer:.2f}% (not judged) in {predict_s:.1f} s; kernel "
            f"launches {counts}; W8A8 products in training {train_i8}, in decoding "
            f"{predict_i8} ({card})")
        want_fwd = steps * (2 * n_enc + (n_w8a8 - n_enc)) + evals * n_w8a8
        if train_i8 != {"int8_mm": want_fwd, "fwd": want_fwd, "bwd": 2 * n_w8a8 * steps}:
            raise AssertionError(f"int8/remat: W8A8 products {train_i8}, expected {want_fwd} "
                                 f"forward (the encoder's twice a step, recomputed) and "
                                 f"{2 * n_w8a8 * steps} backward")
        if (train_counts["ctc_dp_fwd"], train_counts["ctc_dp_bwd"]) != (steps + evals, steps):
            raise AssertionError(f"int8/remat: CTC launches {train_counts}, expected one "
                                 f"forward and one backward a step, one forward a dev batch")
        if counts["ctc_dp_fwd"] != train_counts["ctc_dp_fwd"] or counts["int8_matmul"] or \
                counts["fused_logmel"]:
            raise AssertionError(f"int8/remat: launches {counts}")
        if predict_i8["bwd"] or not predict_i8["fwd"] or predict_i8["fwd"] % n_w8a8 or \
                predict_i8["int8_mm"] != predict_i8["fwd"]:
            raise AssertionError(f"int8/remat: decoding's W8A8 products {predict_i8}")
        if steps != I8_STEPS or not np.isfinite(losses).all() or not np.isfinite(
                list(out["dev_losses"].values())).all():
            raise AssertionError(f"int8/remat: {steps} steps, losses {losses}")
        if not np.mean(losses[-5:]) < np.mean(losses[:5]):
            raise AssertionError(f"int8/remat: the loss did not fall: {losses}")
        with open(f"{root}/result.txt", encoding="utf-8") as f:
            if len(f.read().splitlines()) != RECIPE_UTTS[2] or not 0 <= cer < float("inf"):
                raise AssertionError(f"int8/remat: decode CER {cer}")

        # the checkpoint loads into the float model of the default config
        plain, _ = rtrain.parse_args(i8_recipe_args(root, 0))
        tok = rtrain.build_tokenizer(plain)
        fmodel = rtrain.build_model(plain, tok.vocab_size, torch.device("cuda")).eval()
        rtrain.load_params(fmodel, checkpoint.restore_checkpoint(f"{root}/ckpt")["params"])
        batch, _ = i8_fixed_batch(plain, "cpu", n=4)
        with torch.no_grad():
            feats, feat_lens = rtrain.device_features(
                plain, batch["wavs"].cuda(), batch["wav_lens"].cuda(), train=False)
            floss, _ = fmodel({**{k: v.cuda() for k, v in batch.items()}, "feats": feats,
                               "feat_lens": feat_lens})
        if not torch.isfinite(floss):
            raise AssertionError(f"int8/remat: the float model's loss {floss}")
        log(f"int8/remat: the W8A8 checkpoint loads into the float model unchanged; its "
            f"eval loss on 4 utterances {floss.item():.4f}")
        del fmodel

        settings = [i8_setting_ms(root, a, b) for a in (False, True) for b in (False, True)]
        log("int8/remat: ms a step on one batch of 64 x 227 frames (bf16 autocast, host clock, "
            f"{I8_TIMED_STEPS} steps ending in a read-back) and peak memory ({card}): "
            + "; ".join(f"int8_ffn {s['int8_ffn']}, remat {s['remat']}: {s['ms']:.2f} ms, "
                        f"{s['peak_gib']:.3f} GiB, {s['int8_mm_per_step']:.0f} int8 products"
                        for s in settings))
        by = {(s["int8_ffn"], s["remat"]): s for s in settings}
        for int8 in (False, True):
            if not by[int8, True]["peak_gib"] < by[int8, False]["peak_gib"]:
                raise AssertionError(f"int8/remat: remat did not lower the peak: {settings}")
        if by[False, False]["int8_mm_per_step"] or by[True, False]["int8_mm_per_step"] != \
                n_w8a8 or by[True, True]["int8_mm_per_step"] != n_w8a8 + n_enc:
            raise AssertionError(f"int8/remat: int8 products a step {settings}")

        pairs = remat_pairs(root)
        build, make_optimizer, make_step, batch, _ = i8_float32_step(root, True, 0.0)
        against_cpu = card_against_cpu(
            "int8/remat: one float32 step at full width with remat, B=8 x 227 frames, dropout "
            "off, ctc kernels on the card, the plain recursion on the CPU", build,
            make_optimizer, make_step, batch, "wavs", i8_batch_to,
            {"loss": 1e-4, "grad_norm": 1e-3, "update": 1e-2})
    products = w8a8_products(card)
    dsp = dsp_on_card(card)
    torch.cuda.empty_cache()
    return {"launches": counts, "steps": steps, "dev_evaluations": evals, "losses": losses,
            "window_ms": out["window_ms"], "train_s": train_s, "peak_gib": peak_gib,
            "cer": cer, "w8a8_layers": n_w8a8, "w8a8_products_train": train_i8,
            "w8a8_products_decode": predict_i8, "settings": settings, "remat_pairs": pairs,
            "card_against_cpu": against_cpu, "w8a8_shapes": products, "dsp": dsp}


def par_alone():
    """Within the block this process computes alone (no active mesh: the
    world-size-1 reference on the global batch)."""
    import contextlib

    from mindaudio_torch.parallel.mesh import set_active_mesh

    @contextlib.contextmanager
    def alone():
        prev = set_active_mesh(None)
        try:
            yield
        finally:
            set_active_mesh(prev)

    return alone()


def par_feats(batch):
    """The flagship batch with its deterministic fbank (no dither) as
    ``feats``: the model's own input, which the spread runs move."""
    from mindaudio_torch.ops.spectral import kaldi_fbank

    feats = kaldi_fbank(batch["wavs"], num_mel_bins=N_MELS, dither=0.0,
                        device=batch["wavs"].device)
    out = {k: v for k, v in batch.items() if k not in ("wavs", "wav_lens")}
    out["feats"], out["feat_lens"] = feats, 1 + (batch["wav_lens"] - 400) // 160
    return out


def par_rows(mesh, batch):
    """This rank's rows of the global batch (its ``data`` index)."""
    from mindaudio_torch.parallel.mesh import shard_batch

    return shard_batch(mesh, batch)


def par_ulp(batch, key, seed):
    """``batch`` with every element of ``batch[key]`` moved one float32 ulp
    up or down (a seeded draw): the input of a spread run."""
    x = batch[key]
    ulp = torch.from_numpy(np.spacing(np.abs(x.cpu().numpy())).astype(np.float32)).to(x.device)
    sign = torch.from_numpy(np.random.default_rng(seed).choice(
        [-1.0, 1.0], tuple(x.shape)).astype(np.float32)).to(x.device)
    return dict(batch, **{key: x + ulp * sign})


def par_grads(model, loss_fn, batch, mesh):
    """``(global loss, {name: whole gradient}, {name: whole running
    statistic})`` of one forward and backward of ``loss_fn(model, batch)``
    on this rank's batch, the gradients synced as the train step syncs them
    (``mesh`` None: one process on the whole batch)."""
    from mindaudio_torch.models.layers import running_stats
    from mindaudio_torch.parallel.collectives import all_reduce
    from mindaudio_torch.parallel.shardings import full_tensor, sync_grads

    names, params = zip(*model.named_parameters())
    loss = loss_fn(model, batch)
    grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
    if mesh is not None:
        grads = sync_grads(list(params), grads, mesh)
        loss = all_reduce(loss.detach(), mesh.group("data")) / mesh.size("data")
    ids = {id(b): n for n, b in model.named_buffers()}
    stats = {ids[id(b)]: b.detach().clone() for b in running_stats(model)}
    return (float(loss.detach()), {n: full_tensor(p, g) for n, p, g in zip(names, params, grads)},
            stats)


def par_hold(label, got, ref, spreads, stated):
    """Hold one parallel result ``(loss, {leaf}, {stat})`` against the
    world-size-1 result on the same global batch: the loss (relative) to
    ``stated["loss"]`` or 4x its spread over the one-ulp input runs, the
    larger; each gradient (and each running statistic) to ``stated`` of its
    own leaf's largest or 4x that leaf's own spread, the larger (the rule of
    ``card_against_cpu``; a gradient leaf's largest taken as at least 1e-6
    of the model's largest gradient). Returns the worst ratios; raises when
    one is above 1."""
    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-30)

    # a gradient whose exact value is zero (a key bias under the softmax) is
    # float noise on both sides: its errors count against 1e-6 of the
    # largest gradient of the model when that is above its own largest
    floor = 1e-6 * max(r.abs().max().item() for r in ref[1].values())

    def leaf(a, b, kind):
        scale = b.abs().max().item()
        return (a - b).abs().max().item() / max(scale, floor if kind == "grad" else 0.0, 1e-30)

    out = {"loss": [got[0], ref[0]]}
    spread = max(rel(s[0], ref[0]) for s in spreads)
    limit = max(stated["loss"], 4 * spread)
    out["loss_error"], out["loss_limit"] = rel(got[0], ref[0]), limit
    worst = {"loss": out["loss_error"] / limit}
    for i, kind in ((1, "grad"), (2, "stats")):
        if not ref[i]:
            continue
        ratios = {}
        for name, r in ref[i].items():
            s = max(leaf(sp[i][name], r, kind) for sp in spreads)
            ratios[name] = (leaf(got[i][name].to(r.device), r, kind), max(stated[kind], 4 * s), s)
        name = max(ratios, key=lambda n: ratios[n][0] / ratios[n][1])
        err, lim, s = ratios[name]
        worst[kind] = err / lim
        out[f"{kind}_worst"] = {"leaf": name, "error": err, "limit": lim, "spread": s,
                                "leaves": len(ratios)}
    out["worst_ratio"] = worst
    log(f"parallel {label}: loss {got[0]:.6f} vs one process {ref[0]:.6f}, worst error/limit "
        + ", ".join(f"{k} {v:.3f}" for k, v in worst.items())
        + "".join(f"; {k} worst in {out[k + '_worst']['leaf']} (error "
                  f"{out[k + '_worst']['error']:.3e}, limit {out[k + '_worst']['limit']:.3e}, "
                  f"spread {out[k + '_worst']['spread']:.3e}, {out[k + '_worst']['leaves']} "
                  "leaves)" for k in ("grad", "stats") if k + "_worst" in out))
    if any(v > 1 for v in worst.values()):
        raise AssertionError(f"parallel {label}: differs from one process: {out}")
    return out


def par_sync():
    if torch.device(PAR_DEVICE).type == "cuda":
        torch.cuda.synchronize()


def par_step_ms(fn, n):
    """ms per call of ``fn`` (host clock over ``n`` calls, ending in a
    synchronize; the caller has run it once)."""
    par_sync()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    par_sync()
    return 1e3 * (time.perf_counter() - t) / n


def par_layout(ctx, label, shape, build, loss_fn, batch, key, stated):
    """One layout over a mesh of ``shape``: this rank's forward and backward
    of ``loss_fn`` on its rows of ``batch`` with the gradients synced, its
    CTC launches, ms a step (forward, backward and sync, two ranks on one
    card); rank 0 then holds the result against one process on the whole
    batch (:func:`par_hold`, spread over two one-ulp moves of
    ``batch[key]``) and times that too."""
    import torch.distributed as dist

    from mindaudio_torch.ops import ctc_dp
    from mindaudio_torch.parallel.mesh import make_mesh

    mesh = make_mesh(**shape)
    model = build(mesh)
    rows = par_rows(mesh, batch)
    ctc_dp.ctc_dp_fwd.launches = ctc_dp.ctc_dp_bwd.launches = 0
    got = par_grads(model, loss_fn, rows, mesh)
    launches = [ctc_dp.ctc_dp_fwd.launches, ctc_dp.ctc_dp_bwd.launches]
    ms = par_step_ms(lambda: par_grads(model, loss_fn, rows, mesh), PAR_TIMED)
    del model
    torch.cuda.empty_cache()
    out = {"mesh": mesh.shape, "ctc_launches": launches, "ms": ms}
    dist.barrier()
    if ctx["rank"] == 0:
        with par_alone():
            ref_model = build(None)
            init = copy.deepcopy(ref_model.state_dict())
            refs = []
            for variant in (batch, par_ulp(batch, key, 1), par_ulp(batch, key, 2)):
                ref_model.load_state_dict(init)  # the running statistics too
                refs.append(par_grads(ref_model, loss_fn, variant, None))
            out["one_process_ms"] = par_step_ms(  # after the three above
                lambda: par_grads(ref_model, loss_fn, batch, None), PAR_TIMED)
            del ref_model, init
            torch.cuda.empty_cache()
        out["check"] = par_hold(label, got, refs[0], refs[1:], stated)
    dist.barrier()
    return out


def par_asr_loss(model, batch):
    """The hybrid loss, plus 0.01 of the MoE blocks' mean aux loss (the
    recipe's ``moe_aux_weight``) where the model has them."""
    loss, metrics = model(batch)
    aux = metrics.get("moe_aux_losses")
    return loss if aux is None else loss + 0.01 * aux.mean()


def par_flagship(**kw):
    """``build(mesh)`` of the flagship (seeded weights, dropout off), its
    parallel form over ``mesh`` as ``kw`` asks (``tp``: Megatron over the
    ``model`` axis, the MoE experts with it; ``sp``: the encoder's
    sequence-parallel variant; ``pipe``: the encoder blocks pipelined)."""
    from mindaudio_torch.models.asr_model import ASRModel
    from mindaudio_torch.parallel.shardings import apply_tensor_parallel

    def build(mesh):
        extra = {}
        if kw.get("moe"):
            extra.update(moe_experts=PAR_EXPERTS, moe_top_k=2)
        if mesh is not None and kw.get("sp"):
            extra.update(sp_mesh=mesh, sp_variant=kw["sp"])
        if mesh is not None and kw.get("pipe"):
            extra.update(pipeline_mesh=mesh, pipeline_microbatches=PAR_MICRO)
        gen = torch.Generator(device=PAR_DEVICE).manual_seed(0)
        model = ASRModel(VOCAB, input_dim=N_MELS, d_model=D_MODEL, head_num=HEADS,
                         ffn_dim=FFN, num_encoder_layers=ENC_LAYERS,
                         num_decoder_layers=DEC_LAYERS, kernel_size=CONV_KERNEL,
                         ctc_weight=0.3, ctc_impl="kernel", device=PAR_DEVICE,
                         **extra).reset_parameters(gen).eval()
        if mesh is not None and kw.get("tp"):
            apply_tensor_parallel(model, mesh)
        return model

    return build


def par_moments(model, seed=13):
    """A running AdamW state (count 3, seeded moments, whole tensors), so
    that an update is smooth in the gradient (as ``card_against_cpu``)."""
    rng = np.random.default_rng(seed)
    return {"count": 3,
            "mu": {n: torch.from_numpy(0.01 * rng.standard_normal(p.shape).astype(np.float32))
                   for n, p in model.named_parameters()},
            "nu": {n: torch.from_numpy((1e-4 * (1 + rng.random(p.shape))).astype(np.float32))
                   for n, p in model.named_parameters()}}


def par_zero1(ctx, batch):
    """Data parallel at full width with and without ZeRO-1: ``PAR_STEPS``
    float32 train steps each from the same weights and running moments; the
    two must be bit for bit alike (losses, parameters, whole moments), each
    rank's moment bytes half the replicated ones; the ZeRO-1 step's ms; and
    on rank 0 the first update against one process's on the global batch
    (stated 1e-2 of a leaf's largest update, or 4x its spread)."""
    import torch.distributed as dist

    from mindaudio_torch.ops import ctc_dp
    from mindaudio_torch.parallel.mesh import make_mesh
    from mindaudio_torch.train.optim import AdamW
    from mindaudio_torch.train.state import make_train_step

    mesh = make_mesh(data=2)
    rows = par_rows(mesh, batch)
    model = par_flagship()(mesh)  # every run starts from its weights
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    moments = par_moments(model)
    runs = {}
    ctc_dp.ctc_dp_fwd.launches = ctc_dp.ctc_dp_bwd.launches = 0
    # bit for bit needs a deterministic backward (the embedding's and the
    # convolutions' gradients otherwise add in another order run to run):
    # the control is the replicated run twice
    torch.use_deterministic_algorithms(True, warn_only=True)
    for zero1 in ("control", False, True):
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(init[n])
        opt = AdamW(model.named_parameters(), 1e-3, weight_decay=1e-2, mu_dtype=torch.bfloat16,
                    zero1_group=mesh.group("data") if zero1 is True else None)
        opt.load_state_dict(moments)
        step = make_train_step(model, opt, grad_clip_norm=5.0, mesh=mesh)
        losses, update = [], None
        for i in range(PAR_STEPS):
            losses.append(float(step(rows)["loss"]))
            if i == 0:
                update = {n: p.detach() - init[n] for n, p in model.named_parameters()}
        runs[zero1] = {"losses": losses, "update": update, "state": opt.state_dict(),
                       "params": {n: p.detach().clone() for n, p in model.named_parameters()},
                       "bytes": opt._mu.numel() * 2 + opt._nu.numel() * 4}
        if zero1 is True:
            torch.use_deterministic_algorithms(False)
            step(rows)  # the first step out of deterministic mode
            runs["ms"] = par_step_ms(lambda: step(rows), PAR_TIMED)
        del opt, step
    del model
    torch.cuda.empty_cache()
    launches = [ctc_dp.ctc_dp_fwd.launches, ctc_dp.ctc_dp_bwd.launches]

    def unequal(a, b):
        """The leaves (parameters and both moments) that differ in a bit."""
        return [f"{k}:{n}" for k in ("params", "mu", "nu")
                for n, t in (a[k] if k == "params" else a["state"][k]).items()
                if not torch.equal(t, (b[k] if k == "params" else b["state"][k])[n])]

    rep, z1 = runs[False], runs[True]
    control, differ = unequal(runs["control"], rep), unequal(rep, z1)
    equal = rep["losses"] == z1["losses"] and not differ
    out = {"mesh": mesh.shape, "losses": z1["losses"], "bit_equal": equal,
           "moment_bytes": [rep["bytes"], z1["bytes"]], "control_unequal": len(control),
           "unequal": len(differ), "ctc_launches": launches, "ms": runs["ms"]}
    if not equal:
        raise AssertionError(f"parallel data_zero1: ZeRO-1 is not bit for bit the replicated "
                             f"run: {len(differ)} leaves differ ({differ[:4]}), the control "
                             f"(replicated twice) {len(control)} ({control[:4]}); losses "
                             f"{rep['losses']} / {z1['losses']}")
    if z1["bytes"] * 2 > rep["bytes"] + 8:
        raise AssertionError(f"parallel data_zero1: moment bytes {rep['bytes']} -> {z1['bytes']}")
    dist.barrier()
    if ctx["rank"] == 0:
        with par_alone():
            refs = []
            model = par_flagship()(None)
            for variant in (batch, par_ulp(batch, "feats", 1), par_ulp(batch, "feats", 2)):
                with torch.no_grad():
                    for n, p in model.named_parameters():
                        p.copy_(init[n])
                opt = AdamW(model.named_parameters(), 1e-3, weight_decay=1e-2,
                            mu_dtype=torch.bfloat16)
                opt.load_state_dict(moments)
                one = make_train_step(model, opt, grad_clip_norm=5.0)
                loss = float(one(variant)["loss"])
                refs.append((loss, {n: p.detach() - init[n]
                                    for n, p in model.named_parameters()}, {}))
            out["one_process_ms"] = par_step_ms(lambda: one(batch), PAR_TIMED)
            del model, init, opt, one
            torch.cuda.empty_cache()
        out["check"] = par_hold("data_zero1 (the first update)",
                                (z1["losses"][0], z1["update"], {}), refs[0], refs[1:],
                                {"loss": 1e-5, "grad": 1e-2, "stats": 1e-4})
    dist.barrier()
    return out


def par_recipe(ctx, root):
    """The Conformer recipe's ``main()`` at full width with ZeRO-1 on the
    two ranks for ``PAR_RECIPE_STEPS`` steps (global batch 32 in the
    227-frame bucket), writing its checkpoint."""
    from mindaudio_torch.recipes.conformer import train as rtrain

    out = rtrain.main(par_recipe_args(root, PAR_RECIPE_STEPS, "--train.zero1_optimizer", "true"))
    return {"steps": out["steps"], "final_step": out["final_step"],
            "losses": out["losses"], "dev_losses": out["dev_losses"]}


def par_recipe_args(root, steps, *flags):
    """Phase 9's flags with 32 utterances in the 227-frame bucket and a save
    at the last step."""
    from mindaudio_torch.recipes.conformer import convergence_run

    return convergence_run._args(root, steps) + [
        "--data.batch_factor", "0.34", "--train.log_every_steps", "1",
        "--train.save_every_steps", "100", "--train.resume", "true",
        "--train.ckpt_dir", f"{root}/ckpt"] + list(flags)


def par_ds2(ctx):
    """DeepSpeech2 at full width, data parallel at B = 64 (32 a rank,
    ``PAR_DS2_FRAMES`` frames, ``PAR_DS2_LABELS`` labels): the batch norms'
    training statistics and running statistics over the global batch."""
    from mindaudio_torch.loss.ctc_loss import ctc_loss
    from mindaudio_torch.recipes.deepspeech2 import dataset as ds
    from mindaudio_torch.recipes.deepspeech2 import train as ds_train

    cfg, _ = ds_train.parse_args(["--device", PAR_DEVICE])
    rng = np.random.default_rng(21)
    n = PAR_DS2_FRAMES * ds.HOP
    lens = rng.integers(n // 2, n, PAR_DS2_BATCH)
    wavs = (0.1 * rng.standard_normal((PAR_DS2_BATCH, n))).astype(np.float32)
    wavs[np.arange(n)[None, :] >= lens[:, None]] = 0.0
    batch = {"wavs": torch.from_numpy(wavs).to(PAR_DEVICE), "wav_lens": torch.from_numpy(lens).to(PAR_DEVICE),
             "labels": torch.from_numpy(rng.integers(0, ds.BLANK_ID, (
                 PAR_DS2_BATCH, ds.MAX_LABEL_LEN))).to(PAR_DEVICE),
             "label_lens": torch.full((PAR_DS2_BATCH,), PAR_DS2_LABELS).to(PAR_DEVICE)}
    feats, feat_lens = ds_train.device_features(batch["wavs"], batch["wav_lens"])
    batch = dict(batch, feats=feats, feat_lens=feat_lens)

    def loss_fn(model, b):
        logits, out_lens = model(b["feats"], b["feat_lens"])
        return ctc_loss(logits, out_lens, b["labels"], b["label_lens"], blank_id=ds.BLANK_ID)

    return par_layout(ctx, "deepspeech2", dict(data=2),
                      lambda mesh: ds_train.build_model(cfg, PAR_DEVICE).train(), loss_fn, batch,
                      "feats", {"loss": 1e-5, "grad": 1e-3, "stats": 1e-4})


def par_ecapa(ctx):
    """ECAPA-TDNN at full width, data parallel at B = 32 x 3 s: the batch
    norms' statistics and the fbank's 80 dB floor over the global batch."""
    from mindaudio_torch.loss.aam_softmax import aam_softmax_loss
    from mindaudio_torch.recipes.ecapa_tdnn import train_speaker_embeddings as tse

    cfg, _ = tse.parse_args(["--device", PAR_DEVICE])
    rng = np.random.default_rng(22)
    wavs = (0.1 * rng.standard_normal((PAR_ECAPA_BATCH, 48000))).astype(np.float32)
    labels = rng.integers(0, ECAPA_SPEAKERS, PAR_ECAPA_BATCH)
    batch = {"wavs": torch.from_numpy(wavs).to(PAR_DEVICE), "labels": torch.from_numpy(labels).to(PAR_DEVICE)}
    margin, scale = float(cfg.optim.margin), float(cfg.optim.scale)

    def loss_fn(model, b):
        feats = tse.extract_features(b["wavs"], n_mels=int(cfg.features.n_mels))
        return aam_softmax_loss(model(feats)[1], b["labels"], margin=margin, scale=scale)

    return par_layout(ctx, "ecapa_tdnn", dict(data=2),
                      lambda mesh: tse.build_model(cfg, PAR_DEVICE, ECAPA_SPEAKERS).train(),
                      loss_fn, batch, "wavs", {"loss": 1e-5, "grad": 1e-3, "stats": 1e-4})


def parallel_worker(spec_path):
    """One rank of phase 17 (``chip_smoke.py --parallel-worker SPEC``): join
    the group the environment describes (``PAR_BACKEND`` at two ranks, NCCL
    at one), run the layouts the spec lists in order, and write what each
    returned to ``<spec>.rank<r>.json``."""
    import torch.distributed as dist

    from mindaudio_torch.parallel.mesh import initialize_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(spec_path) as f:
        spec = json.load(f)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if world > 1:
        initialize_distributed(backend=PAR_BACKEND, device=PAR_DEVICE, timeout=300)
    else:
        dist.init_process_group("nccl", init_method=spec["init_method"], rank=0, world_size=1)
    ctx = {"rank": rank}
    # the model-parallel layouts split every row, so a smaller batch shows them
    flagship = par_feats(train_batch(PAR_BATCH, seed=5, device=PAR_DEVICE))
    hybrid = {"loss": 1e-5, "grad": 1e-3, "stats": 1e-4}
    jobs = {
        "recipe": lambda: par_recipe(ctx, spec["root"]),
        "data_zero1": lambda: par_zero1(ctx, par_feats(
            train_batch(TRAIN_BATCH, seed=5, device=PAR_DEVICE))),
        "deepspeech2": lambda: par_ds2(ctx),
        "ecapa_tdnn": lambda: par_ecapa(ctx),
        "moe_expert": lambda: par_layout(ctx, "moe_expert", dict(model=2),
                                         par_flagship(moe=True, tp=True), par_asr_loss,
                                         flagship, "feats", hybrid),
        "tensor": lambda: par_layout(ctx, "tensor", dict(model=2), par_flagship(tp=True),
                                     par_asr_loss, flagship, "feats", hybrid),
        "sequence_ring": lambda: par_layout(ctx, "sequence_ring", dict(seq=2),
                                            par_flagship(sp="ring"), par_asr_loss, flagship,
                                            "feats", hybrid),
        "sequence_ulysses": lambda: par_layout(ctx, "sequence_ulysses", dict(seq=2),
                                               par_flagship(sp="ulysses"), par_asr_loss,
                                               flagship, "feats", hybrid),
        "pipeline": lambda: par_layout(ctx, "pipeline", dict(pipe=2), par_flagship(pipe=True),
                                       par_asr_loss, flagship, "feats", hybrid),
    }
    results = {}
    for name in spec["layouts"]:
        t = time.perf_counter()
        results[name] = jobs[name]()
        results[name]["seconds"] = time.perf_counter() - t
        torch.cuda.empty_cache()
    with open(f"{spec_path}.rank{rank}.json", "w") as f:
        json.dump(results, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def par_spawn(spec, world, timeout):
    """Run :func:`parallel_worker` on ``world`` processes sharing the card;
    returns each rank's results (rank order). A rank that fails or outlives
    ``timeout`` fails the phase; every process is stopped."""
    import socket
    import tempfile

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    spec = dict(spec, init_method=f"tcp://localhost:{port}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_") as tmp:
        path = os.path.join(tmp, "spec.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        procs = []
        for rank in range(world):
            # (the cuBLAS workspace setting makes its products deterministic)
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
                       MASTER_ADDR="localhost", MASTER_PORT=str(port),
                       CUBLAS_WORKSPACE_CONFIG=":4096:8")
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--parallel-worker", path],
                env=env, cwd=os.path.dirname(os.path.abspath(__file__))))
        deadline = time.monotonic() + timeout
        try:
            for rank, p in enumerate(procs):
                code = p.wait(timeout=max(1.0, deadline - time.monotonic()))
                if code != 0:
                    raise AssertionError(f"parallel: rank {rank} of {world} exited with {code}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        results = []
        for rank in range(world):
            with open(f"{path}.rank{rank}.json") as f:
                results.append(json.load(f))
        return results


def parallel_phase(launch_counters, card):
    """Phase 17: the parallel layer (``mindaudio_torch/parallel``) on the
    one card, two ranks sharing it over ``PAR_BACKEND`` (see the module
    docstring): the Conformer recipe with ZeRO-1 and its checkpoint resumed
    by one process, then each layout of ``PAR_TWO_RANKS`` (and, at world
    size 1 over NCCL, of ``PAR_ONE_RANK``) held against one process on the
    global batch. ``launch_counters`` (the four kernel wrappers) are set to
    0 here and read after the one-process resume; the ranks report their
    own CTC launches. Returns the summary."""
    import tempfile

    from mindaudio_torch.recipes.conformer import compute_cmvn_stats, convergence_run
    from mindaudio_torch.recipes.conformer import train as rtrain
    from mindaudio_torch.train import checkpoint

    log(f"parallel: {len(PAR_TWO_RANKS)} layouts at two ranks sharing the one card over "
        f"{PAR_BACKEND} (CUDA tensors): {', '.join(PAR_TWO_RANKS)}; at world size 1 over "
        f"NCCL: {', '.join(PAR_ONE_RANK) or 'none'}. Two processes on one card time "
        "correctness, not a multi-GPU speed.")
    out = {"two_ranks": list(PAR_TWO_RANKS), "one_rank": list(PAR_ONE_RANK),
           "backend": PAR_BACKEND, "card": card}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_recipe_") as root:
        convergence_run.gen(root, n_train=PAR_RECIPE_UTTS[0], n_dev=PAR_RECIPE_UTTS[1],
                            n_test=PAR_RECIPE_UTTS[2])
        compute_cmvn_stats.main(par_recipe_args(root, PAR_RECIPE_STEPS))
        t = time.perf_counter()
        ranks = par_spawn({"layouts": ["recipe", *PAR_TWO_RANKS], "root": root}, 2, 900)
        out["seconds_two_ranks"] = time.perf_counter() - t
        if PAR_ONE_RANK:
            one = par_spawn({"layouts": list(PAR_ONE_RANK), "root": root}, 1, 600)[0]
            ranks[0].update(one)
        recipe = [r["recipe"] for r in ranks]
        if recipe[0]["losses"] != recipe[1]["losses"] or recipe[0]["final_step"] != 2:
            raise AssertionError(f"parallel recipe: ranks disagree or stopped early: {recipe}")
        saved = checkpoint.restore_checkpoint(f"{root}/ckpt")
        for c in launch_counters:
            c.launches = 0
        resumed = rtrain.main(par_recipe_args(root, 2 * PAR_RECIPE_STEPS))
        launches = [c.launches for c in launch_counters]
        again = checkpoint.restore_checkpoint(f"{root}/ckpt")
        if (resumed["start_step"], resumed["final_step"]) != (2, 4) or int(
                again["opt_state"]["count"]) != int(saved["opt_state"]["count"]) + 2:
            raise AssertionError(f"parallel recipe: the two-rank checkpoint did not resume: "
                                 f"{resumed}")
        out["recipe"] = {"two_rank_losses": recipe[0]["losses"],
                         "resumed_at_one": [resumed["start_step"], resumed["final_step"]],
                         "launches_one_process": launches}
        log(f"parallel recipe: main() at full width with ZeRO-1 on two ranks, losses "
            f"{recipe[0]['losses']} on both; its checkpoint resumed by one process at global "
            f"step {resumed['start_step']} to {resumed['final_step']}")
    for name in (*PAR_TWO_RANKS, *PAR_ONE_RANK):
        res = [r[name] for r in ranks if name in r]
        launches = [r["ctc_launches"] for r in res]
        if name not in PAR_NO_KERNEL and any(l[0] < 1 or l[1] < 1 for l in launches):
            raise AssertionError(f"parallel {name}: a rank launched no CTC kernel: {launches}")
        summary = {"ranks": len(res), "ctc_launches_per_rank": launches,
                   "ms_per_rank": [r["ms"] for r in res],
                   "one_process_ms": res[0].get("one_process_ms"),
                   "worst_ratio": res[0]["check"]["worst_ratio"],
                   "loss": res[0]["check"]["loss"], "seconds": res[0]["seconds"]}
        if name == "data_zero1":
            summary.update(bit_equal=all(r["bit_equal"] for r in res),
                           moment_bytes=res[0]["moment_bytes"], losses=res[0]["losses"],
                           control_unequal=res[0]["control_unequal"])
        out[name] = summary
        what = ("a train step with ZeRO-1" if name == "data_zero1"
                else "forward, backward and gradient sync")
        log(f"parallel {name}: ms a step ({what}; float32, TF32 off) "
            f"{' / '.join(f'{v:.1f}' for v in summary['ms_per_rank'])} on the "
            f"{len(res)} rank(s) sharing {card}, one process on the global batch "
            f"{summary['one_process_ms']:.1f}; CTC launches per rank {launches}")
    return out


PHASE_SECONDS = {}
_PHASE_START = [None, None]


def phase_seconds(next_phase):
    """Note the seconds since the phase before ``next_phase`` began (the
    phases' own numbering; 7 and 8 run as one)."""
    now = time.perf_counter()
    if _PHASE_START[0] is not None:
        PHASE_SECONDS[_PHASE_START[0]] = round(now - _PHASE_START[1], 1)
    _PHASE_START[:] = [next_phase, now]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--parallel-worker"]:
        return parallel_worker(sys.argv[2])
    from mindaudio_torch.models.asr_model import ASRModel
    from mindaudio_torch.ops import _build
    from mindaudio_torch.ops import ctc_dp, logmel, quant
    from mindaudio_torch.ops.spectral import kaldi_fbank
    from mindaudio_torch.utils.recognize import ASRInference

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:] == ["--profile-train"]:
        profile_train()
        return 0
    if sys.argv[1:] == ["--profile-separation"]:
        profile_separation()
        return 0
    if sys.argv[1:] == ["--profile-tts"]:
        profile_tts()
        return 0
    if sys.argv[1:] == ["--profile-vocoder"]:
        profile_vocoder()
        return 0
    log("tf32: matmul", torch.backends.cuda.matmul.allow_tf32,
        "cudnn", torch.backends.cudnn.allow_tf32)

    # 1. the card
    phase_seconds(1)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    log(card)
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "device", torch.cuda.get_device_name(0))

    phase_seconds(2)
    # 2. build
    t0 = time.perf_counter()
    reports = _build.build()
    log(f"build: {sorted(reports) or 'cached'} in {time.perf_counter() - t0:.1f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry function" in line:
                log(f"  ptxas {name}: {line.strip()}")

    phase_seconds(3)
    # 3. kernel against its plain version at the slice's shapes
    t_sub = ((1 + (SAMPLES - 400) // 160 - 1) // 2 - 1) // 2
    f_sub = ((N_MELS - 1) // 2 - 1) // 2
    enc_m, dec_m = BATCH * t_sub, BATCH * BEAM * (MAX_TGT + 1)
    mem_m = BATCH * BEAM * t_sub
    path_shapes = [
        (enc_m, f_sub * D_MODEL, D_MODEL), (enc_m, D_MODEL, FFN), (enc_m, FFN, D_MODEL),
        (enc_m, D_MODEL, D_MODEL), (t_sub, D_MODEL, D_MODEL), (enc_m, D_MODEL, 2 * D_MODEL),
        (enc_m, D_MODEL, VOCAB), (dec_m, D_MODEL, D_MODEL), (mem_m, D_MODEL, D_MODEL),
        (dec_m, D_MODEL, FFN), (dec_m, FFN, D_MODEL), (dec_m, D_MODEL, VOCAB),
    ]
    one_request = [(t_sub, k, n) for m, k, n in path_shapes if m == enc_m]
    ragged = (1001, D_MODEL, VOCAB)
    cases = dict.fromkeys([(s, torch.bfloat16) for s in path_shapes + [ragged]]
                          + [(s, torch.float32) for s in path_shapes + one_request + [ragged]])
    lib = quant._launcher()  # checks the kernel's tile against split_k's
    log(f"int8_matmul kernel: {lib.int8_matmul_smem_bytes()} bytes of dynamic shared memory "
        "per block of 512 threads (two consumer, two producer warpgroups); tile "
        f"{quant.TILE_M}x{quant.TILE_N}, K stage {quant.TILE_K}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    log("int8_matmul vs plain: M K N dtype splits | max_abs max_rel tol | kernel (of it the "
        "split-K sum) plain library bound (ms) | bound/kernel | first int8 kernel (ms, "
        "FIRST_INT8_MS), faster")
    for (m, k, n), dtype in cases:
        r = check_int8_gemm(quant, m, k, n, dtype, gen)
        results.append(r)
        first = FIRST_INT8_MS.get((m, k, n, r["dtype"]))
        reduce = f" ({r['reduce_ms']:.4f})" if "reduce_ms" in r else ""
        log(f"  {m} {k} {n} {r['dtype']} {r['splits']} | {r['max_abs_err']:.3e} "
            f"{r['max_rel_err']:.3e} {r['tol']:.3e} | {r['ms']:.4f}{reduce} {r['plain_ms']:.4f} "
            f"{r['library_ms']:.4f} {r['bound_ms']:.4f} ({r['bound_by']}) | "
            f"{r['bound_share']:.3f} | " + (f"{first:.4f} {r['ms'] < first}" if first else "-"))
    # edge cases, checked and not timed: ragged M, K and N, split K on a long
    # K, and x views whose address is not 16-byte aligned (the plain-load path)
    edges = [((m, k, n), dtype, 0) for m in (1, 63, 65, 1001) for k in (200, 4864)
             for n in (8, VOCAB, FFN) for dtype in (torch.bfloat16, torch.float32)]
    edges += [((513, D_MODEL, D_MODEL), torch.bfloat16, 1), ((65, 4864, VOCAB), torch.bfloat16, 3),
              ((63, 200, 2048), torch.float32, 1)]
    edge_results = [check_int8_gemm(quant, m, k, n, dtype, gen, timed=False, x_offset=off)
                    for (m, k, n), dtype, off in edges]
    split_cases = sorted({(r["m"], r["k"], r["n"], r["splits"]) for r in edge_results + results
                          if r["splits"] > 1})
    log(f"int8_matmul edge cases: {len(edge_results)} agree (M 1/63/65/1001 x K 200/4864 x "
        f"N 8/{VOCAB}/{FFN} x bf16/f32, and 3 x views off 16-byte alignment); worst "
        f"max_abs/tol {max(r['max_abs_err'] / r['tol'] for r in edge_results):.3f}; split-K "
        f"bit-identical over two runs at {len(split_cases)} shapes: {split_cases}")
    checked = {(r["m"], r["k"], r["n"], r["dtype"]): r for r in results}

    phase_seconds(4)
    # 4. the slice at full width
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = ASRModel(VOCAB, input_dim=N_MELS, d_model=D_MODEL, head_num=HEADS,
                     ffn_dim=FFN, num_encoder_layers=ENC_LAYERS,
                     num_decoder_layers=DEC_LAYERS, kernel_size=CONV_KERNEL,
                     device="cuda").reset_parameters(gen).eval()
    serving = ASRInference(model, beam_size=BEAM, max_tgt_len=MAX_TGT, weight_quant="int8",
                           weight_quant_min_size=QUANT_MIN, dtype=torch.bfloat16)
    n_int8 = sum(isinstance(m, quant.Int8Linear) for m in serving.model.modules())
    log(f"model: {sum(p.numel() for p in model.parameters()) / 1e6:.2f} M params, "
        f"{n_int8} int8 layers")
    if n_int8 != ENCODE_LAUNCHES + DECODE_LAUNCHES:
        raise AssertionError(f"{n_int8} int8 layers, expected "
                             f"{ENCODE_LAUNCHES + DECODE_LAUNCHES}")
    wav_np, frames = synthetic_speech(BATCH, seed=0)
    wav = torch.from_numpy(wav_np).cuda()
    frame_lens = torch.from_numpy(frames).cuda()

    def serve():
        times = {}
        t = time.perf_counter()
        feats = kaldi_fbank(wav, num_mel_bins=N_MELS, device="cuda")
        torch.cuda.synchronize()
        times["fbank"] = time.perf_counter() - t
        t = time.perf_counter()
        greedy = serving.ctc_greedy_search(feats, frame_lens)
        times["ctc_greedy_search"] = time.perf_counter() - t
        t = time.perf_counter()
        rescored = serving.attention_rescoring_batch(feats, frame_lens)
        times["attention_rescoring_batch"] = time.perf_counter() - t
        return feats, greedy, rescored, times

    warm_feats = serve()[0]  # warm-up: cuDNN/cuBLAS handles and the allocator
    t = time.perf_counter()
    serving.ctc_prefix_beam_search_batch(warm_feats, frame_lens)
    log(f"stage ctc_prefix_beam_search_batch (encoder, top-k, host DP): "
        f"{1e3 * (time.perf_counter() - t):.1f} ms per batch")
    shapes = collections.Counter()
    hooks = count_gemm_shapes(serving.model, quant, shapes)
    quant.int8_matmul.launches = quant.int8_matmul.reduce_launches = 0
    feats, (hyps, scores), rescored, times = serve()
    launches, reduce_launches = quant.int8_matmul.launches, quant.int8_matmul.reduce_launches
    for h in hooks:
        h.remove()
    for name, sec in times.items():
        log(f"latency {name}: {1e3 * sec:.1f} ms per batch of {BATCH} x 10 s")
    expected = 2 * ENCODE_LAUNCHES + DECODE_LAUNCHES
    log(f"int8_matmul launches in the served batch: {launches} (expected {expected})")
    if launches != expected:
        raise AssertionError(f"int8_matmul launched {launches} times, expected {expected}")
    unchecked = set(shapes) - set(checked)
    if unchecked:
        raise AssertionError(f"GEMM shapes on the path not checked in phase 3: {unchecked}")
    expected_reduce = sum(n for s, n in shapes.items() if checked[s]["splits"] > 1)
    log(f"split-K sum pass launches in the served batch: {reduce_launches} (expected "
        f"{expected_reduce}); int8 GEMM launches by (M, K, N, dtype): "
        f"{dict(sorted(shapes.items()))}")
    if reduce_launches != expected_reduce:
        raise AssertionError(f"split-K sum pass launched {reduce_launches} times, "
                             f"expected {expected_reduce}")
    totals = {key: sum(checked[s].get(key, 0.0) * n for s, n in shapes.items())
              for key in ("ms", "reduce_ms", "plain_ms", "library_ms", "bound_ms")}
    first_total = sum(FIRST_INT8_MS[s] * n for s, n in shapes.items())
    log("int8 GEMM device time per served batch (phase-3 times x launches): "
        + ", ".join(f"{key} {value:.3f}" for key, value in totals.items())
        + f"; kernel / library {totals['ms'] / totals['library_ms']:.2f}; the first int8 "
        f"kernel {first_total:.3f} (FIRST_INT8_MS)")

    if feats.shape != (BATCH, 1028, N_MELS) or not torch.isfinite(feats).all():
        raise AssertionError(f"fbank: shape {tuple(feats.shape)} or non-finite values")
    if len(hyps) != BATCH or not np.isfinite(scores).all():
        raise AssertionError("ctc_greedy_search: wrong batch or non-finite scores")
    if any(not 0 < tok < VOCAB for h in hyps for tok in h):
        raise AssertionError("ctc_greedy_search: token out of range")
    if len(rescored) != BATCH or any(
            not np.isfinite(s) or len(h) > MAX_TGT or any(not 0 < t < VOCAB for t in h)
            for h, s in rescored):
        raise AssertionError("attention_rescoring_batch: malformed result")
    log(f"greedy hyp lengths {[len(h) for h in hyps]}; "
        f"rescored lengths {[len(h) for h, _ in rescored]}")
    # the native prefix-beam DP that rescoring ran, against the Python DP: on
    # the served batch's own top-k (bf16 logits, so exact ties), then on the
    # float32 model's
    dps = {"served": dp_check("the served batch's", serving.model, feats, frame_lens),
           "float32": dp_check("the float32 model's", model, feats, frame_lens)}

    # one request, float32 model: the card against the CPU's plain versions,
    # on the same features (the front-end is compared on its own first)
    n0 = int(frames[0])
    wav0 = wav_np[:1, :SAMPLES]
    feats_cpu = kaldi_fbank(wav0, num_mel_bins=N_MELS, device="cpu")
    feats_gpu = kaldi_fbank(torch.from_numpy(wav0).cuda(), num_mel_bins=N_MELS, device="cuda")
    fbank_err = (feats_gpu.cpu() - feats_cpu).abs().max().item()
    log(f"kaldi_fbank card vs CPU: max abs err {fbank_err:.3e} (tol 1e-3)")
    if not fbank_err <= 1e-3:  # log-mel of float32 power sums in another order
        raise AssertionError(f"kaldi_fbank: card and CPU differ by {fbank_err}")
    lens0 = torch.tensor([n0])
    # log-prob tolerances: float32 throughout, sums in another order, ~1e-6
    # apart, so 1e-4; with int8 weights each of the 195 GEMMs rounds its input
    # to bf16 (2^-9 relative) and inputs that are a float32 rounding apart on
    # the two sides land on neighbouring bf16 values, which 12 blocks grow to
    # a few 1e-2 at the log-probs: 0.1. A frame whose CPU top-2 margin is
    # within twice that tolerance is a near-tie; every other frame's best
    # token must be equal.
    for quant_mode, lp_tol in (("none", 1e-4), ("int8", 0.1)):
        gpu = ASRInference(model, weight_quant=quant_mode, weight_quant_min_size=QUANT_MIN)
        cpu = ASRInference(copy.deepcopy(model).cpu(), weight_quant=quant_mode,
                           weight_quant_min_size=QUANT_MIN)
        with torch.inference_mode():
            lp_gpu = gpu.model.ctc_log_probs(
                gpu.model.encode(feats_cpu.cuda(), lens0.cuda())[0]).cpu()[0]
            lp_cpu = cpu.model.ctc_log_probs(cpu.model.encode(feats_cpu, lens0)[0])[0]
        lp_err = (lp_gpu - lp_cpu).abs().max().item()
        top2 = lp_cpu.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        differ = lp_gpu.argmax(-1) != lp_cpu.argmax(-1)
        decided_differ = (differ & (margin > 2 * lp_tol)).sum().item()
        hyp_gpu = gpu.ctc_greedy_search(feats_cpu.cuda(), lens0.cuda())[0]
        hyp_cpu = cpu.ctc_greedy_search(feats_cpu, lens0)[0]
        log(f"one request, f32, weight_quant={quant_mode}: log-prob max abs err "
            f"{lp_err:.3e} (tol {lp_tol}); frames whose best token differs "
            f"{differ.sum().item()} (near-ties {differ.sum().item() - decided_differ}); "
            f"least CPU top-2 margin {margin.min().item():.3e}; "
            f"greedy hyps equal {hyp_gpu == hyp_cpu}")
        if not lp_err <= lp_tol:
            raise AssertionError(f"{quant_mode}: log-probs differ by {lp_err} > {lp_tol}")
        if decided_differ:
            raise AssertionError(f"{quant_mode}: best token differs at {decided_differ} "
                                 "frames that are not near-ties")

    # free the serving models before the training phases
    del serving, gpu, cpu, model
    torch.cuda.empty_cache()

    phase_seconds(5)
    # 5. CTC: the chain's latency ladder, then the kernels against the plain
    # recursion at every case, with the launch plan of each
    ladder = ctc_chain_ladder(_build)
    floor_us = ladder["variants"]["a"]["us_per_step"]
    log(f"ctc chain ladder, B T S = {ladder['shape']} (csrc/ctc_probe.cu; median over blocks "
        "and launches): variant | us per step | SM cycles per step | share of (d) | launch time "
        "over T, us | what")
    for name, r in ladder["variants"].items():
        share = "-" if r["share_of_d"] is None else f"{r['share_of_d']:.3f}"
        log(f"  ({name}) {r['shape']} | {r['us_per_step']:.4f} | {r['cycles_per_step']:.1f} | "
            f"{share} | {r['launch_us_per_step']:.4f} | {r['what']}")
    gen = torch.Generator(device="cuda").manual_seed(2)
    log("ctc_dp vs plain: case [B T S V] path k threads chunk | max abs err: loss, loss at "
        "logits, grad logp_ext, grad logits | tol value, grad")
    ctc_results = {}
    for name in CTC_CASES:
        r = ctc_results[name] = check_ctc(ctc_dp, name, gen, floor_us)
        e, p = r["max_abs_err"], r["plan"]
        log(f"  {name} {r['shape']} {p['path']} {p['k']} {p['threads']} {p['chunk']} | "
            f"{e['loss']:.3e} {e['loss_at_logits']:.3e} {e['grad_logp_ext']:.3e} "
            f"{e['grad_logits']:.3e} | {r['tol_value']:.3e} {r['tol_grad']:.3e}")
    log("ctc_dp times (ms): case | kernel fwd, bwd (CUDA graph) | plain fwd, bwd (eager) | "
        "F.ctc_loss fwd, bwd (device time) | bound fwd, bwd (bytes) | chain floor (steps x "
        "ladder (a), measured) | steps, us per step fwd, bwd")
    for name in CTC_TIMED:
        r = ctc_results[name]
        log(f"  {name} | {r['fwd_ms']:.4f} {r['bwd_ms']:.4f} | {r['plain_fwd_ms']:.2f} "
            f"{r['plain_bwd_ms']:.2f} | {r['library_fwd_ms']:.4f} {r['library_bwd_ms']:.4f} | "
            f"{r['fwd_bound_ms']:.5f} {r['bwd_bound_ms']:.5f} | {r['chain_floor_ms']:.4f} | "
            f"{r['chain_steps']} "
            f"{r['fwd_us_per_step']:.4f} {r['bwd_us_per_step']:.4f}; F.ctc_loss vs kernel "
            f"max abs err {r['library_max_abs_err']:.3e}")
    band_us = ladder["variants"]["e"]["us_per_step"]
    for name in CTC_TIMED:
        r = ctc_results[name]
        if name in BLOCK_PATH_MS:  # DeepSpeech2's S = 701
            if r["plan"]["path"] != "band":
                raise AssertionError(f"ctc_dp {name}: S = 701 took the {r['plan']['path']} path")
            r["band_floor_ms"] = r["chain_steps"] * band_us / 1e3
            pr8_fwd, pr8_bwd = BLOCK_PATH_MS[name]
            log(f"  {name}: band path, {r['plan']['threads'] // 32} warps a sequence; "
                f"chain floor at rung (a) "
                f"{r['chain_floor_ms']:.4f} ms, at rung (e) {band_us:.4f} us "
                f"{r['band_floor_ms']:.4f} ms; kernel / rung (e) floor fwd "
                f"{r['fwd_ms'] / r['band_floor_ms']:.3f}, bwd {r['bwd_ms'] / r['band_floor_ms']:.3f}; "
                f"first design's block path fwd {r['block_path_fwd_ms']:.4f}, bwd "
                f"{r['block_path_bwd_ms']:.4f} (this run; PR 8 read {pr8_fwd:.4f}, "
                f"{pr8_bwd:.4f}: BLOCK_PATH_MS), kernel / block path fwd "
                f"{r['fwd_ms'] / r['block_path_fwd_ms']:.3f}, bwd "
                f"{r['bwd_ms'] / r['block_path_bwd_ms']:.3f}; kernel / F.ctc_loss fwd "
                f"{r['fwd_ms'] / r['library_fwd_ms']:.3f}, bwd "
                f"{r['bwd_ms'] / r['library_bwd_ms']:.3f}")

    phase_seconds(6)
    # 6. fused log-mel kernel against its plain version, then its entry point
    gen = torch.Generator(device="cuda").manual_seed(3)
    asr = dict(n_fft=400, hop_length=160, n_mels=N_MELS)
    tts = dict(sample_rate=22050, n_fft=1024)
    plan, _, _, wts, carries = logmel_plan(logmel, **asr)
    smem = logmel._library().logmel_smem_bytes(plan.fpb, plan.rows, plan.pitch, N_MELS, wts.size,
                                               carries, plan.stages)
    if smem != plan.smem_bytes:
        raise AssertionError(f"fused_logmel: the kernel lays out {smem} bytes of shared memory, "
                             f"the wrapper's plan {plan.smem_bytes}")
    log(f"fused_logmel kernel at n_fft 400, hop 160, 80 mels: {smem} bytes of dynamic shared "
        f"memory per block of {(plan.fpb // 64 + 1) * 128} threads ({plan.fpb} frames: two "
        f"consumer warpgroups, a producer thread, three mel warps), {plan.stages} ring slots")
    logmel_results = [
        check_logmel(logmel, (LOGMEL_BATCH, LOGMEL_SAMPLES), gen, timed=True, **asr),
        check_logmel(logmel, (16, 220500), gen, timed=True, hop_length=256, n_mels=80, **tts),
        check_logmel(logmel, (16, 220500), gen, timed=True, hop_length=300, n_mels=128, **tts),
        check_logmel(logmel, (3, 16000 + 37), gen, n_fft=400, hop_length=160, n_mels=40),
        check_logmel(logmel, (3, 16000 + 37), gen, n_fft=400, hop_length=160, n_mels=40,
                     kaldi=True),
        check_logmel(logmel, (3, 16000 + 37), gen, n_fft=400, hop_length=160, n_mels=40,
                     center=False),
        check_logmel(logmel, (2, 5003), gen, n_mels=23, n_fft=512, win_length=400,
                     hop_length=100, window="hamming", f_min=20.0, f_max=7600.0, log_floor=1e-5),
        check_logmel(logmel, (1, 300), gen, n_mels=8),  # shorter than one frame
    ]
    for r in logmel_results:
        log(f"fused_logmel vs plain, both precisions: {r['shape']} {r['args']} -> "
            f"{r['out_shape']}: max abs err {r['max_abs_err']:.3e}, max err/tol "
            f"{r['max_err_over_tol']:.4f} (tol {r['tol']})")
    log("fused_logmel times, in turns (plain, kernel 'default', kernel 'highest', plain; ms) | "
        "kernel plain | bound "
        "(three TF32 passes) | float32 CUDA-core bound, one-TF32-pass bound | frames a block, "
        "ring slots, shared bytes")
    for r in logmel_results[:3]:
        log(f"  {r['shape']} {r['args']} | {' '.join(f'{t:.4f}' for t in r['turns_ms'])} | "
            f"{r['ms']:.4f} {r['plain_ms']:.4f} | {r['bound_ms']:.4f} ({r['bound_by']}, "
            f"{r['operations']:.3e} operations, {r['bytes'] / 1e6:.1f} MB) | "
            f"{r['bound_ms_f32_cuda_cores']:.4f} {r['bound_ms_one_tf32_pass']:.4f} | "
            f"{r['frames_per_block']} {r['ring_slots']} {r['smem_bytes']}")
    mel = logmel_results[0]
    if not max(mel["turns_ms"][1:3]) < min(mel["turns_ms"][0], mel["turns_ms"][3]):
        raise AssertionError(f"fused_logmel at {mel['shape']}: the kernel is not faster than the "
                             f"plain version at both precisions: {mel['turns_ms']}")
    exact = logmel_against_f64(
        logmel, torch.randn(4, LOGMEL_SAMPLES, device="cuda", generator=gen), **asr)
    log(f"fused_logmel against float64 on (4, {LOGMEL_SAMPLES}): max err/tol kernel "
        f"{exact['kernel']:.4f}, plain {exact['plain']:.4f}")
    if not exact["kernel"] <= 1:
        raise AssertionError(f"fused_logmel: exceeds the tolerance against float64: {exact}")
    mel["against_f64_max_err_over_tol"] = exact
    wave = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (LOGMEL_BATCH, LOGMEL_SAMPLES)).astype(np.float32)).cuda()
    logmel.fused_logmel(wave, n_fft=400, hop_length=160, n_mels=N_MELS)  # warm-up
    torch.cuda.synchronize()
    logmel.fused_logmel.launches = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t = time.perf_counter()
    start.record()
    for _ in range(LOGMEL_CALLS):
        mel_out = logmel.fused_logmel(wave, n_fft=400, hop_length=160, n_mels=N_MELS)
    end.record()
    enqueue_sec = (time.perf_counter() - t) / LOGMEL_CALLS
    torch.cuda.synchronize()
    mel_sec = (time.perf_counter() - t) / LOGMEL_CALLS
    logmel_launches = logmel.fused_logmel.launches
    log(f"log-mel entry point: {LOGMEL_CALLS} calls of {tuple(wave.shape)} -> "
        f"{tuple(mel_out.shape)}, {1e3 * mel_sec:.3f} ms per call, "
        f"{mel_out.shape[0] * mel_out.shape[1] / mel_sec / 1e6:.2f} M frames/s, "
        f"{logmel_launches} launches; the host took {1e3 * enqueue_sec:.3f} ms per call to "
        f"enqueue, the device {start.elapsed_time(end) / LOGMEL_CALLS:.3f} ms per call between "
        "events")
    if mel_out.shape != (LOGMEL_BATCH, 1001, N_MELS) or not torch.isfinite(mel_out).all():
        raise AssertionError(f"log-mel entry point: shape {tuple(mel_out.shape)} or non-finite")
    if logmel_launches != LOGMEL_CALLS:
        raise AssertionError(f"fused_logmel launched {logmel_launches} times, "
                             f"expected {LOGMEL_CALLS}")
    del wave, mel_out

    phase_seconds(7)
    # 7./8. train at full width; the poisoned batch; one step against the CPU
    flagship = ctc_results["flagship"]
    ctc_launches = train_phase(ctc_dp, flagship)
    card_against_cpu_step()

    phase_seconds(9)
    # 9. the recipe: manifest data, training with dev-scored checkpoints and a
    # resume, a best-2 average, decoding
    recipe_launches, recipe = recipe_phase(ctc_dp)

    phase_seconds(10)
    # 10. streaming decode of the served utterances, and the int8 GEMM at the
    # shapes it meets
    stream, stream_results = streaming_phase(quant, wav_np, frames)
    stream_launches = sum(r["launches"] for r in stream["runs"].values())

    phase_seconds(11)
    # 11. the DeepSpeech2 recipe at full width: the CTC pair on its band path
    ds2_launches, ds2 = deepspeech2_phase(ctc_dp)
    ds2_ctc = {name: ctc_results[name] for name in CTC_TIMED if name.startswith("deepspeech2")}

    phase_seconds(12)
    # 12. the ECAPA-TDNN recipe at full width: no TPU kernel on its path
    kernels = [quant.int8_matmul, ctc_dp.ctc_dp_fwd, ctc_dp.ctc_dp_bwd, logmel.fused_logmel]
    ecapa = ecapa_phase(kernels, card)
    log("ecapa_tdnn: " + json.dumps({"card": card, **{
        k: v for k, v in ecapa.items() if k not in ("losses", "window_ms")}}))
    ecapa_launches = ecapa["launches"]

    phase_seconds(13)
    # 13. the Conv-TasNet and TasNet recipes at full width: no TPU kernel on
    # their path
    separation = separation_phase(kernels, card)
    for name, summary in separation.items():
        log(f"{name}: " + json.dumps({"card": card, **{
            k: v for k, v in summary.items() if k not in ("losses", "window_ms")}}))
    sep_launches = {k: sum(s["launches"][k] for s in separation.values())
                    for k in ecapa_launches}

    phase_seconds(14)
    # 14. the FastSpeech2 recipe at full width: no TPU kernel on its path
    tts = fastspeech2_phase(kernels, card)
    log("fastspeech2: " + json.dumps({"card": card, **{
        k: v for k, v in tts.items() if k not in ("losses", "window_ms")}}))
    tts_launches = tts["launches"]

    phase_seconds(15)
    # 15. the WaveGrad recipe at full width: no TPU kernel on its path
    vocoder = wavegrad_phase(kernels, card)
    log("wavegrad: " + json.dumps({"card": card, **{
        k: v for k, v in vocoder.items() if k not in ("losses", "window_ms")}}))
    wg_launches = vocoder["launches"]

    phase_seconds(16)
    # 16. the Conformer recipe trained W8A8 with rematerialized blocks; the
    # W8A8 product and the DSP ops on the card
    int8_remat = int8_remat_phase(kernels, card)
    log("int8_remat: " + json.dumps({"card": card, **{
        k: v for k, v in int8_remat.items()
        if k not in ("losses", "window_ms", "card_against_cpu")}}))
    i8_launches = int8_remat["launches"]

    phase_seconds(17)
    # 17. the parallel layer: two ranks on the one card over gloo
    parallel = parallel_phase(kernels, card)
    log("parallel: " + json.dumps(parallel))
    par_ctc = {name: parallel[name]["ctc_launches_per_rank"]
               for name in (*PAR_TWO_RANKS, *PAR_ONE_RANK)}

    phase_seconds(None)
    log("seconds a phase: " + json.dumps(PHASE_SECONDS))

    # summary lines
    head = next(r for r in results if (r["m"], r["k"], r["n"], r["dtype"])
                == (enc_m, D_MODEL, FFN, "bfloat16"))
    ctc_shapes = [ctc_results[name] for name in CTC_CASES]

    def wide_rows(kind):  # the band path at DeepSpeech2's shapes, beside the block path
        return {name: {
            "path": r["plan"]["path"], "warps": r["plan"]["threads"] // 32, "shape": r["shape"],
            "ms": r[f"{kind}_ms"], "block_path_ms": r[f"block_path_{kind}_ms"],
            "bound_ms": r[f"{kind}_bound_ms"], "bound_by": "bytes",
            "chain_floor_ms_rung_a": r["chain_floor_ms"], "chain_floor_ms_rung_e": r["band_floor_ms"],
            "plain_ms": r[f"plain_{kind}_ms"], "library_ms": r[f"library_{kind}_ms"]}
            for name, r in ds2_ctc.items()}
    log('kernels: ["int8_matmul", "ctc_dp_fwd", "ctc_dp_bwd", "fused_logmel"]')
    log(json.dumps({"kernels": [{
        "name": "int8_matmul", "route": "cuda",
        "source": "mindaudio_torch/ops/csrc/int8_matmul.cu",
        "replaces": "mindaudio_tpu/ops/quant.py:60",
        "launches": launches, "max_abs_err": head["max_abs_err"],
        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "shape": [head["m"], head["k"], head["n"], head["dtype"]],
        "reduce_kernel": "splitk_reduce_kernel", "reduce_launches": reduce_launches,
        "card": card, "shapes": results, "prefix_beam_dp": dps,
        "stream_launches": stream_launches, "stream": stream,
        "stream_shapes": [r for r in stream_results if r["m"] == STREAM_CHUNK and "ms" in r],
        "ecapa_tdnn_launches": ecapa_launches["int8_matmul"],
        "separation_launches": sep_launches["int8_matmul"],
        "fastspeech2_launches": tts_launches["int8_matmul"],
        "wavegrad_launches": wg_launches["int8_matmul"],
        "int8_remat_launches": i8_launches["int8_matmul"],
    }, {
        "name": "ctc_dp_fwd", "route": "cuda",
        "source": "mindaudio_torch/ops/csrc/ctc_dp.cu",
        "replaces": "mindaudio_tpu/ops/pallas_ctc.py:76",
        "launches": ctc_launches[0], "max_abs_err": flagship["max_abs_err"]["loss"],
        "ms": flagship["fwd_ms"], "plain_ms": flagship["plain_fwd_ms"],
        "bound_ms": flagship["fwd_bound_ms"], "bound_by": "bytes",
        "library_ms": flagship["library_fwd_ms"], "shape": flagship["shape"],
        "chain_floor_ms": flagship["chain_floor_ms"], "chain_steps": flagship["chain_steps"],
        "us_per_step": flagship["fwd_us_per_step"], "floor_us_per_step": floor_us,
        "plan": flagship["plan"], "recipe_launches": recipe_launches[0], "recipe": recipe,
        "deepspeech2_launches": ds2_launches[0], "deepspeech2": ds2, "deepspeech2_ctc": ds2_ctc,
        "wide_rows": wide_rows("fwd"),
        "card": card, "chain_ladder": ladder, "shapes": ctc_shapes,
        "ecapa_tdnn_launches": ecapa_launches["ctc_dp_fwd"],
        "separation_launches": sep_launches["ctc_dp_fwd"],
        "fastspeech2_launches": tts_launches["ctc_dp_fwd"],
        "wavegrad_launches": wg_launches["ctc_dp_fwd"],
        "int8_remat_launches": i8_launches["ctc_dp_fwd"],
        "parallel_launches_per_rank": {k: [r[0] for r in v] for k, v in par_ctc.items()},
    }, {
        "name": "ctc_dp_bwd", "route": "cuda",
        "source": "mindaudio_torch/ops/csrc/ctc_dp.cu",
        "replaces": "mindaudio_tpu/ops/pallas_ctc.py:110",
        "launches": ctc_launches[1], "max_abs_err": flagship["max_abs_err"]["grad_logp_ext"],
        "ms": flagship["bwd_ms"], "plain_ms": flagship["plain_bwd_ms"],
        "bound_ms": flagship["bwd_bound_ms"], "bound_by": "bytes",
        "library_ms": flagship["library_bwd_ms"], "shape": flagship["shape"],
        "chain_floor_ms": flagship["chain_floor_ms"], "chain_steps": flagship["chain_steps"],
        "us_per_step": flagship["bwd_us_per_step"], "floor_us_per_step": floor_us,
        "recipe_launches": recipe_launches[1], "deepspeech2_launches": ds2_launches[1],
        "wide_rows": wide_rows("bwd"),
        "ecapa_tdnn_launches": ecapa_launches["ctc_dp_bwd"],
        "separation_launches": sep_launches["ctc_dp_bwd"],
        "fastspeech2_launches": tts_launches["ctc_dp_bwd"],
        "wavegrad_launches": wg_launches["ctc_dp_bwd"],
        "int8_remat_launches": i8_launches["ctc_dp_bwd"], "card": card,
        "parallel_launches_per_rank": {k: [r[1] for r in v] for k, v in par_ctc.items()},
    }, {
        "name": "fused_logmel", "route": "cuda",
        "source": "mindaudio_torch/ops/csrc/logmel.cu",
        "replaces": "mindaudio_tpu/ops/pallas_mel.py:96",
        "launches": logmel_launches, "max_abs_err": mel["max_abs_err"],
        "ms": mel["ms"], "plain_ms": mel["plain_ms"], "bound_ms": mel["bound_ms"],
        "bound_by": mel["bound_by"], "library_ms": None, "shape": mel["shape"], "passes": 3,
        "card": card, "shapes": logmel_results,
        "ecapa_tdnn_launches": ecapa_launches["fused_logmel"],
        "separation_launches": sep_launches["fused_logmel"],
        "fastspeech2_launches": tts_launches["fused_logmel"],
        "wavegrad_launches": wg_launches["fused_logmel"],
        "int8_remat_launches": i8_launches["fused_logmel"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
