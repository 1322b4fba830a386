#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mindaudio_torch``) on one NVIDIA GPU.

Run from the root of the repository, with no arguments::

    python3 chip_smoke.py

(``python3 chip_smoke.py --profile-train`` instead profiles a few train steps
with ``torch.profiler`` and prints the device's busy share and the kernels by
device time; it checks nothing.)

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
   split-K sum pass the count of those whose K is split. Then one request
   (B=1, float32 model) is held against the same weights on the CPU through
   the plain versions;
5. hold the CTC forward and backward kernels against the plain PyTorch
   recursion, in value and in gradient at ``logp_ext`` and at the logits, at
   the flagship train shape, the recipe's longest labels, the long bucket and
   the edge cases (ragged lengths with repeated labels, an empty label,
   ``T = 2L+1``, full length, blank as the last class, one frame); time
   forward, backward, the plain version, ``F.ctc_loss`` (the yardstick, never
   called by the port) and the bound;
6. hold the fused log-mel kernel against its plain version at the bench shape
   ``(128, 160000)``, at ``(3, 16037)`` with 40 mels, with ``kaldi=True`` and
   with ``center=False``; then drive the log-mel entry point as the bench
   does and count its launches;
7. train the flagship Conformer at full width and depth as the train bench
   builds the step: B=32, the 1027-frame bucket holding 10 s of seeded noise,
   20 labels, dither, SpecAugment, dropout, bf16 autocast, ``ctc_impl="kernel"``,
   AdamW (bf16 first moment), clip 5.0, one batch repeated. Every loss must be
   finite, the last below the first, the parameters moved, and the CTC
   kernels' launch counts equal to the number of steps; the same step with
   the plain CTC recursion is timed beside it;
8. one deterministic float32 step (B=2) on the card with the CTC kernels
   against the CPU with the plain recursion; and a poisoned batch, which must
   leave parameters and moments bit-equal and advance the step counter.

The last two lines are a JSON object ``{"kernels": [...]}`` and the result
line ``{"ok": true, "device": {...}}``. Float32 comparisons run with TF32 off
for both matrix products and cuDNN convolutions.
"""

import collections
import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_BF16_FLOP_PER_S = 989e12  # dense bf16 tensor cores, at 700 W
H100_TF32_FLOP_PER_S = 495e12  # dense TF32 tensor cores
H100_F32_FLOP_PER_S = 67e12  # float32 outside the tensor cores

VOCAB, N_MELS, D_MODEL, HEADS, FFN = 4233, 80, 256, 4, 2048
ENC_LAYERS, DEC_LAYERS, CONV_KERNEL = 12, 6, 15
BATCH, BEAM, MAX_TGT = 16, 10, 50
SAMPLE_RATE, SAMPLES = 16000, 164720  # the 10 s bucket: 1028 frames, T' = 256
QUANT_MIN = 65536  # weight_quant_min_size, as the JAX package serves
# the train bench: B=32, 10 s of audio in the 1027-frame bucket (T' = 256)
TRAIN_BATCH, TRAIN_LABELS, TRAIN_SAMPLES, TRAIN_TRUE_SAMPLES = 32, 20, 1027 * 160 + 400, 160000
TRAIN_WARMUP_STEPS, TRAIN_TIMED_STEPS, PLAIN_CTC_STEPS = 2, 10, 5
LOGMEL_BATCH, LOGMEL_SAMPLES, LOGMEL_CALLS = 128, 160000, 8  # the log-mel bench shape
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


def kernel_ms_by_name(fn, iters=10):
    """Device time per call of ``fn`` in ms for each CUDA kernel it launches,
    by name: ``torch.profiler`` over ``iters`` eager calls after one warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = collections.defaultdict(float)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.name] += e.device_time / 1e3 / iters
    return out


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
    raise KeyError(name)


CTC_CASES = ["flagship", "longest_labels", "long_bucket", "mixed_lengths_and_repeats",
             "empty_label", "minimal_fit", "full_length", "blank_is_last_class",
             "single_frame"]
CTC_TIMED = CTC_CASES[:3]


def check_ctc(ctc_dp, name, gen):
    """CTC kernels vs the plain recursion at one case: value, gradient at
    ``logp_ext`` and at the logits; for the train shapes also the times."""
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
    result = {"case": name, "shape": [b, t, s, v], "max_abs_err": errs, "max_loss": peak,
              "tol_value": tol_value, "tol_grad": tol_grad}
    if not ok:
        raise AssertionError(f"ctc_dp {name}: kernels and plain version disagree: {result}")
    if name not in CTC_TIMED:
        return result

    # times: each kernel alone in a CUDA graph; the plain pair and F.ctc_loss
    # eagerly (forward, backward), each on the tensors it consumes
    fwd_ms = cuda_ms(lambda: ctc_dp.ctc_dp_fwd(logp_ext, lens32, allowed8, llens32))
    bwd_ms = cuda_ms(lambda: ctc_dp.ctc_dp_bwd(logp_ext, alphas, lens32, allowed8, llens32,
                                               loss_k, g))

    def plain(mark):
        loss = ctc_dp.ctc_dp_reference(ref_in, lens, allowed, llens)
        mark()
        torch.autograd.grad(loss, ref_in, g)

    log_probs = F.log_softmax(logits, -1).transpose(0, 1).contiguous().requires_grad_()
    lens_host, llens_host = lens.tolist(), llens.tolist()

    def library(mark):
        loss = F.ctc_loss(log_probs, labels, lens_host, llens_host, blank=blank,
                          reduction="none")
        mark()
        torch.autograd.grad(loss, log_probs, g)

    plain_fwd, plain_bwd = event_ms(plain, iters=2, phases=2)
    lib_fwd, lib_bwd = event_ms(library, iters=5, phases=2)
    lib_loss = F.ctc_loss(log_probs, labels, lens_host, llens_host, blank=blank,
                          reduction="none")
    result["library_max_abs_err"] = (lib_loss - loss_k).abs().max().item()
    if not result["library_max_abs_err"] <= tol_value:
        raise AssertionError(f"ctc_dp {name}: F.ctc_loss disagrees: {result}")
    cells = b * t * s * 4
    result.update(
        fwd_ms=fwd_ms, bwd_ms=bwd_ms, plain_fwd_ms=plain_fwd, plain_bwd_ms=plain_bwd,
        library_fwd_ms=lib_fwd, library_bwd_ms=lib_bwd,
        # logp_ext read and alphas written; logp_ext and alphas read, grad written
        fwd_bound_ms=1e3 * 2 * cells / H100_BYTES_PER_S,
        bwd_bound_ms=1e3 * 3 * cells / H100_BYTES_PER_S,
        chain_steps=t, fwd_us_per_step=1e3 * fwd_ms / t, bwd_us_per_step=1e3 * bwd_ms / t)
    return result


def check_logmel(logmel, shape, gen, timed=False, **kw):
    """Log-mel kernel vs its plain version at one shape; times and bound."""
    x = torch.randn(*shape, device="cuda", generator=gen)
    got = logmel.fused_logmel(x, **kw)
    want = logmel.fused_logmel_reference(x, **kw)
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"fused_logmel {shape} {kw}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}, or non-finite values")
    err = (got - want).abs()
    # the tolerance the JAX package holds its own kernel to: rtol = atol = 1e-3
    excess = (err - (1e-3 + 1e-3 * want.abs())).max().item()
    result = {"shape": list(shape), "args": {k: str(v) for k, v in kw.items()},
              "out_shape": list(got.shape), "max_abs_err": err.max().item(),
              "tol": "1e-3 + 1e-3*|plain|"}
    if not excess <= 0:
        raise AssertionError(f"fused_logmel {shape} {kw}: exceeds tolerance by {excess}: {result}")
    if timed:
        b, n_frames, n_mels = got.shape
        n_fft = kw.get("n_fft", 400)
        n_freq = n_fft // 2 + 1
        ops = 2.0 * b * n_frames * (n_fft * 2 * n_freq + n_freq * n_mels)
        moved = 4.0 * (x.numel() + got.numel() + 2 * n_fft * n_freq + n_freq * n_mels)
        t_ops, t_bytes = ops / H100_F32_FLOP_PER_S, moved / H100_BYTES_PER_S
        result.update(
            ms=cuda_ms(lambda: logmel.fused_logmel(x, **kw), iters=5),
            plain_ms=cuda_ms(lambda: logmel.fused_logmel_reference(x, **kw), iters=5),
            bound_ms=1e3 * max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            bound_ms_tf32_tensor_cores=1e3 * max(ops / H100_TF32_FLOP_PER_S, t_bytes),
            bound_ms_bf16_tensor_cores=1e3 * max(ops / H100_BF16_FLOP_PER_S, t_bytes),
            operations=ops, bytes=moved)
    return result


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


def profile_train(steps=3, rows=25):
    """``--profile-train``: ``torch.profiler`` over a few steady train steps.
    Prints the device's busy share of the window and the kernels by device
    time; not part of the smoke run."""
    from torch.profiler import ProfilerActivity, profile

    _, _, step, batch = make_trainer()
    for _ in range(TRAIN_WARMUP_STEPS):
        step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)  # before the profiler's own wrap-up
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time for e in events) / 1e3 if events else 0.0
    log(f"profile: {steps} train steps, {wall_ms:.1f} ms of host time with the profiler on, "
        f"{len(events)} device operations ({len(events) / steps:.0f} per step), device busy "
        f"{busy_ms:.1f} ms = {100 * busy_ms / wall_ms:.1f}% of the window")
    log(prof.key_averages().table(sort_by="device_time_total", row_limit=rows,
                                  max_name_column_width=60))


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
        f"step counter {count} -> {optimizer.count.item()}")
    if np.isfinite(bad_loss) or not same or optimizer.count.item() != count + 1:
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
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
    log("tf32: matmul", torch.backends.cuda.matmul.allow_tf32,
        "cudnn", torch.backends.cudnn.allow_tf32)

    # 1. the card
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    log(card)
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "device", torch.cuda.get_device_name(0))

    # 2. build
    t0 = time.perf_counter()
    reports = _build.build()
    log(f"build: {sorted(reports) or 'cached'} in {time.perf_counter() - t0:.1f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry function" in line:
                log(f"  ptxas {name}: {line.strip()}")

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

    # 5. CTC kernels against the plain recursion
    gen = torch.Generator(device="cuda").manual_seed(2)
    log("ctc_dp vs plain: case [B T S V] | max abs err: loss, loss at logits, grad logp_ext, "
        "grad logits | tol value, grad")
    ctc_results = {}
    for name in CTC_CASES:
        r = ctc_results[name] = check_ctc(ctc_dp, name, gen)
        e = r["max_abs_err"]
        log(f"  {name} {r['shape']} | {e['loss']:.3e} {e['loss_at_logits']:.3e} "
            f"{e['grad_logp_ext']:.3e} {e['grad_logits']:.3e} | {r['tol_value']:.3e} "
            f"{r['tol_grad']:.3e}")
    log("ctc_dp times (ms): case | kernel fwd, bwd (CUDA graph) | plain fwd, bwd (eager) | "
        "F.ctc_loss fwd, bwd (eager) | bound fwd, bwd (bytes) | T steps, us per step fwd, bwd")
    for name in CTC_TIMED:
        r = ctc_results[name]
        log(f"  {name} | {r['fwd_ms']:.4f} {r['bwd_ms']:.4f} | {r['plain_fwd_ms']:.2f} "
            f"{r['plain_bwd_ms']:.2f} | {r['library_fwd_ms']:.4f} {r['library_bwd_ms']:.4f} | "
            f"{r['fwd_bound_ms']:.5f} {r['bwd_bound_ms']:.5f} | {r['chain_steps']} "
            f"{r['fwd_us_per_step']:.3f} {r['bwd_us_per_step']:.3f}; F.ctc_loss vs kernel "
            f"max abs err {r['library_max_abs_err']:.3e}")

    # 6. fused log-mel kernel against its plain version, then its entry point
    gen = torch.Generator(device="cuda").manual_seed(3)
    logmel_results = [
        check_logmel(logmel, (LOGMEL_BATCH, LOGMEL_SAMPLES), gen, timed=True,
                     n_fft=400, hop_length=160, n_mels=N_MELS),
        check_logmel(logmel, (3, 16000 + 37), gen, n_fft=400, hop_length=160, n_mels=40),
        check_logmel(logmel, (3, 16000 + 37), gen, n_fft=400, hop_length=160, n_mels=40,
                     kaldi=True),
        check_logmel(logmel, (3, 16000 + 37), gen, n_fft=400, hop_length=160, n_mels=40,
                     center=False),
    ]
    for r in logmel_results:
        log(f"fused_logmel vs plain: {r['shape']} {r['args']} -> {r['out_shape']}: "
            f"max abs err {r['max_abs_err']:.3e} (tol {r['tol']})")
    mel = logmel_results[0]
    log(f"fused_logmel times at {mel['shape']}: kernel {mel['ms']:.3f} ms, plain "
        f"{mel['plain_ms']:.3f} ms, bound {mel['bound_ms']:.3f} ms ({mel['bound_by']}, float32 "
        f"peak; {mel['bound_ms_tf32_tensor_cores']:.3f} ms at the TF32 and "
        f"{mel['bound_ms_bf16_tensor_cores']:.3f} ms at the bf16 tensor-core peak), "
        f"{mel['operations']:.3e} operations, {mel['bytes'] / 1e6:.1f} MB")
    wave = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (LOGMEL_BATCH, LOGMEL_SAMPLES)).astype(np.float32)).cuda()
    logmel.fused_logmel(wave, n_fft=400, hop_length=160, n_mels=N_MELS)  # warm-up
    torch.cuda.synchronize()
    logmel.fused_logmel.launches = 0
    t = time.perf_counter()
    for _ in range(LOGMEL_CALLS):
        mel_out = logmel.fused_logmel(wave, n_fft=400, hop_length=160, n_mels=N_MELS)
    torch.cuda.synchronize()
    mel_sec = (time.perf_counter() - t) / LOGMEL_CALLS
    logmel_launches = logmel.fused_logmel.launches
    log(f"log-mel entry point: {LOGMEL_CALLS} calls of {tuple(wave.shape)} -> "
        f"{tuple(mel_out.shape)}, {1e3 * mel_sec:.3f} ms per call, "
        f"{mel_out.shape[0] * mel_out.shape[1] / mel_sec / 1e6:.2f} M frames/s, "
        f"{logmel_launches} launches")
    if mel_out.shape != (LOGMEL_BATCH, 1001, N_MELS) or not torch.isfinite(mel_out).all():
        raise AssertionError(f"log-mel entry point: shape {tuple(mel_out.shape)} or non-finite")
    if logmel_launches != LOGMEL_CALLS:
        raise AssertionError(f"fused_logmel launched {logmel_launches} times, "
                             f"expected {LOGMEL_CALLS}")
    del wave, mel_out

    # 7./8. train at full width; the poisoned batch; one step against the CPU
    flagship = ctc_results["flagship"]
    ctc_launches = train_phase(ctc_dp, flagship)
    card_against_cpu_step()

    # summary lines
    head = next(r for r in results if (r["m"], r["k"], r["n"], r["dtype"])
                == (enc_m, D_MODEL, FFN, "bfloat16"))
    ctc_shapes = [ctc_results[name] for name in CTC_CASES]
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
        "card": card, "shapes": results,
    }, {
        "name": "ctc_dp_fwd", "route": "cuda",
        "source": "mindaudio_torch/ops/csrc/ctc_dp.cu",
        "replaces": "mindaudio_tpu/ops/pallas_ctc.py:76",
        "launches": ctc_launches[0], "max_abs_err": flagship["max_abs_err"]["loss"],
        "ms": flagship["fwd_ms"], "plain_ms": flagship["plain_fwd_ms"],
        "bound_ms": flagship["fwd_bound_ms"], "bound_by": "bytes",
        "library_ms": flagship["library_fwd_ms"], "shape": flagship["shape"],
        "chain_steps": flagship["chain_steps"], "us_per_step": flagship["fwd_us_per_step"],
        "card": card, "shapes": ctc_shapes,
    }, {
        "name": "ctc_dp_bwd", "route": "cuda",
        "source": "mindaudio_torch/ops/csrc/ctc_dp.cu",
        "replaces": "mindaudio_tpu/ops/pallas_ctc.py:110",
        "launches": ctc_launches[1], "max_abs_err": flagship["max_abs_err"]["grad_logp_ext"],
        "ms": flagship["bwd_ms"], "plain_ms": flagship["plain_bwd_ms"],
        "bound_ms": flagship["bwd_bound_ms"], "bound_by": "bytes",
        "library_ms": flagship["library_bwd_ms"], "shape": flagship["shape"],
        "chain_steps": flagship["chain_steps"], "us_per_step": flagship["bwd_us_per_step"],
        "card": card,
    }, {
        "name": "fused_logmel", "route": "cuda",
        "source": "mindaudio_torch/ops/csrc/logmel.cu",
        "replaces": "mindaudio_tpu/ops/pallas_mel.py:96",
        "launches": logmel_launches, "max_abs_err": mel["max_abs_err"],
        "ms": mel["ms"], "plain_ms": mel["plain_ms"], "bound_ms": mel["bound_ms"],
        "bound_by": mel["bound_by"], "library_ms": None, "shape": mel["shape"],
        "card": card, "shapes": logmel_results,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
