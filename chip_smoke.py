#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mindaudio_torch``) on one NVIDIA GPU.

Run from the root of the repository, with no arguments::

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it does not hold:

1. the card's name and power limit, from ``nvidia-smi``;
2. build every CUDA kernel under ``mindaudio_torch/ops/csrc/`` with ``nvcc``
   for ``sm_90a`` (one process per source, all at once);
3. hold the int8 weight-only GEMM against its plain PyTorch version at every
   ``(M, K, N)`` the serving path launches, in bf16 and f32, plus a ragged
   shape; time kernel, plain version, ``torch.matmul`` (the yardstick, never
   called by the port) and the bound;
4. serve the flagship Conformer at full width (``conformer.yaml``: 80 mel
   bins, d_model 256, 4 heads, FFN 2048, 12 encoder and 6 decoder layers,
   kernel 15, vocab 4233; random weights from a seeded ``torch.Generator``)
   with int8 weights and bf16 compute: 16 synthetic 10 s waveforms through
   ``kaldi_fbank``, ``ctc_greedy_search`` and ``attention_rescoring_batch``
   (beam 10, 50 tokens). The launch count of the int8 kernel in that run
   must equal the count of quantized layers on the path. Then one request
   (B=1, float32 model) is held against the same weights on the CPU through
   the plain versions.

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

VOCAB, N_MELS, D_MODEL, HEADS, FFN = 4233, 80, 256, 4, 2048
ENC_LAYERS, DEC_LAYERS, CONV_KERNEL = 12, 6, 15
BATCH, BEAM, MAX_TGT = 16, 10, 50
SAMPLE_RATE, SAMPLES = 16000, 164720  # the 10 s bucket: 1028 frames, T' = 256
QUANT_MIN = 65536  # weight_quant_min_size, as the JAX package serves
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


def bf16_ulp(v):
    """One bf16 ulp of ``v`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(max(abs(v), np.finfo(np.float32).tiny))) - 7)


def gemm_bound(m, k, n, x_bytes):
    """Least time (ms) for y = x @ dequant(w): each input read once, y written
    once, 2·M·N·K operations at the bf16 tensor-core peak."""
    moved = m * k * x_bytes + k * n + 4 * n + m * n * x_bytes
    t_bytes, t_ops = moved / H100_BYTES_PER_S, 2.0 * m * n * k / H100_BF16_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_int8_gemm(quant, m, k, n, dtype, gen):
    """Kernel vs plain version at one shape; times and bound."""
    x = torch.randn(m, k, device="cuda", generator=gen).to(dtype)
    v, s = quant.quantize_int8(0.05 * torch.randn(k, n, device="cuda", generator=gen))
    got = quant.int8_matmul(x, v, s)
    want = quant.int8_matmul_reference(x, v, s)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"int8_matmul {(m, k, n)} {dtype}: non-finite output")
    err = (got.float() - want.float()).abs().max().item()
    peak = want.float().abs().max().item()
    # same bf16 products summed in f32 in another order: f32 out agrees to
    # float32 rounding, bf16 out is that sum rounded once (one ulp apart)
    tol = 1e-5 * peak if dtype == torch.float32 else bf16_ulp(peak)
    if not err <= tol:
        raise AssertionError(f"int8_matmul {(m, k, n)} {dtype}: max err {err} > tol {tol}")
    xb, wb = x.to(torch.bfloat16), (v.to(torch.bfloat16) * s.to(torch.bfloat16))
    bound, bound_by = gemm_bound(m, k, n, x.element_size())
    return {
        "m": m, "k": k, "n": n, "dtype": str(dtype).replace("torch.", ""),
        "max_abs_err": err, "max_rel_err": err / peak, "tol": tol,
        "ms": cuda_ms(lambda: quant.int8_matmul(x, v, s)),
        "plain_ms": cuda_ms(lambda: quant.int8_matmul_reference(x, v, s), iters=5),
        "library_ms": cuda_ms(lambda: torch.matmul(xb, wb)),
        "bound_ms": bound, "bound_by": bound_by,
    }


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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    from mindaudio_torch.models.asr_model import ASRModel
    from mindaudio_torch.ops import _build
    from mindaudio_torch.ops import quant
    from mindaudio_torch.ops.spectral import kaldi_fbank
    from mindaudio_torch.utils.recognize import ASRInference

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
            if "registers" in line or "spill" in line:
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
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    log("int8_matmul vs plain: M K N dtype | max_abs max_rel tol | kernel plain library bound (ms)")
    for (m, k, n), dtype in cases:
        r = check_int8_gemm(quant, m, k, n, dtype, gen)
        results.append(r)
        log(f"  {m} {k} {n} {r['dtype']} | {r['max_abs_err']:.3e} {r['max_rel_err']:.3e} "
            f"{r['tol']:.3e} | {r['ms']:.4f} {r['plain_ms']:.4f} {r['library_ms']:.4f} "
            f"{r['bound_ms']:.4f} ({r['bound_by']})")
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
    quant.int8_matmul.launches = 0
    feats, (hyps, scores), rescored, times = serve()
    launches = quant.int8_matmul.launches
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
    totals = {key: sum(checked[s][key] * n for s, n in shapes.items())
              for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    log("int8 GEMM device time per served batch (phase-3 times x launches): "
        + ", ".join(f"{key} {value:.3f}" for key, value in totals.items()))

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

    # 5./6. summary lines
    head = next(r for r in results if (r["m"], r["k"], r["n"], r["dtype"])
                == (enc_m, D_MODEL, FFN, "bfloat16"))
    log('kernels: ["int8_matmul"]')
    log(json.dumps({"kernels": [{
        "name": "int8_matmul", "route": "cuda",
        "source": "mindaudio_torch/ops/csrc/int8_matmul.cu",
        "replaces": "mindaudio_tpu/ops/quant.py:60",
        "launches": launches, "max_abs_err": head["max_abs_err"],
        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "shape": [head["m"], head["k"], head["n"], head["dtype"]],
        "card": card, "shapes": results,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
