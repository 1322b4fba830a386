"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips on a host without a GPU: a
CUDA kernel has no CPU mode. This file imports neither JAX nor the JAX
package, so it runs where only PyTorch is installed. On the card::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from mindaudio_torch.loss.ctc_loss import ctc_per_seq_loss
from mindaudio_torch.ops import ctc_dp
from mindaudio_torch.ops import logmel as tmel
from mindaudio_torch.ops import quant as tq
from mindaudio_torch.ops.spectral import kaldi_fbank

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: a CUDA kernel has no CPU mode")
    # the plain version's float32 product must not drop to TF32
    torch.backends.cuda.matmul.allow_tf32 = False


def bf16_ulp(y):
    """One bf16 ulp of each value (a bf16 keeps 8 significant bits)."""
    y = np.abs(np.asarray(y, np.float32))
    return np.exp2(np.floor(np.log2(np.maximum(y, np.finfo(np.float32).tiny))) - 7)


@pytest.mark.parametrize("m,k,n", [(1, 256, 4233), (257, 4864, 256), (33, 40, 17),
                                   (130, 256, 2048)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_matches_plain(m, k, n, dtype):
    """Ragged M, N and K. Both sides multiply the same bf16 operands exactly
    and sum in float32 in another order: float32 outputs agree to 1e-5 of
    max|y|, bf16 outputs to one bf16 ulp of max|y| (one rounding apart)."""
    g = torch.Generator(device="cuda").manual_seed(m)
    x = torch.randn(m, k, device="cuda", generator=g).to(dtype)
    v, s = tq.quantize_int8(0.05 * torch.randn(k, n, device="cuda", generator=g))
    before = tq.int8_matmul.launches, tq.int8_matmul.reduce_launches
    splits = tq.split_k(m, n, k, torch.cuda.get_device_properties(0).multi_processor_count)
    got = tq.int8_matmul(x, v, s)
    torch.cuda.synchronize()
    assert (tq.int8_matmul.launches, tq.int8_matmul.reduce_launches) == (
        before[0] + 1, before[1] + (splits > 1))
    assert got.dtype == dtype and got.shape == (m, n)
    want = tq.int8_matmul_reference(x, v, s).float().cpu().numpy()
    err = np.abs(got.float().cpu().numpy() - want).max()
    peak = np.abs(want).max()
    assert err <= (1e-5 * peak if dtype == torch.float32 else bf16_ulp(peak)), err


def _int8_case(m, k, n, dtype, seed, x_offset=0):
    """x (m, k) starting ``x_offset`` elements into its buffer, and the
    weight as ``Int8Linear`` holds it: rows padded to 16 bytes."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(m * k + x_offset, device="cuda", generator=g).to(dtype)[x_offset:].view(m, k)
    v, s = tq.quantize_int8(0.05 * torch.randn(k, n, device="cuda", generator=g))
    return x, tq.pad_int8_rows(v)[:, :n], v, s


def _assert_close_to_plain(got, x, v, s):
    want = tq.int8_matmul_reference(x, v, s).float().cpu().numpy()
    err = np.abs(got.float().cpu().numpy() - want).max()
    peak = np.abs(want).max()
    assert err <= (1e-5 * peak if x.dtype == torch.float32 else bf16_ulp(peak)), err


@pytest.mark.parametrize("m", [1, 63, 65, 1001])
@pytest.mark.parametrize("k", [200, 4864])
@pytest.mark.parametrize("n", [8, 4233, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_edges(m, k, n, dtype):
    """Ragged M, K not a multiple of the 64-deep stage, long K (split), N
    narrower than a tile and N whose rows are not 16-byte aligned, with the
    padded weight layout; same tolerance as above."""
    x, w, v, s = _int8_case(m, k, n, dtype, seed=m + k + n)
    got = tq.int8_matmul(x, w, s)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (m, n)
    _assert_close_to_plain(got, x, v, s)


@pytest.mark.parametrize("m,k,n,dtype", [(4096, 4864, 256, torch.bfloat16),
                                         (256, 4864, 256, torch.float32),
                                         (4096, 2048, 256, torch.bfloat16)])
def test_int8_matmul_split_k_is_deterministic(m, k, n, dtype):
    """The few-tile, long-K shapes split K; the splits are summed in a fixed
    order, so two runs give the same bits. Each call launches the sum pass
    once, counted apart."""
    assert tq.split_k(m, n, k, torch.cuda.get_device_properties(0).multi_processor_count) > 1
    x, w, v, s = _int8_case(m, k, n, dtype, seed=7)
    before = tq.int8_matmul.launches, tq.int8_matmul.reduce_launches
    first = tq.int8_matmul(x, w, s)
    second = tq.int8_matmul(x, w, s)
    torch.cuda.synchronize()
    assert (tq.int8_matmul.launches, tq.int8_matmul.reduce_launches) == (
        before[0] + 2, before[1] + 2)
    assert torch.equal(first, second)
    _assert_close_to_plain(first, x, v, s)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_offset", [1, 3])
def test_int8_matmul_x_not_16_byte_aligned(dtype, x_offset):
    """An x view whose address is not 16-byte aligned takes the plain-load
    path; it is not copied."""
    x, w, v, s = _int8_case(513, 256, 4233, dtype, seed=x_offset, x_offset=x_offset)
    assert x.data_ptr() % 16
    _assert_close_to_plain(tq.int8_matmul(x, w, s), x, v, s)


def test_int8_linear_serves_the_padded_layout():
    g = torch.Generator(device="cuda").manual_seed(11)
    v, s = tq.quantize_int8(0.05 * torch.randn(256, 4233, device="cuda", generator=g))
    bias = torch.randn(4233, device="cuda", generator=g)
    layer = tq.Int8Linear(v, s, bias)
    assert layer.qweight.stride(0) == 4240 and torch.equal(layer.values, v)
    x = torch.randn(2, 300, 256, device="cuda", generator=g).bfloat16()
    before = tq.int8_matmul.launches
    y = layer(x)
    torch.cuda.synchronize()
    assert tq.int8_matmul.launches == before + 1
    want = tq.int8_matmul_reference(x, v, s) + bias.bfloat16()
    assert (y.float() - want.float()).abs().max().item() <= 2 * bf16_ulp(
        want.float().abs().max().item())


def test_int8_matmul_rejects_what_the_kernel_does_not_take():
    x = torch.randn(4, 64, device="cuda")
    v, s = tq.quantize_int8(torch.randn(64, 8, device="cuda"))
    with pytest.raises(TypeError):
        tq.int8_matmul(x.half(), v, s)
    with pytest.raises(ValueError):
        tq.int8_matmul(x[:, :32], v, s)
    with pytest.raises(ValueError):
        tq.int8_matmul(x, v.cpu(), s)


_DS2 = np.random.default_rng(626)
CTC_CASES = {
    # name: (B, T, L, V, logit lengths, label lengths, blank)
    "flagship": (32, 256, 20, 4233, None, None, 0),
    "long_bucket": (8, 752, 30, 4233, None, None, 0),
    "mixed_lengths": (4, 37, 9, 11, [37, 25, 10, 30], [9, 5, 2, 4], 0),
    "empty_label": (3, 17, 5, 7, [17, 9, 3], [0, 3, 0], 0),
    "minimal_fit": (2, 9, 4, 6, None, None, 0),
    "blank_is_last_class": (2, 19, 5, 9, [19, 12], [5, 3], 8),
    "single_frame_and_zero_length": (3, 1, 1, 5, [1, 1, 0], [1, 0, 0], 0),
    "wider_than_a_block": (2, 40, 600, 50, [40, 40], [600, 3], 0),
    # S = 12001: the block path's three shared rows need 144 KB; 6000 labels
    # in 12 frames cannot be aligned (a loss near 1e5)
    "widest_rows": (2, 12, 6000, 50, [12, 9], [6000, 7], 0),
    # rows that cannot be aligned (T < L + repeats) on the one-warp path:
    # two repeats in row 0, more labels than frames in rows 1 and 2
    "unalignable_rows": (3, 6, 5, 7, [6, 4, 2], [5, 5, 3], 0),
    "unalignable_beside_alignable": (4, 10, 12, 9, [10, 8, 10, 3], [12, 9, 4, 6], 0),
    "unalignable_wide_rows": (3, 16, 140, 20, [16, 12, 6], [140, 100, 20], 0),  # S = 281
    # the band path's edges (64 states a warp): the first and last S of 5
    # warps, the first of 6, the last of 12 and first of 13, the last of 16;
    # then the first width left to the block path
    "band_edge_257": (2, 140, 128, 40, None, [128, 60], 0),
    "band_edge_319": (2, 170, 159, 40, None, [159, 78], 0),
    "band_edge_321": (2, 171, 160, 40, None, [160, 79], 0),
    "band_edge_767": (2, 395, 383, 40, None, [383, 190], 0),
    "band_edge_769": (2, 396, 384, 40, None, [384, 191], 0),
    "band_edge_1023": (2, 524, 511, 40, None, [511, 260], 0),
    "block_edge_1025": (2, 525, 512, 40, None, [512, 261], 0),
    # DeepSpeech2's S = 701 on the band path: a zero length beside full ones;
    # lengths 45 and 38: the forward's groups of 4 steps end short, the
    # backward's (after its first step) short at 38 and whole at 45; rows
    # that cannot be aligned beside one that can
    "wide_zero_length_beside_full_length": (4, 40, 350, 29, [40, 0, 40, 21], [15, 350, 0, 10],
                                            28),
    "wide_t_not_a_multiple_of_the_chunk": (3, 45, 350, 29, [45, 45, 38], [20, 14, 9], 28),
    "unalignable_wide_rows_701": (3, 30, 350, 29, [30, 24, 12], [350, 100, 5], 28),
    # the one-warp kernel's lane and register edges: S = 63, 65, 127, 129
    "lane_edge_63": (3, 70, 31, 60, None, [31, 15, 8], 0),
    "lane_edge_65": (3, 70, 32, 60, None, [32, 16, 9], 0),
    "register_edge_127": (2, 131, 63, 90, None, [63, 30], 0),
    "register_edge_129": (2, 133, 64, 90, None, [64, 31], 0),
    "batch_of_five": (5, 30, 6, 20, [30, 22, 30, 17, 9], [6, 4, 5, 3, 2], 0),
    "t_not_a_multiple_of_the_chunk": (4, 45, 10, 20, [45, 45, 39, 33], None, 0),
    "t_shorter_than_a_chunk": (3, 13, 4, 9, None, None, 0),
    "zero_length_beside_full_length": (4, 40, 8, 15, [40, 0, 40, 21], [8, 3, 0, 5], 0),
    "lengths_differ_per_row": (4, 50, 12, 30, [50, 33, 41, 26], [12, 7, 10, 3], 0),
    # DeepSpeech2's train step at the 1250-frame bucket: labels padded to 350
    # (S = 701, the band path), 29 characters with the blank last, ragged
    "deepspeech2_block_path": (64, 626, 350, 29, [626] + _DS2.integers(469, 627, 63).tolist(),
                               [350] + _DS2.integers(80, 351, 63).tolist(), 28),
}


def _ctc_inputs(name):
    b, t, l, v, lens, llens, blank = CTC_CASES[name]
    g = torch.Generator(device="cuda").manual_seed(len(name))
    logits = torch.randn(b, t, v, device="cuda", generator=g)
    low, high = (1, v) if blank == 0 else (0, v - 1)
    labels = torch.randint(low, high, (b, l), device="cuda", generator=g)
    labels[0, 1:3] = labels[0, 0]  # repeated labels close the s-2 skip
    lens = torch.tensor(lens or [t] * b, device="cuda")
    llens = torch.tensor(llens or [l] * b, device="cuda")
    weights = 0.5 + torch.rand(b, device="cuda", generator=g)
    return logits, lens, labels, llens, blank, weights


@pytest.mark.parametrize("name", list(CTC_CASES))
def test_ctc_kernels_match_plain(name):
    """Value and gradient at the logits, float32 on both sides. A loss is a
    chain of T log-sum-exps at magnitude |loss|: 16 ulps of the largest loss.
    A gradient is exp(alpha + beta + loss) times the cotangent (at most 1.5
    here), so the same error in its exponent bounds it; the scatter-add into
    the vocabulary sums in another order (atomics) at no other size."""
    logits, lens, labels, llens, blank, weights = _ctc_inputs(name)
    fwd, bwd = ctc_dp.ctc_dp_fwd.launches, ctc_dp.ctc_dp_bwd.launches
    got_in = logits.clone().requires_grad_()
    got = ctc_per_seq_loss(got_in, lens, labels, llens, blank_id=blank, impl="kernel")
    (got_grad,) = torch.autograd.grad(got, got_in, weights)
    torch.cuda.synchronize()
    assert (ctc_dp.ctc_dp_fwd.launches, ctc_dp.ctc_dp_bwd.launches) == (fwd + 1, bwd + 1)
    want_in = logits.clone().requires_grad_()
    want = ctc_per_seq_loss(want_in, lens, labels, llens, blank_id=blank, impl="scan")
    (want_grad,) = torch.autograd.grad(want, want_in, weights)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.isfinite(got).all() and torch.isfinite(got_grad).all()
    tol = 16 * np.finfo(np.float32).eps * max(want.abs().max().item(), 1.0)
    assert (got - want).abs().max().item() <= tol
    assert (got_grad - want_grad).abs().max().item() <= 1.5 * max(tol, 1e-6)


def test_ctc_kernel_gradient_against_finite_differences():
    """``gradcheck``-style: the backward kernel against central differences of
    the forward kernel in ``logp_ext``. float32 differences of step 1e-2 on a
    loss of ~20 carry ~1e-3 of noise, so 5e-3 absolute."""
    g = torch.Generator(device="cuda").manual_seed(0)
    logits = torch.randn(2, 9, 6, device="cuda", generator=g)
    labels = torch.randint(1, 6, (2, 3), device="cuda", generator=g)
    lens, llens = torch.tensor([9, 7], device="cuda"), torch.tensor([3, 2], device="cuda")
    logp_ext, allowed = ctc_dp.extended_log_probs(logits, labels)
    loss, alphas = ctc_dp.ctc_dp_fwd(logp_ext, lens, allowed, llens)
    grad = ctc_dp.ctc_dp_bwd(logp_ext, alphas, lens, allowed, llens, loss,
                             torch.ones(2, device="cuda"))
    step = 1e-2
    for b, t, s in [(0, 0, 0), (0, 4, 3), (0, 8, 6), (1, 3, 2), (1, 6, 4), (1, 8, 0)]:
        bump = torch.zeros_like(logp_ext)
        bump[b, t, s] = step
        up = ctc_dp.ctc_dp_fwd(logp_ext + bump, lens, allowed, llens)[0][b]
        down = ctc_dp.ctc_dp_fwd(logp_ext - bump, lens, allowed, llens)[0][b]
        assert abs(((up - down) / (2 * step)).item() - grad[b, t, s].item()) <= 5e-3, (b, t, s)
    assert torch.equal(grad[1, 7:], torch.zeros_like(grad[1, 7:]))  # past the length


def test_ctc_kernel_under_autocast_and_on_the_cpu():
    logits, lens, labels, llens, blank, _ = _ctc_inputs("mixed_lengths")
    want = ctc_per_seq_loss(logits, lens, labels, llens, impl="kernel")
    with torch.autocast("cuda", dtype=torch.bfloat16):
        got = ctc_per_seq_loss(logits, lens, labels, llens, impl="auto")  # CUDA: the kernel
    assert got.dtype == torch.float32 and torch.equal(got, want)
    with pytest.raises(ValueError, match="CUDA"):
        ctc_per_seq_loss(logits.cpu(), lens.cpu(), labels.cpu(), llens.cpu(), impl="kernel")
    with pytest.raises(TypeError):
        ctc_dp.ctc_dp_fwd(torch.zeros(1, 2, 3, device="cuda", dtype=torch.float16),
                          lens[:1], torch.ones(1, 3, device="cuda").bool(), llens[:1])


@pytest.mark.parametrize("shape,kw", [
    ((4, 16000), dict(n_mels=80, hop_length=160)),
    ((3, 16037), dict(n_mels=40, hop_length=160)),
    ((3, 16037), dict(n_mels=40, hop_length=160, kaldi=True)),
    ((3, 16037), dict(n_mels=40, hop_length=160, center=False)),
    ((2, 5003), dict(n_mels=23, n_fft=512, win_length=400, hop_length=100, window="hamming",
                     f_min=20.0, f_max=7600.0, log_floor=1e-5)),
    ((1, 300), dict(n_mels=8)),  # shorter than one frame: every frame reads zeros
    ((4, 220500), dict(n_fft=1024, hop_length=256, n_mels=80, sample_rate=22050)),  # FastSpeech2
    ((4, 220500), dict(n_fft=1024, hop_length=300, n_mels=128, sample_rate=22050)),  # WaveGrad
])
@pytest.mark.parametrize("precision", ["default", "highest"])
def test_fused_logmel_matches_plain(shape, kw, precision):
    """rtol = atol = 1e-3 on the log-mel, as the JAX package holds its own
    kernel to its reference; the kernel's DFT is three TF32 passes at both
    precisions, the plain version float32 products."""
    g = torch.Generator(device="cuda").manual_seed(shape[1])
    x = torch.randn(*shape, device="cuda", generator=g)
    before = tmel.fused_logmel.launches
    got = tmel.fused_logmel(x, precision=precision, **kw)
    torch.cuda.synchronize()
    assert tmel.fused_logmel.launches == before + 1
    want = tmel.fused_logmel_reference(x, **kw)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-3, atol=1e-3)


def test_fused_logmel_rejects_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        tmel.fused_logmel(torch.zeros(2, 800, device="cuda", dtype=torch.float64))
    with pytest.raises(ValueError):
        tmel.fused_logmel(torch.zeros(800, device="cuda"))
    before = tmel.fused_logmel.launches
    with pytest.raises(ValueError, match="hop 4 < 8"):  # the plan refuses it: no fallback
        tmel.fused_logmel(torch.zeros(1, 800, device="cuda"), hop_length=4)
    with pytest.raises(ValueError, match="shared memory"):
        tmel.fused_logmel(torch.zeros(1, 20000, device="cuda"), n_fft=8192, hop_length=2048)
    assert tmel.fused_logmel.launches == before


def test_random_draws_stay_on_the_device():
    """Dither noise from a CPU generator for a CUDA input would be a host
    round trip in every step: it raises instead."""
    wav = torch.randn(2, 4000, device="cuda")
    with pytest.raises(ValueError, match="generator"):
        kaldi_fbank(wav, dither=0.1, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(0)
    assert torch.isfinite(kaldi_fbank(wav, dither=0.1, generator=gen)).all()
