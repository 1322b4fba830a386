"""Port parity for the fused log-mel: the plain PyTorch version against the
JAX package's Pallas kernel (interpret mode on the CPU, ``precision="highest"``)
and its pure-jnp reference, on the same numpy signals; and the filterbank
copies against their NumPy originals, bit for bit.

Tolerance: ``rtol`` = ``atol`` = 1e-3 on the log-mel, as the JAX package's own
test of its kernel states it (``tests/test_ops_device.py``); in float32 on both
sides the observed differences are ~1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindaudio_tpu.ops import filterbanks as jfb
from mindaudio_tpu.ops import pallas_mel as jmel
from mindaudio_torch.ops import filterbanks as tfb
from mindaudio_torch.ops import logmel as tmel

torch.set_num_threads(1)

TOL = dict(rtol=1e-3, atol=1e-3)


class TestFilterbankCopies:
    @pytest.mark.parametrize("n_freqs,f_min,f_max,n_mels,sr", [
        (201, 0.0, 8000.0, 80, 16000), (257, 20.0, 7600.0, 40, 16000),
        (129, 0.0, 4000.0, 23, 8000)])
    def test_melscale_fbanks(self, n_freqs, f_min, f_max, n_mels, sr):
        want = jfb.melscale_fbanks(n_freqs, f_min, f_max, n_mels, sr, norm=None,
                                   mel_scale="htk")
        got = tfb.melscale_fbanks(n_freqs, f_min, f_max, n_mels, sr)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("window", ["hann", "hamming", "povey"])
    @pytest.mark.parametrize("fftbins", [True, False])
    def test_windows(self, window, fftbins):
        np.testing.assert_array_equal(tfb.get_window(window, 400, fftbins=fftbins),
                                      jfb.get_window(window, 400, fftbins=fftbins))

    def test_htk_hz(self):
        m = np.array([0.0, 150.5, 999.0, 2840.0])
        np.testing.assert_array_equal(tfb.mel_to_hz(m, htk=True), jfb.mel_to_hz(m, htk=True))

    @pytest.mark.parametrize("kaldi", [False, True])
    def test_design_tables(self, kaldi):
        """The kernel's tables equal the unpadded part of the JAX ``_design``."""
        wr, wi, fb, band = tmel._design(400, 400, "hann", 80, 16000, 0.0, None, kaldi)
        jwr, jwi, jfbank, k, hop_pad, *_ = jmel._design(400, 400, 160, "hann", 80, 16000,
                                                         0.0, None, kaldi)
        rows = np.concatenate([np.arange(j * hop_pad, j * hop_pad + 160) for j in range(k)])[:400]
        np.testing.assert_array_equal(wr, np.asarray(jwr)[rows, :201])
        np.testing.assert_array_equal(wi, np.asarray(jwi)[rows, :201])
        np.testing.assert_array_equal(fb, np.asarray(jfbank)[:201, :80])
        # the band of a mel column holds all of its nonzero rows
        for m, (lo, hi) in enumerate(band.T):
            assert 0 <= lo < hi <= 201
            assert not fb[:lo, m].any() and not fb[hi:, m].any()
            assert fb[lo, m] != 0 and fb[hi - 1, m] != 0


def _signal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


class TestFusedLogmelReference:
    @pytest.mark.parametrize("shape,kw", [
        ((4, 16000), dict(n_mels=80)),
        ((2, 12345), dict(n_mels=40)),  # odd length
        ((3, 16037), dict(n_mels=40, kaldi=True)),
        ((2, 12345), dict(n_mels=80, center=False)),
        ((2, 5003), dict(n_mels=23, n_fft=512, win_length=400, hop_length=160,
                         window="hamming", f_min=20.0, f_max=7600.0, log_floor=1e-5)),
    ], ids=["even", "odd", "kaldi", "uncentered", "other_config"])
    def test_matches_jax_kernel(self, shape, kw):
        x = _signal(shape, seed=5)
        got = tmel.fused_logmel_reference(torch.from_numpy(x), **kw).numpy()
        want = np.asarray(jmel.fused_logmel(jnp.asarray(x), block_frames=64,
                                            precision="highest", **kw))
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, **TOL)

    @pytest.mark.parametrize("shape,kw", [
        ((4, 16000), dict(n_mels=80)), ((2, 12345), dict(n_mels=40)),
        ((2, 12345), dict(n_mels=80, center=False))], ids=["even", "odd", "uncentered"])
    def test_matches_jax_reference(self, shape, kw):
        """``kaldi=True`` has no pure-jnp twin in the JAX package (its
        reference ignores the flag), so it is held to the kernel above."""
        x = _signal(shape, seed=6)
        got = tmel.fused_logmel_reference(torch.from_numpy(x), **kw).numpy()
        want = np.asarray(jmel.fused_logmel_reference(jnp.asarray(x), **kw))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL)

    def test_silence_hits_the_floor(self):
        out = tmel.fused_logmel_reference(torch.zeros(1, 1600), n_mels=20, log_floor=1e-10)
        assert out.shape == (1, 9, 20)  # hop defaults to win_length // 2
        np.testing.assert_allclose(out.numpy(), np.log(1e-10), rtol=1e-6)


class TestFusedLogmelEntryPoint:
    def test_cpu_takes_the_plain_version(self):
        x = _signal((2, 4000), seed=7)
        before = tmel.fused_logmel.launches
        got = tmel.fused_logmel(x, n_mels=40, device="cpu")
        assert tmel.fused_logmel.launches == before  # no kernel on the CPU
        assert torch.equal(got, tmel.fused_logmel_reference(torch.from_numpy(x), n_mels=40))
        # the TPU kernel's tile size and precision do not change the result here
        again = tmel.fused_logmel(x, n_mels=40, block_frames=64, precision="highest",
                                  device="cpu")
        assert torch.equal(again, got)

    def test_rejects_bad_arguments(self):
        with pytest.raises(ValueError, match="precision"):
            tmel.fused_logmel(np.zeros((1, 800), np.float32), precision="bf16", device="cpu")
        with pytest.raises(ValueError, match="batch, time"):
            tmel.fused_logmel(np.zeros(800, np.float32), device="cpu")


# The kernel's host side: split tables, their layout, the launch plan, and
# the three-pass TF32 arithmetic emulated on the CPU. No JAX needed here.

DESIGNS = {  # (n_fft, win_length, window, n_mels, sample_rate, f_min, f_max, kaldi), hop
    "asr": ((400, 400, "hann", 80, 16000, 0.0, None, False), 160),
    "asr_40_kaldi": ((400, 400, "hann", 40, 16000, 0.0, None, True), 160),
    "fastspeech2": ((1024, 1024, "hann", 80, 22050, 0.0, None, False), 256),
    "wavegrad": ((1024, 1024, "hann", 128, 22050, 0.0, None, False), 300),
    "hamming_512": ((512, 400, "hamming", 23, 16000, 20.0, 7600.0, False), 100),
    "short": ((400, 400, "hann", 8, 16000, 0.0, None, False), 200),
}


class TestKernelTables:
    @pytest.mark.parametrize("name", list(DESIGNS))
    def test_split_is_tf32_and_exact_to_2_pow_21(self, name):
        table, _, _ = tmel._kernel_design(*DESIGNS[name][0])
        hi, lo = (self._unslot(table[:, i], self._dense(name).shape) for i in (0, 1))
        for half in (hi, lo):  # TF32: the low 13 mantissa bits are zero
            assert not (half.view(np.uint32) & np.uint32(0x1FFF)).any()
        w = hi.astype(np.float64) + lo.astype(np.float64)
        dense = self._dense(name)
        assert np.all(np.abs(dense - w) <= 2.0 ** -21 * np.abs(dense))
        # round to nearest, ties away from zero, as cvt.rna.tf32.f32
        v = np.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12, 1 + 3 * 2.0 ** -11],
                     np.float32)
        np.testing.assert_array_equal(
            tmel.tf32_round(v), np.array([1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1,
                                          1 + 2.0 ** -9], np.float32))

    @staticmethod
    def _unslot(tiles, shape):
        """The kernel's ring slots of one half back to ``(passes * 208,
        k_pad)``: slot s = pass * (k_pad / 8) + k8 step, row r of a slot with
        its two 16-byte halves swapped where ``r & 4`` (32-byte swizzle)."""
        n, k_pad = shape
        passes, ksteps = n // 208, k_pad // 8
        a = np.empty(shape, np.float32)
        for s in range(passes * ksteps):
            p, k = divmod(s, ksteps)
            for r in range(208):
                row = tiles[s, r]
                if r & 4:
                    row = np.concatenate([row[4:], row[:4]])
                a[208 * p + r, 8 * k: 8 * k + 8] = row
        return a

    @staticmethod
    def _dense(name):
        """``_design``'s (wr, wi) in the kernel's layout, built independently:
        row 208 p + 2 j + s is frequency 104 p + j, cos (s = 0) or sin."""
        design = DESIGNS[name][0]
        wr, wi, _, _ = tmel._design(*design)
        n_fft, n_freq = wr.shape
        passes = -(-n_freq // 104)
        k_pad = -(-n_fft // 16) * 16
        dense = np.zeros((passes * 208, k_pad))
        for f in range(n_freq):
            p, j = divmod(f, 104)
            dense[208 * p + 2 * j, :n_fft] = wr[:, f]
            dense[208 * p + 2 * j + 1, :n_fft] = wi[:, f]
        return dense

    @pytest.mark.parametrize("name", list(DESIGNS))
    def test_layout_is_pinned_to_the_dense_tables(self, name):
        design = DESIGNS[name][0]
        table, bands, wts = tmel._kernel_design(*design)
        dense = self._dense(name)
        n, k_pad = dense.shape
        assert k_pad % 16 == 0 and n % 208 == 0
        # one ring slot a (pass, k8 step): hi then lo, 208 rows of 8, contiguous
        assert table.shape == (n // 208 * k_pad // 8, 2, 208, 8) and table.dtype == np.float32
        assert table.flags.c_contiguous and table[0].nbytes == tmel.SLOT_BYTES
        hi = self._unslot(table[:, 0], dense.shape)
        np.testing.assert_array_equal(hi, tmel.tf32_round(dense.astype(np.float32)))
        np.testing.assert_array_equal(hi == 0, dense == 0)  # zeros are the padding
        # the swizzle: row 4 of the first slot holds k 4..7 first
        np.testing.assert_array_equal(table[0, 0, 4, :4], hi[4, 4:8])
        # the bands and their weights give back the dense mel bank
        _, _, fb, band = tmel._design(*design)
        np.testing.assert_array_equal(bands[:2], band)
        rebuilt = np.zeros_like(fb)
        for m, (lo, hi, off, _) in enumerate(bands.T):
            rebuilt[lo:hi, m] = wts[off: off + hi - lo]
        np.testing.assert_array_equal(rebuilt, fb)
        assert bands.dtype == np.int32 and wts.dtype == np.float32
        # a carry column for each band that spans two passes of 104 bins, in order
        spans = [lo // 104 != (hi - 1) // 104 for lo, hi in band.T if lo < hi]
        assert sum(spans) == bands[3].max() + 1
        np.testing.assert_array_equal(bands[3][bands[3] >= 0], np.arange(sum(spans)))


class TestKernelPlan:
    @pytest.mark.parametrize("name,fpb", [
        ("asr", 128), ("asr_40_kaldi", 128), ("fastspeech2", 64), ("wavegrad", 64),
        ("hamming_512", 128), ("short", 128)])
    def test_plans_of_the_front_ends_and_kernel_tests(self, name, fpb):
        design, hop = DESIGNS[name]
        _, bands, wts = tmel._kernel_design(*design)
        carries = int(bands[3].max()) + 1
        plan = tmel.kernel_plan(design[0], hop, design[3], wts.size, carries)
        assert plan.fpb == fpb
        assert plan.pitch >= hop and plan.pitch % 8 == 4  # 8 rows on 8 bank quads
        # the span covers every sample a block's frames read, K padding included
        assert plan.rows * hop >= (fpb - 1) * hop + plan.k_pad > (plan.rows - 1) * hop
        assert plan.passes * 104 >= design[0] // 2 + 1 > (plan.passes - 1) * 104
        assert plan.smem_bytes == tmel.smem_bytes(fpb, plan.rows, plan.pitch, design[3],
                                                  wts.size, carries, plan.stages)
        assert plan.smem_bytes <= tmel.SMEM_LIMIT
        assert 3 <= plan.stages <= tmel.MAX_STAGES
        # the deepest ring that fits: one slot more would not
        if plan.stages < tmel.MAX_STAGES:
            assert tmel.smem_bytes(fpb, plan.rows, plan.pitch, design[3], wts.size, carries,
                                   plan.stages + 1) > tmel.SMEM_LIMIT

    def test_asr_layout_in_bytes(self):
        # 6 slots of 13312, 130 x 164 words of span, 128 x 108 of power,
        # 128 x 2 of carry, 4 x 80 band words, 393 weights, 12 mbarriers,
        # 1024 to align
        plan = tmel.kernel_plan(400, 160, 80, 393, 2)
        assert plan == tmel.Plan(128, 130, 164, 6, 2, 400, 225448)
        assert (6 * 13312 + 4 * 130 * 164 + 4 * 128 * 108 + 4 * 128 * 2 + 16 * 80 + 4 * 393 + 4
                + 96 + 1024) == plan.smem_bytes

    @pytest.mark.parametrize("n_fft,hop,n_mels", [(400, 4, 80), (400, 0, 80),
                                                  (8192, 2048, 80), (400, 160, 12000)])
    def test_refuses_what_it_does_not_take(self, n_fft, hop, n_mels):
        with pytest.raises(ValueError, match="fused_logmel kernel"):
            tmel.kernel_plan(n_fft, hop, n_mels, 400, 2)


def _emulate(x, passes, n_fft=400, win_length=None, hop_length=None, window="hann", n_mels=80,
             sample_rate=16000, f_min=0.0, f_max=None, center=True, log_floor=1e-10,
             kaldi=False):
    """The kernel's arithmetic on the CPU from its own tables: frames and
    table split into TF32 hi and lo by bit operations, ``passes`` = 3 sums
    lo*hi + hi*lo + hi*hi in float32 (1: hi*hi alone), power from the
    interleaved cos/sin columns, the band-sparse mel projection, the log."""
    win_length = win_length or n_fft
    hop = hop_length or win_length // 2
    table, bands, wts = tmel._kernel_design(n_fft, win_length, window, n_mels, sample_rate,
                                            f_min, f_max, kaldi)
    k_pad = -(-n_fft // 16) * 16
    shape = (table.shape[0] // (k_pad // 8) * 208, k_pad)
    b_hi, b_lo = (torch.from_numpy(TestKernelTables._unslot(table[:, i], shape).T.copy())
                  for i in (0, 1))
    t = torch.from_numpy(x)
    if center:
        t = torch.nn.functional.pad(t, (n_fft // 2, n_fft // 2))
    n_frames = 1 + x.shape[1] // hop if center else 1 + (x.shape[1] - n_fft) // hop
    t = torch.nn.functional.pad(t, (0, k_pad))
    frames = tmel.frame_signal(t, k_pad, hop, n_frames)[..., :k_pad].numpy()
    a_hi = tmel.tf32_round(frames)
    a_lo = tmel.tf32_round(frames - a_hi)
    a_hi, a_lo = torch.from_numpy(a_hi), torch.from_numpy(a_lo)
    y = a_hi @ b_hi
    if passes == 3:
        y = a_lo @ b_hi + a_hi @ b_lo + y
    power = y[..., 0::2] ** 2 + y[..., 1::2] ** 2
    mel = torch.zeros(power.shape[:-1] + (n_mels,))
    for m, (lo, hi, off, _) in enumerate(bands.T):
        mel[..., m] = power[..., lo:hi] @ torch.from_numpy(wts[off: off + hi - lo])
    return torch.log(torch.clamp_min(mel, log_floor))


class TestThreePassArithmetic:
    """Pins the precision decision: on the card both precisions take three
    TF32 passes, because one pass misses rtol = atol = 1e-3 (chip_smoke's
    tolerance) at the mel bands one frequency bin wide."""

    CASES = {  # chip_smoke's shapes (the bench shape's rows cut to 4)
        "bench": ((4, 160000), dict(n_fft=400, hop_length=160, n_mels=80)),
        "mels40": ((3, 16037), dict(n_fft=400, hop_length=160, n_mels=40)),
        "kaldi": ((3, 16037), dict(n_fft=400, hop_length=160, n_mels=40, kaldi=True)),
        "uncentered": ((3, 16037), dict(n_fft=400, hop_length=160, n_mels=40, center=False)),
        "fastspeech2": ((1, 220500), dict(n_fft=1024, hop_length=256, n_mels=80,
                                          sample_rate=22050)),
        "wavegrad": ((1, 220500), dict(n_fft=1024, hop_length=300, n_mels=128,
                                       sample_rate=22050)),
        "hamming_512": ((2, 5003), dict(n_mels=23, n_fft=512, win_length=400, hop_length=100,
                                        window="hamming", f_min=20.0, f_max=7600.0,
                                        log_floor=1e-5)),
    }

    @staticmethod
    def _excess(shape, kw, passes):
        x = _signal(shape, seed=11)
        want = tmel.fused_logmel_reference(torch.from_numpy(x), **kw)
        got = _emulate(x, passes, **kw)
        assert got.shape == want.shape
        return ((got - want).abs() - (1e-3 + 1e-3 * want.abs())).max().item()

    @pytest.mark.parametrize("name", list(CASES))
    def test_three_passes_hold_the_tolerance(self, name):
        assert self._excess(*self.CASES[name], passes=3) <= 0

    def test_one_pass_does_not(self):
        assert self._excess(*self.CASES["bench"], passes=1) > 0
