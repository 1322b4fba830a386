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
        np.testing.assert_array_equal(tfb._htk_hz(m), jfb.mel_to_hz(m, htk=True))

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
