"""Port parity for the rest of the device DSP layer against the JAX package
on the CPU: ``ops.spectral`` (``mfcc``, ``istft``, ``global_cmvn``,
``sliding_window_cmn``, ``set_precision`` and the per-call ``precision=``),
``ops.filterbanks`` (``mel``, ``create_dct``) and ``ops.resample``.

Tolerances: both sides compute in float32 with the DFT and mel products in
another summation order. The MFCCs are dB values (tens to hundreds): 1e-4 of
their range. ``istft`` of a unit-scale STFT: 1e-5 absolute; the round trip
through the port's own ``stft``: 1e-5. CMN: float32 prefix sums over 200
frames, 1e-5 absolute on unit-scale features (2e-5 with the variance). The
resample convolution sums ~60 float32 products: 1e-6 absolute on unit-scale
signals. The filter banks are NumPy on both sides: bit for bit.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindaudio_tpu.ops import filterbanks as jfb
from mindaudio_tpu.ops import spectral as jspec
from mindaudio_torch.ops import filterbanks as tfb
from mindaudio_torch.ops import resample as tresample
from mindaudio_torch.ops import spectral as tspec

# the JAX package's ops/__init__ re-exports the function under the module's name
jresample = importlib.import_module("mindaudio_tpu.ops.resample")

torch.set_num_threads(1)


def _wave(seed=0, shape=(2, 4000)):
    return (0.3 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("kw", [
    {},
    {"deltas": False, "context": False, "log_mels": True, "n_mels": 40, "n_mfcc": 13},
    {"norm": None, "context": False, "hop_length": 160, "n_fft": 512},
])
def test_mfcc_matches_jax(kw):
    x = _wave()
    want = np.asarray(jspec.mfcc(jnp.asarray(x), **kw))
    got = tspec.mfcc(torch.from_numpy(x), device="cpu", **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("length", [None, 3900, 4100])
@pytest.mark.parametrize("n_fft,win_length,hop", [(512, None, None), (400, 320, 160)])
def test_istft_matches_jax(length, n_fft, win_length, hop):
    rng = np.random.default_rng(1)
    n_freq = n_fft // 2 + 1
    spec = rng.standard_normal((2, n_freq, 30, 2)).astype(np.float32)
    kw = dict(n_fft=n_fft, win_length=win_length, hop_length=hop, length=length)
    want = np.asarray(jspec.istft(jnp.asarray(spec), **kw))
    got = tspec.istft(torch.from_numpy(spec), device="cpu", **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_istft_inverts_stft():
    x = _wave(2, (3, 8000))
    spec = tspec.stft(torch.from_numpy(x), n_fft=512, device="cpu")
    y = tspec.istft(spec, n_fft=512, length=8000, device="cpu").numpy()
    np.testing.assert_allclose(y, x, rtol=0, atol=1e-5)


def test_global_cmvn_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 50, 20)).astype(np.float32)
    mean, istd = rng.standard_normal(20).astype(np.float32), rng.random(20).astype(np.float32)
    want = np.asarray(jspec.global_cmvn(jnp.asarray(x), jnp.asarray(mean), jnp.asarray(istd)))
    got = tspec.global_cmvn(*(torch.from_numpy(a) for a in (x, mean, istd))).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("center", [False, True])
@pytest.mark.parametrize("norm_vars", [False, True])
@pytest.mark.parametrize("t_len,window,min_window", [(200, 60, 20), (40, 600, 100)])
def test_sliding_window_cmn_matches_jax(center, norm_vars, t_len, window, min_window):
    x = (1.0 + np.random.default_rng(4).standard_normal((2, t_len, 8))).astype(np.float32)
    kw = dict(cmn_window=window, min_cmn_window=min_window, center=center, norm_vars=norm_vars)
    want = np.asarray(jspec.sliding_window_cmn(jnp.asarray(x), **kw))
    got = tspec.sliding_window_cmn(torch.from_numpy(x), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 if norm_vars else 1e-5)


def test_sliding_window_cmn_keeps_bf16():
    x = torch.randn(1, 30, 4, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    assert tspec.sliding_window_cmn(x, cmn_window=10).dtype == torch.bfloat16


@pytest.mark.parametrize("orig,new", [(44100, 16000), (14400, 16000), (17600, 16000),
                                      (16000, 8000), (8000, 16000)])
def test_resample_matches_jax(orig, new):
    x = _wave(5, (2, 3, 2205))
    want = np.asarray(jresample.resample(jnp.asarray(x), orig, new))
    got = tresample.resample(torch.from_numpy(x), orig, new)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_resample_bank_matches_jax():
    kernel, width, up, down = jresample._kernel(441, 160, 6, 0.99, 14.769656459379492)
    bank, w2, u2, d2 = tresample._kernel(441, 160, 6, 0.99, 14.769656459379492)
    assert (width, up, down) == (w2, u2, d2)
    np.testing.assert_array_equal(bank, np.asarray(kernel))


def test_resample_same_rate_is_the_input():
    x = torch.from_numpy(_wave())
    assert tresample.resample(x, 16000, 16000) is x


@pytest.mark.parametrize("kw", [dict(sr=16000, n_fft=512), dict(sr=22050, n_fft=1024, n_mels=80,
                                fmin=30.0, fmax=8000.0, htk=True), dict(sr=8000, n_fft=256,
                                n_mels=20, norm=None)])
def test_mel_bank_is_the_jax_copy(kw):
    np.testing.assert_array_equal(tfb.mel(**kw), jfb.mel(**kw))


@pytest.mark.parametrize("n_mfcc,n_mels,norm", [(20, 23, "ortho"), (13, 40, None),
                                                (40, 40, "none")])
def test_create_dct_is_the_jax_copy(n_mfcc, n_mels, norm):
    np.testing.assert_array_equal(tfb.create_dct(n_mfcc, n_mels, norm),
                                  jfb.create_dct(n_mfcc, n_mels, norm))


def test_set_precision_changes_no_global_flag():
    """The module level and a per-call ``precision=`` set the TF32 switches
    for the op's own products only, and an unknown level raises."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    seen = []
    conv1d = torch.nn.functional.conv1d

    def spy(*args, **kwargs):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return conv1d(*args, **kwargs)

    x = torch.from_numpy(_wave())
    try:
        for level, tf32 in (("high", True), ("highest", False), ("default", True)):
            tspec.set_precision(level)
            tspec.mfcc(x, device="cpu")
            tspec.istft(tspec.stft(x, device="cpu"), device="cpu")
            assert (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32) == flags
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(tresample.F, "conv1d", spy)
                tresample.resample(x, 44100, 16000)
                tresample.resample(x, 44100, 16000, precision="highest")
            assert seen[-2:] == [(tf32, tf32), (False, False)]
        with pytest.raises(ValueError):
            tspec.set_precision("fastest")
        with pytest.raises(ValueError):
            tspec.mfcc(x, device="cpu", precision="fastest")
    finally:
        tspec.set_precision("highest")
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == flags


def test_precision_is_passed_to_the_inner_ops(monkeypatch):
    """``mfcc(precision=...)`` computes its mel spectrogram at that level,
    whatever the module's default."""
    levels = []
    inner = tspec._windowed_dft

    def spy(*args, **kwargs):
        levels.append(torch.backends.cuda.matmul.allow_tf32)
        return inner(*args, **kwargs)

    monkeypatch.setattr(tspec, "_windowed_dft", spy)
    tspec.mfcc(torch.from_numpy(_wave()), device="cpu", precision="high")
    tspec.mfcc(torch.from_numpy(_wave()), device="cpu")
    assert levels == [True, False]
