"""The port's data layer and ``metric.snr`` against the committed reference
goldens, with the cases and tolerances of ``tests/test_golden.py`` and
``tests/test_bss_eval.py``.

``tests/goldens/dsp_goldens.npz`` holds DSP outputs recorded from real
AISHELL / LibriSpeech speech and a room impulse response;
``tests/goldens/bss_eval_goldens.npz`` BSS Eval scores from a direct
least-squares decomposition. Both are read unchanged.

- The host layer (``mindaudio_torch.data``): stft magnitude, the istft round
  trip, fbank, mfcc, resample and sliding-window CMN, at the host tolerances.
- The device ops (``mindaudio_torch.ops``) on the CPU at ``precision=
  "highest"`` (float32 products): the same cases and ``kaldi_fbank``, at the
  device tolerances (the JAX tests' tolerances for its device ops).
- ``metric.bss_eval_sources`` on the committed mixture, at 1e-3 dB.
"""

import os

import numpy as np
import pytest
import torch
from test_bss_eval import _mixture

import mindaudio_torch as ma
from mindaudio_torch import ops
from mindaudio_torch.metric import bss_eval_sources

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
CLIPS = ("libri", "aishell", "rir")


@pytest.fixture(scope="module")
def g():
    with np.load(os.path.join(HERE, "goldens", "dsp_goldens.npz")) as f:
        return dict(f)


def _dev(x):
    """A float32 CPU tensor, as the JAX device tests pass float32 arrays."""
    return torch.from_numpy(np.asarray(x, np.float32))


class TestHostGolden:
    @pytest.mark.parametrize("clip", CLIPS)
    def test_stft_mag(self, g, clip):
        S = ma.stft(g[f"{clip}/wav"], n_fft=512, hop_length=160)
        np.testing.assert_allclose(np.abs(S), g[f"{clip}/stft_mag"], rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("clip", CLIPS)
    def test_istft_roundtrip(self, g, clip):
        x = g[f"{clip}/wav"]
        S = ma.stft(x, n_fft=512, hop_length=160)
        y = ma.istft(S, n_fft=512, hop_length=160, length=len(x))
        err = np.max(np.abs(y - x))
        assert err <= max(5.0 * float(g[f"{clip}/istft_err"]), 1e-6), err

    @pytest.mark.parametrize("clip", CLIPS)
    def test_fbank(self, g, clip):
        x, sr = g[f"{clip}/wav"], int(g[f"{clip}/sr"])
        fb = ma.fbank(x[None].astype(np.float32), n_mels=40, n_fft=400, sample_rate=sr)[0]
        np.testing.assert_allclose(fb, g[f"{clip}/fbank"], rtol=1e-5, atol=1e-4)

    @pytest.mark.parametrize("clip", CLIPS)
    def test_mfcc(self, g, clip):
        x, sr = g[f"{clip}/wav"], int(g[f"{clip}/sr"])
        mf = ma.mfcc(x[None].astype(np.float32), deltas=False, context=False, n_mels=23,
                     n_mfcc=20, sample_rate=sr)[0]
        np.testing.assert_allclose(mf, g[f"{clip}/mfcc"], rtol=1e-4, atol=1e-3)

    @pytest.mark.parametrize("clip", CLIPS)
    def test_resample(self, g, clip):
        x, sr = g[f"{clip}/wav"], int(g[f"{clip}/sr"])
        y = ma.resample(x, orig_freq=sr, new_freq=8000)
        np.testing.assert_allclose(y, g[f"{clip}/resample_8k"], rtol=1e-5, atol=1e-6)

    def test_sliding_window_cmn(self, g):
        fb = g["libri/fbank"].T
        cmn = ma.sliding_window_cmn(fb[None], cmn_window=100, min_cmn_window=50)[0]
        np.testing.assert_allclose(cmn, g["libri/cmn"], rtol=1e-5, atol=1e-5)


class TestDeviceOpsGolden:
    """The ops on the CPU: the same computation the card runs, in float32."""

    @pytest.mark.parametrize("clip", CLIPS)
    def test_stft_mag(self, g, clip):
        ri = ops.stft(_dev(g[f"{clip}/wav"]), n_fft=512, hop_length=160, device="cpu",
                      precision="highest").numpy()
        mag = np.hypot(ri[..., 0], ri[..., 1])
        np.testing.assert_allclose(mag, g[f"{clip}/stft_mag"], rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("clip", CLIPS)
    def test_istft_roundtrip(self, g, clip):
        x = g[f"{clip}/wav"]
        S = ops.stft(_dev(x), n_fft=512, hop_length=160, device="cpu", precision="highest")
        y = ops.istft(S, n_fft=512, hop_length=160, length=len(x), device="cpu",
                      precision="highest").numpy()
        assert np.max(np.abs(y - x)) < 1e-4

    @pytest.mark.parametrize("clip", CLIPS)
    def test_fbank(self, g, clip):
        x, sr = g[f"{clip}/wav"], int(g[f"{clip}/sr"])
        fb = ops.fbank(_dev(x[None]), n_mels=40, n_fft=400, sample_rate=sr, device="cpu",
                       precision="highest")[0].numpy()
        np.testing.assert_allclose(fb, g[f"{clip}/fbank"], rtol=1e-4, atol=2e-3)

    @pytest.mark.parametrize("clip", CLIPS)
    def test_mfcc(self, g, clip):
        x, sr = g[f"{clip}/wav"], int(g[f"{clip}/sr"])
        mf = ops.mfcc(_dev(x[None]), deltas=False, context=False, n_mels=23, n_mfcc=20,
                      sample_rate=sr, device="cpu", precision="highest")[0].numpy()
        np.testing.assert_allclose(mf, g[f"{clip}/mfcc"], rtol=1e-3, atol=1e-2)

    def test_kaldi_fbank(self, g):
        x, sr = g["aishell/wav"], int(g["aishell/sr"])
        kf = ops.kaldi_fbank(_dev(x[None]), num_mel_bins=80, sample_rate=sr, device="cpu",
                             precision="highest")[0].numpy()
        np.testing.assert_allclose(kf, g["aishell/kaldi_fbank"], rtol=1e-4, atol=2e-3)

    def test_sliding_window_cmn(self, g):
        fb = g["libri/fbank"].T
        cmn = ops.sliding_window_cmn(_dev(fb[None]), cmn_window=100, min_cmn_window=50)[0]
        np.testing.assert_allclose(cmn.numpy(), g["libri/cmn"], rtol=1e-3, atol=1e-3)


def test_bss_eval_committed_goldens():
    with np.load(os.path.join(HERE, "goldens", "bss_eval_goldens.npz")) as f:
        data = dict(f)
    refs, ests = _mixture(int(data["seed"]), t=int(data["t"]))
    sdr, sir, sar, perm = bss_eval_sources(refs, ests, filter_length=int(data["flen"]))
    np.testing.assert_allclose(sdr, data["sdr"], atol=1e-3)
    np.testing.assert_allclose(sir, data["sir"], atol=1e-3)
    np.testing.assert_allclose(sar, data["sar"], atol=1e-3)
    np.testing.assert_array_equal(perm, data["perm"])
