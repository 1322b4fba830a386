"""Port parity: filterbank copies, kaldi_fbank, masks and host helpers
against the JAX package, on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindaudio_tpu.ops import filterbanks as jfb
from mindaudio_tpu.ops import spectral as jspec
from mindaudio_tpu.utils import common as jcommon
from mindaudio_tpu.utils import mask as jmask
from mindaudio_torch.ops import filterbanks as tfb
from mindaudio_torch.ops import spectral as tspec
from mindaudio_torch.utils import common as tcommon
from mindaudio_torch.utils import mask as tmask

torch.set_num_threads(1)


class TestFilterbankCopies:
    """The port's NumPy copies must equal the originals bit for bit."""

    @pytest.mark.parametrize("num_bins,n_fft,sr,low,high", [
        (80, 512, 16000, 20.0, None), (40, 256, 8000, 20.0, None),
        (23, 1024, 22050, 60.0, 7600.0)])
    def test_kaldi_mel_banks(self, num_bins, n_fft, sr, low, high):
        want = jfb.kaldi_mel_banks(num_bins, n_fft, sr, low, high)
        got = tfb.kaldi_mel_banks(num_bins, n_fft, sr, low, high)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("window", ["povey", "hann", "hamming"])
    def test_windows(self, window):
        np.testing.assert_array_equal(tfb.get_window(window, 400),
                                      jfb.get_window(window, 400))

    def test_htk_mel(self):
        f = np.array([0.0, 440.0, 999.0, 1000.0, 7999.5])
        np.testing.assert_array_equal(tfb.hz_to_mel(f, htk=True), jfb.hz_to_mel(f, htk=True))
        assert tfb.hz_to_mel(1500.0, htk=True) == jfb.hz_to_mel(1500.0, htk=True)


class TestKaldiFbank:
    # Both sides compute in float32 with the DFT as a matmul; sums run in
    # another order, so the power spectrum differs by a few float32 ulps
    # (relative ~1e-6) and the log-mel by about that much in absolute
    # terms. 2e-4 leaves room for low-energy bins.
    ATOL = 2e-4

    def _jax(self, wav, **kw):
        return np.asarray(jspec.kaldi_fbank(jnp.asarray(wav), **kw))

    def test_float_batch_odd_length(self):
        rng = np.random.default_rng(0)
        wav = (0.3 * rng.standard_normal((2, 16000 + 77))).astype(np.float32)
        got = tspec.kaldi_fbank(wav, device="cpu").numpy()
        want = self._jax(wav)
        assert got.shape == want.shape == (2, 98, 80)
        np.testing.assert_allclose(got, want, rtol=0, atol=self.ATOL)

    def test_int16_input_is_not_rescaled(self):
        rng = np.random.default_rng(1)
        pcm = (rng.standard_normal(8011) * 3000).astype(np.int16)
        got = tspec.kaldi_fbank(torch.from_numpy(pcm), device="cpu").numpy()
        want = self._jax(pcm)
        np.testing.assert_allclose(got, want, rtol=0, atol=self.ATOL)
        # the same samples as float in [-1, 1] give the same features
        as_float = tspec.kaldi_fbank(pcm.astype(np.float32) / 32768.0, device="cpu")
        np.testing.assert_allclose(as_float.numpy(), got, rtol=0, atol=self.ATOL)

    def test_other_config(self):
        rng = np.random.default_rng(2)
        wav = (0.1 * rng.standard_normal((3, 4001))).astype(np.float32)
        kw = dict(num_mel_bins=40, frame_length_ms=20.0, frame_shift_ms=5.0,
                  preemphasis=0.0, remove_dc=False, window="hann")
        got = tspec.kaldi_fbank(wav, device="cpu", **kw).numpy()
        np.testing.assert_allclose(got, self._jax(wav, **kw), rtol=0, atol=self.ATOL)

    def test_frame_signal(self):
        x = np.arange(2 * 1000, dtype=np.float32).reshape(2, 1000)
        for n_fft, hop, n in [(400, 160, 4), (400, 160, 6), (512, 128, 3)]:
            want = np.asarray(jspec.frame_signal(jnp.asarray(x), n_fft, hop, n))
            got = tspec.frame_signal(torch.from_numpy(x), n_fft, hop, n).numpy()
            np.testing.assert_array_equal(got, want)

    def test_dither_needs_generator(self):
        wav = (0.1 * np.random.default_rng(3).standard_normal(4000)).astype(np.float32)
        plain = tspec.kaldi_fbank(wav, device="cpu")
        assert torch.equal(tspec.kaldi_fbank(wav, dither=1.0, device="cpu"), plain)
        g = torch.Generator().manual_seed(0)
        dithered = tspec.kaldi_fbank(wav, dither=1.0, generator=g, device="cpu")
        assert not torch.equal(dithered, plain)
        g2 = torch.Generator().manual_seed(0)
        again = tspec.kaldi_fbank(wav, dither=1.0, generator=g2, device="cpu")
        assert torch.equal(dithered, again)


class TestMasks:
    def test_pad_masks(self):
        lens = np.array([5, 0, 3, 7])
        want = np.asarray(jmask.make_pad_mask(jnp.asarray(lens), 7))
        got = tmask.make_pad_mask(torch.from_numpy(lens), 7).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            tmask.make_non_pad_mask(torch.from_numpy(lens), 7).numpy(), ~want)

    def test_subsequent_masks(self):
        np.testing.assert_array_equal(tmask.subsequent_mask(6).numpy(),
                                      np.asarray(jmask.subsequent_mask(6)))
        for chunk, left in [(1, -1), (3, -1), (4, 0), (2, 1), (16, 2)]:
            np.testing.assert_array_equal(
                tmask.subsequent_chunk_mask(11, chunk, left).numpy(),
                np.asarray(jmask.subsequent_chunk_mask(11, chunk, left)))

    @pytest.mark.parametrize("dyn,dec,static,left", [
        (False, 0, 0, -1), (True, -1, 0, -1), (True, 4, 0, -1), (True, 3, 0, 1),
        (False, 0, 5, -1), (False, -1, 2, 2)])
    def test_add_optional_chunk_mask_decoding(self, dyn, dec, static, left):
        lens = np.array([9, 6])
        jm = jmask.make_non_pad_mask(jnp.asarray(lens), 9)[:, None, :]
        tm = tmask.make_non_pad_mask(torch.from_numpy(lens), 9)[:, None, :]
        want = np.asarray(jmask.add_optional_chunk_mask(jm, dyn, False, dec, static, left))
        got = tmask.add_optional_chunk_mask(tm, dyn, False, dec, static, left).numpy()
        np.testing.assert_array_equal(got, want)

    def test_training_chunk_sampling_is_not_ported(self):
        """The name dates from the serving slice, where this branch raised
        ``NotImplementedError``. It is ported now: it needs a generator, and
        what it samples is held to its invariants in ``test_torch_train.py``."""
        m = tmask.make_non_pad_mask(torch.tensor([4]), 4)[:, None, :]
        with pytest.raises(ValueError, match="Generator"):
            tmask.add_optional_chunk_mask(m, True, False, 0, 0, -1)
        out = tmask.add_optional_chunk_mask(m, True, False, 0, 0, -1,
                                            generator=torch.Generator().manual_seed(0))
        assert out.shape == (1, 4, 4) and out.dtype == torch.bool

    @pytest.mark.parametrize("dtype", [np.float32, np.int64])
    def test_mask_finished(self, dtype):
        """The beam bookkeeping of finished rows, on the same numpy inputs:
        scores (one alive branch at 0, the others at -1e9) and predictions
        (every branch ``eos``)."""
        rng = np.random.default_rng(5)
        end = np.array([[True], [False], [True], [False], [False], [True]])
        if dtype == np.float32:
            x = rng.standard_normal((6, 3)).astype(dtype)
            want = np.asarray(jmask.mask_finished_scores(jnp.asarray(x), jnp.asarray(end)))
            got = tmask.mask_finished_scores(torch.from_numpy(x), torch.from_numpy(end))
        else:
            x = rng.integers(0, 50, (6, 3)).astype(dtype)
            want = np.asarray(jmask.mask_finished_preds(jnp.asarray(x), jnp.asarray(end), 49))
            got = tmask.mask_finished_preds(torch.from_numpy(x), torch.from_numpy(end), 49)
        # the input's type (JAX without x64 gives int32 for int64)
        assert got.dtype == torch.from_numpy(x).dtype
        np.testing.assert_array_equal(got.numpy(), want)


class TestCommon:
    def test_pad_and_sos_eos(self):
        seqs = [np.array([3, 4, 5]), np.array([7]), np.array([], np.int64)]
        for kw in ({}, {"max_len": 2}, {"max_len": 5, "padding_value": -1}):
            np.testing.assert_array_equal(tcommon.pad_sequence(seqs, **kw),
                                          jcommon.pad_sequence(seqs, **kw))
        padded = jcommon.pad_sequence(seqs, padding_value=-1, max_len=4)
        for a, b in zip(tcommon.add_sos_eos(padded, 9, 10),
                        jcommon.add_sos_eos(padded, 9, 10)):
            np.testing.assert_array_equal(a, b)

    def test_collapse_and_log_add(self):
        hyp = [0, 3, 3, 0, 3, 5, 5, 5, 0, 0, 2]
        for blank in (0, 5):
            assert (tcommon.remove_duplicates_and_blank(hyp, blank)
                    == jcommon.remove_duplicates_and_blank(hyp, blank))
        for args in ([-1.0, -2.5, -0.3], [-float("inf")] * 2, [-float("inf"), -4.0]):
            assert tcommon.log_add(args) == jcommon.log_add(args)
