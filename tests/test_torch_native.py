"""Port parity for the native host layer (``mindaudio_torch._native``).

- ``wav_loader.cc`` is a byte copy of the JAX package's; ``ctc_beam.cc``
  has its C interface, byte for byte.
- The CTC prefix-beam DP (``ctc_beam.cc``) against the port's Python DP
  (``utils.recognize.ctc_prefix_beam_dp``) and against the JAX package's
  native DP, over several (B, T, K, beam), valid lengths below T and the
  ``max_len`` cut. The port's native DP follows the Python DP's arithmetic
  and tie order: equal prefixes, and each score the Python DP's float64
  rounded to float32, bit for bit, on tie-free log-probs and on the ties of
  bf16-rounded ones. The JAX package's native DP sums in another order and
  its sort is not stable, so it is compared on tie-free log-probs only
  (drawn from a continuous distribution): equal prefixes, scores within
  ``SCORE_ATOL`` = 1e-5 (a float32 ulp at |score| < 64 is under 8e-6).
- The WAV batch loader (``wav_loader.cc``) against the JAX package's and
  against the port's ``data.io.read``: int16, stereo int16 (first channel),
  float32, 24-bit PCM, a cut at ``max_len`` and a bad file flagged with
  rate 0. All three read the same bits: equal values.
- A failed build raises, in the DP, the loader and ``ASRInference``; there
  is no Python fallback.
"""

import struct
import time

import numpy as np
import pytest
import torch

from mindaudio_tpu import _native as jax_native
from mindaudio_torch import _native
from mindaudio_torch.data import io
from mindaudio_torch.models.asr_model import ASRModel
from mindaudio_torch.utils.recognize import ASRInference, ctc_prefix_beam_dp

torch.set_num_threads(1)

SCORE_ATOL = 1e-5


def _jax_loaded(available):
    """The JAX package builds its libraries in place at first use; another
    test process may be writing one right now, and a half-written file does
    not load. Ask again for up to a minute."""
    for _ in range(60):
        if available():
            return
        time.sleep(1.0)
    raise RuntimeError("the JAX package's native library did not build")


@pytest.fixture(scope="module")
def jax_beam():
    _jax_loaded(jax_native.beam_available)
    return jax_native.ctc_prefix_beam_batch


@pytest.fixture(scope="module")
def jax_wav():
    _jax_loaded(jax_native.available)
    return jax_native.wav_read_batch


@pytest.mark.parametrize("name", ["ctc_beam.cc", "wav_loader.cc"])
def test_sources_are_the_jax_packages(name):
    """The loader whole; the DP's C interface (from ``extern "C"`` on)."""
    ours = (_native.SRC_DIR / name).read_text()
    theirs = (_native.SRC_DIR.parents[1] / "mindaudio_tpu" / "_native" / name).read_text()
    if name == "ctc_beam.cc":
        ours, theirs = (src[src.index('extern "C"'):] for src in (ours, theirs))
    assert ours == theirs


def _same_as_python(got, top, idx, valid, beam, blank=0, max_len=None):
    """``got`` is the Python DP's result: equal prefixes (cut to
    ``max_len``), each score its float64 rounded to float32."""
    for i in range(len(valid)):
        want = ctc_prefix_beam_dp(top[i], idx[i], int(valid[i]), beam, blank_id=blank)
        assert [p for p, _ in got[i]] == [p[:max_len] for p, _ in want]
        assert [s for _, s in got[i]] == [float(np.float32(s)) for _, s in want]


def _same_as_jax(got, want):
    """Equal prefixes, scores within ``SCORE_ATOL``."""
    assert [[p for p, _ in row] for row in got] == [[p for p, _ in row] for row in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], rtol=0,
                                   atol=SCORE_ATOL)


def _topk(rng, b, t, v, k, blank_first=False):
    """Per-frame top-k of random log-softmax rows: ``(logp, idx)``."""
    logits = 2.0 * rng.standard_normal((b, t, v))
    if blank_first:
        logits[..., 0] += 3.0  # blank-heavy frames, as a trained model's
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    idx = np.argsort(-logp, -1)[..., :k].astype(np.int32)
    return np.take_along_axis(logp, idx, -1).astype(np.float32), idx


@pytest.mark.parametrize("b,t,v,k,beam,blank_first", [
    (1, 1, 5, 3, 2, False),
    (3, 17, 12, 4, 3, True),
    (4, 40, 24, 8, 8, False),
    (2, 64, 50, 10, 10, True),
    (5, 9, 6, 6, 1, False),
])
def test_ctc_beam_matches_python_and_jax(jax_beam, b, t, v, k, beam, blank_first):
    rng = np.random.default_rng(t * 31 + b)
    top, idx = _topk(rng, b, t, v, k, blank_first)
    valid = np.array([t] + [int(x) for x in rng.integers(0, t + 1, b - 1)], np.int32)
    got = _native.ctc_prefix_beam_batch(top, idx, valid, beam)
    _same_as_python(got, top, idx, valid, beam)
    _same_as_jax(got, jax_beam(top, idx, valid, beam))


@pytest.mark.parametrize("b,t,v,k,beam", [(4, 60, 40, 10, 10), (3, 120, 300, 10, 4),
                                          (2, 33, 4233, 6, 6)])
def test_ctc_beam_equals_python_on_ties(b, t, v, k, beam):
    """The top-k of bf16-rounded logits, as a bf16 model serves them: many
    tokens of a frame share a log-prob, and prefixes tie."""
    rng = np.random.default_rng(t * 7 + v)
    logits = torch.from_numpy(rng.standard_normal((b, t, v)).astype(np.float32))
    logits[..., 0] += 2.0
    top, idx = torch.log_softmax(logits.to(torch.bfloat16).float(), -1).topk(k, -1)
    top, idx = top.numpy(), idx.numpy().astype(np.int32)
    assert all(any(len(set(row.tolist())) < k for row in top[i]) for i in range(b))  # ties
    valid = np.array([t] + [int(x) for x in rng.integers(1, t + 1, b - 1)], np.int32)
    _same_as_python(_native.ctc_prefix_beam_batch(top, idx, valid, beam), top, idx, valid, beam)


def test_ctc_beam_max_len_and_blank_id(jax_beam):
    rng = np.random.default_rng(7)
    top, idx = _topk(rng, 2, 30, 9, 5)
    valid = np.array([30, 21], np.int32)
    for max_len, blank in ((3, 0), (1, 8), (None, 4)):
        got = _native.ctc_prefix_beam_batch(top, idx, valid, 4, blank_id=blank, max_len=max_len)
        _same_as_jax(got, jax_beam(top, idx, valid, 4, blank_id=blank, max_len=max_len))
        _same_as_python(got, top, idx, valid, 4, blank=blank, max_len=max_len)
        assert all(len(p) <= (max_len or 30) for row in got for p, _ in row)


def _wav_24bit(path, samples, sr):
    """A mono 24-bit little-endian PCM file of int samples in [-2^23, 2^23)."""
    data = b"".join(struct.pack("<i", int(s))[:3] for s in samples)
    fmt = struct.pack("<HHIIHH", 1, 1, sr, 3 * sr, 3, 24)
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", len(data)) + data)
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)


def test_wav_read_batch_matches_jax_and_io(jax_wav, tmp_path):
    rng = np.random.default_rng(0)
    files = {
        "int16.wav": ((0.3 * rng.standard_normal(4000) * 32767).astype(np.int16), 16000),
        "stereo.wav": ((0.2 * rng.standard_normal((3001, 2)) * 32767).astype(np.int16), 16000),
        "float32.wav": ((0.5 * np.sin(np.arange(5000) / 30.0)).astype(np.float32), 22050),
        "long.wav": ((0.1 * rng.standard_normal(9000) * 32767).astype(np.int16), 8000),
    }
    paths = []
    for name, (x, sr) in files.items():
        io.write(str(tmp_path / name), x, sr)
        paths.append(str(tmp_path / name))
    _wav_24bit(tmp_path / "pcm24.wav", rng.integers(-2**23, 2**23, 2500), 16000)
    (tmp_path / "bad.wav").write_bytes(b"not a wav file at all")
    paths += [str(tmp_path / "pcm24.wav"), str(tmp_path / "bad.wav")]

    max_len = 6000
    got = _native.wav_read_batch(paths, max_len)
    for a, b in zip(got, jax_wav(paths, max_len)):
        np.testing.assert_array_equal(a, b)
    batch, lens, rates = got
    assert batch.dtype == np.float32 and batch.shape == (len(paths), max_len)
    assert rates.tolist() == [16000, 16000, 22050, 8000, 16000, 0]
    assert lens.tolist() == [4000, 3001, 5000, 6000, 2500, 0]  # long.wav cut to max_len
    for i, path in enumerate(paths[:-1]):
        x, sr = io.read(path)
        x = np.asarray(x, np.float32)
        x = x[:, 0] if x.ndim > 1 else x
        assert sr == rates[i]
        np.testing.assert_array_equal(batch[i, : lens[i]], x[:max_len])
        assert not batch[i, lens[i]:].any()
    assert not batch[-1].any()


@pytest.fixture
def broken_compiler(monkeypatch, tmp_path):
    """A compiler that always fails, an empty build directory and nothing
    loaded."""
    monkeypatch.setattr(_native, "CXX", "false")
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_native, "_loaded", {})


def test_a_failed_build_raises(broken_compiler, tmp_path):
    top, idx = _topk(np.random.default_rng(1), 1, 4, 6, 3)
    with pytest.raises(RuntimeError, match="build failed"):
        _native.ctc_prefix_beam_batch(top, idx, [4], 2)
    with pytest.raises(RuntimeError, match="build failed"):
        _native.wav_read_batch([str(tmp_path / "a.wav")], 10)
    model = ASRModel(8, input_dim=12, d_model=16, head_num=2, ffn_dim=32, num_encoder_layers=1,
                     num_decoder_layers=1, device="cpu").reset_parameters(
                         torch.Generator().manual_seed(0))
    feats = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 30, 12)).astype(
        np.float32))
    inf = ASRInference(model, beam_size=2)
    with pytest.raises(RuntimeError, match="build failed"):
        inf.ctc_prefix_beam_search_batch(feats, torch.tensor([30]))
    assert not list((tmp_path / "build").glob("*.so"))


def test_build_is_hashed_and_kept(tmp_path, monkeypatch):
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_native, "_loaded", {})
    assert sorted(_native.build()) == ["ctc_beam", "wav_loader"]
    libs = sorted(p.name for p in (tmp_path / "build").iterdir())
    assert len(libs) == 2 and all(p.startswith("lib") and p.endswith(".so") for p in libs)
    assert _native.build() == {}  # built: nothing to do
    monkeypatch.setattr(_native, "CXX_FLAGS", _native.CXX_FLAGS + ["-DNDEBUG"])
    assert sorted(_native.build(["ctc_beam"])) == ["ctc_beam"]  # new flags, new library
