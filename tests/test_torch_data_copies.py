"""The port's copies of the JAX package's NumPy data layer, pinned to the
originals: ``data/filters``, ``data/spectrum``, ``data/features``,
``data/processing``, ``data/augment`` and ``data/aishell``.

Each copied function is held twice: its code (the syntax tree without the
docstring) equals the original's, and on the same seeded input it returns
the original's result bit for bit (``assert_array_equal``: the same NumPy
and SciPy calls in the same order).
"""

import ast
import inspect
import os
import textwrap

import numpy as np
import pytest

from mindaudio_tpu.data import aishell as jaishell
from mindaudio_tpu.data import augment as jaug
from mindaudio_tpu.data import features as jfeat
from mindaudio_tpu.data import filters as jfilt
from mindaudio_tpu.data import io as jio
from mindaudio_tpu.data import processing as jproc
from mindaudio_tpu.data import spectrum as jspec
from mindaudio_torch.data import aishell as taishell
from mindaudio_torch.data import augment as taug
from mindaudio_torch.data import features as tfeat
from mindaudio_torch.data import filters as tfilt
from mindaudio_torch.data import processing as tproc
from mindaudio_torch.data import spectrum as tspec

COPIES = {
    (jfilt, tfilt): ["cal_filter_by_coffs", "_biquad_coeffs", "low_pass_filter",
                     "peaking_equalizer", "contrast", "riaa_biquad", "treble_biquad",
                     "dcshift", "filtfilt"],
    (jspec, tspec): ["amplitude_to_dB", "frame", "overlap_add", "_overlap_add_time_major",
                     "istft", "_window_sumsquare", "_fix_length", "magphase", "resynthesize"],
    (jfeat, tfeat): ["spectral_centroid", "context_window", "compute_deltas", "fbank", "mfcc",
                     "complex_norm", "angle", "soft_mask", "hpss", "harmonic"],
    (jproc, tproc): ["normalize", "stereo_to_mono", "_frame_energy_db", "_activity", "trim",
                     "split", "sliding_window_cmn", "invert_channels", "loop", "clip",
                     "insert_in_background", "overlap_and_add"],
    (jaug, taug): ["_mask_along_axis", "frequencymasking", "timemasking", "add_babble",
                   "time_stretch", "_phase_vocoder", "pitch_shift"],
    (jaishell, taishell): ["load_transcripts", "save_aishell_info"],
}


def _code(fn):
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    node = tree.body[0]
    body = node.body
    if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
        node.body = body[1:]
    return ast.dump(node)


@pytest.mark.parametrize("mods,name", [(m, n) for m, names in COPIES.items() for n in names],
                         ids=lambda v: v if isinstance(v, str) else v[0].__name__.split(".")[-1])
def test_copy_has_the_original_code(mods, name):
    jmod, tmod = mods
    assert _code(getattr(tmod, name)) == _code(getattr(jmod, name))


def test_module_tables_are_copied():
    assert tfilt._RIAA_TABLE == jfilt._RIAA_TABLE
    assert tproc._SCALE_NORMS.keys() == jproc._SCALE_NORMS.keys()
    assert set(tspec.__all__) == set(jspec.__all__)
    assert set(tfeat.__all__) == set(jfeat.__all__)
    assert set(tproc.__all__) == set(jproc.__all__)
    assert set(tfilt.__all__) == set(jfilt.__all__)
    assert set(taug.__all__) == set(jaug.__all__)


def _wave(seed=0, shape=(4000,), scale=0.3):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _same(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name,args,kw", [
    ("low_pass_filter", (16000, 2000.0), {}),
    ("peaking_equalizer", (16000, 1000.0, 6.0), {"q": 0.9}),
    ("contrast", (), {"enhancement_amount": 50.0}),
    ("riaa_biquad", (), {"sample_rate": 48000}),
    ("treble_biquad", (16000, -4.0), {}),
    ("dcshift", (0.2,), {"limiter_gain": 0.05}),
    ("dcshift", (-0.3,), {}),
    ("filtfilt", (4, 0.3, "lowpass"), {}),
])
def test_filters_match(name, args, kw):
    # the biquads filter along axis 0, filtfilt along the last axis
    x = _wave(1, (2, 3000) if name == "filtfilt" else (3000, 2))
    _same(getattr(tfilt, name)(x, *args, **kw), getattr(jfilt, name)(x, *args, **kw))


def test_spectrum_matches():
    x = _wave(2, (2, 4000))
    spec = jspec.stft(x, n_fft=512)
    assert np.iscomplexobj(spec)
    _same(tspec.amplitude_to_dB(np.abs(spec) ** 2), jspec.amplitude_to_dB(np.abs(spec) ** 2))
    _same(tspec.amplitude_to_dB(np.abs(spec), stype="magnitude", top_db=None, ref=np.max),
          jspec.amplitude_to_dB(np.abs(spec), stype="magnitude", top_db=None, ref=np.max))
    _same(tspec.frame(x[0], 400, 160), jspec.frame(x[0], 400, 160))
    for length in (None, 3900):
        _same(tspec.istft(spec, length=length), jspec.istft(spec, length=length))
    _same(tspec.magphase(x, 2.0), jspec.magphase(x, 2.0))
    _same(tspec.magphase(spec, 1.0), jspec.magphase(spec, 1.0))
    mag = np.abs(spec) * 0.5
    _same(tspec.resynthesize(mag, x), jspec.resynthesize(mag, x))
    frames = _wave(3, (10, 400))
    a, b = np.zeros(400 + 9 * 160), np.zeros(400 + 9 * 160)
    tspec.overlap_add(a, frames.T, 160)
    jspec.overlap_add(b, frames.T, 160)
    _same(a, b)


@pytest.mark.parametrize("name,kw", [
    ("spectral_centroid", {"sample_rate": 16000}),
    ("fbank", {}),
    ("fbank", {"deltas": True, "context": True, "n_mels": 24}),
    ("mfcc", {}),
    ("mfcc", {"log_mels": True, "deltas": False, "context": False}),
    ("harmonic", {}),
])
def test_features_match(name, kw):
    x = _wave(4, (2, 3200))
    _same(getattr(tfeat, name)(x, **kw), getattr(jfeat, name)(x, **kw))


def test_spectral_features_match():
    x = _wave(5, (2, 3200))
    spec = jspec.stft(x, n_fft=256)
    mag = np.abs(spec)
    feats = np.abs(_wave(6, (2, 13, 30)))
    for name, args, kw in [("context_window", (feats,), {"left_frames": 2, "right_frames": 1}),
                           ("compute_deltas", (feats,), {"win_length": 7}),
                           ("complex_norm", (np.stack([spec.real, spec.imag], -1),), {}),
                           ("angle", (np.stack([spec.real, spec.imag], -1),), {}),
                           ("soft_mask", (mag, mag + 0.1), {"power": 2}),
                           ("soft_mask", (mag, mag * 0.0), {"split_zeros": True}),
                           ("hpss", (mag,), {"kernel_size": 7}),
                           ("hpss", (mag,), {"kernel_size": 7, "mask": True, "margin": 2.0})]:
        _same(getattr(tfeat, name)(*args, **kw), getattr(jfeat, name)(*args, **kw))


def test_processing_matches():
    x = _wave(7, (3000, 2))
    speech = np.concatenate([np.zeros(3000), _wave(8, (4000,)), np.zeros(2500)]).astype(np.float32)
    for name, args, kw in [
        ("normalize", (x,), {}), ("normalize", (x,), {"norm": "l2", "axis": 1}),
        ("normalize", (x,), {"norm": "mean_std"}), ("normalize", (x,), {"norm": "l0"}),
        ("stereo_to_mono", (x,), {}),
        ("trim", (speech,), {"top_db": 30, "frame_length": 512, "hop_length": 128}),
        ("trim", (np.zeros(2048, np.float32),), {}),
        ("split", (speech,), {"top_db": 30, "frame_length": 512, "hop_length": 128}),
        ("sliding_window_cmn", (_wave(9, (2, 120, 8)),), {"cmn_window": 50, "norm_vars": True}),
        ("sliding_window_cmn", (_wave(9, (120, 8)),), {"center": True}),
        ("invert_channels", (x.copy(),), {}),
        ("loop", (x, 3), {}), ("clip", (x, 0.2, 0.5), {}),
        ("insert_in_background", (x, 0.3, _wave(10, (5000,))), {}),
        ("insert_in_background", (x[:, 0], 0.2, _wave(11, (5000, 2))), {}),
        ("overlap_and_add", (_wave(12, (2, 10, 400)), 160), {}),
    ]:
        _same(getattr(tproc, name)(*args, **kw), getattr(jproc, name)(*args, **kw))


def test_augment_matches():
    spec = np.abs(_wave(13, (3, 40, 50)))

    def rng():
        return np.random.default_rng(14)

    for name, kw in [("frequencymasking", {"frequency_mask_param": 8}),
                     ("frequencymasking", {"frequency_mask_param": 8, "iid_masks": True,
                                           "mask_start": 3, "mask_value": -1.0}),
                     ("timemasking", {"frequency_mask_param": 10})]:
        _same(getattr(taug, name)(spec, rng=rng(), **kw), getattr(jaug, name)(spec, rng=rng(),
                                                                            **kw))
    batch, lens = _wave(15, (4, 3000)), np.array([1.0, 0.8, 0.9, 0.6])
    _same(taug.add_babble(batch, lens, snr_low=0, snr_high=10, rng=rng()),
          jaug.add_babble(batch, lens, snr_low=0, snr_high=10, rng=rng()))
    x = _wave(16, (4000,))
    _same(taug.time_stretch(x, rate=1.25), jaug.time_stretch(x, rate=1.25))
    _same(taug.pitch_shift(x, 16000, 2), jaug.pitch_shift(x, 16000, 2))
    with pytest.raises(ValueError):
        taug.time_stretch(x, rate=0)


def _aishell_tree(root):
    os.makedirs(f"{root}/data_aishell/transcript")
    lines = []
    for split, spk, n in (("train", "S0002", 3), ("dev", "S0724", 2), ("test", "S0764", 1)):
        os.makedirs(f"{root}/data_aishell/wav/{split}/{spk}")
        for i in range(n):
            utt = f"BAC009{spk}W{i:04d}"
            jio.write(f"{root}/data_aishell/wav/{split}/{spk}/{utt}.wav",
                      _wave(i, (1600 * (i + 1),)), 16000)
            if i != 1:  # one utterance without a transcript is skipped
                lines.append(f"{utt} 而 对 楼市 成交 {i}\n")
    with open(f"{root}/data_aishell/transcript/aishell_transcript_v0.8.txt", "w",
              encoding="utf-8") as f:
        f.writelines(lines)


def test_aishell_matches(tmp_path):
    _aishell_tree(tmp_path)
    assert taishell.load_transcripts(str(tmp_path)) == jaishell.load_transcripts(str(tmp_path))
    taishell.prepare_aishell(str(tmp_path), save_folder=str(tmp_path / "port"))
    jaishell.prepare_aishell(str(tmp_path), save_folder=str(tmp_path / "jax"))
    for split in ("train", "dev", "test"):
        port = (tmp_path / "port" / f"{split}.csv").read_bytes()
        assert port == (tmp_path / "jax" / f"{split}.csv").read_bytes()
        assert len(port.splitlines()) > 1
    with pytest.raises(ValueError, match="downloads nothing"):
        taishell.prepare_aishell(str(tmp_path), download=True)
