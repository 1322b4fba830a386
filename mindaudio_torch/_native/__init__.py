"""Native (C++) host components, built with ``g++`` at first use and loaded
with ``ctypes`` (port of ``mindaudio_tpu._native``).

- ``ctc_beam.cc``: the CTC prefix-beam dynamic program over per-frame top-k
  posteriors, one thread per utterance (:func:`ctc_prefix_beam_batch`);
- ``wav_loader.cc``: a thread pool that decodes WAV files into one padded
  float32 batch (:func:`wav_read_batch`).

``wav_loader.cc`` is a copy of the JAX package's. ``ctc_beam.cc`` has the
JAX package's C interface and algorithm, and the Python DP's arithmetic and
tie order, so that the two agree on every input, ties included; the JAX
package's sort is not stable and may keep another of two tied prefixes.
``tests/test_torch_native.py`` pins both. Each builds with ``g++ -O3 -fPIC -shared
-std=c++17 -pthread`` into ``build/lib<name>-<hash>.so`` (the hash covers
the source and the flags). Nothing is built at import. A failed build or
load raises: there is no Python fallback here (the Python DP,
``utils.recognize.ctc_prefix_beam_dp``, is the plain version the tests hold
this one against).
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path

import numpy as np

from ..ops._build import compile_parallel, hashed_lib_path

__all__ = ["build", "ctc_prefix_beam_batch", "wav_read_batch"]

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR / "build"
SOURCES = ("ctc_beam", "wav_loader")
CXX = "g++"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-pthread"]

_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    "ctc_beam": ("ctc_prefix_beam_batch", ctypes.c_int32,
                 [_F32P, _I32P, _I32P] + [ctypes.c_int32] * 6 + [_I32P, _I32P, _F32P, _I32P]),
    "wav_loader": ("wav_read_batch", None,
                   [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, _F32P, ctypes.c_int64,
                    _I32P, _I32P, ctypes.c_int32]),
}

_loaded: dict = {}


def _lib_path(name):
    return hashed_lib_path(SRC_DIR / f"{name}.cc", CXX_FLAGS, BUILD_DIR, name)


def build(names=SOURCES):
    """Compile the named sources that are not built yet, one ``g++`` each, in
    parallel. Returns ``{name: compiler output}`` for what was compiled;
    raises with the compiler's output if a build fails."""
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    return compile_parallel(CXX, CXX_FLAGS,
                            {n: (SRC_DIR / f"{n}.cc", _lib_path(n)) for n in todo})


def _load(name):
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        symbol, restype, argtypes = _SIGNATURES[name]
        fn = getattr(lib, symbol)
        fn.argtypes, fn.restype = argtypes, restype
        _loaded[name] = lib
    return lib


def ctc_prefix_beam_batch(top_logp, top_idx, n_valid, beam_size, blank_id=0, max_len=None):
    """Batched CTC prefix beam search (``ctc_beam.cc``).

    Args:
        top_logp: ``(B, T, K)`` per-frame top-k log-probs (cast to float32).
        top_idx: ``(B, T, K)`` their token ids.
        n_valid: ``(B,)`` valid frame counts.
        max_len: longest prefix returned (``T`` by default); longer ones are
            cut to it.

    Returns:
        over the batch, each utterance's best-first ``[(prefix_tuple,
        log_prob), ...]`` (at most ``beam_size``), the contract of
        ``utils.recognize.ctc_prefix_beam_dp``, whose float64 scores and
        prefixes it reproduces, ties included; scores are returned rounded
        to float32.
    """
    lib = _load("ctc_beam")
    top_logp = np.ascontiguousarray(top_logp, np.float32)
    top_idx = np.ascontiguousarray(top_idx, np.int32)
    n_valid = np.ascontiguousarray(n_valid, np.int32)
    b, t, k = top_logp.shape
    if top_idx.shape != (b, t, k) or n_valid.shape != (b,):
        raise ValueError(f"ctc_prefix_beam_batch: top_logp {top_logp.shape}, top_idx "
                         f"{top_idx.shape} and n_valid {n_valid.shape} do not agree")
    max_len = max(int(t if max_len is None else max_len), 1)
    tokens = np.zeros((b, beam_size, max_len), np.int32)
    lens = np.zeros((b, beam_size), np.int32)
    scores = np.zeros((b, beam_size), np.float32)
    counts = np.zeros((b,), np.int32)
    rc = lib.ctc_prefix_beam_batch(
        top_logp.ctypes.data_as(_F32P), top_idx.ctypes.data_as(_I32P),
        n_valid.ctypes.data_as(_I32P), b, t, k, beam_size, blank_id, max_len,
        tokens.ctypes.data_as(_I32P), lens.ctypes.data_as(_I32P),
        scores.ctypes.data_as(_F32P), counts.ctypes.data_as(_I32P))
    if rc != 0:
        raise RuntimeError(f"ctc_prefix_beam_batch: refused B={b} T={t} K={k} "
                           f"beam={beam_size} max_len={max_len} (rc={rc})")
    return [[(tuple(tokens[i, j, : lens[i, j]].tolist()), float(scores[i, j]))
             for j in range(int(counts[i]))] for i in range(b)]


def wav_read_batch(paths, max_len, n_threads=0):
    """Decode ``paths`` in parallel (``wav_loader.cc``) into one batch.

    Returns ``(batch (N, max_len) float32, lens (N,) int32, rates (N,)
    int32)``: the first channel of each file, integer PCM normalized to
    [-1, 1) and float as it is, cut to ``max_len`` and zero-padded. A rate
    of 0 marks a file that failed to decode.
    """
    lib = _load("wav_loader")
    n = len(paths)
    out = np.empty((n, max_len), np.float32)  # every row is written or zeroed
    lens = np.zeros(n, np.int32)
    rates = np.zeros(n, np.int32)
    names = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    lib.wav_read_batch(names, n, out.ctypes.data_as(_F32P), max_len,
                       lens.ctypes.data_as(_I32P), rates.ctypes.data_as(_I32P), n_threads)
    return out, lens, rates
