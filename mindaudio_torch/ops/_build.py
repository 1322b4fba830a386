"""Build the CUDA kernels under ``csrc/`` at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` interface and no PyTorch
headers, so ``nvcc`` builds it in seconds into ``csrc/build/lib<name>-<hash>.so``
(the hash covers the source and the flags, so an edited source rebuilds).
:func:`build` starts one ``nvcc`` per source, all at once, and waits for all
of them. Nothing here runs at import: the CPU tests import every module.
``nvcc`` is the one of the CUDA toolkit PyTorch finds (``$CUDA_HOME``,
``$PATH``, then ``/usr/local/cuda``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

__all__ = ["build", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict = {}


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _lib_path(name):
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names=None):
    """Compile the named sources (all by default) that are not built yet,
    one ``nvcc`` each, in parallel. Returns ``{name: ptxas report}`` for what
    was compiled; raises with the compiler's output if any build fails."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = _lib_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode})\n{out}")
            continue
        os.replace(tmp, _lib_path(name))
        reports[name] = out
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name):
    """The ctypes library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = _loaded[name] = ctypes.CDLL(str(_lib_path(name)))
    return lib
