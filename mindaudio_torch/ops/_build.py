"""Build the CUDA kernels under ``csrc/`` at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` interface and no PyTorch
headers, so ``nvcc`` builds it in seconds into ``csrc/build/lib<name>-<hash>.so``
(the hash covers the source, the shared ``csrc/*.cuh`` headers and the flags,
so an edited source or header rebuilds).
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

__all__ = ["build", "load", "compile_parallel", "hashed_lib_path"]

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


def hashed_lib_path(source, flags, build_dir, name, headers=()):
    """``build_dir/lib<name>-<hash>.so``, the hash over the bytes of the source
    and of ``headers`` and over the flags, so that an edited source or header
    or a changed flag builds anew."""
    digest = hashlib.sha256(Path(source).read_bytes())
    for header in headers:
        digest.update(Path(header).read_bytes())
    digest.update(" ".join(flags).encode())
    return Path(build_dir) / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _lib_path(name):
    return hashed_lib_path(CSRC / f"{name}.cu", NVCC_FLAGS, BUILD_DIR, name,
                           sorted(CSRC.glob("*.cuh")))


def compile_parallel(compiler, flags, jobs):
    """Run ``compiler *flags -o <tmp> <source>`` for every ``name: (source,
    lib)`` of ``jobs``, all at once, and move each output onto ``lib`` with
    ``os.replace`` (a temporary name per process, so that processes building
    the same library at once never load a partial file). Returns ``{name:
    compiler output}``; raises with the output of every build that failed."""
    procs = {}
    for name, (source, lib) in jobs.items():
        Path(lib).parent.mkdir(parents=True, exist_ok=True)
        tmp = Path(lib).with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *flags, "-o", str(tmp), str(source)]
        procs[name] = (tmp, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for name, (tmp, lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {Path(compiler).name} {name} (exit {proc.returncode})\n{out}")
            continue
        os.replace(tmp, lib)
        reports[name] = out
    if failed:
        raise RuntimeError("build failed:\n" + "\n".join(failed))
    return reports


def build(names=None):
    """Compile the named sources (all by default) that are not built yet,
    one ``nvcc`` each, in parallel. Returns ``{name: ptxas report}`` for what
    was compiled; raises with the compiler's output if any build fails."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    return compile_parallel(_nvcc(), NVCC_FLAGS,
                            {n: (CSRC / f"{n}.cu", _lib_path(n)) for n in todo})


def load(name):
    """The ctypes library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = _loaded[name] = ctypes.CDLL(str(_lib_path(name)))
    return lib
