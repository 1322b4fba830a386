"""Run a function of the port on several ``torch.distributed`` processes
(gloo, on the CPU) for the ``test_torch_parallel_*`` tests.

:func:`run_ranks` starts ``world`` Python processes, each of which joins one
gloo group through ``parallel.mesh.initialize_distributed`` (the
``torchrun`` environment variables, a free ``localhost`` port, a collective
timeout), calls ``module.function(*args)`` and saves what it returns with
``torch.save``; the parent waits at most ``timeout`` seconds, kills every
process that is left, and returns the ranks' results in rank order. A hung
collective therefore fails one test.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile

import torch

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(world, module, function, args=(), timeout=180, collective_timeout=60):
    """``[result of rank 0, ..., rank world-1]`` of ``module.function(*args)``.
    A group whose port another process took between the probe and the bind
    (the tests run in parallel) is started once more on another port."""
    try:
        return _run_ranks(world, module, function, args, timeout, collective_timeout)
    except _PortTaken:
        return _run_ranks(world, module, function, args, timeout, collective_timeout)


class _PortTaken(AssertionError):
    pass


def _run_ranks(world, module, function, args, timeout, collective_timeout):
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(tuple(args), os.path.join(tmp, "args.pt"))
        port = _free_port()
        procs, logs = [], []
        for rank in range(world):
            env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                       MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                       PYTHONPATH=os.pathsep.join([REPO, TESTS, os.environ.get("PYTHONPATH", "")]))
            log = open(os.path.join(tmp, f"log{rank}.txt"), "w+")
            code = ("import sys, torch_dist; "
                    f"torch_dist._child({module!r}, {function!r}, {tmp!r}, {collective_timeout})")
            procs.append(subprocess.Popen([sys.executable, "-c", code], env=env, stdout=log,
                                          stderr=subprocess.STDOUT, cwd=tmp))
            logs.append(log)
        failed = None
        try:
            for rank, p in enumerate(procs):
                try:
                    p.wait(timeout=timeout)
                except subprocess.TimeoutExpired:
                    failed = f"rank {rank} did not finish within {timeout} s"
                    break
                if p.returncode != 0:
                    failed = f"rank {rank} exited with {p.returncode}"
                    break
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if failed:
            tails = []
            for rank, log in enumerate(logs):
                log.seek(0)
                tails.append(f"--- rank {rank} ---\n" + log.read()[-3000:])
            text = "\n".join(tails)
            if "EADDRINUSE" in text or "address already in use" in text.lower():
                raise _PortTaken(failed + "\n" + text)
            raise AssertionError(failed + "\n" + text)
        for log in logs:
            log.close()
        return [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False)
                for r in range(world)]


def _child(module, function, tmp, collective_timeout):
    import importlib

    torch.set_num_threads(1)
    from mindaudio_torch.parallel import mesh

    mesh.initialize_distributed(backend="gloo", device="cpu", timeout=collective_timeout)
    args = torch.load(os.path.join(tmp, "args.pt"), weights_only=False)
    out = getattr(importlib.import_module(module), function)(*args)
    torch.save(out, os.path.join(tmp, f"out{os.environ['RANK']}.pt"))
    import torch.distributed as dist

    if dist.is_initialized():  # a world of one process has no group
        dist.barrier()
        dist.destroy_process_group()
