"""Logging for the recipes (port of ``mindaudio_tpu.train.log``).

A rotating file per process and standard output on rank 0. The rank is
``torch.distributed``'s when a process group is initialised, 0 otherwise.
"""

from __future__ import annotations

import logging
import os
from logging.handlers import RotatingFileHandler

import torch

__all__ = ["get_logger", "print_log", "process_rank"]

_LOGGERS = {}


def process_rank():
    """This process's rank: ``torch.distributed``'s, or 0 without a group."""
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def get_logger(name="mindaudio_torch", log_dir=None, rank=None, stdout_ranks=(0,)):
    """A logger writing to ``<log_dir>/<name>.log`` (rotating) and, on the
    ranks in ``stdout_ranks``, to standard output.

    Cached per name: a call with the same settings, or with all defaults
    after an explicit configuration, returns the cached logger; other
    explicit settings reconfigure its handlers. ``log_dir`` defaults to
    ``~/.cache/mindaudio_torch/device_<rank>``.
    """
    cfg_key = (name, log_dir, rank, tuple(stdout_ranks))
    cached = _LOGGERS.get(name)
    all_defaults = log_dir is None and rank is None and tuple(stdout_ranks) == (0,)
    if cached is not None and (cached[0] == cfg_key or all_defaults):
        return cached[1]

    if rank is None:
        rank = process_rank()

    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    for h in list(logger.handlers):  # reconfiguring: drop previous handlers
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter(f"%(asctime)s [rank {rank}] %(levelname)s %(name)s: %(message)s")

    if log_dir is None:
        log_dir = os.path.join(os.path.expanduser("~"), ".cache", "mindaudio_torch",
                               f"device_{rank}")
    os.makedirs(log_dir, exist_ok=True)
    fh = RotatingFileHandler(os.path.join(log_dir, f"{name}.log"), maxBytes=50 * 2**20,
                             backupCount=5)
    fh.setFormatter(fmt)
    logger.addHandler(fh)

    if rank in stdout_ranks:
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)

    _LOGGERS[name] = (cfg_key, logger)
    return logger


def print_log(msg, logger=None, level=logging.INFO):
    """Log ``msg`` at ``level`` through ``logger`` (the default logger when none)."""
    (logger or get_logger()).log(level, msg)
