"""Checkpoints: save, restore, average, retain (port of
``mindaudio_tpu.train.checkpoint``).

A checkpoint is a nested dict of tensors (the Conformer recipe's: ``params``,
``opt_state`` with ``count``/``mu``/``nu``, ``step``, ``rng``; DeepSpeech2's
adds the batch norms' running statistics, :func:`model_state`)
written with ``torch.save`` as ``<directory>/step_<n>/state.pt``, the JAX
package's directory layout. A save writes into ``step_<n>.tmp-<pid>`` and
renames it, so a save that is killed leaves no ``step_*`` directory behind;
restores load with ``weights_only=True``. Retention and the eval scores
(``eval_scores.json``) follow the JAX package.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Sequence

import torch

from .log import process_rank

__all__ = [
    "model_state",
    "load_model_state",
    "save_checkpoint",
    "restore_checkpoint",
    "average_checkpoints",
    "list_steps",
    "load_scores",
    "CheckpointManager",
]

_STEP_DIR = re.compile(r"^step_(\d+)$")
STATE_FILE = "state.pt"


def list_steps(directory):
    """Steps of the committed checkpoints under ``directory``, ascending
    (the temporary directories of saves in flight do not match)."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP_DIR.match, os.listdir(directory)) if m)


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def model_state(model):
    """``{"params": {name: parameter}, "buffers": {name: buffer}}`` of
    ``model``: its parameters and persistent buffers (a batch norm's running
    statistics, flax's ``batch_stats``), by their names."""
    params = dict(model.named_parameters())
    state = model.state_dict(keep_vars=True)
    return {"params": params, "buffers": {k: v for k, v in state.items() if k not in params}}


@torch.no_grad()
def load_model_state(model, state):
    """Copy a :func:`model_state` (as saved, on any device) into ``model``;
    the names must be the model's."""
    mine = model_state(model)
    for key in ("params", "buffers"):
        if set(mine[key]) != set(state[key]):
            raise KeyError(f"checkpoint {key} differ from the model's: "
                           f"{sorted(set(mine[key]) ^ set(state[key]))[:8]}")
        for name, t in mine[key].items():
            t.copy_(state[key][name])


def save_checkpoint(directory, state, step):
    """Write ``state`` (a nested dict of tensors) as ``directory/step_<step>``,
    replacing a checkpoint of that step. Tensors are copied to the host."""
    directory = os.path.abspath(directory)
    path = os.path.join(directory, f"step_{step}")
    tmp = f"{path}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    host = _map(lambda t: t.detach().to("cpu") if torch.is_tensor(t) else t, state)
    torch.save(host, os.path.join(tmp, STATE_FILE))
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    return path


def restore_checkpoint(directory, step=None):
    """The state saved at ``step`` (the latest when None), on the host."""
    directory = os.path.abspath(directory)
    if step is None:
        steps = list_steps(directory)
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {directory}")
        step = steps[-1]
    return torch.load(os.path.join(directory, f"step_{step}", STATE_FILE), map_location="cpu",
                      weights_only=True)


def average_checkpoints(directory, steps: Sequence[int]):
    """Average the checkpoints of ``steps``: floating leaves (bf16 too) are
    summed in float64 and cast back to their dtype; integer and bool leaves
    (``step``, AdamW's ``count``, a generator's state) are taken from the
    last of ``steps``, so the result has the structure and dtypes of one."""
    if not steps:
        raise ValueError("average_checkpoints: need at least one step")
    acc = None
    for s in steps:
        ckpt = restore_checkpoint(directory, step=s)
        if acc is None:
            dtypes = _map(lambda x: x.dtype, ckpt)
            acc = _map(lambda x: x.double() if x.is_floating_point() else x, ckpt)
        else:
            acc = _map(lambda a, x: a + x.double() if x.is_floating_point() else x, acc, ckpt)
    n = float(len(steps))
    return _map(lambda a, dt: (a / n).to(dt) if dt.is_floating_point else a, acc, dtypes)


def load_scores(directory):
    """``{step: eval metric}`` recorded by a :class:`CheckpointManager`."""
    path = os.path.join(os.path.abspath(directory), "eval_scores.json")
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        return {int(k): float(v) for k, v in json.load(f).items()}


class CheckpointManager:
    """Saves with ``keep_max`` retention and best-by-metric tracking.

    The ``keep_best`` best-scored steps (default ``keep_max``) are never
    pruned, so "average the N best" finds its inputs on disk; a pruned step
    drops its score. Scores persist in ``eval_scores.json`` and are read back
    by a new manager on the same directory. Only rank 0 writes.
    """

    def __init__(self, directory, keep_max=30, keep_best=None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep_max = keep_max
        self.keep_best = keep_max if keep_best is None else keep_best
        self.scores = load_scores(self.directory)

    def save(self, state, step, eval_metric=None):
        if process_rank() != 0:
            return
        save_checkpoint(self.directory, state, step)
        if eval_metric is not None:
            self.scores[step] = float(eval_metric)
            self._write_scores()
        self._prune()

    def _write_scores(self):
        path = os.path.join(self.directory, "eval_scores.json")
        with open(path + ".tmp", "w", encoding="utf-8") as f:
            json.dump({str(k): v for k, v in self.scores.items()}, f)
        os.replace(path + ".tmp", path)

    def _prune(self):
        steps = list_steps(self.directory)
        if len(steps) <= self.keep_max:
            return
        protected = set(steps[-self.keep_max:]) | set(self.best_steps(self.keep_best))
        pruned = False
        for s in steps:
            if s not in protected:
                shutil.rmtree(os.path.join(self.directory, f"step_{s}"), ignore_errors=True)
                pruned = self.scores.pop(s, None) is not None or pruned
        if pruned:
            self._write_scores()

    def best_steps(self, n):
        """The ``n`` steps of lowest eval metric (to pass to
        :func:`average_checkpoints`)."""
        ranked = sorted(self.scores.items(), key=lambda kv: kv[1])
        return [s for s, _ in ranked[:n]]
