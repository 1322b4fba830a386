"""Process groups over the mesh axes ``(data, model, seq, pipe)`` (port of
``mindaudio_tpu.parallel.mesh``).

The JAX layer is declarative: a ``Mesh`` of devices and sharding annotations
from which GSPMD inserts the collectives. The port runs one process a GPU
(``torchrun --nproc_per_node N``), so every collective is written out
(``parallel/collectives.py``) over the process groups that
:func:`make_mesh` builds: for each set of axes, the ranks that differ only
along those axes. The axis order is JAX's, ``pipe`` innermost: rank
``((d * model + m) * seq + s) * pipe + p`` holds mesh coordinate
``(d, m, s, p)``.

A group of one rank is ``None`` and every collective over it is the
identity, so the same code runs in a single process without
``torch.distributed``. The mesh that :func:`make_mesh` built last is the
active one: :func:`data_denominator` and the batch norms read the ``data``
group from it, as GSPMD takes a batch statistic over the global batch of the
mesh a step runs under.
"""

from __future__ import annotations

import contextlib
import datetime
import itertools
import os

import torch
import torch.distributed as dist

__all__ = [
    "AXES",
    "Mesh",
    "initialize_distributed",
    "make_mesh",
    "init_mesh",
    "active_mesh",
    "set_active_mesh",
    "shard_batch",
    "put_global_batch",
    "batch_sharding",
    "replicated",
    "data_denominator",
    "data_max",
    "batch_stat_group",
    "batch_stat_axes",
    "barrier",
    "get_rank_id",
    "get_device_id",
    "get_device_num",
]

AXES = ("data", "model", "seq", "pipe")
_ACTIVE = None
_STAT_AXES = ("data",)


def _world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def initialize_distributed(backend=None, device="cuda", timeout=None):
    """Join the process group that ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``).

    A no-op for a single process (``WORLD_SIZE`` unset or 1) and when a
    group exists already. ``backend`` defaults to ``nccl`` for CUDA and
    ``gloo`` for the CPU; a failed initialisation raises (as the JAX
    package's does when several processes were asked for). Returns this
    rank's device: ``cuda:LOCAL_RANK`` (made current) or the CPU.
    """
    device = torch.device(device)
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if device.type == "cuda":
        device = torch.device("cuda", local if device.index is None else device.index)
        torch.cuda.set_device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and not dist.is_initialized():
        backend = backend or ("nccl" if device.type == "cuda" else "gloo")
        kwargs = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
        dist.init_process_group(backend, rank=int(os.environ["RANK"]), world_size=world,
                                **kwargs)
    return device


class Mesh:
    """This rank's view of a ``(data, model, seq, pipe)`` mesh of processes.

    ``shape`` maps each axis to its size and ``coords`` to this rank's index
    along it; :meth:`group` is the process group of the ranks that differ
    from this one only along the given axes (``None`` when that is this rank
    alone). ``groups=False`` computes the layout alone, without
    ``torch.distributed``.
    """

    def __init__(self, shape, rank=0, groups=True):
        self.shape = {a: int(shape.get(a, 1)) for a in AXES}
        self.rank = rank
        self.world_size = 1
        for a in AXES:
            self.world_size *= self.shape[a]
        strides, s = {}, 1
        for a in reversed(AXES):
            strides[a], s = s, s * self.shape[a]
        self._strides = strides
        self.coords = {a: (rank // strides[a]) % self.shape[a] for a in AXES}
        self._groups = {}
        if groups and self.world_size > 1:
            self._build_groups()

    def ranks(self, *axes):
        """Global ranks of this rank's group along ``axes``, in axis order
        (the group rank of a member is its index here)."""
        base = self.rank - sum(self.coords[a] * self._strides[a] for a in axes)
        return [base + sum(i * self._strides[a] for a, i in zip(axes, idx))
                for idx in itertools.product(*(range(self.shape[a]) for a in axes))]

    def _build_groups(self):
        # every rank creates every group, in one order (new_group is collective)
        made = {}
        for n in range(1, len(AXES) + 1):
            for axes in itertools.combinations(AXES, n):
                if all(self.shape[a] == 1 for a in axes):
                    continue
                others = [a for a in AXES if a not in axes]
                for fixed in itertools.product(*(range(self.shape[a]) for a in others)):
                    base = sum(i * self._strides[a] for a, i in zip(others, fixed))
                    members = tuple(sorted(
                        base + sum(i * self._strides[a] for a, i in zip(axes, idx))
                        for idx in itertools.product(*(range(self.shape[a]) for a in axes))))
                    if len(members) > 1 and members not in made:
                        made[members] = dist.new_group(list(members))
        for n in range(1, len(AXES) + 1):
            for axes in itertools.combinations(AXES, n):
                members = tuple(sorted(self.ranks(*axes)))
                self._groups[axes] = made.get(members)

    def size(self, *axes):
        out = 1
        for a in axes:
            out *= self.shape[a]
        return out

    def index(self, axis):
        return self.coords[axis]

    def group(self, *axes):
        """The process group along ``axes`` (in any order), or ``None``."""
        return self._groups.get(tuple(a for a in AXES if a in axes))

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords})"


def make_mesh(data=None, model=1, seq=1, pipe=1):
    """Build (and make active) the :class:`Mesh` of this process.

    ``data`` defaults to the ranks left over; the sizes must multiply to the
    world size (1 without ``torch.distributed``).
    """
    global _ACTIVE
    world, rank = _world()
    if data is None:
        data = world // (model * seq * pipe)
    if data * model * seq * pipe != world:
        raise ValueError(f"mesh {data}x{model}x{seq}x{pipe} != {world} processes")
    _ACTIVE = Mesh({"data": data, "model": model, "seq": seq, "pipe": pipe}, rank)
    return _ACTIVE


def init_mesh(device, model=1, seq=1, pipe=1, backend=None):
    """A recipe's start: join ``torchrun``'s group
    (:func:`initialize_distributed`) and build the mesh with ``data`` the
    ranks left over. Returns ``(this rank's device, mesh)``."""
    device = initialize_distributed(backend, device)
    return device, make_mesh(model=model, seq=seq, pipe=pipe)


def active_mesh():
    """The mesh :func:`make_mesh` built last, or ``None``."""
    return _ACTIVE


def set_active_mesh(mesh):
    """Make ``mesh`` (or ``None``) the active mesh; returns the previous."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, mesh
    return prev


def batch_sharding(mesh=None):
    """``(data index, data size)``: the rows ``[index * local, (index + 1) *
    local)`` of a global batch are this rank's (the ``P("data")`` spec)."""
    mesh = mesh or _ACTIVE
    return (0, 1) if mesh is None else (mesh.index("data"), mesh.size("data"))


def replicated(mesh=None):
    """The spec of a tensor every rank holds whole: ``(0, 1)``."""
    return (0, 1)


def _to(x, device):
    x = torch.as_tensor(x)
    return x.to(device, non_blocking=True) if device is not None else x


def put_global_batch(sharding, batch, device=None):
    """This rank's rows of the global batch, already collated by the rank's
    iterator, moved to ``device``. The recipes' iterators yield the same batch
    sequence on every rank and collate only rows ``[rank * local:(rank + 1) *
    local]``, so the local batch is this rank's shard of the global one."""
    return {k: _to(v, device) for k, v in batch.items()}


def shard_batch(mesh, batch, device=None):
    """Cut this rank's rows (its ``data`` index) out of a whole global batch
    (a dict of arrays or tensors with the batch first) and move them to
    ``device``. Raises when the batch does not split evenly."""
    index, size = batch_sharding(mesh)
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(v)
        if v.shape[0] % size:
            raise ValueError(f"shard_batch: {k} has {v.shape[0]} rows, not a multiple of "
                             f"the data axis {size}")
        local = v.shape[0] // size
        out[k] = _to(v[index * local:(index + 1) * local], device)
    return out


def data_denominator(count, minimum=1):
    """The denominator that makes a rank's ``local sum / denominator`` average
    over the ``data`` group to the global batch's ``sum / max(count,
    minimum)``: ``max(sum of count over the group, minimum) / group size``.
    A loss normalised by a count (tokens, valid frames) that differs between
    ranks divides by this, as the JAX loss on the global batch divides by
    the global count. Without an active data group, ``max(count, minimum)``.
    """
    mesh = _ACTIVE
    group = None if mesh is None else mesh.group("data")
    if group is None:
        return torch.clamp_min(count, minimum)
    from .collectives import all_reduce

    total = all_reduce(count.detach().to(torch.float32), group)
    return torch.clamp_min(total, minimum) / mesh.size("data")


def data_max(x):
    """``x``'s elementwise maximum over the active mesh's ``data`` group (no
    gradient through the other ranks' values), or ``x``."""
    group = None if _ACTIVE is None else _ACTIVE.group("data")
    if group is None:
        return x
    from .collectives import all_reduce

    peak = all_reduce(x, group, dist.ReduceOp.MAX)
    return x + (peak - x).detach()


def batch_stat_group():
    """The group a batch norm takes its training statistics over: the
    active mesh's ``data`` group (and ``seq`` inside a sequence-parallel
    encoder, :func:`batch_stat_axes`), or ``None``."""
    return None if _ACTIVE is None else _ACTIVE.group(*_STAT_AXES)


@contextlib.contextmanager
def batch_stat_axes(*axes):
    """Within the block, batch statistics are taken over ``axes``."""
    global _STAT_AXES
    prev, _STAT_AXES = _STAT_AXES, axes
    try:
        yield
    finally:
        _STAT_AXES = prev


def barrier(name="sync"):
    """Wait for every process (a no-op without ``torch.distributed``)."""
    if _world()[0] > 1:
        dist.barrier()


def get_rank_id():
    return _world()[1]


def get_device_id():
    return int(os.environ.get("LOCAL_RANK", "0"))


def get_device_num():
    return _world()[0]
