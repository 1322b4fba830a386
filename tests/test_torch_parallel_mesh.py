"""The mesh and the collectives of ``mindaudio_torch.parallel`` on gloo
groups of 2 and 4 processes on the CPU (``torch_dist.run_ranks``).

Each differentiable collective is held, forward and backward, against its
definition computed here in float64 from every rank's inputs: the loss is
one value, a rank holding a replicated tensor holds its whole gradient, a
rank holding a shard the gradient of its shard (exact: float64 sums of a few
terms, tolerance 1e-12). The mesh's rank layout is JAX's ``(data, model,
seq, pipe)`` with ``pipe`` innermost.
"""

import numpy as np
import pytest
import torch

from mindaudio_torch.parallel.mesh import Mesh, data_denominator, make_mesh, shard_batch
from torch_dist import run_ranks

NAMES = ("all_reduce_sum", "reduce_from", "copy_to", "all_gather_slice", "all_gather_sum",
         "scatter", "all_to_all", "permute_ring", "permute_chain", "broadcast",
         "broadcast_grad")


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request):
    n = request.param
    return n, run_ranks(n, "torch_parallel_cases", "collectives_case", (0,))


def _expected(name, xs, ws, r, n):
    x = xs.numpy()
    w = ws.numpy()
    c = 4 // n
    if name == "all_reduce_sum":
        return x.sum(0), w[:, :4, :6].sum(0)
    if name == "reduce_from":
        return x.sum(0), w[r, :4, :6]
    if name == "copy_to":
        return x[r], w[:, :4, :6].sum(0)
    if name in ("all_gather_slice", "all_gather_sum"):
        y = np.concatenate(list(x), axis=1)
        g = w[r, :4, :6 * n] if name == "all_gather_slice" else w[:, :4, :6 * n].sum(0)
        return y, g[:, r * 6:(r + 1) * 6]
    if name == "scatter":
        return x[0][r * c:(r + 1) * c], np.concatenate([w[j, :c, :6] for j in range(n)], 0)
    if name == "all_to_all":
        y = np.concatenate([x[i][r * c:(r + 1) * c] for i in range(n)], axis=1)
        g = np.concatenate([w[j, :c, r * 6:(r + 1) * 6] for j in range(n)], axis=0)
        return y, g
    if name == "permute_ring":
        return x[(r - 1) % n], w[(r + 1) % n, :4, :6]
    if name == "permute_chain":
        y = x[r - 1] if r > 0 else np.zeros_like(x[0])
        g = w[r + 1, :4, :6] if r < n - 1 else np.zeros_like(x[0])
        return y, g
    if name == "broadcast":
        return x[n - 1], w[r, :4, :6] if r == n - 1 else np.zeros_like(x[0])
    if name == "broadcast_grad":
        return x[r], w[0, :4, :6]
    raise KeyError(name)


@pytest.mark.parametrize("name", NAMES)
def test_collective_forward_and_backward(ranks, name):
    n, outs = ranks
    for r, out in enumerate(outs):
        y, g = out[name]
        want_y, want_g = _expected(name, out["inputs"], out["weights"], r, n)
        np.testing.assert_allclose(y.numpy(), want_y, rtol=0, atol=1e-12, err_msg=f"{name} y r{r}")
        np.testing.assert_allclose(g.numpy(), want_g, rtol=0, atol=1e-12, err_msg=f"{name} g r{r}")


@pytest.mark.parametrize("shape", [dict(data=2, model=2), dict(data=1, model=2, pipe=2),
                                   dict(data=2, seq=2)])
def test_mesh_groups_on_four_ranks(shape):
    outs = run_ranks(4, "torch_parallel_cases", "mesh_case", (shape,))
    full = {a: shape.get(a, 1) for a in ("data", "model", "seq", "pipe")}
    for rank, (coords, groups) in enumerate(outs):
        assert coords == Mesh(full, rank, groups=False).coords
        for axes, members in groups.items():
            want = sorted(Mesh(full, rank, groups=False).ranks(*axes))
            assert members == (want if len(want) > 1 else None), (rank, axes)


@pytest.mark.parametrize("rank,coords", [
    (0, dict(data=0, model=0, seq=0, pipe=0)), (1, dict(data=0, model=0, seq=0, pipe=1)),
    (2, dict(data=0, model=1, seq=0, pipe=0)), (5, dict(data=1, model=0, seq=0, pipe=1)),
    (7, dict(data=1, model=1, seq=0, pipe=1))])
def test_rank_layout_is_jax_axis_order(rank, coords):
    """``make_mesh``'s device array reshapes ``(data, model, seq, pipe)``
    with ``pipe`` innermost: rank ``((d * M + m) * S + s) * P + p``."""
    mesh = Mesh({"data": 2, "model": 2, "pipe": 2}, rank, groups=False)
    assert mesh.coords == coords
    assert mesh.world_size == 8
    assert sorted(mesh.ranks("pipe")) == [rank - coords["pipe"], rank - coords["pipe"] + 1]


def test_single_process_mesh_is_the_identity():
    mesh = make_mesh()
    assert mesh.world_size == 1 and mesh.group("data") is None
    batch = {"x": np.arange(6).reshape(3, 2)}
    np.testing.assert_array_equal(shard_batch(mesh, batch)["x"].numpy(), batch["x"])
    assert float(data_denominator(torch.tensor(0.0))) == 1.0
    assert float(data_denominator(torch.tensor(7.0))) == 7.0
    with pytest.raises(ValueError):
        make_mesh(data=2)


def test_shard_batch_rows():
    """Rank ``d`` of the data axis takes rows ``[d * local, (d + 1) * local)``."""
    batch = {"x": np.arange(12).reshape(6, 2), "n": np.arange(6)}
    parts = [shard_batch(Mesh({"data": 3}, r, groups=False), batch) for r in range(3)]
    for key in batch:
        np.testing.assert_array_equal(np.concatenate([p[key].numpy() for p in parts]),
                                      batch[key])
    with pytest.raises(ValueError):
        shard_batch(Mesh({"data": 4}, 0, groups=False), batch)
