"""The CTC kernels' host side and layout, on the CPU.

``kernel_plan`` (path, states a lane, threads, chunk, shared memory and
its refusals) is pinned at the widths where the kernels change shape. The
kernels' arithmetic cannot run here, so a numpy emulation walks the
recursion as ``csrc/ctc_dp.cu`` lays it out: on the one-warp path each row
is a ``(32, K)`` lane-by-register block (state ``s = lane + 32*j``) whose
``s-1``/``s-2`` (backward ``s+1``/``s+2``) neighbours come by a rotation
along the lanes, with the edge lanes taking register ``j-1`` (``j+1``)
explicitly; on the band path a ``(W, 32, K)`` block, band ``w`` holding
states ``w*BAND + lane + 32*j``, whose lanes at the band's edge take the
neighbouring band's two edge states of the step before from its edge ring
(two ``(value, step)`` words a step, read only where the step matches); on
the block path a flat row with two pads. Log-probs (and alphas) are read
from a ring of ``STAGES`` slots filled a chunk of frames ahead (block path:
one frame, a register a step ahead; band path: each band's own columns of
the frame, nothing staged), forward and, backward, walking the chunks from
the last valid frame down. The band path is emulated for every row at once,
its bands stepping together; the edge rings' waits are emulated apart, in
random interleavings of the warps. The emulation is held against
``ctc_dp_reference`` (itself held against the JAX package by
``tests/test_torch_loss.py``) in value and in gradient, at the shapes of
the card tests (``tests/test_torch_kernels.py``) with a small vocabulary.

Tolerance: float32 on both sides, as on the card: 16 ulps of the largest
loss for a value, 1.5 times that (the largest cotangent) for a gradient.
"""

import numpy as np
import pytest
import torch

from mindaudio_torch.ops import ctc_dp
from test_torch_kernels import CTC_CASES

torch.set_num_threads(1)

F32 = np.float32
LOG_EPS = F32(ctc_dp.LOG_EPS)
NEG_INF = F32(-np.inf)
LANES = 32
# the band path's layout, as csrc/ctc_band.cuh fixes it: states a lane, steps
# between two waits for a neighbour's edges, steps an edge ring holds
BAND_K, GROUP, EDGE_RING = 2, 4, 64


@pytest.mark.parametrize("s,path,k,threads", [
    (1, "warp", 1, 32), (3, "warp", 1, 32), (41, "warp", 2, 32), (61, "warp", 2, 32),
    (63, "warp", 2, 32), (65, "warp", 3, 32), (255, "warp", 8, 32),
    (257, "band", 0, 160), (319, "band", 0, 160), (321, "band", 0, 192), (701, "band", 0, 352),
    (767, "band", 0, 384), (769, "band", 0, 416), (1023, "band", 0, 512),
    (1025, "block", 0, 1024), (1201, "block", 0, 1024), (12001, "block", 0, 1024),
])
def test_kernel_plan_at_the_edges(s, path, k, threads):
    plan = ctc_dp.kernel_plan(32, 256, s)
    assert (plan.path, plan.k, plan.threads) == (path, k, threads)
    if path == "warp":  # a ring of chunks of log-probs; backward also alphas, and a word a lane
        ring = ctc_dp.STAGES * ctc_dp.CHUNK * s * 4
        assert (plan.chunk, plan.fwd_smem, plan.bwd_smem) == (ctc_dp.CHUNK, ring,
                                                               2 * ring + 32 * 4)
    elif path == "band":  # 64 states a warp; the launcher lays out the rest
        assert threads // 32 == -(-s // 64)
        assert (plan.chunk, plan.fwd_smem, plan.bwd_smem) == (0, 0, 0)
    else:  # the skip mask and two padded rows; the next frame a step ahead
        assert (plan.chunk, plan.fwd_smem, plan.bwd_smem) == (1, (3 * s + 4) * 4,
                                                               (3 * s + 4) * 4)
        assert plan == ctc_dp.block_plan(s)
    assert plan.bwd_smem <= ctc_dp.SMEM_LIMIT


@pytest.mark.parametrize("t", [1, 3, 4, 45, 626, 1001])
def test_kernel_plan_band_path_does_not_follow_t(t):
    """The band path stages nothing: its plan is the same at every T, T
    shorter than a group included."""
    assert ctc_dp.kernel_plan(64, t, 701) == ctc_dp.Plan("band", 0, 352, 0, 0, 0)


def test_kernel_plan_follows_t():
    assert ctc_dp.kernel_plan(5, 13, 41).chunk == 13  # T shorter than a chunk
    assert ctc_dp.kernel_plan(5, 45, 41).chunk == 32
    assert ctc_dp.kernel_plan(5, 45, 41).fwd_smem == 2 * 32 * 41 * 4
    assert ctc_dp.kernel_plan(0, 45, 41) == ctc_dp.kernel_plan(7, 45, 41)  # B plays no part
    # the widest row whose skip mask and two rows fit in 227 KB
    assert ctc_dp.kernel_plan(3, 9, 19369).bwd_smem <= ctc_dp.SMEM_LIMIT


@pytest.mark.parametrize("b,t,s", [
    (2, 9, 40),  # S = 2L+1 is odd
    (2, 0, 41),
    (2, 9, 0),
    (-1, 9, 41),
    (2, 9, 19371),  # the skip mask and two rows exceed 227 KB
])
def test_kernel_plan_refuses_what_the_kernels_do_not_take(b, t, s):
    with pytest.raises(ValueError):
        ctc_dp.kernel_plan(b, t, s)


# ---------------------------------------------------------------- emulation


def _lse3(a, b, c):
    m = np.maximum(np.maximum(a, b), c)
    return m + np.log(np.exp(a - m) + np.exp(b - m) + np.exp(c - m))


def _lse3_excl(a, b, c):
    """The backward's ``lse3``: the max taken out as at least ``-FLT_MAX``,
    so three minus infinities give minus infinity, not NaN; equal to
    :func:`_lse3` wherever one argument is finite."""
    m = np.maximum(np.maximum(a, b), c)
    mm = np.maximum(m, F32(np.finfo(F32).min))
    with np.errstate(divide="ignore"):
        return m + np.log(np.exp(a - mm) + np.exp(b - mm) + np.exp(c - mm))


def _chunk(c, length, chunk, reverse):
    """Frames ``[start, start + n)`` of chunk ``c``, as ``chunk_start`` and
    ``chunk_frames`` walk them."""
    start = max(length - (c + 1) * chunk, 0) if reverse else c * chunk
    end = length - c * chunk if reverse else min(length, (c + 1) * chunk)
    return start, end - start


class _Layout:
    """A row of ``s`` states as the kernel holds it: ``(32, K)`` registers on
    the one-warp path, ``(W, 32, K)`` on the band path (band ``w`` holding
    states ``w*BAND + lane + 32*j``), a flat row on the block path. The band
    layout takes leading axes (rows)."""

    def __init__(self, s, plan):
        self.s, self.path = s, plan.path
        lane = np.arange(LANES)
        if self.path == "warp":
            self.state = lane[:, None] + LANES * np.arange(plan.k)[None, :]
        elif self.path == "band":
            self.warps = plan.threads // LANES
            base = ctc_dp.BAND * np.arange(self.warps)
            self.state = (base[:, None, None] + lane[None, :, None]
                          + LANES * np.arange(BAND_K)[None, None, :])
        else:
            self.state = np.arange(s)
        self.valid = self.state < s
        # gather index, clamped in the padding (the band kernels read column
        # min(lane + 32*j, width - 1) of their own band: the same states)
        self.at = np.minimum(self.state, s - 1)

    def gather(self, row):
        """``(..., s)`` values in the layout; padding states read the last one."""
        return row[..., self.at]

    def flat(self, x):
        """The layout's values back in state order, ``(..., s)``."""
        if self.path == "band":
            return np.swapaxes(x, -1, -2).reshape(*x.shape[:-3], -1)[..., : self.s]
        if self.path == "warp":
            return x.T.reshape(-1)[: self.s]
        return x

    def from_below(self, x, d, edge=None):
        """``out[s] = x[s-d]`` (``-1e5`` below state 0); on the band path the
        ``d`` states below a band are ``edge (..., W, 2)``: the band below's
        top and top-1 as its edge ring carried them."""
        if self.path == "block":
            return np.concatenate([np.full(d, LOG_EPS, F32), x[:-d]]) if d < x.size else \
                np.full_like(x, LOG_EPS)
        r = np.roll(x, d, axis=-2)  # __shfl_sync from lane - d: lanes < d wrap to lane 32 - d
        out = r.copy()
        out[..., :d, 1:] = r[..., :d, :-1]  # ... and take register j-1 there
        if self.path == "warp":
            out[:d, 0] = LOG_EPS
        elif d == 1:  # lane 0 of register 0: s-1 is the band below's top
            out[..., 0, 0] = edge[..., 0]
        else:  # lane 0: s-2 is the band below's top-1; lane 1: its top
            out[..., 0, 0], out[..., 1, 0] = edge[..., 1], edge[..., 0]
        return out

    def from_above(self, x, d, pad=NEG_INF, edge=None):
        """``out[s] = x[s+d]`` (``pad`` beyond S: no state is there); on the
        band path the ``d`` states above a band are ``edge (..., W, 2)``: the
        band above's bottom and bottom+1 as its edge ring carried them."""
        if self.path == "block":
            return np.concatenate([x[d:], np.full(d, pad, F32)]) if d < x.size else \
                np.full_like(x, pad)
        r = np.roll(x, -d, axis=-2)  # from lane + d: lanes >= 32 - d wrap to lane d - 1
        out = r.copy()
        out[..., LANES - d:, :-1] = r[..., LANES - d:, 1:]  # ... and take register j+1 there
        if self.path == "warp":
            out[LANES - d:, -1] = pad
        elif d == 1:  # lane 31 of register K-1: s+1 is the band above's bottom
            out[..., 31, -1] = edge[..., 0]
        else:  # lane 31: s+2 is the band above's bottom+1; lane 30: its bottom
            out[..., 31, -1], out[..., 30, -1] = edge[..., 1], edge[..., 0]
        return out


class _EdgeRing:
    """The band kernels' edge rings for a batch of rows, the bands stepping
    together: for each row and band ``EDGE_RING`` steps of two ``(value,
    step)`` words, step -1 where never written. A band writes its pair of
    step ``f`` at position ``f % EDGE_RING``; the band that reads it finds
    that step's tag there."""

    def __init__(self, rows, warps, fill, up):
        self.values = np.full((rows, warps, EDGE_RING, 2), np.nan, F32)
        self.steps = np.full((rows, warps, EDGE_RING, 2), -1)
        self.fill = F32(fill)  # what a band with no neighbour takes
        # forward: band w reads band w-1's ring; backward: band w+1's
        source = np.arange(warps) + (-1 if up else 1)
        self.source = source[(source >= 0) & (source < warps)]
        self.readers = np.arange(warps)[(source >= 0) & (source < warps)]

    def put(self, step, pairs, live):
        """The pairs ``(rows, W, 2)`` of ``step``, from the rows that take it."""
        pos = step % EDGE_RING
        self.values[live, :, pos], self.steps[live, :, pos] = pairs[live], step

    def get(self, step, live):
        """``(rows, W, 2)``: each band's neighbour's pair of ``step``, which
        its position must carry in every row that took the step; ``fill``
        for a band with no neighbour and for the other rows."""
        pos = step % EDGE_RING
        assert (self.steps[live][:, self.source, pos] == step).all()
        out = np.full(self.values.shape[:2] + (2,), self.fill, F32)
        out[:, self.readers] = np.where(live[:, None, None], self.values[:, self.source, pos],
                                        self.fill)
        return out


def emulate(logp, lens, allowed, llens, g, plan, excluded=NEG_INF):
    """The kernel pair as laid out: ``(loss (B,), alphas, grad)``, float32 numpy.

    ``excluded`` is what beta holds where no path to a final state exists:
    at ``t = len-1`` every state but the final two, and the states past S.
    The kernels hold minus infinity; ``excluded=LOG_EPS`` is the TPU
    kernel's ``-1e5``, which on a row that cannot be aligned also counts
    the paths that end elsewhere."""
    if plan.path == "band":
        return _emulate_bands(logp, lens, allowed, llens, g, plan, excluded)
    lse3 = _lse3_excl if np.isneginf(excluded) else _lse3
    b, t, s = logp.shape
    lay = _Layout(s, plan)
    loss = np.empty(b, F32)
    alphas = np.empty_like(logp)
    grad = np.empty_like(logp)
    slot_size = plan.chunk * s
    for i in range(b):
        length = int(np.clip(lens[i], 0, t))
        allow_row = np.where(allowed[i], F32(0), LOG_EPS).astype(F32)
        allow = np.where(lay.valid, lay.gather(allow_row), LOG_EPS)
        chunks = -(-length // plan.chunk)

        # forward: chunk c+1 is copied into the other slot while chunk c is read
        ring = np.full((ctc_dp.STAGES, slot_size), np.nan, F32)
        a = np.where(lay.state == 0, F32(0), LOG_EPS).astype(F32)

        def fill_fwd(c):
            start, n = _chunk(c, length, plan.chunk, False)
            ring[c % ctc_dp.STAGES] = np.nan
            ring[c % ctc_dp.STAGES, : n * s] = logp[i, start:start + n].reshape(-1)

        if chunks:
            fill_fwd(0)
        for c in range(chunks):
            if c + 1 < chunks:
                fill_fwd(c + 1)
            slot = ring[c % ctc_dp.STAGES]
            start, n = _chunk(c, length, plan.chunk, False)
            for k in range(n):
                lp = np.where(lay.valid, lay.gather(slot[k * s:(k + 1) * s]), F32(0))
                a = lp + _lse3(a, lay.from_below(a, 1), lay.from_below(a, 2) + allow)
                alphas[i, start + k] = lay.flat(a)
        alphas[i, length:] = lay.flat(a)
        row = lay.flat(a)
        l2 = 2 * int(np.clip(llens[i], 0, (s - 1) // 2))
        ll = row[l2]
        if l2 > 0:
            a1 = row[l2 - 1]
            ll = np.maximum(ll, a1) + np.log1p(np.exp(-np.abs(ll - a1)))
        loss[i] = -ll

        # backward: chunks walk down from the last valid frame, log-probs and
        # alphas staged together
        allow2_row = np.full(s, LOG_EPS, F32)
        allow2_row[: s - 2] = allow_row[2:]
        allow2 = np.where(lay.valid, lay.gather(allow2_row), LOG_EPS)
        term = np.where((lay.state == l2) | ((lay.state == l2 - 1) & (l2 > 0)), F32(0),
                        excluded).astype(F32)
        grad[i, length:] = 0  # the loss does not depend on frames past the length
        ring = np.full((ctc_dp.STAGES, 2, slot_size), np.nan, F32)
        w = np.full(lay.state.shape, excluded, F32)

        def fill_bwd(c):
            start, n = _chunk(c, length, plan.chunk, True)
            ring[c % ctc_dp.STAGES] = np.nan
            ring[c % ctc_dp.STAGES, 0, : n * s] = logp[i, start:start + n].reshape(-1)
            ring[c % ctc_dp.STAGES, 1, : n * s] = alphas[i, start:start + n].reshape(-1)

        if chunks:
            fill_bwd(0)
        for c in range(chunks):
            if c + 1 < chunks:
                fill_bwd(c + 1)
            slot = ring[c % ctc_dp.STAGES]
            start, n = _chunk(c, length, plan.chunk, True)
            for k in range(n - 1, -1, -1):
                if start + k == length - 1:
                    beta = term
                else:
                    beta = lse3(w, lay.from_above(w, 1, excluded),
                                lay.from_above(w, 2, excluded) + allow2)
                lp = lay.gather(slot[0, k * s:(k + 1) * s])
                al = lay.gather(slot[1, k * s:(k + 1) * s])
                grad[i, start + k] = lay.flat(-np.exp(al + beta + loss[i]) * g[i])
                w = np.where(lay.valid, lp + beta, excluded).astype(F32)
    return loss, alphas, grad


def _emulate_bands(logp, lens, allowed, llens, g, plan, excluded):
    """:func:`emulate` on the band path, every row at once: a row's step
    ``f`` runs on frame ``f`` (backward: ``len-1-f``) while ``f < len``, its
    bands stepping together, each taking its neighbour's pair of the step
    before from the edge ring (the rings' waits are emulated apart, in
    random interleavings of the warps). Nothing is staged: each band reads
    its own columns of the frame."""
    lse3 = _lse3_excl if np.isneginf(excluded) else _lse3
    b, t, s = logp.shape
    lay = _Layout(s, plan)
    rows = np.arange(b)
    length = np.clip(lens, 0, t)
    alphas = np.empty_like(logp)
    grad = np.zeros_like(logp)  # the loss does not depend on frames past the length
    allow_row = np.where(allowed, F32(0), LOG_EPS).astype(F32)
    allow = np.where(lay.valid, lay.gather(allow_row), LOG_EPS)

    # forward; frames past a row's length carry its row
    a = np.broadcast_to(np.where(lay.state == 0, F32(0), LOG_EPS), allow.shape).astype(F32)
    edges = _EdgeRing(b, lay.warps, LOG_EPS, up=True)
    edge = np.full((b, lay.warps, 2), LOG_EPS, F32)  # the initial row's
    for f in range(t):
        live = f < length
        lp = np.where(lay.valid, lay.gather(logp[:, f]), F32(0))
        new = lp + _lse3(a, lay.from_below(a, 1, edge), lay.from_below(a, 2, edge) + allow)
        a = np.where(live[:, None, None, None], new, a)
        # the top two states out (lanes 31, 30), the band below's in
        edges.put(f, np.stack([a[..., 31, -1], a[..., 30, -1]], -1), live)
        edge = edges.get(f, live)
        alphas[:, f] = lay.flat(a)
    row = lay.flat(a)
    l2 = 2 * np.clip(llens, 0, (s - 1) // 2)
    a2, a1 = row[rows, l2], row[rows, np.maximum(l2 - 1, 0)]
    loss = -np.where(l2 > 0, np.maximum(a2, a1) + np.log1p(np.exp(-np.abs(a2 - a1))), a2)

    # backward: step i on frame len-1-i, from the final states' term
    allow2_row = np.full((b, s), LOG_EPS, F32)
    allow2_row[:, : s - 2] = allow_row[:, 2:]
    allow2 = np.where(lay.valid, lay.gather(allow2_row), LOG_EPS)
    last = l2[:, None, None, None]
    term = np.where((lay.state == last) | ((lay.state == last - 1) & (last > 0)), F32(0),
                    excluded).astype(F32)
    w = np.full(allow.shape, excluded, F32)
    edges = _EdgeRing(b, lay.warps, excluded, up=False)
    edge = np.full((b, lay.warps, 2), excluded, F32)
    scale = (loss[:, None, None, None], g[:, None, None, None])
    for i in range(t):
        live = i < length
        frame = np.maximum(length - 1 - i, 0)
        if i == 0:
            beta = term
        else:
            beta = lse3(w, lay.from_above(w, 1, excluded, edge),
                        lay.from_above(w, 2, excluded, edge) + allow2)
        lp, al = lay.gather(logp[rows, frame]), lay.gather(alphas[rows, frame])
        grad[rows[live], frame[live]] = lay.flat(-np.exp(al + beta + scale[0]) * scale[1])[live]
        w = np.where(live[:, None, None, None], np.where(lay.valid, lp + beta, excluded),
                     w).astype(F32)
        # the bottom two w out (lanes 0, 1), the band above's in
        edges.put(i, np.stack([w[..., 0, 0], w[..., 1, 0]], -1), live)
        edge = edges.get(i, live)
    return loss.astype(F32), alphas, grad


def _inputs(name):
    """The card test's case, from numpy, with at most 50 classes."""
    b, t, l, v, lens, llens, blank = CTC_CASES[name]
    v = min(v, 50)
    blank = min(blank, v - 1)
    rng = np.random.default_rng(len(name))
    logits = torch.from_numpy(rng.standard_normal((b, t, v)).astype(F32))
    low, high = (1, v) if blank == 0 else (0, v - 1)
    labels = torch.from_numpy(rng.integers(low, high, (b, l)))
    labels[0, 1:3] = labels[0, 0]
    lens = torch.tensor(lens or [t] * b)
    llens = torch.tensor(llens or [l] * b)
    g = torch.from_numpy((0.5 + rng.random(b)).astype(F32))
    return logits, lens, labels, llens, blank, g


@pytest.mark.parametrize("name", list(CTC_CASES))
def test_emulated_layout_matches_the_reference(name):
    logits, lens, labels, llens, blank, g = _inputs(name)
    logp_ext, allowed = ctc_dp.extended_log_probs(logits, labels, blank)
    b, t, s = logp_ext.shape
    plan = ctc_dp.kernel_plan(b, t, s)
    loss, _, grad = emulate(logp_ext.numpy(), lens.numpy(), allowed.numpy(), llens.numpy(),
                            g.numpy(), plan)
    x = logp_ext.clone().requires_grad_()
    want = ctc_dp.ctc_dp_reference(x, lens, allowed, llens)
    (want_grad,) = torch.autograd.grad(want, x, g)
    assert np.isfinite(loss).all() and np.isfinite(grad).all()
    tol = 16 * np.finfo(F32).eps * max(want.abs().max().item(), 1.0)
    np.testing.assert_allclose(loss, want.detach().numpy(), rtol=0, atol=tol)
    np.testing.assert_allclose(grad, want_grad.numpy(), rtol=0, atol=1.5 * max(tol, 1e-6))


@pytest.mark.parametrize("name", ["unalignable_rows", "unalignable_beside_alignable",
                                  "unalignable_wide_rows", "unalignable_wide_rows_701"])
def test_a_finite_beta_start_misses_rows_that_cannot_be_aligned(name):
    """Why beta starts at minus infinity off the final states: with the TPU
    kernel's -1e5 there, the gradient on a row that cannot be aligned (a loss
    near 1e5) also counts the paths that end elsewhere, and these cases see
    it (one-warp and band paths). The loss is the forward's, unchanged."""
    logits, lens, labels, llens, blank, g = _inputs(name)
    logp_ext, allowed = ctc_dp.extended_log_probs(logits, labels, blank)
    plan = ctc_dp.kernel_plan(*logp_ext.shape)
    args = (logp_ext.numpy(), lens.numpy(), allowed.numpy(), llens.numpy(), g.numpy(), plan)
    loss, _, grad = emulate(*args)
    loss_tpu, _, grad_tpu = emulate(*args, excluded=LOG_EPS)
    x = logp_ext.clone().requires_grad_()
    want = ctc_dp.ctc_dp_reference(x, lens, allowed, llens)
    (want_grad,) = torch.autograd.grad(want, x, g)
    assert want.max().item() > 9e4  # a row cannot be aligned
    np.testing.assert_array_equal(loss_tpu, loss)
    tol_grad = 1.5 * 16 * np.finfo(F32).eps * want.abs().max().item()
    assert np.abs(grad - want_grad.numpy()).max() <= tol_grad
    assert np.abs(grad_tpu - want_grad.numpy()).max() > tol_grad


@pytest.mark.parametrize("s", [1, 3, 31, 33, 63, 65, 127, 129, 255,
                               257, 319, 321, 383, 385, 701, 1023])
def test_emulated_register_exchange_is_a_shift(s):
    """The rotations with the edge lanes' register exchange, and on the band
    path the edge pairs each band writes for its neighbour, are exactly the
    shifts of the row in state order, at every K the one-warp path takes and
    at the band path's widths of 5 to 16 warps."""
    rng = np.random.default_rng(s)
    lay = _Layout(s, ctc_dp.kernel_plan(1, 4, s))
    row = rng.standard_normal(s).astype(F32)
    # forward rows pad with -1e5, backward rows (w) with minus infinity
    x = np.where(lay.valid, lay.gather(row), LOG_EPS)
    w = np.where(lay.valid, lay.gather(row), NEG_INF)
    up = down = None
    if lay.path == "band":  # what each band's edge ring carries: its top pair up, bottom down
        up = np.full((lay.warps, 2), LOG_EPS, F32)
        up[1:] = np.stack([x[:-1, 31, -1], x[:-1, 30, -1]], 1)
        down = np.full((lay.warps, 2), NEG_INF, F32)
        down[:-1] = np.stack([w[1:, 0, 0], w[1:, 1, 0]], 1)
    pad, none = np.full(2, LOG_EPS, F32), np.full(2, NEG_INF, F32)
    for d in (1, 2):
        below = np.concatenate([pad, row])[2 - d: 2 - d + s]
        above = np.concatenate([row, none])[d: d + s]
        np.testing.assert_array_equal(lay.flat(lay.from_below(x, d, up)), below)
        np.testing.assert_array_equal(lay.flat(lay.from_above(w, d, NEG_INF, down)), above)


def _band_protocol(warps, length, rng, first_alone):
    """The band kernels' edge-ring protocol, one warp a coroutine, run in a
    random, skewed interleaving: each step ``i`` a band stores its pair for the band
    it feeds and then loads its source's pair of step ``i``, with no check.
    It waits only when it opens a group of ``GROUP`` steps (the backward's
    step 0 is a group of its own, and the last group may be short): as a
    writer until its reader's published count has reached ``g1 -
    EDGE_RING`` (the oldest step the group overwrites), then as a reader
    until its source's pair of the group's last step is stored. It publishes
    its count when a group ends past a half of the ring (``EDGE_RING / 2``),
    but for the last short group. Returns the number of scheduling turns;
    fails on a deadlock, a pair overwritten before its reader took it, or a
    pair loaded before it was stored. The forward's bands feed upwards and
    the backward's downwards: one protocol, the band order reversed."""
    ring, half, group = EDGE_RING, EDGE_RING // 2, GROUP
    steps = np.full((warps, ring), -1)  # the step tag of each band's pair
    values = np.full((warps, ring), -1)
    taken = np.full(warps, -1)  # the last step of each band's ring that its reader took
    reads = np.zeros(warps, int)  # the published counts
    first = 1 if first_alone and length > 0 else 0
    groups = [(0, 1)] * first + [(g, min(g + group, length)) for g in range(first, length, group)]

    def band(w):
        source, reader = w - 1, (w + 1 if w + 1 < warps else -1)
        seen = 0
        for g0, g1 in groups:
            if reader >= 0 and seen < g1 - ring:
                while reads[reader] < g1 - ring:
                    yield False
                seen = g1 - ring
            while source >= 0 and steps[source, (g1 - 1) % ring] != g1 - 1:
                yield False
            for i in range(g0, g1):
                if reader >= 0:
                    old = steps[w, i % ring]
                    assert old < 0 or taken[w] >= old, "overwritten"
                    steps[w, i % ring], values[w, i % ring] = i, 1000 * i + w
                yield True
                if source >= 0:
                    assert steps[source, i % ring] == i, "loaded before it was stored"
                    assert values[source, i % ring] == 1000 * i + source
                    taken[source] = i
            last_short = g1 == length and g1 - g0 < group and (g0, g1) != (0, first)
            if source >= 0 and g0 // half != g1 // half and not last_short:
                reads[w] = g1

    # skewed turns, so that some bands run far ahead of their readers
    weight = rng.exponential(size=warps) ** 4
    live = {w: band(w) for w in range(warps)}
    blocked = set()  # live bands that have spun since the last step anywhere
    turns = 0
    while live:
        ready = [w for w in live if w not in blocked]
        assert ready, "deadlock"
        w = rng.choice(ready, p=weight[ready] / weight[ready].sum())
        turns += 1
        try:
            if next(live[w]):
                blocked.clear()
            else:
                blocked.add(w)
        except StopIteration:
            del live[w]
            blocked.clear()
    assert (taken[:-1] == length - 1).all()  # every pair was read
    return turns


@pytest.mark.parametrize("warps,length", [(5, 0), (5, 1), (5, 45), (11, 45), (11, 97),
                                          (11, 200), (16, 60), (16, 33), (6, 129), (6, 130)])
@pytest.mark.parametrize("first_alone", [False, True], ids=["forward", "backward"])
def test_band_edge_protocol_in_random_interleavings(warps, length, first_alone):
    """Whatever order the warps run in, every band loads each step's pair of
    its neighbour after it was stored and before it is overwritten, and
    nothing deadlocks: lengths not a multiple of the group, and walks over
    the ring several times, included."""
    rng = np.random.default_rng(warps * 1000 + length)
    for _ in range(4):
        assert _band_protocol(warps, length, rng, first_alone) >= warps * length


@pytest.mark.parametrize("length,chunk", [(0, 32), (1, 1), (13, 13), (32, 32), (45, 32),
                                          (249, 32), (752, 32)])
def test_chunks_cover_the_valid_frames_once(length, chunk):
    """``chunk_start``/``chunk_frames`` as the kernels walk them: forward
    from frame 0, backward from the last valid frame, whole chunks first and
    the short one last, every valid frame exactly once and no other."""
    chunks = -(-length // chunk)
    for reverse in (False, True):
        spans = [_chunk(c, length, chunk, reverse) for c in range(chunks)]
        assert all(1 <= n <= chunk for _, n in spans)
        assert all(n == chunk for _, n in spans[:-1])
        # backward, chunk c ends where chunk c-1 began
        ordered = spans[::-1] if reverse else spans
        assert [f for start, n in ordered for f in range(start, start + n)] == list(range(length))
