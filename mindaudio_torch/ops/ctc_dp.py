"""CTC forward/backward dynamic program (port of ``mindaudio_tpu.ops.pallas_ctc``).

The canonical Graves extended-label recursion, as the JAX package's kernel
pair computes it::

    ext labels  : [b, l0, b, l1, ..., b]            S = 2L+1, b = blank
    alpha_t(s)  = logp_t(ext_s) + LSE(alpha_{t-1}(s), alpha_{t-1}(s-1),
                                      alpha_{t-1}(s-2) if allowed(s))
    allowed(s)  = s >= 2  and  ext_s != blank  and  ext_s != ext_{s-2}
    loss        = -LSE(alpha_{len-1}(2L), alpha_{len-1}(2L-1))

On CUDA tensors the recursion and its reverse (beta) pass are the two kernels
of ``csrc/ctc_dp.cu``, paired by a ``torch.autograd.Function``, launched as
:func:`kernel_plan` lays them out (one warp a sequence with the row in
registers and a chunk of frames staged ahead in shared memory; for wider
rows several warps a sequence, each a band of the row in registers, passing
edge states to its neighbour; for the widest one block a sequence); beside
them
stands the plain PyTorch version (a Python loop over ``T`` on ``(B, S)``
rows, differentiated by autograd), which CPU tensors and the tests use.
Log-softmax and the gather ``logp[..., ext]`` stay outside the Function, so
their gradients (and the scatter-add into the vocabulary axis) come from
autograd, as in the JAX package.

"Minus infinity" is ``-1e5``: the masks are additive, and an infeasible pair
(``T < L + repeats``) gives a finite loss near ``1e5`` with finite gradients.
The backward kernel's gradient is ``-exp(alpha + beta + loss)`` with beta
starting at ``t = len-1`` from 0 at the two final states and a true minus
infinity elsewhere (the TPU kernel's ``-1e5`` there would, on such a row,
also count the paths that end elsewhere); so on every row it is the plain
version's autograd gradient, and exactly 0 at states from which no final
state can be reached.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from torch.nn import functional as F

from . import _build

__all__ = [
    "ctc_dp_reference",
    "ctc_dp_fwd",
    "ctc_dp_bwd",
    "extended_log_probs",
    "ctc_per_seq_loss_reference",
    "ctc_per_seq_loss_kernel",
    "kernel_plan",
    "block_plan",
    "launch_fwd",
    "launch_bwd",
]

LOG_EPS = -1e5

# the kernels' fixed shapes (csrc/ctc_dp.cu)
MAX_K = 8             # states a lane holds on the one-warp path: S <= 32 * MAX_K
BAND = 64             # states a warp's band holds on the band path (csrc/ctc_band.cuh)
MAX_WARPS = 16        # warps a block on the band path: S <= BAND * MAX_WARPS
STAGES = 2            # ring slots: chunk c+1 is copied while chunk c is read
MAX_THREADS = 1024    # threads a block on the block path (a strided loop beyond)
CHUNK = 32            # frames a chunk at most
SMEM_LIMIT = 232448   # shared memory a block may use on the H100 (227 KB)
PATHS = ("warp", "band", "block")  # the launchers' path codes, in order


class Plan(NamedTuple):
    """How the kernel pair is launched for ``(B, T, S)``: ``B`` blocks."""
    path: str        # "warp": one warp a sequence; "band": several warps a sequence,
    #                  each a band of states; "block": one thread a state
    k: int           # states a lane holds (the register row); 0 on the block path
    threads: int     # a block's
    chunk: int       # frames a ring slot holds; 1 on the block path (a register
    #                  a step ahead)
    fwd_smem: int    # dynamic shared memory a block, bytes
    bwd_smem: int
    # the band launcher lays out its block itself (csrc/ctc_band.cuh): k,
    # chunk and shared memory are 0 there


def kernel_plan(b, t, s):
    """The launch plan of the kernel pair for ``logp_ext (b, t, s)``, or
    ValueError where the kernels take none. The one place that sizes the
    kernels' shared memory and chooses their path, by shape alone.

    ``S <= 32 * MAX_K`` (256): one warp a sequence, each lane holding ``k =
    ceil(S/32)`` states, and a ring of ``STAGES`` slots of ``chunk =
    min(CHUNK, T)`` frames of log-probs (backward: and of alphas, then one
    word a lane). ``S < BAND * MAX_WARPS`` (1024): ``ceil(S / BAND)`` warps
    a sequence, each a band of ``BAND`` states in registers, the launcher
    sizing the edge rings in shared memory (``csrc/ctc_band.cuh``). Wider
    rows: :func:`block_plan`.
    """
    if b < 0 or t < 1 or s < 1 or s % 2 == 0:
        raise ValueError(f"ctc_dp kernel: need B >= 0, T >= 1 and odd S = 2L+1, "
                         f"got B={b}, T={t}, S={s}")
    k = -(-s // 32)
    if k <= MAX_K:
        chunk = min(CHUNK, t)
        ring = STAGES * chunk * s * 4
        return Plan("warp", k, 32, chunk, ring, 2 * ring + 32 * 4)
    warps = -(-s // BAND)
    if warps <= MAX_WARPS:
        return Plan("band", 0, 32 * warps, 0, 0, 0)
    return block_plan(s)


def block_plan(s):
    """The block path's plan at ``S``, the widest rows' in :func:`kernel_plan`
    and the first design's at any width: one block a sequence, one thread a
    state up to 1024, the skip mask and two rows in shared memory; a row
    whose three do not fit in 227 KB is refused."""
    smem = (3 * s + 4) * 4
    if smem > SMEM_LIMIT:
        raise ValueError(f"ctc_dp kernel: S={s} does not fit the skip mask and two rows in "
                         f"{SMEM_LIMIT} bytes of shared memory")
    return Plan("block", 0, min(MAX_THREADS, 32 * -(-s // 32)), 1, smem, smem)


def _lse3(a, b, c):
    m = torch.maximum(torch.maximum(a, b), c)
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m) + torch.exp(c - m))


def _shift_right(row, k):
    """``out[:, s] = row[:, s-k]``, front-filled with ``LOG_EPS`` (any S)."""
    pad = row.new_full((row.shape[0], k), LOG_EPS)
    return torch.cat([pad, row], dim=1)[:, : row.shape[1]]


def ctc_dp_reference(logp_ext, logit_lengths, allowed, label_lengths):
    """Plain PyTorch version of the kernel pair: per-sequence loss ``(B,)``
    from ``logp_ext (B, T, S)``; the gradient comes from autograd."""
    b, t, s = logp_ext.shape
    allow = torch.where(allowed, 0.0, LOG_EPS).to(logp_ext.dtype)
    alpha = logp_ext.new_full((b, s), LOG_EPS)
    alpha[:, 0] = 0.0
    # frames by unbind: one stack in the backward (a select a frame would
    # build and fill a (B, T, S) gradient every frame)
    for i, frame in enumerate(logp_ext.unbind(1)):
        new = frame + _lse3(alpha, _shift_right(alpha, 1), _shift_right(alpha, 2) + allow)
        alpha = torch.where((logit_lengths > i)[:, None], new, alpha)
    s2 = 2 * label_lengths.long()
    a2 = alpha.gather(1, s2[:, None])[:, 0]
    a1 = alpha.gather(1, (s2 - 1).clamp_min(0)[:, None])[:, 0]
    return -torch.where(label_lengths > 0, torch.logaddexp(a2, a1), a2)


def _library():
    lib = _build.load("ctc_dp")
    if lib.ctc_dp_fwd_launch.argtypes is None:  # pointers must not be cut to 32 bits
        plan = [ctypes.c_int] * 7 + [ctypes.c_longlong, ctypes.c_void_p]
        lib.ctc_dp_fwd_launch.argtypes = [ctypes.c_void_p] * 6 + plan
        lib.ctc_dp_fwd_launch.restype = ctypes.c_int
        lib.ctc_dp_bwd_launch.argtypes = [ctypes.c_void_p] * 8 + plan
        lib.ctc_dp_bwd_launch.restype = ctypes.c_int
        lib.ctc_dp_error_string.argtypes = [ctypes.c_int]
        lib.ctc_dp_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, logp_ext, logit_lengths, allowed, label_lengths):
    if logp_ext.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel needs CUDA tensors, got {logp_ext.device}; "
                         "the plain version is ctc_dp_reference")
    if logp_ext.dtype != torch.float32 or logp_ext.dim() != 3:
        raise TypeError(f"{name}: logp_ext must be a float32 (B, T, S) tensor")
    b, t, s = logp_ext.shape
    if t < 1 or s < 1 or s % 2 == 0:
        raise ValueError(f"{name}: need T >= 1 and odd S = 2L+1, got T={t}, S={s}")
    if logit_lengths.shape != (b,) or label_lengths.shape != (b,) or allowed.shape != (b, s):
        raise ValueError(f"{name}: lengths must be (B,) and allowed (B, S)")
    if any(x.device != logp_ext.device for x in (logit_lengths, allowed, label_lengths)):
        raise ValueError(f"{name}: all tensors must share a device")
    if max(b, t, s) >= 2**31:
        raise ValueError(f"{name}: dimensions must fit in int32")
    return (logp_ext.contiguous(), logit_lengths.to(torch.int32).contiguous(),
            allowed.to(torch.uint8).contiguous(), label_lengths.to(torch.int32).contiguous())


def _raise_on(rc, lib, name):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.ctc_dp_error_string(rc).decode()} ({rc})")


def ctc_dp_fwd(logp_ext, logit_lengths, allowed, label_lengths):
    """Launch the forward kernel: ``(loss (B,), alphas (B, T, S))``, float32.
    CUDA tensors only; counted in ``ctc_dp_fwd.launches``."""
    loss, alphas = launch_fwd(None, logp_ext, logit_lengths, allowed, label_lengths)
    if loss.shape[0]:
        ctc_dp_fwd.launches += 1
    return loss, alphas


ctc_dp_fwd.launches = 0


def launch_fwd(plan, logp_ext, logit_lengths, allowed, label_lengths):
    """:func:`ctc_dp_fwd` by ``plan`` (``None``: :func:`kernel_plan`'s; or
    another path that takes ``S``, such as :func:`block_plan`), not counted:
    for timing one path beside another at one shape."""
    logp, lens, allow, llens = _check("ctc_dp_fwd", logp_ext, logit_lengths, allowed,
                                      label_lengths)
    b, t, s = logp.shape
    plan = kernel_plan(b, t, s) if plan is None else plan
    alphas = torch.empty_like(logp)
    loss = torch.empty(b, dtype=torch.float32, device=logp.device)
    if b:
        lib = _library()
        with torch.cuda.device(logp.device):
            rc = lib.ctc_dp_fwd_launch(
                logp.data_ptr(), lens.data_ptr(), llens.data_ptr(), allow.data_ptr(),
                alphas.data_ptr(), loss.data_ptr(), b, t, s, PATHS.index(plan.path), plan.k,
                plan.threads, plan.chunk, plan.fwd_smem,
                torch.cuda.current_stream(logp.device).cuda_stream)
        _raise_on(rc, lib, "ctc_dp_fwd")
    return loss, alphas


def ctc_dp_bwd(logp_ext, alphas, logit_lengths, allowed, label_lengths, loss, g):
    """Launch the backward kernel: ``dL/dlogp_ext (B, T, S)`` for the upstream
    cotangent ``g (B,)``. CUDA tensors only; counted in ``ctc_dp_bwd.launches``."""
    grad = launch_bwd(None, logp_ext, alphas, logit_lengths, allowed, label_lengths, loss, g)
    if grad.shape[0]:
        ctc_dp_bwd.launches += 1
    return grad


ctc_dp_bwd.launches = 0


def launch_bwd(plan, logp_ext, alphas, logit_lengths, allowed, label_lengths, loss, g):
    """:func:`ctc_dp_bwd` by ``plan``, not counted, as :func:`launch_fwd`."""
    logp, lens, allow, llens = _check("ctc_dp_bwd", logp_ext, logit_lengths, allowed,
                                      label_lengths)
    b, t, s = logp.shape
    plan = kernel_plan(b, t, s) if plan is None else plan
    if alphas.shape != logp.shape or alphas.dtype != torch.float32:
        raise ValueError("ctc_dp_bwd: alphas must be float32 of logp_ext's shape")
    alphas = alphas.contiguous()
    loss = loss.to(torch.float32).contiguous()
    g = g.to(torch.float32).contiguous()
    if loss.shape != (b,) or g.shape != (b,):
        raise ValueError("ctc_dp_bwd: loss and g must be (B,)")
    grad = torch.empty_like(logp)
    if b:
        lib = _library()
        with torch.cuda.device(logp.device):
            rc = lib.ctc_dp_bwd_launch(
                logp.data_ptr(), alphas.data_ptr(), lens.data_ptr(), llens.data_ptr(),
                allow.data_ptr(), loss.data_ptr(), g.data_ptr(), grad.data_ptr(), b, t, s,
                PATHS.index(plan.path), plan.k, plan.threads, plan.chunk, plan.bwd_smem,
                torch.cuda.current_stream(logp.device).cuda_stream)
        _raise_on(rc, lib, "ctc_dp_bwd")
    return grad


class _CtcDp(torch.autograd.Function):
    """The kernel pair as one differentiable function of ``logp_ext``."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda", cast_inputs=torch.float32)
    def forward(ctx, logp_ext, logit_lengths, allowed, label_lengths):
        loss, alphas = ctc_dp_fwd(logp_ext, logit_lengths, allowed, label_lengths)
        ctx.save_for_backward(logp_ext, alphas, loss, logit_lengths, allowed, label_lengths)
        return loss

    @staticmethod
    @torch.autograd.function.once_differentiable
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g):
        logp_ext, alphas, loss, logit_lengths, allowed, label_lengths = ctx.saved_tensors
        grad = ctc_dp_bwd(logp_ext, alphas, logit_lengths, allowed, label_lengths, loss, g)
        return grad, None, None, None


def extended_log_probs(logits, labels, blank_id=0):
    """What both versions of the DP consume: float32 log-softmax of ``logits
    (B, T, V)`` gathered at the extended labels, ``logp_ext (B, T, 2L+1)``,
    and ``allowed (B, 2L+1)`` bool."""
    b, t, _ = logits.shape
    s = 2 * labels.shape[1] + 1
    logprobs = F.log_softmax(logits.float(), dim=-1)
    ext = torch.full((b, s), blank_id, dtype=torch.long, device=logits.device)
    ext[:, 1::2] = labels.long()
    logp_ext = logprobs.gather(2, ext[:, None, :].expand(b, t, s))
    s_idx = torch.arange(s, device=logits.device)[None, :]
    allowed = (ext != blank_id) & (ext != ext.roll(2, dims=1)) & (s_idx >= 2)
    return logp_ext, allowed


def ctc_per_seq_loss_reference(logits, logit_lengths, labels, label_lengths, blank_id=0):
    """Per-sequence CTC negative log-likelihood ``(B,)``, plain PyTorch."""
    logp_ext, allowed = extended_log_probs(logits, labels, blank_id)
    return ctc_dp_reference(logp_ext, logit_lengths, allowed, label_lengths)


def ctc_per_seq_loss_kernel(logits, logit_lengths, labels, label_lengths, blank_id=0):
    """Per-sequence CTC negative log-likelihood ``(B,)`` through the CUDA
    kernels (counterpart of ``ctc_per_seq_loss_pallas``). CUDA tensors only."""
    if logits.device.type != "cuda":
        raise ValueError("ctc_per_seq_loss_kernel: the CUDA kernel needs CUDA tensors, "
                         f"got {logits.device}; use ctc_per_seq_loss_reference")
    logp_ext, allowed = extended_log_probs(logits, labels, blank_id)
    return _CtcDp.apply(logp_ext, logit_lengths, allowed, label_lengths)
