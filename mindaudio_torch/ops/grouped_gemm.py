"""A grouped GEMM over ragged row groups (CUDA C++, ``csrc/grouped_gemm.cu``),
and the expert FFN of a dropless mixture of experts built on it.

The rows of ``a (M, K)`` are sorted into groups: group ``g`` holds rows
``offsets[g]:offsets[g + 1]`` and is multiplied by its own matrix ``b[g]``.
The offsets live in device memory and are read by the kernels themselves, so
nothing is read back to the host and the launch does not depend on how the
rows fall: the grid is sized from the shapes alone, and its spare row tiles
write zeros to the rows outside every group. It replaces no TPU kernel: the JAX package's MoE multiplies
a dense one-hot dispatch tensor into capacity-padded expert blocks, which
drops tokens past the capacity; this kernel runs every routed row and pads
nothing.

Three products, each one launch:

- :func:`grouped_gemm`: ``a[rows of g] @ b[g]`` (or ``@ b[g].T`` with
  ``trans_b``: the gradient of the input), with optional epilogues: plus
  ``bias[g]``; ``"swish_dropout"``, the expert FFN's first product, which
  writes ``z = a @ b + bias`` and ``dropout(swish(z))``, the dropout's
  bytes read row by row through ``src`` (the row of ``bits`` each sorted row
  came from: the bytes stay in the order they were drawn); and
  ``"dswish_dropout"``, its gradient, ``(g @ b.T) * keep * scale *
  swish'(z)``;
- :func:`grouped_gemm_wgrad`: ``a[rows of g].T @ dy[rows of g]`` in float32
  for every group (an empty group gives zeros), and optionally the column
  sums of ``dy`` per group (the bias gradient): partial sums over chunks of
  a group's rows, then a second kernel adds them in a fixed order.

The kernels (the design and what bounds them: the source's header) take bf16
operands on the tensor cores with float32 sums, and float32 operands
in full float32 on the FMA units; K and N (K1 and N of the weight gradient)
must be multiples of 8, and a launch takes at most 256 groups. CUDA tensors launch them (counted in
``grouped_gemm.launches`` and ``grouped_gemm_wgrad.launches``) on PyTorch's
current stream, with no synchronisation; CPU tensors take the plain versions
(:func:`grouped_gemm_plain`, :func:`grouped_gemm_wgrad_plain`), a loop over
the groups with the same arithmetic. The library is built by ``_build`` and
loaded at the first launch.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["grouped_gemm", "grouped_gemm_wgrad", "grouped_gemm_plain",
           "grouped_gemm_wgrad_plain", "expert_ffn", "EPILOGUES"]

EPILOGUES = ("none", "swish_dropout", "dswish_dropout")  # the kernel's epilogue codes, in order
DTYPES = (torch.float32, torch.bfloat16)  # the kernels' type codes, in order
MAX_GROUPS = 256  # groups a launch takes

_CODES = {dtype: i for i, dtype in enumerate(DTYPES)}
_LIB = []  # the library, once loaded


def _library():
    if not _LIB:
        lib = _build.load("grouped_gemm", keep_gil=True)
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.grouped_gemm_launch.argtypes = [ptr] * 8 + [i64] + [i32] * 5 + [ctypes.c_float,
                                                                             i32, ptr]
        lib.grouped_gemm_wgrad_launch.argtypes = [ptr] * 6 + [i64] + [i32] * 5 + [ptr]
        lib.grouped_gemm_wgrad_workspace.argtypes = [i64, i32, i32, i32]
        lib.grouped_gemm_wgrad_workspace.restype = i64
        for fn in (lib.grouped_gemm_launch, lib.grouped_gemm_wgrad_launch):
            fn.restype = i32
        lib.grouped_gemm_error_string.argtypes = [i32]
        lib.grouped_gemm_error_string.restype = ctypes.c_char_p
        _LIB.append(lib)
    return _LIB[0]


def _raise_on(rc, name):
    raise RuntimeError(f"{name} kernel launch failed: "
                       f"{_library().grouped_gemm_error_string(rc).decode()} ({rc})")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _bounds(offsets):
    """The offsets as the kernels read them: contiguous int64."""
    return offsets if offsets.dtype == torch.int64 and offsets.is_contiguous() else (
        offsets.to(torch.int64).contiguous())


def _widths(name, groups, *sizes):
    if any(size % 8 for size in sizes):
        raise ValueError(f"{name}: the kernel takes widths that are multiples of 8, got {sizes}")
    if groups > MAX_GROUPS:
        raise ValueError(f"{name}: the kernel takes at most {MAX_GROUPS} groups, got {groups}")


def _pairs(offsets):
    bounds = offsets.tolist()
    return list(zip(bounds[:-1], bounds[1:]))


def _check(a, b, offsets, trans_b, bias, epilogue, z, src, bits):
    if epilogue not in EPILOGUES:
        raise ValueError(f"grouped_gemm: epilogue must be one of {EPILOGUES}, got {epilogue!r}")
    if a.dim() != 2 or b.dim() != 3:
        raise ValueError(f"grouped_gemm: a must be (M, K) and b (G, K, N), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype not in DTYPES or b.dtype != a.dtype:
        raise TypeError(f"grouped_gemm: a and b must share a type of {DTYPES}, got {a.dtype} "
                        f"and {b.dtype}")
    k = b.shape[2] if trans_b else b.shape[1]
    if a.shape[1] != k:
        raise ValueError(f"grouped_gemm: a has {a.shape[1]} columns, b's groups take {k}")
    if offsets.dim() != 1 or offsets.numel() != b.shape[0] + 1 or offsets.dtype not in (
            torch.int32, torch.int64):
        raise ValueError(f"grouped_gemm: offsets must be {b.shape[0] + 1} int32 or int64 "
                         f"bounds, got {tuple(offsets.shape)} {offsets.dtype}")
    n = b.shape[1] if trans_b else b.shape[2]
    if bias is not None and tuple(bias.shape) != (b.shape[0], n):
        raise ValueError(f"grouped_gemm: bias must be ({b.shape[0]}, {n}), got "
                         f"{tuple(bias.shape)}")
    if epilogue == "dswish_dropout" and (z is None or tuple(z.shape) != (a.shape[0], n)):
        raise ValueError("grouped_gemm: the dswish_dropout epilogue needs z of the output's shape")
    if (bits is None) != (src is None):
        raise ValueError("grouped_gemm: bits and src come together")
    if bits is not None:
        if epilogue == "none":
            raise ValueError("grouped_gemm: dropout bytes need a dropout epilogue")
        if bits.dtype != torch.uint8 or bits.dim() != 2 or bits.shape[1] != n:
            raise ValueError(f"grouped_gemm: bits must be uint8 (rows, {n})")
        if src.dtype != torch.int64 or tuple(src.shape) != (a.shape[0],):
            raise ValueError(f"grouped_gemm: src must be int64 ({a.shape[0]},)")
    for t in (b, offsets, bias, z, src, bits):
        if t is not None and t.device != a.device:
            raise ValueError("grouped_gemm: every tensor must be on a's device")


def grouped_gemm_plain(a, b, offsets, trans_b=False, bias=None, epilogue="none", z=None,
                       src=None, bits=None, thresh=0, scale=1.0):
    """:func:`grouped_gemm` as a loop over the groups, in ``a``'s type."""
    n = b.shape[1] if trans_b else b.shape[2]
    out = a.new_zeros(a.shape[0], n)
    z_out = a.new_zeros(a.shape[0], n) if epilogue == "swish_dropout" else None
    for g, (lo, hi) in enumerate(_pairs(offsets.cpu())):
        if hi <= lo:
            continue
        y = a[lo:hi] @ (b[g].t() if trans_b else b[g])
        if bias is not None:
            y = y + bias[g].to(y.dtype)
        keep = None if bits is None else bits[src[lo:hi]] >= thresh
        if epilogue == "swish_dropout":
            z_out[lo:hi] = y
            zf = y.float()
            y = zf * torch.sigmoid(zf)
        elif epilogue == "dswish_dropout":
            zf = z[lo:hi].float()
            sig = torch.sigmoid(zf)
            y = y.float()
            if keep is not None:
                y = torch.where(keep, y * scale, 0.0)
            y = y * (sig * (1.0 + zf * (1.0 - sig)))
            keep = None
        if keep is not None:
            y = torch.where(keep, y * scale, 0.0)
        out[lo:hi] = y.to(out.dtype)
    return out if z_out is None else (z_out, out)


def grouped_gemm(a, b, offsets, trans_b=False, bias=None, epilogue="none", z=None, src=None,
                 bits=None, thresh=0, scale=1.0):
    """For every group ``g``: ``a[lo:hi] @ b[g]`` (``b[g].T`` with
    ``trans_b``) with ``lo, hi = offsets[g], offsets[g + 1]``, in ``a``'s
    type, rows outside every group 0. ``bias (G, N)`` is added in float32.
    ``epilogue``: ``"swish_dropout"`` returns ``(z, dropout(swish(z)))``;
    ``"dswish_dropout"`` returns ``(a @ b.T) * keep * scale * swish'(z)``
    for the ``z`` given. ``bits`` (uint8, one row per source row) and
    ``src`` (int64, each row's source row) carry the dropout's bytes: a value
    is kept where its byte is at least ``thresh`` and multiplied by
    ``scale``. One launch on CUDA (``grouped_gemm.launches``)."""
    _check(a, b, offsets, trans_b, bias, epilogue, z, src, bits)
    if not a.is_cuda:
        return grouped_gemm_plain(a, b, offsets, trans_b, bias, epilogue, z, src, bits, thresh,
                                  scale)
    a = a.contiguous()
    m, k = a.shape
    g = b.shape[0]
    n = b.shape[1] if trans_b else b.shape[2]
    _widths("grouped_gemm", g, k, n)
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)  # every row written
    z_out = torch.empty_like(out) if epilogue == "swish_dropout" else None
    if m and n and g:
        if bias is not None:
            bias = bias.to(torch.float32).contiguous()
        if z is not None:
            z = z.contiguous()
        index = a.get_device()
        codes = _CODES[a.dtype] | int(trans_b) << 4 | EPILOGUES.index(epilogue) << 8
        rc = (_LIB[0] if _LIB else _library()).grouped_gemm_launch(
            a.data_ptr(), b.contiguous().data_ptr(), out.data_ptr(),
            _ptr(z_out if z_out is not None else z), _ptr(bias), _bounds(offsets).data_ptr(),
            _ptr(None if src is None else src.contiguous()),
            _ptr(None if bits is None else bits.contiguous()), m, n, k, g, codes,
            int(thresh), float(scale), index, torch._C._cuda_getCurrentRawStream(index))
        if rc:
            _raise_on(rc, "grouped_gemm")
        grouped_gemm.launches += 1
    elif m and n:  # no group: every row is outside
        out.zero_()
        if z_out is not None:
            z_out.zero_()
    return out if z_out is None else (z_out, out)


grouped_gemm.launches = 0


def grouped_gemm_wgrad_plain(x, dy, offsets, bias_grad=False):
    """:func:`grouped_gemm_wgrad` as a loop over the groups, in float32."""
    g = offsets.numel() - 1
    dw = x.new_zeros((g, x.shape[1], dy.shape[1]), dtype=torch.float32)
    db = dy.new_zeros((g, dy.shape[1]), dtype=torch.float32) if bias_grad else None
    for i, (lo, hi) in enumerate(_pairs(offsets.cpu())):
        if hi > lo:
            dw[i] = x[lo:hi].float().t() @ dy[lo:hi].float()
            if bias_grad:
                db[i] = dy[lo:hi].float().sum(0)
    return dw, db


def grouped_gemm_wgrad(x, dy, offsets, bias_grad=False):
    """For every group ``g``: ``x[lo:hi].T @ dy[lo:hi]`` as ``(G, K, N)``
    float32 (an empty group gives zeros) and, with ``bias_grad``, ``dy[lo:hi]
    .sum(0)`` as ``(G, N)`` float32 (else ``None``). One launch on CUDA
    (``grouped_gemm_wgrad.launches``) of two kernels: the chunks of each
    group's rows into a float32 workspace of ``(ceil(M / 4096) + G) (K + 1)
    N`` values, then their sum."""
    if x.dim() != 2 or dy.dim() != 2 or x.shape[0] != dy.shape[0]:
        raise ValueError(f"grouped_gemm_wgrad: x (M, K) and dy (M, N) must share M, got "
                         f"{tuple(x.shape)} and {tuple(dy.shape)}")
    if x.dtype not in DTYPES or dy.dtype != x.dtype:
        raise TypeError(f"grouped_gemm_wgrad: x and dy must share a type of {DTYPES}")
    if offsets.dim() != 1 or offsets.dtype not in (torch.int32, torch.int64):
        raise ValueError("grouped_gemm_wgrad: offsets must be 1-D int32 or int64")
    if not x.is_cuda:
        return grouped_gemm_wgrad_plain(x, dy, offsets, bias_grad)
    x, dy = x.contiguous(), dy.contiguous()
    g, k1, n = offsets.numel() - 1, x.shape[1], dy.shape[1]
    _widths("grouped_gemm_wgrad", g, k1, n)
    dw = torch.empty((g, k1, n), dtype=torch.float32, device=x.device)
    db = torch.empty((g, n), dtype=torch.float32, device=x.device) if bias_grad else None
    if g and k1 and n:
        index = x.get_device()
        lib = _LIB[0] if _LIB else _library()
        ws = torch.empty(lib.grouped_gemm_wgrad_workspace(x.shape[0], k1, n, g),
                         dtype=torch.float32, device=x.device)
        rc = lib.grouped_gemm_wgrad_launch(
            x.data_ptr(), dy.data_ptr(), dw.data_ptr(), _ptr(db), ws.data_ptr(),
            _bounds(offsets).data_ptr(), x.shape[0], k1, n, g, _CODES[x.dtype], index,
            torch._C._cuda_getCurrentRawStream(index))
        if rc:
            _raise_on(rc, "grouped_gemm_wgrad")
        grouped_gemm_wgrad.launches += 1
    return dw, db


grouped_gemm_wgrad.launches = 0


class _ExpertFFN(torch.autograd.Function):
    """``dropout(swish(x W1_g + b1_g)) W2_g + b2_g`` for the rows of every
    group ``g``: two launches forward, four backward."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, offsets, src, bits, thresh, scale):
        w1c, w2c = w1.to(x.dtype), w2.to(x.dtype)
        z, h = grouped_gemm(x, w1c, offsets, bias=b1, epilogue="swish_dropout", src=src,
                            bits=bits, thresh=thresh, scale=scale)
        y = grouped_gemm(h, w2c, offsets, bias=b2)
        ctx.save_for_backward(x, w1c, w2c, z, h, offsets, src, bits)
        ctx.thresh, ctx.scale = thresh, scale
        ctx.dtypes = (w1.dtype, b1.dtype, w2.dtype, b2.dtype)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, w1c, w2c, z, h, offsets, src, bits = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dz = grouped_gemm(g, w2c, offsets, trans_b=True, epilogue="dswish_dropout", z=z,
                          src=src, bits=bits, thresh=ctx.thresh, scale=ctx.scale)
        dw2, db2 = grouped_gemm_wgrad(h, g, offsets, bias_grad=True)
        dx = grouped_gemm(dz, w1c, offsets, trans_b=True)
        dw1, db1 = grouped_gemm_wgrad(x, dz, offsets, bias_grad=True)
        t1, tb1, t2, tb2 = ctx.dtypes
        return (dx, dw1.to(t1), db1.to(tb1), dw2.to(t2), db2.to(tb2), None, None, None, None,
                None)


def expert_ffn(x, w1, b1, w2, b2, offsets, src=None, bits=None, thresh=0, scale=1.0):
    """The experts of a mixture on rows sorted by expert: for the rows
    ``offsets[g]:offsets[g + 1]`` of ``x (M, D)``, ``dropout(swish(x @
    w1[g] + b1[g])) @ w2[g] + b2[g]``; rows outside every group give 0.
    ``w1 (G, D, H)``, ``w2 (G, H, D)`` are cast to ``x``'s type, the biases
    added in float32; the dropout (``bits``, ``src``, ``thresh``, ``scale``)
    as :func:`grouped_gemm`'s, or none without ``bits``. Differentiable in
    ``x`` and the four parameters, whose gradients come back in their own
    types from float32 sums."""
    return _ExpertFFN.apply(x, w1, b1, w2, b2, offsets, src, bits, thresh, scale)
