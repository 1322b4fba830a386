"""The training dropout fused with the elementwise work beside it: one CUDA
kernel forward and one backward (``csrc/fused_dropout.cu``) in place of
PyTorch's chain of elementwise kernels.

The dropout is ``models.layers.FastDropout``'s: a value is kept where its
uniform byte is ``>= thresh`` and kept values are divided by ``keep_prob =
1 - thresh / 256``. The bytes are given by the caller, drawn as the plain
path draws them (``FastDropout.bits``), so the fused and the plain path drop
the same positions and leave the generator in the same state. Two
differentiable forms, each a ``torch.autograd.Function``:

- :func:`dropout_activation`: ``dropout(act(h))``, ``act`` one of
  :data:`ACTS` (``"identity"`` is the dropout alone); it keeps ``h`` (for an
  activation) and the bytes, and its backward recomputes the activation's
  derivative from ``h``;
- :func:`dropout_add`: ``x + s * dropout(y)`` in ``torch.result_type(x,
  y)``; it keeps the bytes, and its backward hands ``g`` to ``x`` (cast to
  ``x``'s type where that differs) and writes ``g * s * keep / keep_prob`` to
  ``y``.

Both evaluate in float32 and round once to the output's type, where the plain
chain rounds after each step. The launchers (:func:`fused_dropout_fwd`,
:func:`fused_dropout_bwd`) take CUDA tensors alone and count their kernel
launches in ``.launches``. The layers take these forms on the card only
(``FastDropout.fusable``) and keep their plain chain elsewhere.

The Functions run a few hundred times a training step, so their path to the
kernel does no more on the host than it must: no argument checks (the layers
hand them what the kernels take; the public launchers check), one packed
type code, and a library loaded with ``ctypes.PyDLL``, whose calls keep the
GIL (a launch never waits on Python, and no other thread need run meanwhile).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

__all__ = ["ACTS", "DTYPES", "applications", "scale_of", "fused_dropout_fwd",
           "fused_dropout_bwd", "dropout_activation", "dropout_add"]

ACTS = ("identity", "swish", "relu")  # the kernels' activation codes, in order
DTYPES = (torch.float32, torch.bfloat16, torch.float16)  # the kernels' type codes, in order

# training-mode FastDropout applications by path since the last reset:
# counted by models/layers.FastDropout, read by train/profiler.dropout_counts
applications = {"fused": 0, "plain": 0}


_SCALES = {}  # (thresh, s) -> scale_of's value: a step asks for a few, many times
_CODES = {dtype: i for i, dtype in enumerate(DTYPES)}
_ACT_CODES = {act: i for i, act in enumerate(ACTS)}
# the type of x + y for the kernels' types (torch.result_type's), keyed (y, x)
_PROMOTED = {(a, b): a if a == b else torch.float32 for a in DTYPES for b in DTYPES}
_LIB = []  # the library, once loaded


def scale_of(thresh, s=1.0):
    """``s / keep_prob`` as the float32 the kernels multiply by."""
    scale = _SCALES.get((thresh, s))
    if scale is None:
        scale = _SCALES[thresh, s] = float(np.float32(s * 256.0 / (256 - thresh)))
    return scale


def _library():
    if not _LIB:
        lib = _build.load("fused_dropout", keep_gil=True)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.fused_dropout_fwd_launch, lib.fused_dropout_bwd_launch):
            # pointers must not be cut to 32 bits
            fn.argtypes = [ptr] * 4 + [ctypes.c_longlong, i32, i32, ctypes.c_float, i32, ptr]
            fn.restype = i32
        lib.fused_dropout_error_string.argtypes = [i32]
        lib.fused_dropout_error_string.restype = ctypes.c_char_p
        _LIB.append(lib)
    return _LIB[0]


def _stream(index):
    """The raw handle of PyTorch's current stream on device ``index`` (what
    ``torch.cuda.current_stream(index).cuda_stream`` gives, without building
    a ``Stream``)."""
    return torch._C._cuda_getCurrentRawStream(index)


def _raise_on(rc, name):
    raise RuntimeError(f"{name} kernel launch failed: "
                       f"{_library().fused_dropout_error_string(rc).decode()} ({rc})")


def _check(name, bits, thresh, act, *tensors):
    if act not in ACTS:
        raise ValueError(f"{name}: act must be one of {ACTS}, got {act!r}")
    if not 0 < thresh < 256:
        raise ValueError(f"{name}: thresh must lie in 1..255, got {thresh}")
    if bits.dtype != torch.uint8:
        raise TypeError(f"{name}: bits must be uint8, got {bits.dtype}")
    for t in tensors:
        if t.dtype not in DTYPES:
            raise TypeError(f"{name}: values must be float32, bf16 or fp16, got {t.dtype}")
        if t.shape != bits.shape or t.device != bits.device:
            raise ValueError(f"{name}: every tensor must have the bytes' shape "
                             f"{tuple(bits.shape)} and device {bits.device}")
    if not bits.is_cuda:
        raise ValueError(f"{name}: the kernels take CUDA tensors, got {bits.device}")


def _forward(y, bits, thresh, scale, act, x=None):
    """The forward kernel on contiguous CUDA tensors the kernel takes, no
    check made: ``y``'s type without ``x``, ``x + y``'s with it."""
    out = torch.empty(y.shape, dtype=y.dtype if x is None else _PROMOTED[y.dtype, x.dtype],
                      device=y.device)
    n = out.numel()
    if n:
        index = y.get_device()
        codes = _CODES[y.dtype] | (0 if x is None else _CODES[x.dtype] + 1) << 4 | act << 8
        rc = (_LIB[0] if _LIB else _library()).fused_dropout_fwd_launch(
            y.data_ptr(), None if x is None else x.data_ptr(), bits.data_ptr(), out.data_ptr(),
            n, codes, thresh, scale, index, _stream(index))
        if rc:
            _raise_on(rc, "fused_dropout_fwd")
        fused_dropout_fwd.launches += 1
    return out


def _backward(g, bits, thresh, scale, dtype, act, y=None):
    """The backward kernel on contiguous CUDA tensors the kernel takes, no
    check made; the result in ``dtype``."""
    dy = torch.empty(g.shape, dtype=dtype, device=g.device)
    n = dy.numel()
    if n:
        index = g.get_device()
        codes = _CODES[g.dtype] | _CODES[dtype] << 4 | act << 8
        rc = (_LIB[0] if _LIB else _library()).fused_dropout_bwd_launch(
            g.data_ptr(), None if y is None else y.data_ptr(), bits.data_ptr(), dy.data_ptr(),
            n, codes, thresh, scale, index, _stream(index))
        if rc:
            _raise_on(rc, "fused_dropout_bwd")
        fused_dropout_bwd.launches += 1
    return dy


def fused_dropout_fwd(y, bits, thresh, scale, act="identity", x=None):
    """``x + act(y) * scale`` where ``bits >= thresh``, ``x`` (or 0) elsewhere,
    in the type of ``x + y`` (``y``'s without ``x``), evaluated in float32 by
    one kernel launch (counted in ``fused_dropout_fwd.launches``). CUDA
    tensors only. ``scale`` is :func:`scale_of`'s."""
    if x is not None and act != "identity":
        raise ValueError("fused_dropout_fwd: the residual add takes no activation")
    _check("fused_dropout_fwd", bits, thresh, act, *((y,) if x is None else (y, x)))
    return _forward(y.contiguous(), bits.contiguous(), thresh, scale, _ACT_CODES[act],
                    None if x is None else x.contiguous())


fused_dropout_fwd.launches = 0


def fused_dropout_bwd(g, bits, thresh, scale, dtype, act="identity", y=None):
    """``g * scale * act'(y)`` where ``bits >= thresh``, 0 elsewhere, in
    ``dtype`` (``y``'s where there is an activation; ``g``'s type is then
    ``dtype`` too, else ``dtype`` or float32), by one kernel launch (counted
    in ``fused_dropout_bwd.launches``). CUDA tensors only."""
    if (act == "identity") != (y is None):
        raise ValueError("fused_dropout_bwd: y is needed by an activation, and only there")
    if (y is not None and y.dtype != dtype) or g.dtype not in (dtype, torch.float32):
        raise TypeError(f"fused_dropout_bwd: g {g.dtype} and y into dtype {dtype} are not "
                        "a pair the kernel takes")
    _check("fused_dropout_bwd", bits, thresh, act, g, *(() if y is None else (y,)))
    return _backward(g.contiguous(), bits.contiguous(), thresh, scale, dtype, _ACT_CODES[act],
                     None if y is None else y.contiguous())


fused_dropout_bwd.launches = 0


class _DropoutActivation(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, bits, thresh, act):
        h = h.contiguous()
        ctx.thresh, ctx.act, ctx.dtype = thresh, act, h.dtype
        ctx.save_for_backward(h if act else None, bits)
        return _forward(h, bits, thresh, scale_of(thresh), act)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        h, bits = ctx.saved_tensors
        dh = _backward(g.to(ctx.dtype).contiguous(), bits, ctx.thresh, scale_of(ctx.thresh),
                       ctx.dtype, ctx.act, h)
        return dh, None, None, None


class _DropoutAdd(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, y, bits, thresh, s):
        x, y = x.contiguous(), y.contiguous()
        ctx.thresh, ctx.s, ctx.x_dtype, ctx.y_dtype = thresh, s, x.dtype, y.dtype
        ctx.out_dtype = _PROMOTED[y.dtype, x.dtype]
        ctx.save_for_backward(bits)
        return _forward(y, bits, thresh, scale_of(thresh, s), 0, x)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (bits,) = ctx.saved_tensors
        g = g.to(ctx.out_dtype)
        dx = dy = None
        if ctx.needs_input_grad[0]:
            dx = g.to(ctx.x_dtype)
        if ctx.needs_input_grad[1]:
            dy = _backward(g.contiguous(), bits, ctx.thresh, scale_of(ctx.thresh, ctx.s),
                           ctx.y_dtype, 0)
        return dx, dy, None, None, None


def dropout_activation(h, bits, thresh, act="identity"):
    """``dropout(act(h))`` on the bytes ``bits``, differentiable in ``h``;
    CUDA tensors the kernels take, unchecked (the layers check)."""
    return _DropoutActivation.apply(h, bits, thresh, _ACT_CODES[act])


def dropout_add(x, y, bits, thresh, s=1.0):
    """``x + s * dropout(y)`` on the bytes ``bits``, differentiable in ``x``
    and ``y``; ``x`` and ``y`` have one shape; CUDA tensors the kernels
    take, unchecked (the layers check)."""
    return _DropoutAdd.apply(x, y, bits, thresh, s)
