"""The precision the reference's products run in.

``float32`` is the reference itself (run with TF32 off). ``bfloat16`` and
``fp8`` are the controls, the reference computed as a lower-precision
program would compute it: the operands of every product (linear layers,
matrix products, convolutions and the LSTM's products) rounded, bf16
directly or fp8 (e4m3) with one scale a tensor at its largest magnitude;
the product accumulated in float32 and its output stored in bf16; and in
the backward the gradient reaching each product's output rounded to bf16
too, so that the backward's products take rounded operands as well.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

FP8_MAX = 448.0  # the largest float8_e4m3fn


def _bf16(t):
    return t.to(torch.bfloat16).to(t.dtype)


def _fp8(t):
    scale = t.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


class _Round(torch.autograd.Function):
    """``forward(x)`` in the forward, ``backward(g)`` in the backward."""

    @staticmethod
    def forward(ctx, x, forward, backward):
        ctx.backward_fn = backward
        return forward(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.backward_fn(g), None, None


def _same(t):
    return t


class Precision:
    def __init__(self, name="float32"):
        if name not in ("float32", "bfloat16", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self._operand = {"bfloat16": _bf16, "fp8": _fp8}.get(name)

    def operand(self, t):
        """``t`` as a product's operand (the gradient passes unchanged)."""
        return t if self._operand is None else _Round.apply(t, self._operand, _same)

    def output(self, y):
        """A product's output, stored in bf16; its gradient rounded alike."""
        return y if self._operand is None else _Round.apply(y, _bf16, _bf16)

    def linear(self, x, w, b=None):
        return self.output(F.linear(self.operand(x), self.operand(w), b))

    def matmul(self, a, b):
        return self.output(self.operand(a) @ self.operand(b))

    def conv1d(self, x, w, b=None, **kw):
        return self.output(F.conv1d(self.operand(x), self.operand(w), b, **kw))

    def conv2d(self, x, w, b=None, **kw):
        return self.output(F.conv2d(self.operand(x), self.operand(w), b, **kw))


FLOAT32 = Precision("float32")
