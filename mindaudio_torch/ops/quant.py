"""Weight-only int8 serving (port of ``mindaudio_tpu.ops.quant``).

Small-batch decoding is weight-bound; storing each large Linear as int8
values with per-output-channel float32 scales halves the weight stream
against bf16. The GEMM dequantizes in shared memory inside a CUDA kernel
(``csrc/int8_matmul.cu``), so the bf16 weight never exists in device memory.
Use::

    values, scales = quantize_int8(w)        # w (K, N), offline
    y = int8_matmul(x, values, scales)       # == x @ (values * scales)

or, for a whole model, :func:`quantize_dense_params` then
:func:`swap_quantized`.
"""

from __future__ import annotations

import ctypes

import torch
from torch import nn

from . import _build

__all__ = [
    "quantize_int8",
    "dequantize_int8",
    "int8_matmul",
    "int8_matmul_reference",
    "quantize_dense_params",
    "split_k",
    "pad_int8_rows",
    "Int8Linear",
    "swap_quantized",
]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def quantize_int8(w):
    """Per-output-channel symmetric int8 quantization of a ``(K, N)`` weight.

    Returns ``(values int8 (K, N), scales float32 (N,))`` with
    ``values * scales ≈ w``, bit-identical to the JAX package's NumPy
    version (same float32 division and round-half-to-even).
    """
    w = torch.as_tensor(w).to(torch.float32)
    amax = torch.clamp_min(w.abs().amax(dim=0), 1e-12)
    scales = amax / 127.0
    values = torch.clamp(torch.round(w / scales[None, :]), -127, 127).to(torch.int8)
    return values, scales


def dequantize_int8(values, scales):
    """``(K, N)`` int8 times ``(N,)`` scales, in float32."""
    return values.to(torch.float32) * scales.to(torch.float32)[None, :]


def int8_matmul_reference(x, values, scales):
    """Plain PyTorch version of :func:`int8_matmul`, the same arithmetic:
    ``bf16(x) @ bf16(bf16(values) * bf16(scales))`` accumulated in float32,
    returned in ``x``'s dtype."""
    k, n = values.shape
    xb = x.reshape(-1, k).to(torch.bfloat16).to(torch.float32)
    wde = (values.to(torch.bfloat16) * scales.to(torch.bfloat16)).to(torch.float32)
    return (xb @ wde).reshape(*x.shape[:-1], n).to(x.dtype)


# the kernel's output tile and K stage (csrc/int8_matmul.cu BM, BN, BK; the
# launcher checks them against the built kernel)
TILE_M, TILE_N, TILE_K = 128, 128, 64
# the int8 weight's row stride is padded to a multiple of this many bytes, so
# that 16-byte copies can address every row (csrc/int8_matmul.cu)
ROW_ALIGN = 16


def split_k(m, n, k, sms=132):
    """How many K splits the kernel takes for ``(m, k) @ (k, n)`` on a card
    with ``sms`` SMs: 1 unless there are few output tiles (under half the
    SMs) and K is long (8 stages or more); then as many as fill the SMs,
    each split keeping at least 4 K stages."""
    tiles = -(-m // TILE_M) * -(-n // TILE_N)
    stages = -(-k // TILE_K)
    if stages < 8 or 2 * tiles > sms:
        return 1
    return max(1, min(sms // tiles, stages // 4))


def pad_int8_rows(values):
    """``values`` (K, N) int8 copied into a (K, N') buffer whose rows are
    padded with zeros to a multiple of ``ROW_ALIGN`` bytes; returns the
    buffer, whose ``[:, :N]`` view reads back equal to ``values``. No copy
    where N is a multiple already and ``values`` is contiguous."""
    k, n = values.shape
    width = -(-n // ROW_ALIGN) * ROW_ALIGN
    if width == n:
        return values.contiguous()
    buf = torch.zeros((k, width), dtype=torch.int8, device=values.device)
    buf[:, :n] = values
    return buf


def _launcher():
    lib = _build.load("int8_matmul")
    fn = lib.int8_matmul_launch
    if fn.argtypes is None:  # pointers must not be cut to 32-bit ints
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.int8_matmul_error_string.argtypes = [ctypes.c_int]
        lib.int8_matmul_error_string.restype = ctypes.c_char_p
        lib.int8_matmul_smem_bytes.restype = ctypes.c_int
        tile = (ctypes.c_int * 3)()
        lib.int8_matmul_tile(tile)
        if tuple(tile) != (TILE_M, TILE_N, TILE_K):
            raise RuntimeError(f"int8_matmul: the kernel's tile {tuple(tile)} is not "
                               f"{(TILE_M, TILE_N, TILE_K)}, which split_k assumes")
    return lib


_SMS = {}


def _sm_count(device):
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[device]


def _check(x, values, scales):
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"int8_matmul: x must be float32 or bfloat16, got {x.dtype}")
    if values.dtype != torch.int8 or values.dim() != 2:
        raise TypeError("int8_matmul: values must be a 2-D int8 (K, N) tensor")
    k, n = values.shape
    if x.shape[-1] != k or scales.shape != (n,):
        raise ValueError(f"int8_matmul: x {tuple(x.shape)}, values {(k, n)}, "
                         f"scales {tuple(scales.shape)} do not agree")
    if values.device != x.device or scales.device != x.device:
        raise ValueError("int8_matmul: x, values and scales must share a device")
    if k >= 2**31 or n >= 2**31 or x.numel() // max(k, 1) >= 2**31:
        raise ValueError("int8_matmul: dimensions must fit in int32")


def _operands(x, values, scales):
    """The kernel's operands as views of the tensors given: ``(x2, ldx, w,
    ldw, s)``. ``x`` is copied only where its rows are not unit-strided and
    evenly spaced, ``values`` only where its columns are not unit-strided
    (the ``[:, :N]`` view of a row-padded buffer, as :func:`pad_int8_rows`
    gives, is taken as it is)."""
    k, n = values.shape
    x2 = x.reshape(-1, k)
    if k > 1 and x2.stride(1) != 1 or x2.shape[0] > 1 and x2.stride(0) < k:
        x2 = x2.contiguous()
    ldx = x2.stride(0) if x2.shape[0] > 1 else k
    w = values
    if n > 1 and w.stride(1) != 1 or k > 1 and w.stride(0) < n:
        w = w.contiguous()
    ldw = w.stride(0) if k > 1 else n
    return x2, ldx, w, ldw, scales.to(torch.float32).contiguous()


def int8_matmul(x, values, scales):
    """``x @ (values * scales)`` with int8 weights dequantized on chip.

    Args:
        x: ``(..., K)`` activations, float32 or bf16 on CUDA (any float
            dtype on the CPU); computed in bf16.
        values: ``(K, N)`` int8 weights, or the ``[:, :N]`` view of a
            row-padded buffer (:func:`pad_int8_rows`), which lets the kernel
            copy every row 16 bytes at a time.
        scales: ``(N,)`` per-output-channel scales.

    Returns:
        ``(..., N)`` in ``x``'s dtype, accumulated in float32.

    A CPU tensor takes the plain version; a CUDA tensor launches the CUDA
    kernel (counted in ``int8_matmul.launches``) or raises. Where K is split
    (:func:`split_k`), a second kernel sums the splits, counted in
    ``int8_matmul.reduce_launches``. A contiguous ``x`` and a ``values`` with
    unit column stride are not copied.
    """
    if x.device.type == "cpu":
        return int8_matmul_reference(x, values, scales)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    _check(x, values, scales)
    k, n = values.shape
    x2, ldx, w, ldw, s = _operands(x, values, scales)
    m = x2.shape[0]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m and n and k:
        sms = _sm_count(x.device)
        splits = split_k(m, n, k, sms)
        ws = (torch.empty((splits, m, -(-n // 4) * 4), dtype=torch.float32, device=x.device)
              if splits > 1 else None)
        lib = _launcher()
        with torch.cuda.device(x.device):
            rc = lib.int8_matmul_launch(
                x2.data_ptr(), w.data_ptr(), s.data_ptr(), y.data_ptr(),
                None if ws is None else ws.data_ptr(), m, n, k, ldx, ldw,
                _DTYPE_CODE[x.dtype], splits, sms,
                torch.cuda.current_stream(x.device).cuda_stream)
        if rc != 0:
            raise RuntimeError("int8_matmul kernel launch failed: "
                               f"{lib.int8_matmul_error_string(rc).decode()} ({rc})")
        int8_matmul.launches += 1
        int8_matmul.reduce_launches += int(splits > 1)
    elif m and n:
        y.zero_()
    return y.reshape(*x.shape[:-1], n)


int8_matmul.launches = 0
int8_matmul.reduce_launches = 0


def quantize_dense_params(model, min_weights=65536):
    """Int8 tables for every ``nn.Linear`` with at least ``min_weights``
    weights: ``{module_name: (values (K, N), scales (N,))}``.

    The JAX package keys the same tables by flax module path
    (``convert.module_name`` maps one to the other); smaller layers stay in
    the float path, as there.
    """
    return {
        name: quantize_int8(module.weight.detach().t())
        for name, module in model.named_modules()
        if isinstance(module, nn.Linear) and module.weight.numel() >= min_weights
    }


class Int8Linear(nn.Module):
    """A Linear layer served from int8 values and float32 scales.

    Holds only the int8 values, ``scales`` (N,) float32 and the bias; the
    float weight is gone. The values live in one buffer, ``qweight`` (K, N'),
    whose rows are padded with zeros to a multiple of 16 bytes
    (:func:`pad_int8_rows`) so that the kernel copies them 16 bytes at a
    time; ``values`` is its (K, N) view and reads back what
    :func:`quantize_int8` gave. The bias is a (frozen) parameter so that a
    cast of the parameters to the compute dtype reaches it, as the JAX path
    adds ``bias.astype(y.dtype)``.
    """

    def __init__(self, values, scales, bias=None):
        super().__init__()
        self.in_features, self.out_features = values.shape
        self.register_buffer("qweight", pad_int8_rows(values))
        self.register_buffer("scales", scales)
        self.bias = (nn.Parameter(bias.detach().clone(), requires_grad=False)
                     if bias is not None else None)

    @property
    def values(self):
        return self.qweight[:, : self.out_features]

    def forward(self, x):
        y = int8_matmul(x, self.values, self.scales)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


def swap_quantized(model, tables):
    """Replace each ``nn.Linear`` named in ``tables`` by an :class:`Int8Linear`
    (in place; returns ``model``). Stands for the JAX ``intercept_dense_int8``
    (route the layer through the int8 kernel) and ``strip_quantized`` (drop
    the float weight) together."""
    for name, (values, scales) in tables.items():
        parent_name, _, attr = name.rpartition(".")
        parent = model.get_submodule(parent_name)
        old = getattr(parent, attr)
        setattr(parent, attr, Int8Linear(values.to(old.weight.device),
                                         scales.to(old.weight.device), old.bias))
    return model
