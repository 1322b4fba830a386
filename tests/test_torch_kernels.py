"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips on a host without a GPU: a
CUDA kernel has no CPU mode. This file imports neither JAX nor the JAX
package, so it runs where only PyTorch is installed. On the card::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from mindaudio_torch.ops import quant as tq

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: a CUDA kernel has no CPU mode")
    # the plain version's float32 product must not drop to TF32
    torch.backends.cuda.matmul.allow_tf32 = False


def bf16_ulp(y):
    """One bf16 ulp of each value (a bf16 keeps 8 significant bits)."""
    y = np.abs(np.asarray(y, np.float32))
    return np.exp2(np.floor(np.log2(np.maximum(y, np.finfo(np.float32).tiny))) - 7)


@pytest.mark.parametrize("m,k,n", [(1, 256, 4233), (257, 4864, 256), (33, 40, 17),
                                   (130, 256, 2048)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_matches_plain(m, k, n, dtype):
    """Ragged M, N and K. Both sides multiply the same bf16 operands exactly
    and sum in float32 in another order: float32 outputs agree to 1e-5 of
    max|y|, bf16 outputs to one bf16 ulp of max|y| (one rounding apart)."""
    g = torch.Generator(device="cuda").manual_seed(m)
    x = torch.randn(m, k, device="cuda", generator=g).to(dtype)
    v, s = tq.quantize_int8(0.05 * torch.randn(k, n, device="cuda", generator=g))
    before = tq.int8_matmul.launches
    got = tq.int8_matmul(x, v, s)
    torch.cuda.synchronize()
    assert tq.int8_matmul.launches == before + 1
    assert got.dtype == dtype and got.shape == (m, n)
    want = tq.int8_matmul_reference(x, v, s).float().cpu().numpy()
    err = np.abs(got.float().cpu().numpy() - want).max()
    peak = np.abs(want).max()
    assert err <= (1e-5 * peak if dtype == torch.float32 else bf16_ulp(peak)), err


def test_int8_matmul_rejects_what_the_kernel_does_not_take():
    x = torch.randn(4, 64, device="cuda")
    v, s = tq.quantize_int8(torch.randn(64, 8, device="cuda"))
    with pytest.raises(TypeError):
        tq.int8_matmul(x.half(), v, s)
    with pytest.raises(ValueError):
        tq.int8_matmul(x[:, :32], v, s)
    with pytest.raises(ValueError):
        tq.int8_matmul(x, v.cpu(), s)
