"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports neither jax nor ``heat_tpu``, so it also runs on a
machine whose Python has PyTorch for CUDA and no JAX.  There, run it
without the suite's ``conftest.py`` (which imports jax):

    python -m pytest --noconftest -m gpu tests/test_torch_card.py -q

Without a CUDA device every test here skips.  The inputs are the ones
``chip_smoke.py`` holds the kernels to: random rows with one of each
special block (zero, NaN, +-Inf, the 1e36 saturation block, subnormal
and flushed-scale blocks, half-way ties), at odd row counts and at the
main path's 8192 rows.  Kernel and plain version must agree bit for bit.
"""

import pytest
import torch

import chip_smoke
from heat_tpu_torch.comm import compressed as tcq

BLOCK = tcq.BLOCK


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _bitwise(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 3, 33, 8192])
def test_kernels_match_plain_on_card(cuda_device, rows):
    x = torch.from_numpy(chip_smoke.payload(rows, seed=rows)).to(cuda_device)
    addend = torch.from_numpy(chip_smoke.payload(rows, seed=rows + 1)).to(cuda_device)
    q, s = tcq.quantize_blocks(x)
    qp, sp = tcq.quantize_blocks_plain(x.reshape(rows, BLOCK))
    assert _bitwise(q, qp)
    assert _bitwise(s, sp)
    assert _bitwise(tcq.dequantize_blocks(q, s), tcq.dequantize_blocks_plain(q, s))
    for negate in (False, True):
        f = tcq.dequantize_fma_blocks(q, s, addend, negate=negate)
        fp = tcq.dequantize_fma_blocks_plain(q, s, addend, negate=negate)
        assert _bitwise(f, fp)


@pytest.mark.gpu
def test_wrappers_count_kernel_launches(cuda_device):
    x = torch.randn(4 * BLOCK, device=cuda_device)
    counted = (tcq.quantize_blocks, tcq.dequantize_blocks, tcq.dequantize_fma_blocks)
    before = [fn.launches for fn in counted]
    q, s = tcq.quantize_blocks(x)
    tcq.dequantize_blocks(q, s)
    tcq.dequantize_fma_blocks(q, s, x)
    tcq.quantize_blocks_plain(x.reshape(-1, BLOCK))
    torch.cuda.synchronize()
    assert [fn.launches - b for fn, b in zip(counted, before)] == [1, 1, 1]
