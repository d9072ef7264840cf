"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports neither jax nor ``heat_tpu``, so it also runs on a
machine whose Python has PyTorch for CUDA and no JAX.  There, run it
without the suite's ``conftest.py`` (which imports jax):

    python -m pytest --noconftest -m gpu tests/test_torch_card.py -q

Without a CUDA device every test here skips.  The inputs are the ones
``chip_smoke.py`` holds the kernels to: random rows with one of each
special block (zero, NaN, +-Inf, the 1e36 saturation block, subnormal
and flushed-scale blocks, half-way ties) and rows of quotients on or
near half-integers, at odd row counts, at the
KMeans error-feedback ring's 4 and 8 rows, at the main path's 8192 rows,
at counts that are not a multiple of the quantize kernels' slab (8191,
8193), and at 2^17 rows, where every CTA of the capped grid walks
several slabs.  Kernel and plain version must agree bit for bit.

The flash-attention kernels are held to their plain versions at the
kernel's tiles (``kernel_blocks``: 128-row query tiles, 128-row K/V tiles
in bf16/f16 and 64 in float32) and to float64 dense attention, at the
tolerances ``chip_smoke.py`` states (float32 2e-5; bf16/f16 2 ulps of
plain and 5e-2 of dense; a partial chain 2e-6 of the full kernel), on
small shapes and the edge cases of its phase 5: an odd count of query
tiles, a K/V ring that wraps past its stages, diagonal tiles that straddle
mid-tile, head widths that TMA pads with zeros, four positions on distinct
bases (one fully masked) and the zig-zag ring's non-contiguous slices.
Each wrapper's launch count is checked per call.
"""

import importlib

import pytest
import torch

import chip_smoke
import heat_tpu_torch as htt
from heat_tpu_torch.comm import compressed as tcq

fa = importlib.import_module("heat_tpu_torch.parallel.flash_attention")

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
@pytest.mark.parametrize("rows", [1, 3, 33, 8192, 4, 8, 8191, 8193, 1 << 17])
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
    h, hs = tcq.dequantize_add_quantize_blocks(q, s, addend)
    hp, hsp = tcq.dequantize_add_quantize_blocks_plain(q, s, addend)
    assert _bitwise(h, hp)
    assert _bitwise(hs, hsp)


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [False, True])
def test_capped_grid_walks_several_slabs_on_card(cuda_device, fused):
    # the grid never exceeds the CTAs the card holds at once: a 4-row
    # call is one CTA, and at 2^17 rows every CTA takes several slabs
    assert tcq._quantize_grid(4, fused)[0] == 1
    ctas, step = tcq._quantize_grid(1 << 17, fused)
    assert ctas * step < 1 << 17
    assert ctas == tcq._quantize_grid(1 << 20, fused)[0]


@pytest.mark.gpu
def test_hop_wrapper_takes_block_128_on_card(cuda_device):
    q = torch.zeros((2, 64), dtype=torch.int8, device=cuda_device)
    s = torch.ones((2, 1), device=cuda_device)
    with pytest.raises(ValueError, match="block=128"):
        tcq.dequantize_add_quantize_blocks(q, s, torch.zeros(128, device=cuda_device))


@pytest.mark.gpu
def test_wrappers_count_kernel_launches(cuda_device):
    x = torch.randn(4 * BLOCK, device=cuda_device)
    counted = (tcq.quantize_blocks, tcq.dequantize_blocks, tcq.dequantize_fma_blocks,
               tcq.dequantize_add_quantize_blocks)

    def count(fn):
        before = [c.launches for c in counted]
        fn()
        torch.cuda.synchronize()
        return [c.launches - b for c, b in zip(counted, before)]

    def each_once():
        q, s = tcq.quantize_blocks(x)
        tcq.dequantize_blocks(q, s)
        tcq.dequantize_fma_blocks(q, s, x)
        tcq.dequantize_add_quantize_blocks(q, s, x)
        tcq.quantize_blocks_plain(x.reshape(-1, BLOCK))
        tcq.dequantize_add_quantize_blocks_plain(q, s, x)

    assert count(each_once) == [1, 1, 1, 1]
    # a ring at 4 positions: 1 quantize, 3 hops, 1 dequantize
    stacked = torch.randn(4, 1000, device=cuda_device)
    assert count(lambda: tcq.ring_allreduce_q(stacked, size=4, mode="int8_block")) == [1, 1, 0, 3]


def _plain(q, k, v, causal, q_base=0):
    return fa.flash_attention_plain(q, k, v, causal, q_base,
                                    *fa.kernel_blocks(q.dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [16, 32, 64, 128, 8, 40])
def test_flash_kernel_matches_plain_on_card(cuda_device, dtype, causal, d):
    q, k, v = chip_smoke.attn_inputs((2, 256, 2, d), dtype, seed=d, dev=cuda_device)
    out = fa.flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    chip_smoke.hold(f"D={d} {dtype} causal={causal}", out, _plain(q, k, v, causal),
                    chip_smoke.dense64(q, k, v, causal))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_q_base_with_longer_kv_on_card(cuda_device, dtype):
    q, k, v = chip_smoke.attn_inputs((1, 512, 2, 64), dtype, seed=3, dev=cuda_device)
    qs = q[:, 256:384]
    out = fa.flash_attention(qs, k, v, True, q_base=256)
    chip_smoke.hold("q_base", out, _plain(qs, k, v, True, 256),
                    chip_smoke.dense64(q, k, v, True)[:, 256:384])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_odd_query_tile_count_on_card(cuda_device, dtype, causal):
    # S = 384: three 128-row query tiles
    q, k, v = chip_smoke.attn_inputs((2, 384, 3, 64), dtype, seed=8, dev=cuda_device)
    chip_smoke.hold("S=384", fa.flash_attention(q, k, v, causal), _plain(q, k, v, causal),
                    chip_smoke.dense64(q, k, v, causal))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kv_ring_wraps_on_card(cuda_device, dtype, causal):
    # Lk = 640: 5 (bf16/f16) or 10 (f32) K/V tiles through a 2-stage ring;
    # the query block sits at the end of the keys under causal
    q, k, v = chip_smoke.attn_inputs((1, 640, 2, 64), dtype, seed=9, dev=cuda_device)
    qs = q[:, 512:]
    chip_smoke.hold("Lk=640", fa.flash_attention(qs, k, v, causal, q_base=512),
                    _plain(qs, k, v, causal, 512), chip_smoke.dense64(q, k, v, causal)[:, 512:])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lo", [64, 192])
def test_flash_diagonal_straddles_mid_tile_on_card(cuda_device, dtype, lo):
    # q_base = 64 or 192 with K/V longer than Q: the diagonal crosses the
    # middle of a query tile and of a K/V tile
    q, k, v = chip_smoke.attn_inputs((1, 384, 2, 64), dtype, seed=10, dev=cuda_device)
    qs = q[:, lo:lo + 128]
    chip_smoke.hold(f"q_base={lo}", fa.flash_attention(qs, k, v, True, q_base=lo),
                    _plain(qs, k, v, True, lo), chip_smoke.dense64(q, k, v, True)[:, lo:lo + 128])


def _state(rows, length, d, dev):
    return (torch.full((rows, length), -float("inf"), device=dev),
            torch.zeros((rows, length), device=dev), torch.zeros((rows, length, d), device=dev))


@pytest.mark.gpu
def test_partial_kernel_edge_cases_on_card(cuda_device):
    BH, L, D = 8, 256, 64
    q, k, v = chip_smoke.attn_inputs((BH, 2 * L, D), torch.float32, seed=4, dev=cuda_device)
    st0 = _state(BH, L, D, cuda_device)
    # a q tile wholly before its segment: the state comes back untouched
    got = fa.flash_attention_partial(q[:, :L], k[:, L:], v[:, L:], *st0, 0, L, causal=True)
    assert all(torch.equal(a, b) for a, b in zip(got, st0))
    # per-position bases in one launch == one launch per position
    bases = ([0, 256, 128, 0], [256, 0, 128, 0])
    one = fa.flash_attention_partial(q[:, :L], k[:, :L], v[:, :L], *st0, *bases, causal=True)
    for i in range(4):
        sl = slice(2 * i, 2 * i + 2)
        sep = fa.flash_attention_partial(q[sl, :L], k[sl, :L], v[sl, :L], *(t[sl] for t in st0),
                                         bases[0][i], bases[1][i], causal=True)
        assert all(torch.equal(a[sl], b) for a, b in zip(one, sep))
    # a chain of two segments equals the full kernel
    for causal in (False, True):
        st = _state(BH, 2 * L, D, cuda_device)
        for r in range(2):
            sl = slice(r * L, (r + 1) * L)
            st = fa.flash_attention_partial(q, k[:, sl], v[:, sl], *st, 0, r * L, causal=causal)
        chained = st[2] / torch.clamp_min(st[1], 1e-30)[..., None]
        full = fa.flash_attention(*(t.transpose(0, 1)[None] for t in (q, k, v)), causal)
        assert chip_smoke.max_abs_err(chained, full[0].transpose(0, 1)) <= chip_smoke.CHAIN_TOL


@pytest.mark.gpu
def test_partial_kernel_matches_plain_on_card(cuda_device):
    rows, L, D = 8, 256, 64
    q, k, v = chip_smoke.attn_inputs((rows, L, D), torch.bfloat16, seed=5, dev=cuda_device)
    st = _state(rows, L, D, cuda_device)
    got = fa.flash_attention_partial(q, k, v, *st, [0, 128], [0, 0], causal=True)
    want = fa.flash_attention_partial_plain(q, k, v, *st, [0, 128], [0, 0], True,
                                            *fa.kernel_blocks(torch.bfloat16))
    chip_smoke.hold_state("partial bf16 causal", got, want, torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_partial_four_positions_on_card(cuda_device, dtype):
    # four positions on distinct bases in one launch; position 0's queries
    # lie wholly before its keys (fully masked: its state comes back as
    # it went in, bit for bit)
    chip_smoke.check_partial_positions(fa, cuda_device, dtype, d=40)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_partial_zigzag_slices_on_card(cuda_device, dtype):
    # the zig-zag ring's operands: halves of a (p, BH, 2Lh, D) buffer,
    # handed over without a copy
    chip_smoke.check_partial_zigzag(fa, cuda_device, dtype)


@pytest.mark.gpu
def test_zigzag_ring_back_to_back_on_card(cuda_device):
    # ring rounds of 512 rows (four K/V tiles: the ring's third stage holds
    # the state first, then a K/V tile), calls back to back with no sync
    comm = htt.TorchCommunication([cuda_device] * 4)
    q, k, v = chip_smoke.attn_inputs((4096, 4, 64), torch.bfloat16, seed=11, dev=cuda_device)
    outs = [htt.parallel.ring_attention(q, k, v, True, comm=comm) for _ in range(4)]
    ref = chip_smoke.dense64(q[None], k[None], v[None], True)[0]
    for out in outs:
        assert float((out.double() - ref).abs().max()) <= chip_smoke.HALF_TOL


@pytest.mark.gpu
def test_attention_wrappers_count_kernel_launches(cuda_device):
    p = 4
    comm = htt.TorchCommunication([cuda_device] * p)
    counted = (fa.flash_attention, fa.flash_attention_partial)
    q, k, v = chip_smoke.attn_inputs((256 * p, 2, 32), torch.float32, seed=6, dev=cuda_device)

    def count(fn):
        before = [c.launches for c in counted]
        fn()
        torch.cuda.synchronize()
        return [c.launches - b for c, b in zip(counted, before)]

    assert count(lambda: fa.flash_attention(q, k, v, True)) == [1, 0]
    assert count(lambda: fa.flash_attention_plain(q, k, v, True)) == [0, 0]
    assert count(lambda: htt.parallel.ring_attention(q, k, v, False, comm=comm)) == [0, p]
    assert count(lambda: htt.parallel.ring_attention(q, k, v, True, comm=comm)) == [0, 3 + 2 * (p - 1)]
    q8, k8, v8 = chip_smoke.attn_inputs((256 * p, 2 * p, 32), torch.float32, seed=7, dev=cuda_device)
    assert count(lambda: htt.parallel.ulysses_attention(q8, k8, v8, True, comm=comm)) == [1, 0]
