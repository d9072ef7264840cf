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

The slice's linear algebra and Lasso run on the card at small sizes
against float64: matmul in every split combination (integer operands
included, which take an exact broadcast product since cuBLAS has none),
QR and SVD at 1 and 4 positions (float32: relative residual 1e-5 and
orthonormality 1e-4, as ``chip_smoke.py`` phase 7 holds them; float64:
1e-12) and the SVD of a matrix of condition 1e6 and of a rank-deficient
one (S within 1e-5 of the largest singular value), Lasso cd and gd against a float64 numpy replay, and the exact
kernel launches of a quantized ISTA step (2 quantize, 3 hops, 1
dequantize_fma, 1 dequantize at 4 positions).  ``allclose`` and ``equal``
of a card array and host data compare on the card.

The RNG draws on the card equal the port's CPU draws of the same seed and
counter bit for bit at 1 and 4 positions (``randn``: within 4 ulps, the
card's ``log1p`` not being the CPU's); the comparison operators give card
arrays; KMedians' bisection at 2^17 rows equals ``numpy.median``; an
int64 2048^3 product equals the exact one with its transients under
``INT_MATMUL_BUDGET``.
"""

import importlib

import numpy as np
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


# --------------------------------------------------------------------- #
# linear algebra and Lasso                                               #
# --------------------------------------------------------------------- #
def _tols(dtype):
    """(relative residual, orthonormality) of a factorization in ``dtype``."""
    return (chip_smoke.QR_TOL, chip_smoke.ORTH_TOL) if dtype == torch.float32 else (1e-12, 1e-12)


@pytest.mark.gpu
@pytest.mark.parametrize("p", [1, 4])
@pytest.mark.parametrize("sa,sb", [(None, None), (0, 0), (0, 1), (1, 1), (1, 0), (None, 1)])
def test_matmul_on_card_against_float64(cuda_device, p, sa, sb):
    comm = htt.TorchCommunication([cuda_device] * p)
    rng = np.random.default_rng(20)
    a, b = rng.normal(size=(13, 7)), rng.normal(size=(7, 11))
    got = htt.array(a.astype(np.float32), split=sa, comm=comm) @ htt.array(b.astype(np.float32), split=sb, comm=comm)
    np.testing.assert_allclose(got.numpy(), a @ b, rtol=1e-5, atol=1e-5)
    ai, bi = rng.integers(-9, 10, size=(13, 7)), rng.integers(-9, 10, size=(7, 11))
    goti = htt.array(ai.astype(np.int32), split=sa, comm=comm) @ htt.array(bi.astype(np.int32), split=sb, comm=comm)
    assert goti.dtype is htt.int32
    np.testing.assert_array_equal(goti.numpy(), ai @ bi)
    assert torch.get_float32_matmul_precision() == "highest"


@pytest.mark.gpu
@pytest.mark.parametrize("p", [1, 4])
@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_qr_svd_on_card_against_float64(cuda_device, p, split, dtype):
    comm = htt.TorchCommunication([cuda_device] * p)
    a64 = torch.from_numpy(np.random.default_rng(21).normal(size=(2048, 24))).to(cuda_device)
    x = htt.array(a64.to(dtype), split=split, comm=comm)
    res_tol, orth_tol = _tols(dtype)
    norm = float(torch.linalg.norm(a64))
    eye = torch.eye(24, dtype=torch.float64, device=cuda_device)
    q, r = htt.linalg.qr(x)
    Q, R = q.larray.double(), r.larray.double()
    assert q.split == split and r.split == (1 if split == 1 else None)
    assert float(torch.linalg.norm(Q @ R - a64)) / norm <= res_tol
    assert float((Q.T @ Q - eye).abs().max()) <= orth_tol
    assert bool((torch.tril(r.larray, -1) == 0).all())
    u, s, v = htt.linalg.svd(x)
    s64 = torch.linalg.svdvals(a64)
    assert float(((s.larray.double() - s64).abs() / s64).max()) <= chip_smoke.S_RTOL
    rec = (u.larray.double() * s.larray.double()) @ v.larray.double().T
    assert float(torch.linalg.norm(rec - a64)) / norm <= res_tol
    only = htt.linalg.svd(x, compute_uv=False)
    torch.testing.assert_close(only.larray, s.larray, rtol=1e-5, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("p", [1, 4])
@pytest.mark.parametrize("kind", ["condition 1e6", "rank 20 of 24"])
def test_svd_of_hard_matrices_on_card(cuda_device, p, kind):
    """A float32 matrix of condition 1e6 or of deficient rank: its QR's
    rounding (float32's eps times the largest singular value) bounds what
    any SVD route can give, so S is held within 1e-5 of the largest
    singular value of the matrix's float64 SVD, the reconstruction and the
    orthonormality of U and V as phase 7 holds them."""
    rng = np.random.default_rng(25)
    m, n = 2048, 24
    if kind.startswith("rank"):
        a = rng.normal(size=(m, n))
        a[:, -4:] = a[:, :4]
    else:
        left, right = np.linalg.qr(rng.normal(size=(m, n)))[0], np.linalg.qr(rng.normal(size=(n, n)))[0]
        a = (left * np.logspace(0, -6, n)) @ right.T
    a64 = torch.from_numpy(a.astype(np.float32)).to(cuda_device).double()
    u, s, v = htt.linalg.svd(htt.array(a64.float(), split=0, comm=htt.TorchCommunication([cuda_device] * p)))
    U, S, V = u.larray.double(), s.larray.double(), v.larray.double()
    s64 = torch.linalg.svdvals(a64)
    eye = torch.eye(n, dtype=torch.float64, device=cuda_device)
    assert float((S - s64).abs().max()) <= 1e-5 * float(s64[0])
    assert float(torch.linalg.norm((U * S) @ V.T - a64)) <= chip_smoke.QR_TOL * float(torch.linalg.norm(a64))
    assert float((U.T @ U - eye).abs().max()) <= chip_smoke.ORTH_TOL
    assert float((V.T @ V - eye).abs().max()) <= chip_smoke.ORTH_TOL


def _lasso_data(n, f, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, f)).astype(np.float32)
    y = (a @ np.linspace(-2, 2, f) + 0.5 + 0.1 * rng.normal(size=n)).astype(np.float32)
    return a, y


@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["cd", "gd"])
def test_lasso_on_card_against_float64_replay(cuda_device, solver):
    comm = htt.TorchCommunication([cuda_device] * 4)
    a, y = _lasso_data(4096, 8, 22)
    x, yy = htt.array(a, split=0, comm=comm), htt.array(y, split=0, comm=comm)
    want = chip_smoke.numpy_cd(a, y, 0.1, 300)  # converged: the minimiser in float64
    if solver == "cd":
        est = htt.regression.Lasso(lam=0.1, max_iter=20, tol=-1.0).fit(x, yy)
        replay = chip_smoke.numpy_cd(a, y, 0.1, 20)
        got = est.theta.numpy().reshape(-1)
        assert np.abs(got - replay).max() <= chip_smoke.CD_TOL * np.abs(replay).max()
    else:
        est = htt.regression.Lasso(lam=0.1, max_iter=3000, tol=1e-7, solver="gd").fit(x, yy)
        got = est.theta.numpy().reshape(-1)
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()
    assert est.theta.larray.device.type == "cuda"
    pred = est.predict(x)
    assert pred.split == 0 and pred.larray.device.type == "cuda"
    np.testing.assert_allclose(pred.numpy().reshape(-1), a @ got[1:] + got[0], rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_quantized_ista_step_launches_on_card(cuda_device):
    """m = 33 (the blobs' 32 features and the intercept) at 4 positions:
    per step 2 quantize, 3 hops, 1 dequantize_fma, 1 dequantize."""
    comm = htt.TorchCommunication([cuda_device] * 4)
    a, y = _lasso_data(1024, 32, 23)
    x, yy = htt.array(a, split=0, comm=comm), htt.array(y, split=0, comm=comm)
    counted = (tcq.quantize_blocks, tcq.dequantize_blocks, tcq.dequantize_fma_blocks,
               tcq.dequantize_add_quantize_blocks)
    steps = 5
    exact = htt.regression.Lasso(lam=0.1, max_iter=400, tol=-1.0, solver="gd").fit(x, yy)
    with tcq.collective_precision("int8_block"):
        before = [c.launches for c in counted]
        htt.regression.Lasso(lam=0.1, max_iter=steps, tol=-1.0, solver="gd").fit(x, yy)
        torch.cuda.synchronize()
        assert [c.launches - b for c, b in zip(counted, before)] == [2 * steps, steps, steps, 3 * steps]
        comp = htt.regression.Lasso(lam=0.1, max_iter=400, tol=-1.0, solver="gd").fit(x, yy)

    def loss(est):
        th = est.theta.numpy().reshape(-1).astype(np.float64)
        return chip_smoke.lasso_loss(a, y, th, 0.1)

    assert abs(loss(comp) - loss(exact)) <= chip_smoke.LOSS_RTOL * loss(exact)


@pytest.mark.gpu
def test_comparisons_with_host_data_run_on_card(cuda_device, monkeypatch):
    """allclose/equal with a numpy operand on either side put it on the
    DNDarray's device: every tensor the comparison reaches is on the card."""
    comm = htt.TorchCommunication([cuda_device] * 4)
    c = np.random.default_rng(24).normal(size=(37, 5)).astype(np.float32)
    x = htt.array(c, split=0, comm=comm)
    seen = []

    def spy(fn):
        def call(*args, **kw):
            seen.append({t.device.type for t in args if isinstance(t, torch.Tensor)})
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(torch, "allclose", spy(torch.allclose))
    monkeypatch.setattr(torch, "all", spy(torch.all))
    assert htt.allclose(c, x) and htt.allclose(x, c) and not htt.allclose(x, c + 1)
    assert htt.equal(c, x) and htt.equal(x, c) and not htt.equal(x, c + 1)
    assert len(seen) == 6 and all(s == {"cuda"} for s in seen)


# --------------------------------------------------------------------- #
# the RNG, the comparison operators, KMedians, integer products          #
# --------------------------------------------------------------------- #
RNG_DRAWS = [
    ("rand", (513, 7), {}), ("rand", (300,), {"dtype": "float64"}), ("rand", (257,), {"dtype": "float16"}),
    ("rand", (257,), {"dtype": "bfloat16"}), ("randint", (-9, 10**6, (1000,)), {}),
    ("randint", (-3, 2**62, (100,)), {"dtype": "int64"}), ("randint", (0, 200, (99,)), {"dtype": "uint8"}),
    ("randperm", (1 << 17,), {}), ("permutation", (1000,), {}), ("randn", (64, 9), {"dtype": "float16"}),
]


def _draw(fn, args, kw, comm):
    kw = {k: getattr(htt, v) if k == "dtype" else v for k, v in kw.items()}
    htt.random.set_state(("Threefry", 31, 4))
    out = getattr(htt.random, fn)(*args, split=0, comm=comm, **kw)
    return out, htt.random.get_state()


@pytest.mark.gpu
@pytest.mark.parametrize("p", [1, 4])
@pytest.mark.parametrize("fn,args,kw", RNG_DRAWS, ids=lambda v: str(v)[:24])
def test_rng_on_card_bitwise_against_cpu(cuda_device, p, fn, args, kw):
    got, st_card = _draw(fn, args, kw, htt.TorchCommunication([cuda_device] * p))
    want, st_cpu = _draw(fn, args, kw, htt.TorchCommunication(["cpu"] * p))
    assert got.larray.device.type == "cuda" and st_card == st_cpu
    a, b = got.larray.cpu(), want.larray
    if a.is_floating_point():
        a, b = a.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]), \
            b.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[b.element_size()])
    assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,ulps", [("float32", 4), ("float64", 64)])
def test_randn_on_card_within_ulps_of_cpu(cuda_device, dtype, ulps):
    got, _ = _draw("randn", (4096, 33), {"dtype": dtype}, htt.TorchCommunication([cuda_device]))
    want, _ = _draw("randn", (4096, 33), {"dtype": dtype}, htt.TorchCommunication(["cpu"]))
    g, w = got.numpy(), want.numpy()
    assert float((np.abs(g.astype(np.float64) - w) / np.spacing(np.abs(w))).max()) <= ulps


@pytest.mark.gpu
@pytest.mark.parametrize("split", [None, 0, 1])
def test_comparison_operators_on_card(cuda_device, split):
    comm = htt.TorchCommunication([cuda_device] * 4)
    a = np.random.default_rng(26).integers(-3, 4, size=(13, 6)).astype(np.float32)
    x, y = htt.array(a, split=split, comm=comm), htt.array(a.T.copy().T, split=split, comm=comm)
    for got, want in ((x == y, a == a), (x != 1, a != 1), (x < 0, a < 0), (x <= a, a <= a),
                      (2 > x, 2 > a), (x >= y, a >= a)):
        assert got.larray.device.type == "cuda" and got.split == split and got.dtype is htt.bool
        np.testing.assert_array_equal(got.numpy(), want)
    assert bool(x[0, 0] == float(a[0, 0])) and x[True].shape == (1, 13, 6)


@pytest.mark.gpu
def test_kmedians_bisection_at_2_17_rows_on_card(cuda_device):
    """The exact medians of 2^17 rows (presorted columns, warm brackets
    from the second step) equal numpy's median of each cluster's rows
    under the same labels."""
    from heat_tpu_torch.cluster.kmeans import _assign
    from heat_tpu_torch.cluster.kmedians import KMedians

    n, f, k = 1 << 17, 8, 6
    rng = np.random.default_rng(27)
    centers = rng.normal(scale=4, size=(k, f)).astype(np.float32)
    data = (centers[rng.integers(0, k, n)] + rng.normal(size=(n, f))).astype(np.float32)
    arr = torch.from_numpy(data).to(cuda_device)
    c = torch.from_numpy(centers).to(cuda_device)
    for _ in range(3):
        got, labels, _ = KMedians._fit_loop(arr, c, -1.0, 1)
        lab = _assign(arr, c).cpu().numpy()
        want = np.stack([np.median(data[lab == j], axis=0) for j in range(k)]).astype(np.float32)
        np.testing.assert_array_equal(got.cpu().numpy(), want)
        c = got


@pytest.mark.gpu
def test_int64_matmul_2048_on_card_under_budget(cuda_device):
    """int64 2048 x 2048 @ 2048 x 2048 equals the exact product (values
    small enough that float64 holds every sum exactly on the host), and
    the product's memory beyond its operands stays under
    ``INT_MATMUL_BUDGET`` plus the output."""
    from heat_tpu_torch.core.linalg import basics

    n = 2048
    rng = np.random.default_rng(28)
    a, b = rng.integers(-1000, 1000, size=(n, n)), rng.integers(-1000, 1000, size=(n, n))
    comm = htt.TorchCommunication([cuda_device])
    x, y = htt.array(a, split=0, comm=comm), htt.array(b, comm=comm)
    assert x.dtype is htt.int64
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    z = x @ y
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    assert extra <= basics.INT_MATMUL_BUDGET + n * n * 8, extra
    want = (a.astype(np.float64) @ b.astype(np.float64)).astype(np.int64)
    np.testing.assert_array_equal(z.numpy(), want)
