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

The base layer: under each armed fault (NaN, Inf, the 1e36 saturation,
the bit-30 flip) the card's int8 ring at 4 and 8 positions is bitwise the
plain ring's on the CPU; a guarded ``allreduce_q`` reads one scalar from
the card and an unguarded one none; telemetry on or off launches the same
kernels with bitwise equal results; and ``start_trace(...,
device_trace_dir=...)`` writes a ``torch.profiler`` trace that names the
quantize, hop and dequantize kernels.

The stream: the pinned, double-buffered copies of ``stream_chunks`` give
the serial stream's chunks bit for bit (each the host rows, zero-padded)
with slab peaks 2 and 1; a checkpointed ``int8_block`` Lasso gd at 4
positions killed after its second snapshot and resumed is bitwise the
uninterrupted fit, the pair launching what the uninterrupted fit launches
(it skips where ``h5py``, which the snapshots are written with, is not
installed).

The serving fleet: a one-replica ``ProcFleet`` on the card, its replica a
process of ``chip_smoke.py --replica`` over ``chip_smoke.DiskRegistry``
(the card has no ``h5py``): the hello reports zero fuse and compile
misses with every bundle installed, the replica holds one CUDA context
(``nvidia-smi``), its ledger equals the in-process ``FleetEngine``
twin's, and kill -9 re-queues the whole un-acked set to a warm
replacement.

The capture rules: ``tests/test_torch_capture_rules.py``'s fixtures on
the card, each held to what the linter's finding on it means there
(``chip_smoke.capture_ground_truth``, phase 19's second part).

The port across processes: phase 20's spine at a small size, two
processes of ``chip_smoke.py --multihost`` on ``cuda:0`` over gloo
(``chip_smoke.phase_multihost``): ``int8_block`` results bitwise the
one-process run at four positions, each child's launches equal to its,
the ledgers summing to ``wire_model``, no CUDA context left behind.
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


# --------------------------------------------------------------------- #
# the array API's foundation on the card                                  #
# --------------------------------------------------------------------- #
def _card_and_cpu(cuda_device, positions: int = 1):
    return (htt.TorchCommunication([cuda_device] * positions), htt.TorchCommunication(["cpu"] * positions))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["int32", "int64", "int8", "uint8"])
def test_integer_division_by_zero_gives_numpys_values_on_card(cuda_device, dtype):
    """torch on CUDA returns its own values for a zero divisor (the CPU
    raises); the port masks them to numpy's."""
    num = np.array([7, -7, 5, 0, 1, -100, 3, 9], np.int64)
    den = np.array([0, 2, -3, 0, 0, 0, 1, -2], np.int64)
    if dtype == "uint8":
        num, den = np.abs(num), np.abs(den)
    num, den = num.astype(dtype), den.astype(dtype)
    card, _ = _card_and_cpu(cuda_device, 4)
    with np.errstate(divide="ignore", invalid="ignore"):
        for name, fn in (("floordiv", np.floor_divide), ("mod", np.remainder), ("fmod", np.fmod)):
            got = getattr(htt, name)(htt.array(num, split=0, comm=card), htt.array(den, split=0, comm=card))
            assert got.larray.is_cuda and got.dtype.__name__ == dtype
            np.testing.assert_array_equal(got.numpy(), fn(num, den), err_msg=name)
            by_zero = getattr(htt, name)(htt.array(num, comm=card), 0).numpy()
            np.testing.assert_array_equal(by_zero, fn(num, 0 * num))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_float_division_by_zero_gives_numpys_values_on_card(cuda_device, dtype):
    num = np.array([1.5, -2.5, 0.0, np.nan, np.inf, -np.inf, 3.0, -0.0], dtype)
    den = np.array([0.0, 0.0, 0.0, 0.0, 0.0, -0.0, -0.0, 0.0], dtype)
    card, _ = _card_and_cpu(cuda_device)
    with np.errstate(divide="ignore", invalid="ignore"):
        for name, fn in (("floordiv", np.floor_divide), ("mod", np.remainder), ("fmod", np.fmod)):
            got = getattr(htt, name)(htt.array(num, comm=card), htt.array(den, comm=card)).numpy()
            np.testing.assert_array_equal(got, fn(num, den), err_msg=name)
            assert (np.signbit(got) == np.signbit(fn(num, den)))[~np.isnan(got)].all(), name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["int32", "int64", "int8", "uint8", "int16"])
def test_shifts_past_the_width_on_card_equal_the_cpu(cuda_device, dtype):
    """Counts outside [0, width) give 0 (left) and the sign fill (right)
    on the card as on the CPU, whatever the device's shift does."""
    bits = np.iinfo(dtype).bits
    rng = np.random.default_rng(40)
    a = rng.integers(0 if dtype == "uint8" else -100, 100, size=64).astype(dtype)
    counts = np.resize(np.array([0, 1, bits - 1, bits, bits + 1, 40, 2 * bits, 100, -1, -bits]), 64)
    counts = counts.astype(dtype) if dtype != "uint8" else np.abs(counts).astype(dtype)
    card, cpu = _card_and_cpu(cuda_device)
    for fn in ("left_shift", "right_shift"):
        got = getattr(htt, fn)(htt.array(a, comm=card), htt.array(counts, comm=card)).numpy()
        want = getattr(htt, fn)(htt.array(a, comm=cpu), htt.array(counts, comm=cpu)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=fn)
        out_of_range = (counts.astype(np.int64) >= bits) | (counts.astype(np.int64) < 0)
        fill = 0 if fn == "left_shift" else np.where(a < 0, -1, 0)
        np.testing.assert_array_equal(got[out_of_range], np.broadcast_to(fill, a.shape)[out_of_range])


@pytest.mark.gpu
@pytest.mark.parametrize("args", [(0.1, 7.3, 11), (-3, 2, 500_000), (5, -5, 1001), (-7, 3, 174),
                                  (17.5, -2.25, 173)])
@pytest.mark.parametrize("dtype", ["float32", "float64", "float16"])
def test_linspace_and_logspace_on_card_equal_the_cpu(cuda_device, args, dtype):
    """The float64 grid (with its emulated FMAs) rounds alike on the card
    and the CPU, so linspace is bitwise the CPU's (and through it the
    reference's); logspace's float64 power may differ from the CPU's in
    its last float64 bit, which moves the float32 rounding at no point of
    these grids."""
    card, cpu = _card_and_cpu(cuda_device)
    kw = {"dtype": getattr(htt, dtype)}
    for endpoint in (True, False):
        got = htt.linspace(*args, endpoint=endpoint, comm=card, **kw)
        want = htt.linspace(*args, endpoint=endpoint, comm=cpu, **kw)
        assert got.larray.is_cuda
        assert torch.equal(got.larray.cpu(), want.larray)
    lg = htt.logspace(*args, comm=card).larray.cpu()
    assert torch.equal(lg, htt.logspace(*args, comm=cpu).larray)


@pytest.mark.gpu
def test_float16_rounds_once_on_the_card(cuda_device):
    """float64 data and Python floats reach float16 on the card rounded
    once, as numpy rounds them: values just off a float16 tie, where
    rounding through float32 first lands on the tie."""
    base = np.array([1.0, 2.0, -3.0, 1000.0, 6.1e-5, 3e-7, -0.5, 60000.0], np.float16)
    half = np.spacing(np.abs(base)).astype(np.float64) / 2
    b = base.astype(np.float64)
    nudge = np.maximum(np.abs(b), 2.0 ** -24) * 2.0 ** -40
    x = np.concatenate([b + np.sign(b) * (half + nudge), b + np.sign(b) * (half - nudge)])
    want = x.astype(np.float16)
    assert not np.array_equal(x.astype(np.float32).astype(np.float16), want)
    card = htt.TorchCommunication([cuda_device] * 4)
    got = htt.array(x, split=0, comm=card).astype(htt.float16)
    assert got.larray.is_cuda
    np.testing.assert_array_equal(got.numpy().view(np.int16), want.view(np.int16))
    got = htt.array(x, dtype=htt.float16, split=0, comm=card).numpy()
    np.testing.assert_array_equal(got.view(np.int16), want.view(np.int16))
    zeros = htt.zeros((3,), dtype=htt.float16, comm=card)
    for v, w in zip(x.tolist(), want):
        for t in (htt.full((3,), v, dtype=htt.float16, comm=card), zeros + v, v - zeros):
            np.testing.assert_array_equal(t.numpy().view(np.int16), np.full(3, w).view(np.int16))


# --------------------------------------------------------------------- #
# slice 8: sort, take, array keys, unique, topk, histogram on the card    #
# --------------------------------------------------------------------- #
def _on(dev, p):
    return htt.TorchCommunication([dev] * p), htt.TorchCommunication(["cpu"] * p)


def _bits(t: np.ndarray) -> np.ndarray:
    return t.view(f"u{t.itemsize}") if t.dtype.kind == "f" else t


def _zeros_nan(n: int, dtype) -> np.ndarray:
    x = np.random.default_rng(n).integers(-3, 4, size=n).astype(dtype)
    x[::5], x[1::5], x[2::7] = 0.0, -0.0, np.nan
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(61,), (61, 2), (61, 9)])
@pytest.mark.parametrize("dtype", ["float32", "float64", "float16", "bfloat16"])
def test_sort_nan_and_signed_zeros_on_card_bitwise_the_cpu(cuda_device, shape, dtype):
    """The three routes (1-D ring, narrow ring, resplit) at 4 positions."""
    x = _zeros_nan(int(np.prod(shape)), "float32").reshape(shape)
    card, cpu = _on(cuda_device, 4)
    kw = {"dtype": getattr(htt, dtype)}
    t, c = htt.array(x, split=0, comm=card, **kw), htt.array(x, split=0, comm=cpu, **kw)
    for desc in (False, True):
        (tv, ti), (cv, ci) = htt.sort(t, axis=0, descending=desc), htt.sort(c, axis=0, descending=desc)
        assert tv.larray.is_cuda
        np.testing.assert_array_equal(ti.numpy(), ci.numpy())
        np.testing.assert_array_equal(_bits(tv.numpy()), _bits(cv.numpy()))
        if dtype == "float32":  # numpy's stable order, NaN last both ways
            want = np.argsort(-x if desc else x, axis=0, kind="stable")
            np.testing.assert_array_equal(ti.numpy(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("ring", [False, True])
def test_out_of_range_and_negative_array_keys_on_card(cuda_device, monkeypatch, ring):
    """Clamped in a gather, dropped in a scatter, negatives wrapped, and no
    device-side assert (a later kernel still runs)."""
    from heat_tpu_torch.core import dndarray as dnd

    monkeypatch.setattr(dnd, "_RING_INDEX_MIN", 0 if ring else 1 << 62)
    x = np.arange(40 * 3, dtype=np.float32).reshape(40, 3)
    card, _ = _on(cuda_device, 4)
    t = htt.array(x, split=0, comm=card)
    keys = np.array([45, -1, -40, -41, 2**40, 3], np.int64)
    np.testing.assert_array_equal(t[keys].numpy(), x[[39, 39, 0, 0, 39, 3]])
    np.testing.assert_array_equal(t[np.array([-128, 127, 5], np.int8)].numpy(), x[[0, 39, 5]])
    t[np.array([44, -50, 7, -2], np.int64)] = -1.0
    want = x.copy()
    want[[7, 38]] = -1.0
    np.testing.assert_array_equal(t.numpy(), want)
    t[[0, 5], 1] = 9.0
    want[[0, 5], 1] = 9.0
    np.testing.assert_array_equal(t.numpy(), want)
    torch.cuda.synchronize()
    assert float((t.larray * 2).sum().item()) == float((want * 2).sum())


@pytest.mark.gpu
def test_topk_ties_on_card(cuda_device):
    card, cpu = _on(cuda_device, 4)
    x = np.array([[3, 1, 3, 2, 3, 1], [0, 0, 5, 5, -1, 5]] * 3, np.float32)
    x[0, 1], x[1, 0], x[1, 1] = np.nan, -0.0, 0.0
    for dim in (0, 1):
        for largest in (True, False):
            (tv, ti) = htt.topk(htt.array(x, split=0, comm=card), 3, dim=dim, largest=largest)
            (cv, ci) = htt.topk(htt.array(x, split=0, comm=cpu), 3, dim=dim, largest=largest)
            np.testing.assert_array_equal(ti.numpy(), ci.numpy())
            np.testing.assert_array_equal(_bits(tv.numpy()), _bits(cv.numpy()))
    assert htt.topk(htt.array([3, 1, 3, 2, 3, 1], comm=card), 3)[1].numpy().tolist() == [0, 2, 4]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_histogram_edge_values_on_card(cuda_device, dtype):
    """Values on the edges: the last edge in the last bin, each inner edge
    in the bin it opens, NaN in none; counts and edges equal the CPU's."""
    card, cpu = _on(cuda_device, 4)
    x = np.concatenate([np.arange(-5, 6), np.linspace(-5, 5, 1001), [np.nan]]).astype(dtype)
    for bins, rng in ((10, (-5, 5)), (7, None), (100, None)):
        data = x if rng else x[:-1]  # the range of data with a NaN is NaN
        h, e = htt.histogram(htt.array(data, split=0, comm=card), bins=bins, range=rng)
        hc, ec = htt.histogram(htt.array(data, split=0, comm=cpu), bins=bins, range=rng)
        np.testing.assert_array_equal(h.numpy(), hc.numpy())
        np.testing.assert_array_equal(_bits(e.numpy()), _bits(ec.numpy()))
    h, _ = htt.histogram(htt.array(x, split=0, comm=card), bins=10, range=(-5, 5))
    assert h.numpy()[-1] == 2 + 101 and h.numpy().sum() == x.size - 1  # [4, 5], both ends in


@pytest.mark.gpu
def test_unique_row_hash_of_96_columns_on_card_bitwise_the_cpu(cuda_device):
    from heat_tpu_torch.core import manipulations as manip

    rng = np.random.default_rng(11)
    base = (rng.normal(size=(40, 32)) > 0).astype(np.int8)
    x = np.concatenate([base] * 3, axis=1)[rng.integers(0, 40, size=999)]
    card, cpu = _on(cuda_device, 4)
    words = manip._row_words(torch.from_numpy(x).to(cuda_device))
    for seed in range(2):
        for a, b in zip(manip._hash_rows(words, seed), manip._hash_rows(words.cpu(), seed)):
            assert torch.equal(a.cpu(), b)
    (tu, ti), (cu, ci) = (htt.unique(htt.array(x, split=0, comm=card), axis=0, return_inverse=True),
                          htt.unique(htt.array(x, split=0, comm=cpu), axis=0, return_inverse=True))
    np.testing.assert_array_equal(tu.numpy(), cu.numpy())
    np.testing.assert_array_equal(ti.numpy(), ci.numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("src", ["float32", "float64"])
def test_half_nan_converts_as_the_reference_on_card(cuda_device, src):
    """The card's own conversion writes 0x7FFF for a NaN; the port writes
    the reference's NaN, as on the CPU."""
    payload = np.array([0x7F800001, 0xFFA00000, 0x7FC12345], np.uint32).view(np.float32)
    x = np.concatenate([np.array([np.nan, -np.nan, 1.5], np.float32), payload]).astype(src)
    card, cpu = _on(cuda_device, 1)
    for half in (htt.bfloat16, htt.float16):
        got = htt.array(x, dtype=half, comm=card).larray.view(torch.int16).cpu()
        assert torch.equal(got, htt.array(x, dtype=half, comm=cpu).larray.view(torch.int16))
    assert htt.array(x, dtype=htt.bfloat16, comm=card).larray.view(torch.int16).cpu().tolist()[:3] == [
        0x7FC0, -0x40, 0x3FC0]


# --------------------------------------------------------------------- #
# the 2-D grid of positions: SUMMA layouts, CAQR and QDWH on the card    #
# --------------------------------------------------------------------- #
GRID_MESHES = [(2, 2), (2, 4)]
GRID_LAYOUTS = [((0, 1), (0, 1)), ((0, None), (None, 1)), ((None, 1), (0, None))]


def _grids(device, mesh):
    n = mesh[0] * mesh[1]
    return htt.grid_comm(mesh, [device] * n), htt.grid_comm(mesh, ["cpu"] * n)


@pytest.mark.gpu
@pytest.mark.parametrize("mesh", GRID_MESHES)
@pytest.mark.parametrize("sa,sb", GRID_LAYOUTS)
@pytest.mark.parametrize("m,k,n", [(7, 13, 9), (64, 96, 80)])
def test_grid_summa_layouts_on_card(cuda_device, mesh, sa, sb, m, k, n):
    """The three grid layouts on the card: ``splits=(0, 1)``, within 1e-5
    of the port's CPU result and of float64 (float32 sums of k terms)."""
    card, cpu = _grids(cuda_device, mesh)
    rng = np.random.default_rng(29)
    a, b = rng.normal(size=(m, k)).astype(np.float32), rng.normal(size=(k, n)).astype(np.float32)
    got = htt.array(a, splits=sa, comm=card) @ htt.array(b, splits=sb, comm=card)
    want = htt.array(a, splits=sa, comm=cpu) @ htt.array(b, splits=sb, comm=cpu)
    assert got.splits == want.splits == (0, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), a.astype(np.float64) @ b, rtol=1e-5, atol=1e-5)
    assert torch.get_float32_matmul_precision() == "highest"


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(19, 10), (96, 24), (256, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cusolver_householder_signs_match_lapack(cuda_device, shape, dtype):
    """cuSOLVER's QR on the card carries LAPACK's Householder signs on the
    CPU (R's diagonal), singly and batched as the grid CAQR calls it."""
    x = torch.from_numpy(np.random.default_rng(22).normal(size=(3,) + shape)).to(dtype)
    _, r_cpu = torch.linalg.qr(x)
    _, r_card = torch.linalg.qr(x.to(cuda_device))
    _, r_one = torch.linalg.qr(x[0].to(cuda_device))
    d_cpu = torch.diagonal(r_cpu, dim1=-2, dim2=-1).sign()
    assert torch.equal(torch.diagonal(r_card, dim1=-2, dim2=-1).sign().cpu(), d_cpu)
    assert torch.equal(torch.diagonal(r_one).sign().cpu(), d_cpu[0])


@pytest.mark.gpu
@pytest.mark.parametrize("mesh", GRID_MESHES)
@pytest.mark.parametrize("m,n", [(19, 10), (33, 7), (256, 64)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_grid_qr_on_card_matches_the_cpu(cuda_device, mesh, m, n, dtype):
    """The grid CAQR on the card against the port's CPU result, unnormalised
    (the same Householder signs): Q and R within 1e-5 of their largest
    entry in float32 (1e-12 in float64), R upper triangular, the
    reconstruction and orthonormality as phase 7 holds them."""
    card, cpu = _grids(cuda_device, mesh)
    a = np.random.default_rng(31).standard_normal((m, n)).astype(dtype)
    q, r = htt.linalg.qr(htt.array(a, splits=(0, 1), comm=card))
    qc, rc = htt.linalg.qr(htt.array(a, splits=(0, 1), comm=cpu))
    assert q.splits == (0, 1) and r.splits == (None, 1)
    tol = 1e-5 if dtype == np.float32 else 1e-12
    for got, want in ((q, qc), (r, rc)):
        w = want.numpy()
        assert np.abs(got.numpy() - w).max() <= tol * np.abs(w).max()
    res_tol, orth_tol = _tols(torch.float32 if dtype == np.float32 else torch.float64)
    qv, rv = q.numpy().astype(np.float64), r.numpy().astype(np.float64)
    assert np.linalg.norm(qv @ rv - a) / np.linalg.norm(a) <= res_tol
    assert np.abs(qv.T @ qv - np.eye(n)).max() <= orth_tol
    assert not np.tril(rv, -1).any()


@pytest.mark.gpu
@pytest.mark.parametrize("mesh", GRID_MESHES)
@pytest.mark.parametrize("m,n", [(24, 8), (19, 10), (8, 16), (256, 64)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_grid_svd_on_card_matches_the_cpu(cuda_device, mesh, m, n, dtype):
    """The QDWH SVD on the card against the port's CPU result: the same
    iteration count, S within 1e-5 of the largest singular value in float32
    (1e-12 in float64), and the reference's gates against numpy's float64
    SVD (S within 50 eps s_max, ``U S V^T - A`` within 100 eps s_max, U and
    V orthonormal within 200 eps)."""
    card, cpu = _grids(cuda_device, mesh)
    svd_mod = importlib.import_module("heat_tpu_torch.core.linalg.svd")
    a = np.random.default_rng(31).standard_normal((m, n)).astype(dtype)
    x, xc = htt.array(a, splits=(0, 1), comm=card), htt.array(a, splits=(0, 1), comm=cpu)
    u, s, v = (t.numpy().astype(np.float64) for t in htt.linalg.svd(x))
    sc = htt.linalg.svd(xc).S.numpy()
    s64 = np.linalg.svd(a.astype(np.float64), compute_uv=False)
    eps, smax = np.finfo(dtype).eps, float(s64[0])
    assert np.abs(s - sc).max() <= (1e-5 if dtype == np.float32 else 1e-12) * smax
    assert np.abs(s - s64).max() <= 50 * eps * smax
    assert np.abs(u @ np.diag(s) @ v.T - a).max() <= 100 * eps * smax
    k = min(m, n)
    assert np.abs(u.T @ u - np.eye(k)).max() <= 200 * eps
    assert np.abs(v.T @ v - np.eye(k)).max() <= 200 * eps
    if m >= n:
        htype = htt.float32 if dtype == np.float32 else htt.float64
        assert svd_mod._grid_svd_parts(x, htype)[3] == svd_mod._grid_svd_parts(xc, htype)[3]


# --------------------------------------------------------------------- #
# the base layer on the card: faults through the kernels, the guard's   #
# host read, telemetry's disabled mode, the profiler's device trace     #
# --------------------------------------------------------------------- #
FAULTS = [("nonfinite", {}), ("nonfinite", {"value": float("inf")}), ("saturate", {}),
          ("bitflip", {"seed": 3})]


@pytest.mark.gpu
@pytest.mark.parametrize("p", [4, 8])
@pytest.mark.parametrize("kind,kw", FAULTS, ids=str)
def test_faulted_ring_on_card_bitwise_plain_ring(cuda_device, p, kind, kw):
    """Under each armed plan the card's ring (B1, the hop, B2) is bitwise
    the plain ring's on the CPU on the same corrupted input: the seams
    corrupt before the kernels and after them, never inside."""
    from heat_tpu_torch.resilience import faults, guards

    x = torch.from_numpy(np.random.default_rng(p).normal(size=(p, 64 * BLOCK)).astype(np.float32))
    card = htt.TorchCommunication([cuda_device] * p)
    cpu = htt.TorchCommunication(["cpu"] * p)
    with faults.inject(kind, nth=1, **kw):
        got = tcq.allreduce_q(x.to(cuda_device), comm=card, precision="int8_block")
    with faults.inject(kind, nth=1, **kw):
        want = tcq.allreduce_q(x, comm=cpu, precision="int8_block")
    assert _bitwise(got.cpu(), want)
    assert kind == "bitflip" or not guards.is_healthy(got)


def _scalar_reads(fn) -> int:
    """Device-to-host scalar reads (``aten::_local_scalar_dense``) of one
    call of ``fn`` under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sum(int(e.count) for e in prof.key_averages() if e.key == "aten::_local_scalar_dense")


@pytest.mark.gpu
def test_guard_reads_one_scalar_a_call(cuda_device):
    from heat_tpu_torch.resilience import guards

    comm = htt.TorchCommunication([cuda_device] * 4)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(4, 64 * BLOCK)).astype(np.float32))
    x = x.to(cuda_device)
    call = lambda: tcq.allreduce_q(x, comm=comm, precision="int8_block")  # noqa: E731
    assert _scalar_reads(call) == 0
    for policy in ("raise", "warn", "degrade"):
        with guards.guard(policy):
            assert _scalar_reads(call) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("p", [4, 8])
def test_disabled_telemetry_keeps_the_launch_counts(cuda_device, p):
    from heat_tpu_torch import telemetry

    comm = htt.TorchCommunication([cuda_device] * p)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(p, 64 * BLOCK)).astype(np.float32))
    x = x.to(cuda_device)
    counted = (tcq.quantize_blocks, tcq.dequantize_add_quantize_blocks, tcq.dequantize_blocks,
               tcq.dequantize_fma_blocks)
    results, counts = [], []
    was = telemetry.is_enabled()
    try:
        for on in (False, True):
            (telemetry.enable if on else telemetry.disable)()
            for fn in counted:
                fn.launches = 0
            results.append(tcq.allreduce_q(x, comm=comm, precision="int8_block"))
            counts.append([fn.launches for fn in counted])
    finally:
        (telemetry.enable if was else telemetry.disable)()
        telemetry.reset()
    assert counts[0] == counts[1] == [1, p - 1, 1, 0]
    assert _bitwise(results[0], results[1])


@pytest.mark.gpu
def test_device_trace_names_the_blockquant_kernels(cuda_device, tmp_path):
    from heat_tpu_torch import telemetry
    from heat_tpu_torch.telemetry import export

    comm = htt.TorchCommunication([cuda_device] * 4)
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(4, 1 << 18)).astype(np.float32))
    x = x.to(cuda_device)
    tcq.allreduce_q(x, comm=comm, precision="int8_block")
    torch.cuda.synchronize()
    was = telemetry.is_enabled()
    try:
        export.start_trace(str(tmp_path / "host.json"), device_trace_dir=str(tmp_path / "dev"))
        try:
            tcq.allreduce_q(x, comm=comm, precision="int8_block")
        finally:
            export.stop_trace()
    finally:
        (telemetry.enable if was else telemetry.disable)()
        telemetry.reset()
    (dev,) = list((tmp_path / "dev").iterdir())
    names = chip_smoke.trace_kernel_names(dev.read_text())
    assert set(chip_smoke.TRACE_SYMBOLS) <= names


@pytest.mark.gpu
@pytest.mark.parametrize("rows,mb", [(103, 16), (20_000, 2_500)])
def test_pinned_prefetch_chunks_on_card_bitwise_the_serial_stream(cuda_device, rows, mb):
    """The stream's pinned, double-buffered copies give the serial
    stream's chunks bit for bit, each the host rows zero-padded, with at
    most 2 slabs live (1 without prefetch); a kernel queued on the
    consuming stream behind each chunk sees the chunk's bytes even while
    the next chunk's copy runs."""
    from heat_tpu_torch.io import stream

    x = np.random.default_rng(rows).normal(size=(rows, 7)).astype(np.float32)
    comm = htt.TorchCommunication([cuda_device] * 4)
    h = -(-rows // mb)
    runs = {}
    try:
        for mode in ("off", "on"):
            stream.set_prefetch(mode)
            stream.reset_slab_peak()
            got = []
            for (chunk,), nv in stream.stream_chunks(stream.ArraySource(x), mb, 0, 2 * h, comm=comm):
                got.append((chunk * 1.0, nv))  # read on the consuming stream
            runs[mode] = (got, stream.slab_peak())
    finally:
        stream.set_prefetch("auto")
    assert (runs["off"][1], runs["on"][1]) == (1, 2)
    width = -(-mb // 4) * 4
    for step, ((a, na), (b, nb)) in enumerate(zip(runs["off"][0], runs["on"][0])):
        lo = (step % h) * mb
        assert na == nb == min(rows, lo + mb) - lo
        want = np.zeros((width, 7), np.float32)
        want[:na] = x[lo:lo + na]
        assert _bitwise(a, b)
        assert _bitwise(a.cpu(), torch.from_numpy(want))
    assert stream.prefetch_enabled(cuda_device)


@pytest.mark.gpu
def test_resumed_int8_lasso_on_card_is_bitwise_and_launches_the_same(cuda_device, tmp_path):
    """A checkpointed int8_block Lasso gd at 4 positions, killed after its
    second snapshot and resumed, is bitwise the uninterrupted fit and the
    pair launches exactly what the uninterrupted fit launches."""
    from heat_tpu_torch.resilience import faults
    from heat_tpu_torch.resilience.faults import Preempted

    if not htt.io.supports_hdf5():
        pytest.skip("h5py is not installed: loop snapshots are HDF5")
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4096, 12)).astype(np.float32)
    y = (x @ rng.normal(size=12) + 0.1 * rng.normal(size=4096)).astype(np.float32)
    comm = htt.TorchCommunication([cuda_device] * 4)
    X, Y = htt.array(x, split=0, comm=comm), htt.array(y, split=0, comm=comm)
    counted = (tcq.quantize_blocks, tcq.dequantize_add_quantize_blocks, tcq.dequantize_blocks,
               tcq.dequantize_fma_blocks)
    path = str(tmp_path / "ls.h5")

    def fit(**kw):
        return htt.regression.Lasso(lam=0.05, max_iter=40, tol=-1.0, solver="gd", **kw)

    counts = []
    with tcq.collective_precision("int8_block"):
        for fn in counted:
            fn.launches = 0
        clean = fit().fit(X, Y)
        counts.append([fn.launches for fn in counted])
        for fn in counted:
            fn.launches = 0
        with pytest.raises(Preempted):
            with faults.inject("preempt", site="iteration", nth=2):
                fit(checkpoint_every=10, checkpoint_path=path).fit(X, Y)
        resumed = fit(checkpoint_every=10, checkpoint_path=path).fit(X, Y, resume=True)
        counts.append([fn.launches for fn in counted])
    assert counts[0] == counts[1] == [80, 120, 40, 40]
    assert resumed.n_iter == 40
    assert _bitwise(resumed.theta.larray, clean.theta.larray)


# --------------------------------------------------------------------- #
# htt.fuse: one CUDA-graph replay a call                                  #
# --------------------------------------------------------------------- #
def _fused_pipeline(a, b):
    c = a + b
    d = c - a
    return htt.minimum(htt.sqrt(htt.abs(d)) + c, b * 2.0)


def _fused_moments(a):
    return htt.mean(a, axis=0), htt.std(a, axis=0)


def _reads_a_device_scalar(a):
    return a * float(a.larray.sum().item())


def _forces_a_value(a):
    return a * float(a.sum())


@pytest.mark.gpu
@pytest.mark.parametrize("shape,split", [((4, 6), 0), ((7, 5), 1), ((1024, 33), None)])
def test_fused_capture_is_bitwise_eager_and_outputs_fresh(cuda_device, shape, split):
    """The captured program's result is bitwise the eager pipeline's, a
    later call's operands are copied in (the first result is untouched),
    and a second key (another shape) is another program."""
    comm = htt.TorchCommunication([cuda_device] * 4)
    rng = np.random.default_rng(7)
    mk = lambda: htt.array(rng.standard_normal(shape).astype(np.float32), split=split, comm=comm)  # noqa: E731
    a, b, c, d = mk(), mk(), mk(), mk()
    htt.fuse.clear_cache()
    fused = htt.fuse(_fused_pipeline)
    r1 = fused(a, b)
    keep = r1.larray.clone()
    assert _bitwise(r1.larray, _fused_pipeline(a, b).larray)
    r2 = fused(c, d)
    assert _bitwise(r1.larray, keep)
    assert _bitwise(r2.larray, _fused_pipeline(c, d).larray)
    assert htt.fuse.cache_size() == 1


@pytest.mark.gpu
def test_fused_int8_moments_bitwise_eager_and_launch_counts(cuda_device):
    """mean/std along the split under int8_block at 4 positions: the
    capture is bitwise the eager call; the warm-up and the capture each
    launch what one eager call launches."""
    comm = htt.TorchCommunication([cuda_device] * 4)
    x = htt.array(np.random.default_rng(3).standard_normal((64, 4096)).astype(np.float32),
                  split=0, comm=comm)
    counted = (tcq.quantize_blocks, tcq.dequantize_add_quantize_blocks, tcq.dequantize_blocks)
    with tcq.collective_precision("int8_block"):
        for f in counted:
            f.launches = 0
        eager = _fused_moments(x)
        once = [f.launches for f in counted]
        fused = htt.fuse(_fused_moments)
        first = fused(x)
        after_build = [f.launches for f in counted]
        again = fused(x)
        after_replay = [f.launches for f in counted]
    assert once == [2, 6, 2]
    assert after_build == [3 * n for n in once] and after_replay == after_build
    for e, f, g in zip(eager, first, again):
        assert _bitwise(e.larray, f.larray) and _bitwise(e.larray, g.larray)


@pytest.mark.gpu
def test_fused_capture_failure_raises(cuda_device):
    """A host read the capture cannot hold raises naming the pipeline; a
    value-forcing DNDarray call raises FuseTraceError; neither runs
    eagerly in its place."""
    comm = htt.TorchCommunication([cuda_device])
    x = htt.array(np.ones((8, 4), np.float32), split=0, comm=comm)
    with pytest.raises(RuntimeError, match="_reads_a_device_scalar") as err:
        htt.fuse(_reads_a_device_scalar)(x)
    assert not isinstance(err.value, htt.FuseTraceError)
    with pytest.raises(htt.FuseTraceError, match=r"float\(\)"):
        htt.fuse(_forces_a_value)(x)


@pytest.mark.gpu
def test_fused_library_predicts_bitwise_eager(cuda_device):
    """KMeans, GaussianNB and Lasso predicts and kurtosis/skew on the card,
    each captured program bitwise its program run eagerly."""
    from heat_tpu_torch.cluster import _kcluster
    from heat_tpu_torch.core import statistics as st
    from heat_tpu_torch.naive_bayes import gaussianNB as gnb
    from heat_tpu_torch.regression import lasso

    comm = htt.TorchCommunication([cuda_device])
    rng = np.random.default_rng(11)
    data = rng.standard_normal((2048, 8)).astype(np.float32)
    x = htt.array(data, split=0, comm=comm)
    km = htt.cluster.KMeans(n_clusters=4, init=htt.array(data[:4], comm=comm), max_iter=2).fit(x)
    nb = htt.naive_bayes.GaussianNB().fit(x, htt.array(rng.integers(0, 4, 2048), split=0, comm=comm))
    la = htt.regression.Lasso(max_iter=3).fit(x, htt.array(data[:, 0].copy(), split=0, comm=comm))
    theta, sigma, prior = (torch.as_tensor(t, device=cuda_device) for t in nb._fit_params())
    classes = torch.as_tensor(np.asarray(nb.classes_), device=cuda_device)
    pairs = [
        (km.predict(x), _kcluster._assign_program(x, km.cluster_centers_, km._metric)),
        (nb.predict(x), gnb._nb_predict_program(x, theta, sigma, prior, classes)),
        (nb.predict_proba(x), gnb._nb_proba_program(x, theta, sigma, prior)),
        (la.predict(x), lasso._lasso_predict_program(x, la.theta)),
        (htt.kurtosis(x, axis=0), st._kurtosis_program(x, 0, True, True)),
        (htt.skew(x, axis=0), st._skew_program(x, 0, True)),
    ]
    for fused, eager in pairs:
        assert _bitwise(fused.larray, eager.larray)


def _graph_pool_bytes() -> int:
    """Bytes reserved in graph memory pools (segments outside the caching
    allocator's default pool, which no eager op can use)."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) != (0, 0))


@pytest.mark.gpu
def test_fused_predicts_over_many_batch_sizes_keep_memory_bounded(cuda_device):
    """KMeans.predict on 24 row counts, in a shuffled order, builds 24
    programs, whose static inputs alone (over 600 MiB) would stay on the
    card in an unbounded cache.  Under a 256 MiB limit the cache never
    holds more than the limit: the graph pools' reservation and the live
    allocations stay under it, and once the caching allocator lets go of
    its free blocks the reserved memory is back under it too.  Every
    result is bitwise its eager program's."""
    from heat_tpu_torch.cluster import _kcluster

    comm = htt.TorchCommunication([cuda_device])
    rng = np.random.default_rng(21)
    rows = [200_000 + 4096 * int(i) for i in rng.permutation(24)]
    data = rng.standard_normal((max(rows), 32)).astype(np.float32)
    km = htt.cluster.KMeans(n_clusters=8, init=htt.array(data[:8], comm=comm), max_iter=2).fit(
        htt.array(data[:4096], split=0, comm=comm))
    xs = [htt.array(data[:n], split=0, comm=comm) for n in rows]
    static = sum(x.larray.numel() * 4 for x in xs)
    assert static > 600 << 20
    limit, slack = 256 << 20, 64 << 20
    prev = htt.fuse.set_cache_limit(limit)
    htt.fuse.clear_cache()
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        pools0, allocated0 = _graph_pool_bytes(), torch.cuda.memory_allocated(cuda_device)
        reserved0 = torch.cuda.memory_reserved(cuda_device)
        for x in xs:
            got = km.predict(x)
            want = _kcluster._assign_program(x, km.cluster_centers_, km._metric)
            assert _bitwise(got.larray, want.larray)
            del got, want
            assert htt.fuse.cache_bytes(cuda_device) <= limit
            assert _graph_pool_bytes() - pools0 <= limit + slack
            assert torch.cuda.memory_allocated(cuda_device) - allocated0 <= limit + slack
        assert htt.fuse.cache_size() < len(rows)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        assert torch.cuda.memory_reserved(cuda_device) - reserved0 <= limit + slack
    finally:
        htt.fuse.set_cache_limit(prev)
        htt.fuse.clear_cache()


# --------------------------------------------------------------------- #
# planned redistribution                                                 #
# --------------------------------------------------------------------- #
def _resplit_on(devices, data, src, dst, mesh=None):
    comm = htt.TorchCommunication(devices) if mesh is None else htt.grid_comm(mesh, devices)
    x = htt.array(data, split=src, comm=comm) if mesh is None else htt.array(data, splits=src, comm=comm)
    return htt.resplit(x, dst)


@pytest.mark.gpu
@pytest.mark.parametrize("p,src,dst,mesh,want", [
    (4, 0, 1, None, [1, 1]), (8, 1, 0, None, [1, 1]), (7, 0, 1, None, [1, 1]),
    (4, (0, 1), (1, 0), (2, 2), [2, 2]), (8, (0, None), (None, 0), (2, 4), [1, 1]),
])
def test_planned_int8_resplit_on_card_bitwise_its_cpu_plain_run(cuda_device, p, src, dst, mesh, want):
    """Under int8_block the planned resplit on the card launches B1 and B2
    once for each compressed split -> split stage, and its result equals
    the port's CPU run (the plain versions) bit for bit."""
    ragged = src == 0 or src == (0, None)  # a ragged destination axis pads; a source must divide
    data = np.random.default_rng(p).standard_normal((64 * p, 48 * p + 5 * ragged)).astype(np.float32)
    counted = (tcq.quantize_blocks, tcq.dequantize_blocks)
    with tcq.collective_precision("int8_block"):
        for f in counted:
            f.launches = 0
        got = _resplit_on([cuda_device] * p, data, src, dst, mesh)
        launches = [f.launches for f in counted]
        plain = _resplit_on(["cpu"] * p, data, src, dst, mesh)
    assert launches == want
    assert _bitwise(got._buffer.cpu(), plain._buffer)
    assert not np.array_equal(got.numpy(), data)


@pytest.mark.gpu
def test_exact_planned_resplit_on_card_is_the_input(cuda_device):
    data = np.random.default_rng(1).standard_normal((64, 300)).astype(np.float32)
    counted = (tcq.quantize_blocks, tcq.dequantize_blocks)
    for f in counted:
        f.launches = 0
    got = _resplit_on([cuda_device] * 4, data, 0, 1)
    assert [f.launches for f in counted] == [0, 0]
    assert got.split == 1 and np.array_equal(got.numpy(), data)


def _fused_resplit(a):
    return htt.resplit(a, 1) * 2.0


@pytest.mark.gpu
def test_policy_flip_recaptures_a_fused_resplit(cuda_device):
    """A fused program that resplits is captured once and replayed; a flip
    of the redistribution policy keys a new capture; inside the capture
    the resplit is exact (no plan, no kernel) even under int8_block."""
    from heat_tpu_torch.comm import redistribute as trd

    comm = htt.TorchCommunication([cuda_device] * 4)
    data = np.random.default_rng(2).standard_normal((64, 512)).astype(np.float32)
    x = htt.array(data, split=0, comm=comm)
    htt.fuse.clear_cache()
    fused = htt.fuse(_fused_resplit)
    with tcq.collective_precision("int8_block"):
        tcq.quantize_blocks.launches = 0
        first = fused(x)
        size = htt.fuse.cache_size()
        again = fused(x)
        assert htt.fuse.cache_size() == size
        with trd.redistribution("monolithic"):
            flipped = fused(x)
            assert htt.fuse.cache_size() == size + 1
        assert tcq.quantize_blocks.launches == 0
    for out in (first, again, flipped):
        assert np.array_equal(out.numpy(), data * 2.0)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_knn_ties_on_card_go_to_the_lowest_training_row(cuda_device, k):
    """ROADMAP C9's input on the card: the fused predict gives the
    reference's tie order (training row 0 for k = 1), as on the CPU."""
    train = np.array([[0, 0], [0, 0], [0, 0], [3, 3], [0, 0], [4, 4], [0, 0], [5, 5]], np.float32)
    labels = np.array([1, 0, 0, 1, 1, 1, 0, 0])
    query = np.zeros((8, 2), np.float32)
    got = []
    for dev in (cuda_device, torch.device("cpu")):
        comm = htt.TorchCommunication([dev])
        knn = htt.classification.KNN(htt.array(train, split=0, comm=comm),
                                     htt.array(labels, split=0, comm=comm), k)
        got.append(knn.predict(htt.array(query, split=0, comm=comm)).numpy())
    np.testing.assert_array_equal(got[0], got[1])
    if k == 1:
        assert (got[0] == 1).all()


@pytest.mark.gpu
@pytest.mark.parametrize("background", [False, True])
def test_served_predicts_on_card_bitwise_their_direct_twin(cuda_device, background):
    """The four fused predicts served by ``ServeEngine`` on the card (from
    ``chip_smoke.MemoryRegistry``: no ``h5py`` there), with the batches on
    the caller's thread or on the lanes' workers: every reply bitwise the
    unbatched direct predict, one dispatch a micro-batch."""
    from heat_tpu_torch.serve import ServeEngine

    comm = htt.TorchCommunication([cuda_device])
    rng = np.random.default_rng(17)
    data = rng.standard_normal((512, 6)).astype(np.float32)
    labels = rng.integers(0, 3, 512)
    x = htt.array(data, split=0, comm=comm)
    reg = chip_smoke.MemoryRegistry()
    reg.publish("t", "km", htt.cluster.KMeans(n_clusters=3, max_iter=3, random_state=0).fit(x))
    reg.publish("t", "nb", htt.naive_bayes.GaussianNB().fit(x, htt.array(labels, split=0, comm=comm)))
    reg.publish("t", "knn", htt.classification.KNN(x, htt.array(labels, split=0, comm=comm), 5))
    reg.publish("t", "lasso", htt.regression.Lasso(max_iter=5).fit(
        x, htt.array(data[:, 0].copy(), split=0, comm=comm)))
    prev = htt.core.communication._default_comm
    htt.use_comm(comm)
    eng = ServeEngine(reg, max_batch_rows=32, min_bucket=8, max_delay_s=0.005)
    try:
        if background:
            eng.start()
        for name in ("km", "nb", "knn", "lasso"):
            pays = [rng.standard_normal((r, 6)).astype(np.float32) for r in (1, 3, 5, 8, 2, 13, 7)]
            futs = [eng.submit("t", name, p) for p in pays]
            if not background:
                eng.flush()
            # every reply before the first direct call: the engine counts a
            # batch's dispatches process-wide, as the reference does
            replies = [f.result(timeout=60) for f in futs]
            for p, reply in zip(pays, replies):
                assert not reply.degraded
                assert chip_smoke.same_bytes(reply.value, eng.direct_predict("t", name, p)), name
        assert eng.stats()["dispatches_per_batch"] == 1.0
    finally:
        eng.close()
        htt.use_comm(prev)
        htt.fuse.clear_cache()


@pytest.mark.gpu
def test_procfleet_replica_on_card(cuda_device, tmp_path):
    """One replica process on the card: zero-miss hello, its CUDA context
    listed while it runs and gone after close, the ledger equal to the
    in-process twin's CRCs; kill -9 while its worker holds a request (a
    pinned straggle) re-queues all it held to a warm replacement."""
    import time
    import zlib

    from heat_tpu_torch.core import communication as tcomm
    from heat_tpu_torch.resilience import faults
    from heat_tpu_torch.serve import FleetEngine, ProcFleet, ReplicaProc, ServeEngine

    dev = torch.device("cuda", 0)
    kw = dict(max_batch_rows=32, min_bucket=8)
    prev, prev_argv = tcomm._default_comm, ReplicaProc._child_argv
    htt.use_comm(htt.TorchCommunication([dev]))
    ReplicaProc._child_argv = chip_smoke.replica_argv()
    try:
        base = chip_smoke.compute_apps()
        rng = np.random.default_rng(19)
        data = rng.standard_normal((2000, 8)).astype(np.float32)
        reg = chip_smoke.DiskRegistry(str(tmp_path))
        reg.publish("t", "km", htt.cluster.KMeans(n_clusters=4, max_iter=3, random_state=0).fit(
            htt.array(data, split=0)))
        src = ServeEngine(reg, **kw)
        bundles = src.export_warm("t", "km", version=1)
        src.close()
        reg.publish_executables("t", "km", 1, bundles)
        pays = [rng.standard_normal((r, 8)).astype(np.float32) for r in (1, 3, 5, 8, 13, 2, 32, 7)]
        twin = FleetEngine(reg, warm_models=[("t", "km", 1)], **kw)
        crcs = [zlib.crc32(twin.predict("t", "km", p, version=1).value.tobytes()) for p in pays]
        twin.close()
        with ProcFleet(str(tmp_path), n_replicas=1, warm_models=[("t", "km", 1)], **kw) as pf:
            (rep,) = pf.alive()
            assert (rep.hello["fuse_misses"], rep.hello["compile_misses"]) == (0, 0)
            assert rep.hello["installed"] == len(bundles)
            assert chip_smoke.check_contexts(base, [rep.pid], "card test") in ("pids", "count")
            for i, p in enumerate(pays):
                pf.submit("t", "km", p, version=1, request_id=f"a{i}")
            pf.flush()
            assert [c for _, c in pf.ledger()] == crcs
            with faults.inject("slow_replica", site=f"replica{rep.index}", nth=1, delay=3.0):
                for i, p in enumerate(pays):
                    pf.submit("t", "km", p, version=1, request_id=f"k{i}")
                time.sleep(0.5)  # the worker holds k0; the rest wait in its outbox
                pf.kill_replica(rep.index)
                rep.proc.wait(timeout=30)
                pf.flush(timeout_s=300)
            stats = pf.stats()
            assert (stats["requeued"], stats["replica_losses"], stats["respawns"]) == (len(pays), 1, 1)
            disp = [d for d in pf.disposition_ledger() if d[0].startswith("k")]
            assert [d[1] for d in disp] == ["requeued-ok"] * len(pays)
            assert [d[2] for d in disp] == crcs
            (new,) = pf.alive()
            assert (new.hello["fuse_misses"], new.hello["compile_misses"]) == (0, 0)
            chip_smoke.check_contexts(base, [new.pid], "card test after kill -9")
        chip_smoke.check_contexts(base, [], "card test after close")
    finally:
        ReplicaProc._child_argv = prev_argv
        htt.use_comm(prev)
        htt.fuse.clear_cache()


@pytest.mark.gpu
def test_autoshard_bench_pipeline_solved_bitwise_its_hand_twin(cuda_device, tmp_path):
    """``htt.autoshard`` of the reference benchmark's pipeline at 4
    positions on the card: bitwise its hand twin (``htt.fuse`` of the same
    function) in values and split metadata, one elided hop, and one
    ``cudaGraphLaunch`` a call each."""
    mod = chip_smoke.autoshard_module(str(tmp_path))
    comm = htt.TorchCommunication([cuda_device] * 4)
    auto = htt.autoshard(mod._autoshard_bench_pipeline)
    hand = htt.fuse(mod._autoshard_bench_pipeline)
    try:
        plan = auto.plan(comm)
        assert plan is not None and sum(d["elide"] for d in plan["decisions"]) == 1
        got, want = auto(comm), hand(comm)
        chip_smoke.on_card(cuda_device, got + want, "card test")
        assert chip_smoke.twin_equal(got, want)
        for prog in (auto, hand):
            _, _, graphs, _ = chip_smoke.replay_profile(torch, lambda: prog(comm), tries=1)
            assert graphs == 1
    finally:
        htt.fuse.clear_cache()


@pytest.mark.gpu
def test_capture_rules_ground_truth_on_card(cuda_device):
    """``tests/test_torch_capture_rules.py`` on the card, as
    ``chip_smoke.py`` phase 19 holds it: the SPMD202 positives' captures
    refused (in a process of their own), the SPMD201/205 positives frozen
    at capture, the SPMD210 positive observed at capture only, the
    negatives one ``cudaGraphLaunch`` a call and bitwise eager."""
    try:
        metrics = chip_smoke.capture_ground_truth(torch, cuda_device, chip_smoke.card_line())
    finally:
        htt.fuse.clear_cache()
    mod = chip_smoke.capture_rules_module()
    assert sorted(metrics["capture_refused"]) == sorted(mod.REFUSED)
    assert sorted(metrics["capture_clean"]) == sorted(mod.CLEAN)


@pytest.mark.gpu
def test_two_processes_on_card(cuda_device):
    """Phase 20 at 8192 rows: two processes of two positions each on the
    card, held to the one-process run as ``chip_smoke.py`` holds them."""
    launches, metrics = chip_smoke.phase_multihost(
        torch, htt, tcq, torch.device("cuda", 0), chip_smoke.card_line(), rows=8192, payload=8192,
        reps=3)
    assert (metrics["phase20_backend"], metrics["phase20_transport"]) == (
        "gloo", "gloo, staged through host memory")
    assert metrics["phase20_launches_per_child"]["blockquant_dequantize_add_quantize"] > 0
    assert launches == {k: 2 * v for k, v in metrics["phase20_launches_per_child"].items()}
