#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``heat_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA device and the
CUDA toolkit:

    python3 chip_smoke.py [--out FILE]

Phases (any failure exits non-zero; nothing is caught and continued):

1. build the CUDA kernels from ``heat_tpu_torch/csrc`` (one ``nvcc`` per
   source, all at once) and print the card's name and power limit;
2. hold each kernel against its plain PyTorch version on the card,
   bitwise, at the main path's shape (8192 rows = 2^20 values), at odd
   row counts, at the KMeans error-feedback ring's 4 and 8 rows, at 8191
   and 8193 rows (not a multiple of the quantize kernels' slab) and at
   2^17 rows (every CTA of the capped grid walks several slabs), on
   random and special blocks (zero, NaN, +-Inf, the 1e36 saturation
   block, subnormal, flushed scales, near FLT_MAX, ties); then time
   kernel, plain version and, where one exists, the single PyTorch call
   computing the same function, the ring hop's kernel beside the two
   launches it replaces (dequantize_fma + quantize, in the same CUDA
   graph), and quantize and the hop at the KMeans ring's 4 and 8 rows
   (their launch floor); quantize, the hop and the pair are timed both
   back to back and as the main path launches them, behind a ring hop's
   rolls (``after_roll_ms``: the time each adds behind them);
3. the main path at ONE position, exact: 500 000 x 32 float32 blobs
   split over rows, mean/std, cdist on 20 000 rows, KMeans (k=8, 30
   Lloyd steps, explicit initial centers) and predict, checked against
   numpy;
4. the compressed path at FOUR positions on the one card under the
   ``int8_block`` policy: allreduce of a (4, 2^20) payload, mean/var/std,
   and the error-feedback KMeans fit, each held to the documented ring
   bound ``p * sum_i absmax_i / 254`` of what rides the ring (the labels
   to 99.9 % of the exact fit's), and the allreduce bitwise equal to the
   ring composed of the unfused kernels; the kernels' launch counts are
   set to 0 before this phase and read after it, and must be exactly 64
   quantize, 102 hops, 30 dequantize_fma and 34 dequantize;
5. the flash-attention kernels (B3 ``flash_attention``, B4
   ``flash_attention_partial``) against their plain versions on the card
   at the kernel's tiles (``kernel_blocks``) at the reference benchmark's
   attention shape (S=4096, H=16, D=64: bf16, bf16 causal, f32 causal)
   and at edge cases (D 8/16/32/40/128, float16, S=384, K/V of 640 rows
   through the K/V ring, q_base 64 and 256 with K/V longer than Q, a q
   tile wholly before its K/V segment, B4 at four positions on distinct
   bases, B4 on the zig-zag ring's non-contiguous slices, a chain of two
   partial folds), each also against float64 dense attention, then timed
   beside their bound, their achieved TFLOP/s and, for B3, PyTorch's
   ``scaled_dot_product_attention`` (timed as a yardstick only), with the
   card's SM clock and power read right after the timed window;
6. the attention path at FOUR positions on the one card: ring attention
   (f32 contiguous flash fold at S=2048, H=8; bf16 causal zig-zag fold at
   S=4096, H=16, three calls back to back), Ulysses (bf16 causal) and ring self-attention (f32,
   x 4096 x 1024 and weights 1024 x 64 carried in through ``interop``),
   each held against single-card ``flash_attention`` or float64 dense
   attention; both kernels' launch counts are set to 0 before this phase
   and read after it, and each must be above 0;
7. linear algebra and Lasso at the reference benchmark's sizes, through
   the entry points: QR and SVD of a tall-skinny 131 072 x 64 float32
   matrix (``bench.py`` qr_svd_ms), split on rows, at 1 position and at 4
   (TSQR), each held to ``||QR - A|| / ||A|| <= 1e-5``, ``max|Q^T Q - I|
   <= 1e-4``, an upper-triangular R, S within rtol 1e-4 of float64
   singular values computed on the card and ``||U diag(S) V^T - A|| /
   ||A|| <= 1e-5``; Lasso coordinate descent at 1 position on the blobs
   (y as ``bench.py`` lasso_rate builds it; lam 0.1, 50 sweeps) held to a
   float64 numpy replay of the same sweeps within 1e-4 of its largest
   coefficient; Lasso ISTA (gd) at 4 positions, exact and under
   ``int8_block`` (1000 steps each), the exact fit within 1e-4 of its
   largest coefficient of a float64 numpy replay of the same steps (on
   the Gram matrix, its step from an eigensolver), the compressed fit's
   loss within 1e-3 of the exact one's (the reference's own gate); the
   kernels' launch counts are set to 0 before the compressed fit and read
   after it, and must be exactly 2 quantize, 3 hops, 1 dequantize_fma and
   1 dequantize a step; the QR input is drawn as the reference benchmark
   draws it, ``randn(131072, 64, split=0)``;
8. the threefry RNG and the estimators that draw from it: the draws of
   the main path (``randn`` 131 072 x 64, ``rand`` 20 000 x 300, ``randint``
   and ``randperm`` over the blobs) on the card at 1 and 4 positions, bit
   for bit the port's CPU draws of the same seed and counter (``randn``
   within 4 ulps), the counter advancing by the elements drawn; KMeans
   with ``init="random"`` and k-means++ on the blobs (the initial centers
   the rows a CPU draw and a float64 replay of the d^2 CDF pick, or for a
   draw within 1e-5 of a CDF step a row that reaches it; each step of the
   fit held to a float64
   numpy Lloyd step, labels equal off float32 ties); KMedians
   (30 steps bitwise equal to numpy's medians) and KMedoids (30 steps
   each held to numpy's snapped means) from the generating centers, and
   their "++" inits; Spectral on 20 000 rows (V orthonormal to 1e-4,
   ``||V^T L V - T|| / ||T|| <= 1e-4``, the 8 smallest Ritz residuals
   under 1e-4, the blob labels recovered at least as well as the
   reference on the CPU); GaussianNB exact (1e-10 of float64 numpy,
   predict equal to numpy's argmax) and under ``int8_block`` at 4
   positions (sigma_ within the ring bound; exactly 1 quantize, 3 hops,
   1 dequantize launched by the fit); KNN (k=5, 20 000 x 20 000) equal to
   a numpy replay off distance ties; an int64 2048^3 product, exact.

Tolerances: float32 within 2e-5 of the plain version and of float64 dense;
bfloat16/float16 within 5e-2 of float64 dense and within 2 ulps of the
output type of the plain version, the ulp taken at each output row's
largest magnitude (its D values: a bf16 rounding of one ``p`` that flips
when kernel and plain scores differ in their last float32 bit moves the
row by about 2^-8 of a value of that row's scale); a partial chain within
2e-6 of the full kernel.

Then it prints a metrics line, the card line, the kernels line, and as its
last line ``{"ok": true, "device": {...}}``.  ``--out`` also writes every
JSON line to FILE.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

N, F, K, ITERS = 500_000, 32, 8, 30
SUB = 20_000
PAYLOAD = 1 << 20
POSITIONS = 4
BLOCK = 128
#: rows at which every CTA of the quantize kernels' capped grid walks
#: several slabs
WALK_ROWS = 1 << 17
#: the KMeans error-feedback ring's shapes: a chunk of 4 rows, a residual of 8
SMALL_ROWS = (4, 8)
#: H100 SXM data sheet: HBM3 bandwidth, float32 (non-tensor-core) rate and
#: the bf16/fp16 and TF32 dense tensor-core rates
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12
TF32_TC_OPS_PER_S = 495e12
#: the float32 attention kernel runs 3xTF32: three TF32 products per product
TF32_PASSES = 3
FLT_MIN = float(np.finfo(np.float32).tiny)
SOURCE = "heat_tpu_torch/csrc/blockquant.cu"
ATTN_SOURCE = "heat_tpu_torch/csrc/flash_attention.cu"
#: the reference benchmark's attention headline (bench.py:67-68) and ring
#: family (bench.py:1678)
ATTN_S, ATTN_H, ATTN_D = 4096, 16, 64
RING_S, RING_H = 2048, 8
SELF_E = 1024
F32_TOL, HALF_TOL, CHAIN_TOL = 2e-5, 5e-2, 2e-6
#: the reference benchmark's tall-skinny QR/SVD (bench.py qr_svd_ms)
QR_M, QR_N = 131_072, 64
QR_TOL, ORTH_TOL, S_RTOL = 1e-5, 1e-4, 1e-4
#: Lasso on the blobs (bench.py lasso_rate): penalty, cd sweeps, gd steps
LASSO_LAM, LASSO_SWEEPS, LASSO_STEPS = 0.1, 50, 1000
#: cd and exact gd against their float64 replays, as a share of the largest
#: coefficient (gd's 1000 steps stop short of the minimiser, so theta still
#: carries the step size); the compressed gd loss against the exact one
#: (the reference's gate)
CD_TOL, GD_TOL, LOSS_RTOL = 1e-4, 1e-4, 1e-3
#: phase 8's draws at the main path's sizes: the reference benchmark's QR
#: input (bench.py:2189), a 20 000-row Spectral fit's Lanczos restart
#: matrix, k-means++'s first row and KMeans' random init over the blobs
RNG_DRAWS = (("randn", (QR_M, QR_N)), ("rand", (SUB, 300)), ("randint", (0, N, (1,))), ("randperm", (N,)))
#: randn against the port's CPU draw: torch's log1p on the card is not the
#: CPU's (tests/test_torch_random.py holds the CPU to the reference so)
RANDN_ULPS = 4
#: a k-means++ draw closer than this share of the total to a step of the
#: d^2 CDF may pick a neighbouring row where two float32 cumsums round
#: apart (the CPU tests assert no draw of their few hundred rows comes so
#: close; over the blobs' 500 000 rows the steps lie 2e-6 apart on
#: average, so there a pick is held to the float64 row or, for a draw
#: this close, to the rows whose interval reaches it)
KPP_GAP = 1e-5
#: Spectral on every 25th row of the blobs (phase 3's SUB rows): the rbf
#: similarity is about 0.94 within a blob and 1.7e-3 across, so the graph
#: is connected and the eigengap after the 8th eigenvalue is clear
SPECTRAL_GAMMA, SPECTRAL_M = 1e-3, 300
#: the share of blob labels the JAX package's Spectral recovers on the CPU
#: at 2 000 rows (every 250th) of the same blobs, with these settings:
#: 1.0, from scripts/spectral_reference_share.py
SPECTRAL_SHARE = 1.0
#: the 8 smallest Ritz pairs' residuals ||L u - theta u|| (||L|| <= 2):
#: 2e-7 at 2 000 rows on the CPU, float32's reach
RITZ_TOL = 1e-4
#: KMedians/KMedoids fits: the benchmark's steps (medians_medoids_rates)
MED_STEPS = 30
KNN_K = 5


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def smi(query: str) -> str:
    """One line of ``nvidia-smi --query-gpu=<query>`` for the first card."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def card_line() -> str:
    return smi("name,power.limit")


def make_blobs():
    """The reference benchmark's blobs (bench.py make_blobs), same seed."""
    rng = np.random.default_rng(0)
    centers = rng.normal(scale=10, size=(K, F)).astype(np.float32)
    return np.concatenate(
        [c + rng.normal(size=(N // K, F)).astype(np.float32) for c in centers]
    ), centers


def numpy_lloyd(data: np.ndarray, init: np.ndarray, iters: int):
    """The reference benchmark's numpy Lloyd loop (bench.py
    numpy_kmeans_rate), per-cluster sums by masks."""
    centers = init.copy()
    for _ in range(iters):
        d2 = (
            (data * data).sum(1, keepdims=True)
            + (centers * centers).sum(1)[None, :]
            - 2.0 * data @ centers.T
        )
        labels = d2.argmin(1)
        sums = np.stack([data[labels == k].sum(0, dtype=np.float64) for k in range(K)])
        counts = np.bincount(labels, minlength=K).astype(np.float64)[:, None]
        centers = np.where(counts > 0, sums / np.maximum(counts, 1), centers).astype(np.float32)
    return centers


def special_rows(rng) -> np.ndarray:
    """One row per special block kind (see the kernel source)."""
    def scaled(amax):
        r = rng.normal(size=BLOCK).astype(np.float32)
        r = (r / np.abs(r).max() * np.float32(amax)).astype(np.float32)
        r[10], r[11] = 0.0, np.float32(0.5 * FLT_MIN)
        return r

    rows = [np.zeros(BLOCK, np.float32)]
    for idx, val in ((5, np.nan), (7, np.inf), (9, -np.inf), ((3, 4), (np.inf, np.nan))):
        r = rng.normal(size=BLOCK).astype(np.float32)
        r[list(np.atleast_1d(idx))] = val
        rows.append(r)
    rows.append((rng.normal(size=BLOCK) * 1e36).astype(np.float32))
    rows.append((rng.uniform(-0.99, 0.99, size=BLOCK) * FLT_MIN).astype(np.float32))
    for amax in (FLT_MIN * 2, 1e-37, 1e-36, 127 * FLT_MIN * 0.9999, 200 * FLT_MIN, 3e38):
        rows.append(scaled(amax))
    rows.append(np.array([127.0, 2.5, -3.5, 0.5, -0.5, 126.5] + [0.0] * (BLOCK - 6), np.float32))
    return np.stack(rows)


def near_tie_rows(rng, count: int) -> np.ndarray:
    """Rows whose quotients x / scale sit on or within 2 ulps of a
    half-integer: the cases where a division that is not correctly
    rounded would round to the other integer.  Each row's absmax is
    log-uniform in [2^-119, 2^100] (so some scales lie under 2^-96, the
    kernels' IEEE-division path); in every other row the scale has at most
    12 significant bits, so that many quotients are exact ties."""
    inv127 = np.float32(1.0) / np.float32(127.0)
    out = np.empty((count, BLOCK), np.float32)
    for i in range(count):
        amax = np.float32(2.0 ** rng.uniform(-119, 100))
        if i % 2:
            e = int(np.floor(np.log2(amax / 127))) - 11
            s0 = np.float32(np.ldexp(float(rng.integers(2048, 4096)), e))
            cand = np.float32(s0 / inv127)
            if np.float32(cand * inv127) == s0:
                amax = cand
        scale = np.float32(amax * inv127)
        h = rng.integers(-127, 127, size=BLOCK).astype(np.float32) + np.float32(0.5)
        x = (h * scale).astype(np.float32)
        steps = rng.integers(-2, 3, size=BLOCK)
        for _ in range(2):
            x = np.where(steps > 0, np.nextafter(x, np.float32(np.inf)), x)
            x = np.where(steps < 0, np.nextafter(x, np.float32(-np.inf)), x)
            steps = steps - np.sign(steps)
        x[0] = amax if rng.integers(2) else -amax
        out[i] = x
    return out


def payload(rows: int, seed: int) -> np.ndarray:
    """``rows`` rows of 128 values: one of each special block first, then
    random rows, every other one of them near ties (:func:`near_tie_rows`)."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, BLOCK)) * 3.0).astype(np.float32)
    sp = special_rows(rng)
    k = min(rows, len(sp))
    x[:k] = sp[:k] if rows >= len(sp) else sp[rng.choice(len(sp), size=k, replace=False)]
    ties = x[k + 1::2]  # a view: every other random row
    if len(ties):
        ties[:] = near_tie_rows(rng, min(len(ties), 512))[np.arange(len(ties)) % 512]
    return x.reshape(-1)


def bitwise_equal(a, b) -> bool:
    import torch

    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


def max_abs_err(a, b) -> float:
    import torch

    both = torch.isfinite(a) & torch.isfinite(b)
    if not bool(both.any()):
        return 0.0
    return float((a[both].double() - b[both].double()).abs().max())


def device_ms(fn, argsets, per_graph: int = 32, trials: int = 9) -> float:
    """Median device time of one call: ``per_graph`` calls, rotating over
    ``argsets`` (sized past the 50 MB L2 so each call reads from HBM), are
    captured in one CUDA graph and replayed between CUDA events."""
    import torch

    for a in argsets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(per_graph):
            fn(*argsets[i % len(argsets)])
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_graph)
    return float(np.median(times))


def after_ms(kernel, prep, argsets):
    """Device time that ``kernel`` adds behind ``prep``, the PyTorch op
    that comes before it on the main path: ``(prep then kernel) - prep``,
    each timed with :func:`device_ms`.  ``prep`` maps an argset to the
    kernel's arguments.  Back to back, a kernel launched with programmatic
    dependent launch overlaps its own previous launch; behind a PyTorch
    op, which never triggers its dependents early, it cannot.  Returns
    ``(added, both, prep alone)`` in ms."""
    both = device_ms(lambda *a: kernel(*prep(*a)), argsets)
    alone = device_ms(prep, argsets)
    return both - alone, both, alone


def hop_prep(cq, q, s, a):
    """What the ring runs before a hop kernel, at the same sizes: the
    addend's gather (a roll stands in for it), then the payload's roll."""
    add = cq._hop((a,), POSITIONS)[0]
    return (*cq._hop((q, s), POSITIONS), add)


def wall_ms(fn, reps: int = 5) -> float:
    """Median host time of ``fn`` fenced by a device synchronise."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def bound_ms(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S):
    b, o = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def phase_kernels(torch, cq, dev):
    """Phase 2: every kernel bitwise against its plain version, then timed."""
    big = PAYLOAD // BLOCK
    for rows in (1, 3, 33, big, *SMALL_ROWS, big - 1, big + 1, WALK_ROWS):
        x = torch.from_numpy(payload(rows, seed=rows)).to(dev)
        add = torch.from_numpy(payload(rows, seed=rows + 1)).to(dev)
        q, s = cq.quantize_blocks(x)
        qp, sp = cq.quantize_blocks_plain(x.reshape(rows, BLOCK))
        d, dp = cq.dequantize_blocks(q, s), cq.dequantize_blocks_plain(q, s)
        pairs = [("quantize q", q, qp), ("quantize scale", s, sp), ("dequantize", d, dp)]
        for negate in (False, True):
            f = cq.dequantize_fma_blocks(q, s, add, negate=negate)
            fp = cq.dequantize_fma_blocks_plain(q, s, add, negate=negate)
            pairs.append((f"dequantize_fma negate={negate}", f, fp))
        h, hs = cq.dequantize_add_quantize_blocks(q, s, add)
        hp, hsp = cq.dequantize_add_quantize_blocks_plain(q, s, add)
        pairs += [("dequantize_add_quantize q", h, hp), ("dequantize_add_quantize scale", hs, hsp)]
        torch.cuda.synchronize()
        for what, a, b in pairs:
            check(bitwise_equal(a, b), f"{what} kernel != plain at rows={rows}")
        print(f"kernels == plain, bitwise, at rows={rows}")
    for fused in (False, True):
        grids = {rows: cq._quantize_grid(rows, fused) for rows in (*SMALL_ROWS, big, WALK_ROWS)}
        ctas, step = grids[WALK_ROWS]
        check(grids[SMALL_ROWS[0]][0] == 1 and ctas * step < WALK_ROWS,
              f"quantize grid (fused={fused}): {grids}")
        print(f"{'hop' if fused else 'quantize'} grid (rows: CTAs, rows per step): {grids}")

    n = big * BLOCK
    bufs = 16  # 16 x 4 MiB inputs: past the L2
    xs = [torch.randn(n, device=dev) for _ in range(bufs)]
    adds = [torch.randn(n, device=dev) for _ in range(bufs)]
    enc = [cq.quantize_blocks(x) for x in xs]
    torch.cuda.synchronize()
    q0, s0 = enc[0]
    x0 = xs[0]

    def q_err(got, want):
        return max(max_abs_err(got[1], want[1]), max_abs_err(got[0].float(), want[0].float()))

    err = {
        "blockquant_quantize": q_err(cq.quantize_blocks(x0), cq.quantize_blocks_plain(x0.reshape(big, BLOCK))),
        "blockquant_dequantize": max_abs_err(cq.dequantize_blocks(q0, s0), cq.dequantize_blocks_plain(q0, s0)),
        "blockquant_dequantize_fma": max_abs_err(
            cq.dequantize_fma_blocks(q0, s0, adds[0]), cq.dequantize_fma_blocks_plain(q0, s0, adds[0])
        ),
        "blockquant_dequantize_add_quantize": q_err(
            cq.dequantize_add_quantize_blocks(q0, s0, adds[0]),
            cq.dequantize_add_quantize_blocks_plain(q0, s0, adds[0]),
        ),
    }
    qargs = [(x,) for x in xs]
    qargs_plain = [(x.reshape(big, BLOCK),) for x in xs]
    dargs = [e for e in enc]
    fargs = [(e[0], e[1], a) for e, a in zip(enc, adds)]
    scale_b = big * 4
    rows_out = []
    for name, kernel, plain, library, args, plain_args, nbytes, ops, replaces in (
        ("blockquant_quantize", cq.quantize_blocks, cq.quantize_blocks_plain, None,
         qargs, qargs_plain, n * 4 + n + scale_b, n * 6, "heat_tpu/comm/compressed.py:230"),
        ("blockquant_dequantize", cq.dequantize_blocks, cq.dequantize_blocks_plain,
         lambda q, s: torch.mul(q, s), dargs, dargs, n + scale_b + n * 4, n, "heat_tpu/comm/compressed.py:249"),
        ("blockquant_dequantize_fma", cq.dequantize_fma_blocks, cq.dequantize_fma_blocks_plain,
         lambda q, s, a: torch.addcmul(a.reshape(q.shape), q, s), fargs, fargs,
         n + scale_b + n * 4 + n * 4, n * 2, "heat_tpu/comm/compressed.py:249"),
        ("blockquant_dequantize_add_quantize", cq.dequantize_add_quantize_blocks,
         cq.dequantize_add_quantize_blocks_plain, None, fargs, fargs,
         n + scale_b + n * 4 + n + scale_b, n * 8, "heat_tpu/comm/compressed.py:230"),
    ):
        ms = device_ms(kernel, args)
        plain_ms = device_ms(plain, plain_args)
        lib_ms = device_ms(library, args) if library is not None else None
        b_ms, b_by = bound_ms(nbytes, ops)
        row = {
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": None, "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        }
        extra = ""
        pair = lambda q, s, a: cq.quantize_blocks(cq.dequantize_fma_blocks(q, s, a))  # noqa: E731
        if name == "blockquant_dequantize_add_quantize":
            row["unfused_pair_ms"] = device_ms(pair, fargs)
            extra = f", the two launches it replaces {row['unfused_pair_ms'] * 1e3:.2f} us"
        if name in ("blockquant_quantize", "blockquant_dequantize_add_quantize"):
            # the launch floor at the KMeans error-feedback ring's shapes;
            # and at every shape, as the main path launches the kernel:
            # behind a ring hop's roll (for the hop, the addend's roll,
            # standing in for the ring's gather of it, then the payload's)
            hop = name == "blockquant_dequantize_add_quantize"
            if hop:
                prep = lambda q, s, a: hop_prep(cq, q, s, a)  # noqa: E731
            else:
                prep = lambda x: cq._hop((x,), POSITIONS)  # noqa: E731
            row["small_ms"], row["after_roll_ms"], rolls = {}, {}, []
            for rows in (big, *SMALL_ROWS):
                sets = args
                if rows != big:
                    xs_s = [torch.randn(rows * BLOCK, device=dev) for _ in range(bufs)]
                    sets = [(*cq.quantize_blocks(x), torch.randn(rows * BLOCK, device=dev)) if hop
                            else (x,) for x in xs_s]
                    row["small_ms"][str(rows)] = device_ms(kernel, sets)
                added, _, alone = after_ms(kernel, prep, sets)
                row["after_roll_ms"][str(rows)] = added
                rolls.append(f"{rows} rows {added * 1e3:.2f} us (roll alone {alone * 1e3:.2f} us)")
            if hop:
                row["unfused_pair_after_roll_ms"] = after_ms(pair, prep, fargs)[0]
                rolls.append(f"the two launches it replaces {row['unfused_pair_after_roll_ms'] * 1e3:.2f} us")
            added = row["after_roll_ms"][str(big)]
            share = (f"{b_ms / added * 100:.1f} % of the bound at {big} rows" if added > 0
                     else "share of the bound not resolved")
            extra += ("; at " + ", ".join(f"{r} rows {t * 1e3:.2f} us" for r, t in row["small_ms"].items())
                      + "; behind a roll, as on the main path: " + ", ".join(rolls)
                      + f" ({share})")
        rows_out.append(row)
        print(f"{name}: {ms * 1e3:.2f} us (bound {b_ms * 1e3:.2f} us by {b_by}, "
              f"{b_ms / ms * 100:.1f} %), plain {plain_ms * 1e3:.2f} us, library "
              f"{'none: no single PyTorch call computes it' if lib_ms is None else f'{lib_ms * 1e3:.2f} us'}"
              + extra)
    return rows_out


def ring_unfused(torch, cq, stacked, size: int):
    """The int8 ring allreduce with every reduce-scatter hop as two
    launches, ``dequantize_fma`` then ``quantize`` (the f32 partial sum
    written and read back): the composition the hop kernel replaces."""
    n = stacked.shape[1]
    chunk = cq._padded_len(-(-n // size), BLOCK)
    chunks = torch.nn.functional.pad(stacked, (0, size * chunk - n)).reshape(size, size, chunk)
    pos = torch.arange(size, device=stacked.device)
    cur = chunks[pos, pos]
    for s in range(size - 1):
        payload = cq._hop(cq.quantize_blocks(cur.reshape(-1)), size)
        add = chunks[pos, (pos - s - 1) % size].reshape(-1)
        cur = cq.dequantize_fma_blocks(*payload, add).reshape(size, chunk)
    return cq.dequantize_blocks(*cq._hop(cq.quantize_blocks(cur.reshape(-1)), size))[:n]


# --------------------------------------------------------------------- #
# attention (phases 5 and 6)                                              #
# --------------------------------------------------------------------- #
def attn_inputs(shape, dtype, seed: int, dev, n: int = 3):
    """``n`` float32 normal arrays from a numpy seed, on ``dev`` in ``dtype``."""
    import torch

    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev).to(dtype)
            for _ in range(n)]


def dense64(q, k, v, causal: bool, q_base: int = 0):
    """Float64 dense attention on (B, S, H, D), one head at a time."""
    import torch

    B, S, H, D = q.shape
    Sk = k.shape[1]
    out = torch.empty((B, S, H, D), dtype=torch.float64, device=q.device)
    keep = None
    if causal:
        keep = (q_base + torch.arange(S, device=q.device)[:, None]) >= torch.arange(Sk, device=q.device)[None, :]
    for b in range(B):
        for h in range(H):
            qh, kh, vh = (t[b, :, h].double() for t in (q, k, v))
            sc = (qh @ kh.T) / np.sqrt(D)
            if keep is not None:
                sc = sc.masked_fill(~keep, -np.inf)
            out[b, :, h] = torch.softmax(sc, dim=-1) @ vh
    return out


def ulps(a, b) -> float:
    """Largest distance of ``a`` from ``b`` in ulps of their (half-precision
    or float32) dtype, the ulp taken at the largest magnitude of each row
    of ``b`` (its last axis)."""
    import torch

    mant = {torch.bfloat16: 7, torch.float16: 10, torch.float32: 23}[a.dtype]
    mag = torch.clamp_min(b.double().abs().amax(dim=-1, keepdim=True), 2.0 ** -100)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - mant)
    return float(((a.double() - b.double()).abs() / ulp).max())


def hold(what: str, out, plain, ref) -> float:
    """Hold a kernel's output to its plain version and to float64 dense at
    the stated tolerances; returns the max abs error against plain."""
    import torch

    check(bool(torch.isfinite(out).all()), f"{what}: non-finite output")
    err_plain = max_abs_err(out.float(), plain.float())
    err_ref = float((out.double() - ref).abs().max())
    if out.dtype == torch.float32:
        check(err_plain <= F32_TOL, f"{what}: {err_plain:.3g} from plain > {F32_TOL}")
        check(err_ref <= F32_TOL, f"{what}: {err_ref:.3g} from float64 dense > {F32_TOL}")
        print(f"{what}: plain {err_plain:.3g}, dense {err_ref:.3g}")
    else:
        u = ulps(out, plain)
        check(u <= 2.0, f"{what}: {u:.3g} ulps from plain > 2")
        check(err_ref <= HALF_TOL, f"{what}: {err_ref:.3g} from float64 dense > {HALF_TOL}")
        print(f"{what}: plain {err_plain:.3g} ({u:.2f} ulps), dense {err_ref:.3g}")
    return err_plain


def hold_state(what: str, got, want, dtype) -> float:
    """Hold a partial fold's state to its plain version: ``m`` and ``l``
    within 2e-5 relative (float32 maxima and sums of the float32 ``p``),
    the normalized ``acc / l`` at the output tolerance of ``dtype`` (2e-5
    for float32, 2 ulps per row for bf16/f16: the PV product takes ``p``
    rounded to ``dtype``).  Returns the max abs error of ``acc / l``."""
    import torch

    (m, l, acc), (m0, l0, acc0) = got, want
    check(bool(torch.equal(torch.isfinite(m), torch.isfinite(m0))), f"{what}: m finiteness differs")
    for name, a, b in (("m", m, m0), ("l", l, l0)):
        err = max_abs_err(a, b)
        scale = float(b[torch.isfinite(b)].abs().max()) if bool(torch.isfinite(b).any()) else 1.0
        check(err <= F32_TOL * max(1.0, scale), f"{what}: {name} {err:.3g} from plain")
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    out0 = acc0 / torch.clamp_min(l0, 1e-30)[..., None]
    err = max_abs_err(out, out0)
    if dtype == torch.float32:
        check(err <= F32_TOL, f"{what}: acc/l {err:.3g} from plain > {F32_TOL}")
        print(f"{what}: acc/l {err:.3g} from plain")
    else:
        u = ulps(out.to(dtype), out0.to(dtype))
        check(u <= 2.0, f"{what}: acc/l {u:.3g} ulps from plain > 2")
        print(f"{what}: acc/l {err:.3g} from plain ({u:.2f} ulps)")
    return err


def attn_flops(S: int, Sk: int, D: int, heads: int, causal: bool) -> float:
    """4*D operations per (query, key) pair per head (2 for QK^T, 2 for PV)
    over the pairs the function needs, queries and keys both from position
    0: all S * Sk, or under causal min(Sk, i + 1) keys for query row i."""
    pairs = sum(min(Sk, i + 1) for i in range(S)) if causal else S * Sk
    return 4.0 * D * heads * pairs


def rate_line(ms: float, ops: float, b_ms: float) -> str:
    """Achieved TFLOP/s (the algorithm's operations, not the passes) and
    the share of the bound reached."""
    return f"kernel: {ops / (ms * 1e-3) / 1e12:.1f} TFLOP/s, {b_ms / ms * 100:.1f} % of its bound"


def _bshd(t):
    """(heads, L, d) -> (1, L, heads, d), the layout of ``dense64``."""
    return t.transpose(0, 1)[None]


def check_partial_positions(fa, dev, dtype, d: int = 64, per: int = 2, L: int = 256) -> float:
    """B4 at four positions on distinct bases in one launch.  From the
    initial state, the normalized fold is held to the plain version at the
    kernel's tiles and to float64 dense attention of each position's
    queries over its segment; from a random state, to the plain version.
    Position 0's queries lie wholly before its keys: its state comes back
    bit for bit.  Returns the largest error of acc / l against plain."""
    import torch

    qb, kb = [0, 256, 64, 128], [256, 0, 0, 64]
    P = len(qb)
    blocks = fa.kernel_blocks(dtype)
    q, k, v = attn_inputs((P * per, L, d), dtype, seed=11, dev=dev)
    init = (torch.full((P * per, L), -float("inf"), device=dev),
            torch.zeros((P * per, L), device=dev), torch.zeros((P * per, L, d), device=dev))
    m0, l0 = attn_inputs((P * per, L), torch.float32, seed=12, dev=dev, n=2)
    rand = (m0, l0.abs() + 1.0, attn_inputs((P * per, L, d), torch.float32, seed=13, dev=dev, n=1)[0])
    errs = []
    for what, st in (("initial", init), ("random", rand)):
        got = fa.flash_attention_partial(q, k, v, *st, qb, kb, causal=True)
        want = fa.flash_attention_partial_plain(q, k, v, *st, qb, kb, True, *blocks)
        torch.cuda.synchronize()
        errs.append(hold_state(f"partial 4 positions {dtype} D={d} ({what} state)", got, want,
                               dtype))
        check(all(bool(torch.equal(a[:per], b[:per])) for a, b in zip(got, st)),
              f"partial 4 positions {dtype}: the fully masked position changed its state")
        if what == "initial":
            out = got[2] / torch.clamp_min(got[1], 1e-30)[..., None]
            tol = F32_TOL if dtype == torch.float32 else HALF_TOL
            for i in range(1, P):
                sl = slice(i * per, (i + 1) * per)
                ref = dense64(_bshd(q[sl]), _bshd(k[sl]), _bshd(v[sl]), True, qb[i] - kb[i])
                err = float((out[sl].double() - ref[0].transpose(0, 1)).abs().max())
                check(err <= tol, f"partial position {i} {dtype}: {err:.3g} from float64 dense > {tol}")
    return max(errs)


def check_partial_zigzag(fa, dev, dtype, p: int = 4, bh: int = 4, Lh: int = 128,
                         d: int = 64) -> float:
    """B4 on the zig-zag ring's operands: the halves of a (p, BH, 2Lh, D)
    K/V buffer, handed over without a copy.  The diagonal fold (causal)
    and the unmasked fold are each held to the plain version and to
    float64 dense attention, and must equal the kernel on contiguous
    copies bit for bit.  Returns the largest error against plain."""
    import torch

    blocks = fa.kernel_blocks(dtype)
    kz, vz = attn_inputs((p, bh, 2 * Lh, d), dtype, seed=14, dev=dev, n=2)
    q = attn_inputs((p * bh, Lh, d), dtype, seed=15, dev=dev, n=1)[0]
    rows = lambda t: t.reshape((p * bh,) + tuple(t.shape[2:]))  # noqa: E731
    base = (torch.arange(p, device=dev) * Lh).tolist()
    errs = []
    for half, causal in ((slice(0, Lh), True), (slice(Lh, 2 * Lh), False)):
        ks, vs = rows(kz[:, :, half]), rows(vz[:, :, half])
        check(not ks.is_contiguous() and ks.stride(0) == 2 * Lh * d, "zig-zag slice is a copy")
        st = (torch.full((p * bh, Lh), -float("inf"), device=dev),
              torch.zeros((p * bh, Lh), device=dev), torch.zeros((p * bh, Lh, d), device=dev))
        got = fa.flash_attention_partial(q, ks, vs, *st, base, base, causal=causal)
        copy = fa.flash_attention_partial(q, ks.contiguous(), vs.contiguous(), *st, base, base,
                                          causal=causal)
        want = fa.flash_attention_partial_plain(q, ks, vs, *st, base, base, causal, *blocks)
        torch.cuda.synchronize()
        what = f"partial zig-zag slices {dtype} causal={causal}"
        check(all(bool(torch.equal(a, b)) for a, b in zip(got, copy)),
              f"{what}: differs from the kernel on contiguous copies")
        errs.append(hold_state(what, got, want, dtype))
        out = got[2] / torch.clamp_min(got[1], 1e-30)[..., None]
        ref = dense64(_bshd(q), _bshd(ks), _bshd(vs), causal)[0].transpose(0, 1)
        err = float((out.double() - ref).abs().max())
        tol = F32_TOL if dtype == torch.float32 else HALF_TOL
        check(err <= tol, f"{what}: {err:.3g} from float64 dense > {tol}")
    return max(errs)


def phase_attention_kernels(torch, fa, dev):
    """Phase 5: B3/B4 against their plain versions (at the kernel's tiles)
    and float64 dense, at edge cases and the headline shape; then timed.
    Returns the two kernel rows and the three tokens/s metrics."""
    plain = lambda q, k, v, c, qb=0: fa.flash_attention_plain(  # noqa: E731
        q, k, v, c, qb, *fa.kernel_blocks(q.dtype))
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32

    # -- edge cases at small shapes
    for D in (16, 32, 128, 8, 40):
        for dt in (f32, bf16):
            q, k, v = attn_inputs((1, 256, 2, D), dt, seed=D, dev=dev)
            hold(f"flash D={D} {dt} causal", fa.flash_attention(q, k, v, True),
                 plain(q, k, v, True), dense64(q, k, v, True))
    q, k, v = attn_inputs((2, 256, 2, 64), f16, seed=5, dev=dev)
    hold("flash f16 causal B=2", fa.flash_attention(q, k, v, True), plain(q, k, v, True),
         dense64(q, k, v, True))
    for dt in (f32, bf16):
        q, k, v = attn_inputs((2, 384, 3, 64), dt, seed=8, dev=dev)
        hold(f"flash S=384 {dt} causal", fa.flash_attention(q, k, v, True), plain(q, k, v, True),
             dense64(q, k, v, True))
        q, k, v = attn_inputs((1, 640, 2, 64), dt, seed=9, dev=dev)
        qs = q[:, 512:]
        hold(f"flash Sq=128 Sk=640 q_base=512 {dt} causal",
             fa.flash_attention(qs, k, v, True, q_base=512), plain(qs, k, v, True, 512),
             dense64(q, k, v, True)[:, 512:])
        for lo, Sk in ((256, 512), (64, 384)):
            q, k, v = attn_inputs((1, Sk, 2, 64), dt, seed=6, dev=dev)
            qs = q[:, lo:lo + 128]
            hold(f"flash q_base={lo} Sq=128 Sk={Sk} {dt}",
                 fa.flash_attention(qs, k, v, True, q_base=lo), plain(qs, k, v, True, lo),
                 dense64(q, k, v, True)[:, lo:lo + 128])
    for dt in (f32, bf16, f16):
        check_partial_positions(fa, dev, dt, d=40)
    for dt in (f32, bf16):
        check_partial_zigzag(fa, dev, dt)

    BH, L, D = 8, 256, 64
    q, k, v = attn_inputs((BH, 2 * L, D), f32, seed=7, dev=dev)
    st0 = (torch.full((BH, L), -float("inf"), device=dev), torch.zeros((BH, L), device=dev),
           torch.zeros((BH, L, D), device=dev))
    # a q tile wholly before its K/V segment: no tile visited, state untouched
    m, l, acc = fa.flash_attention_partial(q[:, :L], k[:, L:], v[:, L:], *st0, 0, L, causal=True)
    torch.cuda.synchronize()
    check(all(bool(torch.equal(a, b)) for a, b in zip((m, l, acc), st0)),
          "partial: a q tile before its segment changed the state")
    # a chain of two segments equals the full kernel
    for causal in (False, True):
        st = (torch.full((BH, 2 * L), -float("inf"), device=dev),
              torch.zeros((BH, 2 * L), device=dev), torch.zeros((BH, 2 * L, D), device=dev))
        for r in range(2):
            sl = slice(r * L, (r + 1) * L)
            st = fa.flash_attention_partial(q, k[:, sl], v[:, sl], *st, 0, r * L, causal=causal)
        chained = st[2] / torch.clamp_min(st[1], 1e-30)[..., None]
        full = fa.flash_attention(q.transpose(0, 1)[None], k.transpose(0, 1)[None],
                                  v.transpose(0, 1)[None], causal)[0].transpose(0, 1)
        err = max_abs_err(chained, full)
        check(err <= CHAIN_TOL, f"partial chain causal={causal}: {err:.3g} from full > {CHAIN_TOL}")
        print(f"partial chain of 2 == full kernel, causal={causal}: {err:.3g}")

    # -- the headline shape, checked then timed
    S, H, D = ATTN_S, ATTN_H, ATTN_D
    sets = 3  # 3 x (Q, K, V) of 8-16 MiB each: past the L2
    results, metrics = {}, {}
    for key, dt, causal in (("attention", bf16, False), ("causal_attention", bf16, True),
                            ("causal_attention_f32", f32, True)):
        argsets = [tuple(attn_inputs((1, S, H, D), dt, seed=100 + i, dev=dev)) for i in range(sets)]
        q, k, v = argsets[0]
        out = fa.flash_attention(q, k, v, causal)
        err = hold(f"flash S={S} H={H} D={D} {dt} causal={causal}", out, plain(q, k, v, causal),
                   dense64(q, k, v, causal))
        ms = device_ms(lambda a, b, c: fa.flash_attention(a, b, c, causal), argsets)
        clocks = smi("clocks.sm,power.draw,power.limit")
        plain_ms = device_ms(lambda a, b, c: plain(a, b, c, causal), argsets, per_graph=2, trials=3)
        lib_ms = device_ms(
            lambda a, b, c: torch.nn.functional.scaled_dot_product_attention(
                a.transpose(1, 2), b.transpose(1, 2), c.transpose(1, 2), is_causal=causal),
            argsets)
        nbytes = 4 * S * H * D * q.element_size()
        ops = attn_flops(S, S, D, H, causal)
        if dt == f32:  # 3xTF32: three tensor-core passes per product
            b_ms, b_by = bound_ms(nbytes, TF32_PASSES * ops, TF32_TC_OPS_PER_S)
        else:
            b_ms, b_by = bound_ms(nbytes, ops, BF16_TC_OPS_PER_S)
        results[key] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                            bound_by=b_by, max_abs_err=err)
        metrics[f"{key}_tokens_per_s"] = S / (ms / 1e3)
        print(f"clocks.sm, power.draw, power.limit right after timing {key}: {clocks}")
        print(f"flash_attention {key}: {ms * 1e3:.1f} us (bound {b_ms * 1e3:.1f} us by {b_by}), "
              f"plain {plain_ms * 1e3:.1f} us, scaled_dot_product_attention {lib_ms * 1e3:.1f} us; "
              + rate_line(ms, ops, b_ms))

    # B4 at the zig-zag ring's round fold: 4 positions x 16 heads, Lh = 512
    P, Lh = POSITIONS, ATTN_S // POSITIONS // 2
    rows = P * ATTN_H
    argsets = []
    for i in range(sets):
        q, k, v = attn_inputs((rows, Lh, D), bf16, seed=200 + i, dev=dev)
        m0, l0 = attn_inputs((rows, Lh), f32, seed=300 + i, dev=dev, n=2)
        acc0 = attn_inputs((rows, Lh, D), f32, seed=400 + i, dev=dev, n=1)[0]
        argsets.append((q, k, v, m0, l0.abs() + 1.0, acc0))
    bases = (torch.arange(P, device=dev) * Lh, torch.zeros(P, dtype=torch.int64, device=dev))
    blocks = fa.kernel_blocks(bf16)
    got = fa.flash_attention_partial(*argsets[0], *bases)
    want = fa.flash_attention_partial_plain(*argsets[0], *[b.tolist() for b in bases], False, *blocks)
    err = hold_state("flash_attention_partial bf16 round fold", got, want, bf16)
    ms = device_ms(lambda *a: fa.flash_attention_partial(*a, *bases), argsets)
    clocks = smi("clocks.sm,power.draw,power.limit")
    plain_ms = device_ms(lambda *a: fa.flash_attention_partial_plain(*a, 0, 0, False, *blocks),
                         argsets, per_graph=4, trials=3)
    nbytes = 3 * rows * Lh * D * 2 + 2 * (2 * rows * Lh * 4) + 2 * rows * Lh * D * 4
    ops = attn_flops(Lh, Lh, D, rows, False)
    b_ms, b_by = bound_ms(nbytes, ops, BF16_TC_OPS_PER_S)
    results["partial"] = dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                              bound_by=b_by, max_abs_err=err)
    print(f"clocks.sm, power.draw, power.limit right after timing partial: {clocks}")
    print(f"flash_attention_partial (bf16, {rows} x {Lh} x {D}, one ring round): "
          f"{ms * 1e3:.1f} us (bound {b_ms * 1e3:.1f} us by {b_by}), plain {plain_ms * 1e3:.1f} us, "
          f"library none: no single PyTorch call folds into a running softmax state; "
          + rate_line(ms, ops, b_ms)
          + f", {nbytes / (ms * 1e-3) / 1e9:.0f} GB/s")

    kernel_rows = []
    for name, key, replaces in (
        ("flash_attention", "attention", "heat_tpu/parallel/flash_attention.py:137"),
        ("flash_attention_partial", "partial", "heat_tpu/parallel/flash_attention.py:161"),
    ):
        r = results[key]
        kernel_rows.append({
            "name": name, "route": "cuda", "source": ATTN_SOURCE, "replaces": replaces,
            "launches": None, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    kernel_rows[0]["cases"] = {k: v for k, v in results.items() if k != "partial"}
    return kernel_rows, metrics


def phase_attention_path(torch, htt, fa, dev):
    """Phase 6: ring, Ulysses and ring self-attention at POSITIONS positions
    on the one card, through the entry points; returns the launch counts
    and the path's metrics."""
    from heat_tpu_torch import interop

    par = htt.parallel
    comm4 = htt.TorchCommunication([dev] * POSITIONS)
    f32, bf16 = torch.float32, torch.bfloat16
    counted = (fa.flash_attention, fa.flash_attention_partial)
    for fn in counted:
        fn.launches = 0

    # ring, f32, non-causal: the contiguous flash fold
    q, k, v = attn_inputs((RING_S, RING_H, ATTN_D), f32, seed=500, dev=dev)
    qd, kd, vd = (htt.array(t, split=0, comm=comm4) for t in (q, k, v))
    ring32 = par.ring_attention(qd, kd, vd, causal=False)
    single32 = fa.flash_attention(q, k, v, False)
    ref32 = dense64(q[None], k[None], v[None], False)[0]
    # ring, bf16, causal: the zig-zag fold
    qb, kb, vb = attn_inputs((ATTN_S, ATTN_H, ATTN_D), bf16, seed=501, dev=dev)
    qbd, kbd, vbd = (htt.array(t, split=0, comm=comm4) for t in (qb, kb, vb))
    # three calls back to back, no sync between: each fold's state must be
    # complete when the next kernel reads it
    ringzs = [par.ring_attention(qbd, kbd, vbd, causal=True) for _ in range(3)]
    ringz = ringzs[0]
    uly = par.ulysses_attention(qbd, kbd, vbd, causal=True)
    singleb = fa.flash_attention(qb, kb, vb, True)
    refb = dense64(qb[None], kb[None], vb[None], True)[0]
    # ring self-attention, f32: weights made by numpy, carried in through interop
    rng = np.random.default_rng(502)
    x_np = rng.normal(size=(ATTN_S, SELF_E)).astype(np.float32)
    w_np = [(rng.normal(size=(SELF_E, ATTN_D)) / np.sqrt(SELF_E)).astype(np.float32) for _ in range(3)]
    xd = interop.array_from_numpy(x_np, split=0, comm=comm4)
    wd = [interop.array_from_numpy(w, comm=comm4) for w in w_np]
    selfo = par.ring_self_attention(xd, *wd)
    proj = [(xd.larray @ w.larray)[:, None, :] for w in wd]
    single_self = fa.flash_attention(*proj, False)[:, 0]
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counted}
    print(f"{POSITIONS} positions, attention: launches {launches} "
          f"(expected flash_attention 4, flash_attention_partial 4 + 3 x 9 + 4 = 35)")
    for name, count in launches.items():
        check(count > 0, f"{name} was not launched on the attention path")

    for what, out, single, ref, tol in (
        ("ring f32 contiguous", ring32, single32, ref32, F32_TOL),
        *((f"ring bf16 zig-zag causal, call {i + 1}", r, singleb, refb, HALF_TOL)
          for i, r in enumerate(ringzs)),
        ("ulysses bf16 causal", uly, singleb, refb, HALF_TOL),
        ("ring self-attention f32", selfo, single_self, None, F32_TOL),
    ):
        check(tuple(out.shape) == tuple(single.shape) and bool(torch.isfinite(out).all()),
              f"{what}: shape {tuple(out.shape)} or non-finite values")
        e_single = max_abs_err(out.float(), single.float())
        line = f"{what}: {e_single:.3g} from single-card flash_attention"
        if out.dtype == f32:
            check(e_single <= tol, f"{what}: {e_single:.3g} from single-card flash > {tol}")
        if ref is not None:
            e_ref = float((out.double() - ref).abs().max())
            check(e_ref <= tol, f"{what}: {e_ref:.3g} from float64 dense > {tol}")
            line += f", {e_ref:.3g} from float64 dense"
        print(line)
    check(bool(torch.equal(uly, singleb)), "ulysses != single-card flash_attention on the same global tensor")
    xs = torch.from_numpy(x_np).double().to(dev)
    ref_self = dense64(*[(xs @ torch.from_numpy(w).double().to(dev))[None, :, None, :] for w in w_np],
                       False)[0, :, 0]
    e = float((selfo.double() - ref_self).abs().max())
    check(e <= F32_TOL, f"ring self-attention: {e:.3g} from float64 dense > {F32_TOL}")

    metrics = {
        "ring_attention_ms": wall_ms(lambda: par.ring_attention(qbd, kbd, vbd, causal=True), reps=9),
        "ring_attention_f32_ms": wall_ms(lambda: par.ring_attention(qd, kd, vd, causal=False), reps=9),
        "ulysses_attention_ms": wall_ms(lambda: par.ulysses_attention(qbd, kbd, vbd, causal=True), reps=9),
    }
    print(f"ring bf16 zig-zag causal {metrics['ring_attention_ms']:.3f} ms, ring f32 "
          f"{metrics['ring_attention_f32_ms']:.3f} ms, ulysses bf16 causal "
          f"{metrics['ulysses_attention_ms']:.3f} ms")
    return launches, metrics


# --------------------------------------------------------------------- #
# linear algebra and Lasso (phase 7)                                    #
# --------------------------------------------------------------------- #
def lasso_target(data: np.ndarray) -> np.ndarray:
    """y as the reference benchmark builds it (bench.py lasso_rate)."""
    return (data @ np.arange(1, F + 1, dtype=np.float32) / F
            + np.random.default_rng(1).normal(size=data.shape[0]).astype(np.float32))


def columns64(data: np.ndarray) -> np.ndarray:
    """Lasso's design matrix in float64, as ``(f + 1, n)`` columns: the
    intercept's row of ones, then the features."""
    cols = np.empty((data.shape[1] + 1, data.shape[0]))
    cols[0], cols[1:] = 1.0, data.T
    return cols


def numpy_cd(data: np.ndarray, y: np.ndarray, lam: float, sweeps: int) -> np.ndarray:
    """The reference's coordinate descent (heat_tpu/regression/lasso.py
    ``_fit_segment``) replayed in float64 with numpy: the intercept column
    first, ``rho_j = mean(x_j (r + x_j theta_j))``, the soft threshold,
    the residual kept incrementally."""
    n, f = data.shape
    cols = columns64(data)
    z = np.maximum(np.einsum("ij,ij->i", cols, cols) / n, 1e-12)
    theta = np.zeros(f + 1)
    for _ in range(sweeps):
        resid = y.astype(np.float64) - cols.T @ theta
        for j in range(f + 1):
            rho = cols[j] @ resid / n + theta[j] * z[j]
            new = (rho if j == 0 else np.sign(rho) * max(abs(rho) - lam, 0.0)) / z[j]
            resid -= cols[j] * (new - theta[j])
            theta[j] = new
    return theta


def numpy_ista(data: np.ndarray, y: np.ndarray, lam: float, steps: int) -> np.ndarray:
    """The reference's exact ISTA (heat_tpu/regression/lasso.py
    ``_gd_segment``) replayed in float64 with numpy on the Gram matrix:
    ``grad = G theta - b`` with ``G = A^T A / n`` and ``b = A^T y / n`` over
    the columns [1, data], the step ``1 / lambda_max(G)`` from an
    eigensolver (not a power iteration), the soft threshold ``step * lam``
    on all but the intercept."""
    n, f = data.shape
    cols = columns64(data)
    g, b = cols @ cols.T / n, cols @ y.astype(np.float64) / n
    step = 1.0 / np.linalg.eigvalsh(g)[-1]
    theta = np.zeros(f + 1)
    for _ in range(steps):
        theta = theta - step * (g @ theta - b)
        theta[1:] = np.sign(theta[1:]) * np.maximum(np.abs(theta[1:]) - step * lam, 0.0)
    return theta


def lasso_loss(data: np.ndarray, y: np.ndarray, theta: np.ndarray, lam: float) -> float:
    """The Lasso objective ``mean(r^2) / 2 + lam |theta_1:|_1``, in float64."""
    r = data.astype(np.float64) @ theta[1:] + theta[0] - y
    return 0.5 * float(np.mean(r * r)) + lam * float(np.abs(theta[1:]).sum())


def phase_linalg_lasso(torch, htt, cq, dev, data, counted):
    """Phase 7: QR/SVD and Lasso through the entry points; returns the
    kernels' launch counts of the compressed gd fit and the metrics."""
    metrics = {}
    m, n, sweeps, steps = QR_M, QR_N, LASSO_SWEEPS, LASSO_STEPS
    # drawn as the reference benchmark draws it (bench.py:2189)
    htt.random.seed(0)
    A = htt.random.randn(m, n, split=0, comm=htt.TorchCommunication([dev])).larray
    A64 = A.double()
    s64 = torch.linalg.svdvals(A64)
    norm_a = float(torch.linalg.norm(A64))
    eye = torch.eye(n, dtype=torch.float64, device=dev)
    for p in (1, POSITIONS):
        comm = htt.TorchCommunication([dev] * p)
        X = htt.array(A, split=0, comm=comm)
        q, r = htt.linalg.qr(X)
        Q, R = q.larray.double(), r.larray.double()
        res = float(torch.linalg.norm(Q @ R - A64)) / norm_a
        orth = float((Q.T @ Q - eye).abs().max())
        check(q.shape == (m, n) and r.shape == (n, n) and q.split == 0, f"qr shapes at {p}")
        check(res <= QR_TOL, f"qr at {p} position(s): ||QR - A|| / ||A|| = {res:.3g} > {QR_TOL}")
        check(orth <= ORTH_TOL, f"qr at {p} position(s): max|Q^T Q - I| = {orth:.3g} > {ORTH_TOL}")
        check(bool((torch.tril(r.larray, -1) == 0).all()), f"qr at {p} position(s): R not upper-triangular")
        u, s, v = htt.linalg.svd(X)
        check(u.shape == (m, n) and u.split == 0 and s.shape == (n,) and v.shape == (n, n),
              f"svd shapes at {p}")
        s_err = float(((s.larray.double() - s64).abs() / s64).max())
        rec = float(torch.linalg.norm((u.larray.double() * s.larray.double()) @ v.larray.double().T - A64)) / norm_a
        check(s_err <= S_RTOL, f"svd at {p} position(s): S {s_err:.3g} from float64 > rtol {S_RTOL}")
        check(rec <= QR_TOL, f"svd at {p} position(s): ||U S V^T - A|| / ||A|| = {rec:.3g} > {QR_TOL}")
        ms = wall_ms(lambda: htt.linalg.svd(X))
        metrics["qr_svd_ms" if p == 1 else f"qr_svd_{p}pos_ms"] = ms
        print(f"qr/svd {m} x {n}, {p} position(s): ||QR - A||/||A|| {res:.3g}, max|Q^T Q - I| {orth:.3g}, "
              f"S rtol {s_err:.3g}, ||USV^T - A||/||A|| {rec:.3g}; svd {ms:.3f} ms")

    Lasso = htt.regression.Lasso
    y = lasso_target(data).astype(np.float32)
    comm1 = htt.TorchCommunication([dev])
    X1, Y1 = htt.array(data, split=0, comm=comm1), htt.array(y, split=0, comm=comm1)
    cd = Lasso(lam=LASSO_LAM, max_iter=sweeps, tol=-1.0).fit(X1, Y1)
    theta = cd.theta.numpy().reshape(-1)
    t0 = time.perf_counter()
    theta64 = numpy_cd(data, y, LASSO_LAM, sweeps)
    replay_s = time.perf_counter() - t0
    cd_err = float(np.abs(theta - theta64).max())
    check(cd.n_iter == sweeps, f"lasso cd ran {cd.n_iter} sweeps, not {sweeps}")
    check(cd_err <= CD_TOL * float(np.abs(theta64).max()),
          f"lasso cd: {cd_err:.3g} from the float64 replay > {CD_TOL} x {np.abs(theta64).max():.3g}")
    cd_ms = wall_ms(lambda: Lasso(lam=LASSO_LAM, max_iter=sweeps, tol=-1.0).fit(X1, Y1), reps=3)
    metrics["lasso_sweeps_per_s"] = sweeps / cd_ms * 1e3
    print(f"lasso cd, 1 position, {sweeps} sweeps: {cd_err:.3g} from the float64 replay "
          f"(max|theta| {np.abs(theta64).max():.4g}; replay {replay_s:.1f} s on the host); "
          f"{metrics['lasso_sweeps_per_s']:.1f} sweeps/s")

    comm4 = htt.TorchCommunication([dev] * POSITIONS)
    X4, Y4 = htt.array(data, split=0, comm=comm4), htt.array(y, split=0, comm=comm4)

    def gd():
        return Lasso(lam=LASSO_LAM, max_iter=steps, tol=-1.0, solver="gd").fit(X4, Y4)

    exact = gd()
    theta_gd = exact.theta.numpy().reshape(-1).astype(np.float64)
    t0 = time.perf_counter()
    ista64 = numpy_ista(data, y, LASSO_LAM, steps)
    replay_s = time.perf_counter() - t0
    gd_err = float(np.abs(theta_gd - ista64).max())
    check(gd_err <= GD_TOL * float(np.abs(ista64).max()),
          f"lasso gd: {gd_err:.3g} from the float64 replay > {GD_TOL} x {np.abs(ista64).max():.3g}")
    with cq.collective_precision("int8_block"):
        for fn in counted:
            fn.launches = 0
        comp = gd()
        torch.cuda.synchronize()
        launches = {f"blockquant_{fn.__name__.removesuffix('_blocks')}": fn.launches for fn in counted}
        gd_q_ms = wall_ms(gd, reps=3)
    gd_ms = wall_ms(gd, reps=3)
    le = lasso_loss(data, y, theta_gd, LASSO_LAM)
    lq = lasso_loss(data, y, comp.theta.numpy().reshape(-1).astype(np.float64), LASSO_LAM)
    l0 = lasso_loss(data, y, np.zeros(F + 1), LASSO_LAM)
    check(exact.n_iter == comp.n_iter == steps, f"lasso gd ran {exact.n_iter} / {comp.n_iter} steps")
    check(np.isfinite(le) and le < l0, f"lasso gd: exact loss {le} not under the start's {l0}")
    check(abs(lq - le) <= LOSS_RTOL * le, f"lasso gd int8: loss {lq} not within {LOSS_RTOL} of exact {le}")
    # each ISTA step: the EF encode and the ring's first encode, the EF
    # residual, POSITIONS - 1 reduce-scatter hops and the gather's decode
    expected = {"blockquant_quantize": 2 * steps, "blockquant_dequantize": steps,
                "blockquant_dequantize_fma": steps,
                "blockquant_dequantize_add_quantize": (POSITIONS - 1) * steps}
    check(launches == expected, f"lasso gd int8 launches {launches} != {expected}")
    metrics["lasso_gd_iter_per_s"] = steps / gd_ms * 1e3
    metrics["lasso_gd_int8_4pos_iter_per_s"] = steps / gd_q_ms * 1e3
    print(f"lasso gd, {POSITIONS} positions, {steps} steps: exact {gd_err:.3g} from the float64 replay "
          f"(max|theta| {np.abs(ista64).max():.4g}, its loss {lasso_loss(data, y, ista64, LASSO_LAM):.7g}; "
          f"replay {replay_s:.1f} s on the host), loss exact "
          f"{le:.7g}, int8_block {lq:.7g} (rel {abs(lq - le) / le:.3g}, start {l0:.4g}); launches {launches}; exact "
          f"{metrics['lasso_gd_iter_per_s']:.1f} iter/s, int8_block "
          f"{metrics['lasso_gd_int8_4pos_iter_per_s']:.1f} iter/s")
    return launches, metrics


# --------------------------------------------------------------------- #
# the RNG and the estimators that draw from it (phase 8)                  #
# --------------------------------------------------------------------- #
def label_share(labels: np.ndarray, truth: np.ndarray, k: int) -> float:
    """The share of rows whose label maps to their true label under the
    best one-to-one relabelling."""
    from scipy.optimize import linear_sum_assignment

    counts = np.zeros((k, k))
    np.add.at(counts, (labels, truth), 1)
    rows, cols = linear_sum_assignment(-counts)
    return float(counts[rows, cols].sum() / len(labels))


def ulps_from(a: np.ndarray, b: np.ndarray) -> float:
    """Largest distance of ``a`` from ``b`` in ulps of ``b``'s dtype, the ulp
    taken at each element of ``b``."""
    return float((np.abs(a.astype(np.float64) - b) / np.spacing(np.abs(b))).max())


def kpp_check(data64: np.ndarray, picks, us: np.ndarray, margin: float = KPP_GAP):
    """Hold k-means++ picks (row indices, the first one given) to a float64
    replay of the d^2 CDF from the same picks: pick i must be the row in
    whose CDF interval ``us[i] * total`` falls (left side), or, where that
    draw lies within ``margin`` of the total from a CDF step (where two
    float32 cumsums may round apart), a row whose interval reaches within
    that margin of it.  Returns the number of such draws near a step and
    the smallest distance of a draw from a step, as a share of the total."""
    dmin, near, gmin = np.full(len(data64), np.inf), 0, np.inf
    for i in range(1, len(picks)):
        dmin = np.minimum(dmin, ((data64 - data64[picks[i - 1]]) ** 2).sum(1))
        cdf = np.cumsum(dmin)
        total = cdf[-1]
        draw = float(us[i]) * total
        j = min(int(np.searchsorted(cdf, draw)), len(cdf) - 1)
        gap = float(np.abs(cdf[max(j - 1, 0):j + 1] - draw).min() / total)
        gmin = min(gmin, gap)
        if int(picks[i]) != j:
            lo = cdf[picks[i] - 1] if picks[i] else 0.0
            check(gap <= margin and lo - margin * total <= draw <= cdf[picks[i]] + margin * total,
                  f"k-means++ draw {i} picked row {picks[i]}, the float64 CDF row {j} "
                  f"(the draw {gap:.3g} of the total from a step)")
            near += 1
    return near, gmin


def rows_of(data: np.ndarray, centers: np.ndarray) -> list:
    """The index of each center among the rows of ``data`` (raises when a
    center is not a row)."""
    idx = []
    for c in centers:
        hit = np.flatnonzero((data == c).all(1))
        check(len(hit) == 1, f"a center is not a row of the data ({len(hit)} matches)")
        idx.append(int(hit[0]))
    return idx


def nb_log_likelihood(x64: np.ndarray, theta, sigma, prior) -> np.ndarray:
    """GaussianNB's joint log-likelihood in float64 numpy."""
    n_ij = -0.5 * np.log(2.0 * np.pi * sigma).sum(1)
    ll = np.stack([n_ij[c] - 0.5 * (((x64 - theta[c]) ** 2) / sigma[c]).sum(1) for c in range(len(theta))], 1)
    return np.log(np.maximum(prior, 1e-300))[None, :] + ll


def knn_replay(train: np.ndarray, labels: np.ndarray, query: np.ndarray, k: int, classes: int):
    """KNN in float64 numpy: the k nearest training rows of each query
    (argsort of the distances), their vote, the lowest class of most votes;
    and the rows where the k-th and (k+1)-th distances tie within float32
    rounding of the quadratic expansion (where either neighbour may win)."""
    t64, q64 = train.astype(np.float64), query.astype(np.float64)
    t2 = (t64 * t64).sum(1)
    pred, tie = np.empty(len(q64), np.int64), np.zeros(len(q64), bool)
    for lo in range(0, len(q64), 1000):
        q = q64[lo:lo + 1000]
        q2 = (q * q).sum(1)[:, None]
        d2 = q2 + t2[None, :] - 2.0 * q @ t64.T
        part = np.argpartition(d2, k, axis=1)[:, :k + 1]
        order = np.take_along_axis(d2, part, 1).argsort(1)
        near = np.take_along_axis(part, order, 1)
        dk = np.take_along_axis(d2, near, 1)
        tol = 64 * np.finfo(np.float32).eps * (q2[:, 0] + t2[near[:, k]])
        tie[lo:lo + 1000] = dk[:, k] - dk[:, k - 1] <= tol
        votes = np.stack([(labels[near[:, :k]] == c).sum(1) for c in range(classes)], 1)
        pred[lo:lo + 1000] = votes.argmax(1)
    return pred, tie


def phase_rng(torch, htt, dev):
    """Phase 8, first part: the draws on the card at 1 and POSITIONS
    positions against the port's CPU draws of the same seed and counter,
    and the counter advancing by the elements drawn.  Returns the metrics."""
    import math

    cpu = htt.TorchCommunication(["cpu"])
    got = {}
    for p in (1, POSITIONS):
        comm = htt.TorchCommunication([dev] * p)
        htt.random.seed(0)
        counter = 0
        for fn, args in RNG_DRAWS:
            out = getattr(htt.random, fn)(*args, split=0, comm=comm)
            counter += math.prod(args[2] if fn == "randint" else args)
            check(htt.random.get_state() == ("Threefry", 0, counter, 0, 0.0),
                  f"{fn} at {p} position(s): state {htt.random.get_state()}, counter {counter} expected")
            check(out.larray.device.type == "cuda", f"{fn} drew off the card")
            got[p, fn] = out.larray
    htt.random.seed(0)
    for fn, args in RNG_DRAWS:
        want = getattr(htt.random, fn)(*args, split=0, comm=cpu).larray
        card, card4 = got[1, fn], got[POSITIONS, fn]
        check(bitwise_equal(card, card4), f"{fn}: 1 and {POSITIONS} positions differ on the card")
        if fn == "randn":
            u = ulps_from(card.cpu().numpy(), want.numpy())
            check(u <= RANDN_ULPS, f"randn: {u} ulps from the CPU draw > {RANDN_ULPS}")
            same = float((card.cpu() == want).double().mean())
            print(f"randn {tuple(args)}: {u:.0f} ulps at most from the CPU draw ({same:.4f} bitwise equal)")
        else:
            check(bitwise_equal(card.cpu(), want), f"{fn} on the card != the CPU draw")
            print(f"{fn} {tuple(args)}: bitwise equal to the CPU draw, at 1 and {POSITIONS} positions")
    perm = got[1, "randperm"].cpu().numpy()
    check(bool((np.sort(perm) == np.arange(N)).all()), "randperm is not a permutation")

    comm1 = htt.TorchCommunication([dev])
    randn_ms = device_ms(lambda: htt.random.randn(QR_M, QR_N, split=0, comm=comm1), [()])
    metrics = {
        "rng_randn_gb_per_s": QR_M * QR_N * 4 / randn_ms / 1e6,
        "rng_randn_wall_ms": wall_ms(lambda: htt.random.randn(QR_M, QR_N, split=0, comm=comm1)),
        "randperm_500k_ms": wall_ms(lambda: htt.random.randperm(N, comm=comm1)),
        "randperm_500k_device_ms": device_ms(lambda: htt.random.randperm(N, comm=comm1), [()]),
    }
    print(f"randn {QR_M} x {QR_N}: {randn_ms:.3f} ms of device time, "
          f"{metrics['rng_randn_gb_per_s']:.1f} GB/s written; randperm({N}): "
          f"{metrics['randperm_500k_ms']:.3f} ms wall, {metrics['randperm_500k_device_ms']:.3f} ms device")
    return metrics


def phase_kclusterers(torch, htt, dev, data, centers):
    """Phase 8, second part: KMeans with its string inits, KMedians and
    KMedoids on the blobs at one position.  Returns the metrics."""
    from heat_tpu_torch.cluster.kmeans import _assign

    comm1, cpu = htt.TorchCommunication([dev]), htt.TorchCommunication(["cpu"])
    X = htt.array(data, split=0, comm=comm1)
    arr = X.larray
    d64 = data.astype(np.float64)
    metrics = {}
    state = ("Threefry", 7, 0, 0, 0.0)

    # KMeans with its defaults: init="random" (k rows at randperm's first k
    # places), then k-means++.  Each step of the fit is held to a float64
    # numpy Lloyd step from the same centers: the labels equal off float32
    # ties, the new centers the means of the port's labels.  (A whole
    # float32 trajectory is not comparable after a blob is split between
    # two centers: its tie flips drift, 0.023 between torch on the CPU and
    # numpy after the 109 steps of the random init's fit.)
    x2 = (d64 * d64).sum(1)
    for init, key in (("random", "kmeans_random_init_ms"), ("probability_based", "kmeanspp_init_ms")):
        htt.random.set_state(state)
        km = htt.cluster.KMeans(n_clusters=K, init=init)
        km._initialize_cluster_centers(X)
        init_c = km.cluster_centers_.larray
        htt.random.set_state(state)
        rows = rows_of(data, init_c.cpu().numpy())
        if init == "random":
            check(rows == htt.random.randperm(N, comm=cpu).larray[:K].tolist(),
                  f"KMeans init=random: rows {rows}, not the CPU draw's")
            drawn = ""
        else:
            first = int(htt.random.randint(0, N, (1,), comm=cpu).larray[0])
            us = htt.random.rand(K, comm=cpu).larray.numpy()
            check(rows[0] == first, f"k-means++ first row {rows[0]}, not the CPU draw's {first}")
            near, gmin = kpp_check(d64, rows, us)
            drawn = (f" ({near} picks off the float64 CDF's row, each by a draw within {KPP_GAP} "
                     f"of a step; the closest draw {gmin:.3g} of the total from a step)")
        htt.random.set_state(state)
        fitted = htt.cluster.KMeans(n_clusters=K, init=init).fit(X)
        carry, tol, flips, c_err = (0, init_c, float("inf")), float(np.float32(km.tol)), 0, 0.0
        while carry[0] < km.max_iter and carry[2] > tol:
            lab = _assign(arr, carry[1]).cpu().numpy()
            c64 = carry[1].double().cpu().numpy()
            # d^2 less the row's |x|^2, which moves neither argmin nor gaps
            d2 = d64 @ (-2.0 * c64.T)
            d2 += (c64 * c64).sum(1)
            best = d2.argmin(1)
            first = d2[np.arange(N), best]
            d2[np.arange(N), best] = np.inf
            ties = d2.min(1) - first <= 64 * np.finfo(np.float32).eps * (x2 + (c64 * c64).sum(1).max())
            off = lab != best
            check(not bool((off & ~ties).any()), f"KMeans init={init} step {carry[0]}: labels off ties")
            flips += int(off.sum())
            carry = htt.cluster.KMeans._fit_segment(arr, tol, carry[0] + 1, carry)
            counts = np.bincount(lab, minlength=K)[:, None]
            sums = np.eye(K)[lab].T @ d64
            means = np.where(counts > 0, sums / np.maximum(counts, 1), c64)
            got = carry[1].cpu().numpy()
            check(np.allclose(got, means, rtol=1e-5, atol=1e-4), f"KMeans init={init} step {carry[0]}: centers")
            c_err = max(c_err, float(np.abs(got - means).max()))
        check(carry[0] == fitted.n_iter_ and bitwise_equal(carry[1], fitted.cluster_centers_.larray),
              f"KMeans init={init}: the fit != its steps")

        def init_once(init=init):
            htt.random.set_state(state)
            htt.cluster.KMeans(n_clusters=K, init=init)._initialize_cluster_centers(X)

        metrics[key] = wall_ms(init_once)
        print(f"KMeans init={init}: rows {rows}{drawn}, {fitted.n_iter_} steps, each held to float64 numpy ({flips} labels on float32 ties, "
              f"centers within {c_err:.3g}); init {metrics[key]:.3f} ms")

    # KMedians: the benchmark's init (the generating centers), exactly
    # MED_STEPS steps, against numpy's median of each cluster's rows under
    # the port's own labels, step by step
    init = htt.array(centers, comm=comm1)
    med = htt.cluster.KMedians(n_clusters=K, init=init, max_iter=MED_STEPS, tol=-1.0).fit(X)
    check(med.n_iter_ == MED_STEPS, f"KMedians ran {med.n_iter_} steps")
    c, made_by = centers.copy(), None
    for _ in range(MED_STEPS):
        lab = _assign(arr, torch.from_numpy(c).to(dev)).cpu().numpy()
        if made_by is not None and np.array_equal(lab, made_by):
            continue  # the labels that made c: the same medians again
        c = np.stack([np.median(data[lab == j], axis=0) if (lab == j).any() else c[j]
                      for j in range(K)]).astype(np.float32)
        made_by = lab
    check(bool((med.cluster_centers_.numpy() == c).all()), "KMedians centers != numpy's medians, bitwise")
    med_ms = wall_ms(lambda: htt.cluster.KMedians(n_clusters=K, init=init, max_iter=MED_STEPS, tol=-1.0).fit(X),
                     reps=3)
    metrics["kmedians_iter_per_s"] = MED_STEPS / med_ms * 1e3

    # KMedoids: MED_STEPS assign-and-snap steps from the same init, each
    # held to numpy: the mean of each cluster's rows (float64) snapped to
    # its nearest member (float64 distances); a member whose distance ties
    # the nearest within float32 rounding may win instead
    KMedoids = htt.cluster.KMedoids
    c_t = torch.from_numpy(centers).to(dev)
    ties, held = 0, None
    for _ in range(MED_STEPS):
        lab = _assign(arr, c_t).cpu().numpy()
        nxt = KMedoids._step_loop(arr, c_t, 1)
        got = nxt.cpu().numpy()
        if held is not None and bitwise_equal(held, c_t) and bitwise_equal(nxt, c_t):
            continue  # a fixed point, its step already held to numpy
        held = c_t
        for j in range(K):
            rows = np.flatnonzero(lab == j)
            if not len(rows):
                check(bool((got[j] == c_t[j].cpu().numpy()).all()), "KMedoids moved an empty cluster")
                continue
            mean = d64[rows].mean(0)
            dist = ((d64[rows] - mean) ** 2).sum(1)
            best = rows[int(dist.argmin())]
            if not (got[j] == data[best]).all():
                pick = np.flatnonzero((data[rows] == got[j]).all(1))
                tol = 64 * np.finfo(np.float32).eps * float((mean * mean).sum() + (d64[best] ** 2).sum())
                check(len(pick) == 1 and dist[pick[0]] - dist.min() <= tol,
                      f"KMedoids center {j} is not its cluster's medoid (or a tie of it)")
                ties += 1
        c_t = nxt
    fit = KMedoids(n_clusters=K, init=init, max_iter=MED_STEPS).fit(X)
    check(bitwise_equal(fit.cluster_centers_.larray, KMedoids._step_loop(arr, init.larray, fit.n_iter_)),
          "KMedoids.fit != its steps")
    check(all((data == row).all(1).any() for row in fit.cluster_centers_.numpy()),
          "KMedoids centers are not data rows")
    medoid_ms = wall_ms(lambda: KMedoids._step_loop(arr, init.larray, MED_STEPS), reps=3)
    metrics["kmedoids_iter_per_s"] = MED_STEPS / medoid_ms * 1e3

    # the "++" inits through the RNG: the initial centers are the float64
    # replay's rows, the fits run
    for cls, alias in ((htt.cluster.KMedians, "kmedians++"), (KMedoids, "probability_based")):
        htt.random.set_state(state)
        first = int(htt.random.randint(0, N, (1,), comm=cpu).larray[0])
        us = htt.random.rand(K, comm=cpu).larray.numpy()
        htt.random.set_state(state)
        est = cls(n_clusters=K, init=alias, max_iter=MED_STEPS)
        est._initialize_cluster_centers(X)
        rows = rows_of(data, est.cluster_centers_.numpy())
        check(rows[0] == first, f"{cls.__name__} {alias}: first row {rows[0]}, not the CPU draw's {first}")
        kpp_check(d64, rows, us)
        est.fit(X)
        check(bool(np.isfinite(est.cluster_centers_.numpy()).all()), f"{cls.__name__} {alias}: fit")
    print(f"KMedians {MED_STEPS} steps bitwise equal to numpy's medians, "
          f"{metrics['kmedians_iter_per_s']:.1f} iter/s; KMedoids {MED_STEPS} steps held to numpy "
          f"({ties} float32 ties), fit converged in {fit.n_iter_} steps, "
          f"{metrics['kmedoids_iter_per_s']:.1f} iter/s")
    return metrics


def phase_spectral_nb_knn(torch, htt, cq, dev, data, counted):
    """Phase 8, third part: Spectral on SUB rows, GaussianNB exact and
    under int8_block at POSITIONS positions (the kernels' launches of its
    fit), KNN.  Returns the launch counts and the metrics."""
    comm1, comm4 = htt.TorchCommunication([dev]), htt.TorchCommunication([dev] * POSITIONS)
    truth = np.repeat(np.arange(K), N // K)
    metrics = {}

    # Spectral: the Lanczos basis and T, the Ritz pairs, the labels
    sub, t_sub = data[::N // SUB], truth[::N // SUB]
    Xs = htt.array(sub, split=0, comm=comm1)
    sp = htt.cluster.Spectral(n_clusters=K, gamma=SPECTRAL_GAMMA, metric="rbf", n_lanczos=SPECTRAL_M)
    L = sp._laplacian.construct(Xs)
    v0 = htt.full((SUB,), 1.0 / np.sqrt(SUB), dtype=htt.float32, comm=comm1)
    t0 = time.perf_counter()
    V, T = htt.linalg.lanczos(L, SPECTRAL_M, v0=v0)
    torch.cuda.synchronize()
    metrics["lanczos_ms"] = (time.perf_counter() - t0) * 1e3
    Vd, Td, Ld = V.larray.double(), T.larray.double(), L.larray
    eye = torch.eye(SPECTRAL_M, dtype=torch.float64, device=dev)
    orth = float((Vd.T @ Vd - eye).abs().max())
    LV = (Ld @ V.larray).double()
    tri = float(torch.linalg.norm(Vd.T @ LV - Td) / torch.linalg.norm(Td))
    theta, Y = torch.linalg.eigh(Td)
    U = Vd @ Y[:, :K]
    ritz = float(torch.linalg.vector_norm((LV @ Y[:, :K]) - U * theta[:K], dim=0).max())
    check(orth <= ORTH_TOL, f"lanczos: max|V^T V - I| = {orth:.3g} > {ORTH_TOL}")
    check(tri <= 1e-4, f"lanczos: ||V^T L V - T|| / ||T|| = {tri:.3g} > 1e-4")
    check(ritz <= RITZ_TOL, f"lanczos: Ritz residual {ritz:.3g} > {RITZ_TOL}")
    # device time of the 300 steps (busy 0.93 in the profile), one call a graph
    metrics["lanczos_device_ms"] = device_ms(lambda: htt.linalg.lanczos(L, SPECTRAL_M, v0=v0), [()],
                                             per_graph=1, trials=3)
    del L, LV, Ld
    t0 = time.perf_counter()
    sp.fit(Xs)
    torch.cuda.synchronize()
    metrics["spectral_fit_ms"] = (time.perf_counter() - t0) * 1e3
    share = label_share(sp.labels_.numpy(), t_sub, K)
    check(share >= SPECTRAL_SHARE, f"Spectral recovers {share} of the blob labels < {SPECTRAL_SHARE}")
    print(f"Spectral {SUB} rows: max|V^T V - I| {orth:.3g}, ||V^T L V - T||/||T|| {tri:.3g}, Ritz residual "
          f"{ritz:.3g} (theta {theta[:K].cpu().numpy().round(5).tolist()}), label share {share}; lanczos "
          f"{metrics['lanczos_ms']:.1f} ms ({metrics['lanczos_device_ms']:.1f} ms of device time), fit "
          f"{metrics['spectral_fit_ms']:.1f} ms")

    # GaussianNB on the blobs, labels their blob index
    d64 = data.astype(np.float64)
    nb = htt.naive_bayes.GaussianNB
    X1, y1 = htt.array(data, split=0, comm=comm1), htt.array(truth, split=0, comm=comm1)
    exact = nb().fit(X1, y1)
    theta64 = np.stack([d64[truth == c].mean(0) for c in range(K)])
    var64 = np.stack([d64[truth == c].var(0) for c in range(K)]) + 1e-9 * d64.var(0).max()
    for name, got, want in (("theta_", exact.theta_, theta64), ("sigma_", exact.sigma_, var64)):
        rel = float((np.abs(got - want) / np.abs(want)).max())
        check(rel <= 1e-10, f"GaussianNB {name}: {rel:.3g} relative from float64 numpy > 1e-10")
    pred = exact.predict(X1).numpy()
    want_pred = nb_log_likelihood(d64, exact.theta_, exact.sigma_, exact.class_prior_).argmax(1)
    check(bool((pred == want_pred).all()), "GaussianNB predict != numpy's argmax of the log-likelihood")
    metrics["gaussian_nb_fit_ms"] = wall_ms(lambda: nb().fit(X1, y1), reps=3)

    X4, y4 = htt.array(data, split=0, comm=comm4), htt.array(truth, split=0, comm=comm4)
    with cq.collective_precision("int8_block"):
        for fn in counted:
            fn.launches = 0
        comp = nb().fit(X4, y4)
        torch.cuda.synchronize()
        launches = {f"blockquant_{fn.__name__.removesuffix('_blocks')}": fn.launches for fn in counted}
        metrics["gaussian_nb_int8_4pos_fit_ms"] = wall_ms(lambda: nb().fit(X4, y4), reps=3)
    # one ring_allreduce_q of the (4, k, f) ssd partials: its first encode,
    # POSITIONS - 1 reduce-scatter hops and the gather's decode
    expected = {"blockquant_quantize": 1, "blockquant_dequantize": 1, "blockquant_dequantize_fma": 0,
                "blockquant_dequantize_add_quantize": POSITIONS - 1}
    check(launches == expected, f"GaussianNB int8 launches {launches} != {expected}")
    blocks, lab4 = d64.reshape(POSITIONS, -1, F), truth.reshape(POSITIONS, -1)
    parts = np.stack([np.stack([((blocks[i][lab4[i] == c] - theta64[c]) ** 2).sum(0) for c in range(K)])
                      for i in range(POSITIONS)])
    bound = (POSITIONS + 1) * float(np.abs(parts).reshape(POSITIONS, -1).max(1).sum()) / 254.0 / (N // K)
    s_err = float(np.abs(comp.sigma_ - exact.sigma_).max())
    check(s_err <= bound, f"GaussianNB int8: sigma_ {s_err:.3g} from exact > the ring bound {bound:.3g}")
    # the compressed fit's means come from float32 sums (combined exactly):
    # within float32's summation bound n eps sum|x| / count of the exact ones
    t_err = np.abs(comp.theta_ - exact.theta_)
    t_bound = (N // POSITIONS) * float(np.finfo(np.float32).eps) * np.stack(
        [np.abs(d64[truth == c]).sum(0) for c in range(K)]) / (N // K)
    check(bool((t_err <= t_bound).all()), f"GaussianNB int8: theta_ {t_err.max():.3g} from exact, "
          f"past float32's summation bound {t_bound.min():.3g}")
    print(f"GaussianNB: exact within 1e-10 of float64 numpy, predict == numpy on all {N} rows; int8_block "
          f"at {POSITIONS} positions: sigma_ {s_err:.3g} from exact (bound {bound:.3g}), theta_ "
          f"{t_err.max():.3g} (float32 sums), launches {launches}; "
          f"fit {metrics['gaussian_nb_fit_ms']:.1f} ms, int8 {metrics['gaussian_nb_int8_4pos_fit_ms']:.1f} ms")

    # KNN: train on SUB rows, predict SUB others
    train, query = data[::N // SUB], data[1::N // SUB]
    knn = htt.classification.KNN(htt.array(train, split=0, comm=comm1),
                                 htt.array(t_sub, split=0, comm=comm1), KNN_K)
    Q = htt.array(query, split=0, comm=comm1)
    got = knn.predict(Q).numpy()
    want, tie = knn_replay(train, t_sub, query, KNN_K, K)
    off = got != want
    check(not bool((off & ~tie).any()), f"KNN: {int((off & ~tie).sum())} labels differ from numpy off ties")
    metrics["knn_predict_ms"] = wall_ms(lambda: knn.predict(Q))
    metrics["knn_predict_device_ms"] = device_ms(lambda: knn.predict(Q), [()], per_graph=4, trials=5)
    print(f"KNN {SUB} x {SUB}, k={KNN_K}: labels equal numpy's on every row but {int(off.sum())} "
          f"({int(tie.sum())} rows with a distance tie at the k-th neighbour); predict "
          f"{metrics['knn_predict_ms']:.2f} ms ({metrics['knn_predict_device_ms']:.2f} ms of device time)")

    # an int64 2048^3 product (exact in float64: |a|, |b| < 1000)
    rng = np.random.default_rng(3)
    a, b = (torch.from_numpy(rng.integers(-1000, 1000, size=(2048, 2048))).to(dev) for _ in range(2))
    A, B = htt.array(a, split=0, comm=comm1), htt.array(b, comm=comm1)
    prod = (A @ B).larray
    check(bool(torch.equal(prod, (a.double() @ b.double()).to(torch.int64))), "int64 matmul != exact product")
    metrics["int_matmul_2048_ms"] = wall_ms(lambda: A @ B, reps=3)
    metrics["int_matmul_2048_device_ms"] = device_ms(lambda: A @ B, [()], per_graph=1, trials=3)
    print(f"int64 2048^3 matmul: exact, {metrics['int_matmul_2048_ms']:.1f} ms "
          f"({metrics['int_matmul_2048_device_ms']:.1f} ms of device time)")
    return launches, metrics


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every JSON line to this file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    return run(torch.device("cuda", 0), args.out)


def run(dev, out_path=None) -> int:
    import torch

    import importlib

    import heat_tpu_torch as htt
    from heat_tpu_torch import kernels
    from heat_tpu_torch.comm import compressed as cq

    fa = importlib.import_module("heat_tpu_torch.parallel.flash_attention")

    lines = []
    t_run = time.perf_counter()

    # ---------------------------------------------------------------- 1
    t0 = time.perf_counter()
    built = kernels.build_all()
    build_s = time.perf_counter() - t0
    card = card_line()
    print(f"build: {build_s:.1f} s ({built}); card: {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    for name in ("blockquant", "flash_attention"):
        for row in kernels.ptxas_report(name):
            print(f"ptxas {name}: {row['entry']}: {row['registers']} registers, spill stores "
                  f"{row['spill_stores']} B, spill loads {row['spill_loads']} B"
                  + "".join(f"; {w}" for w in row["warnings"]))
    half = [r for r in kernels.ptxas_report("flash_attention")
            if "__nv_bfloat16" in r["entry"] or "6__half" in r["entry"]]
    check(bool(half) and all(r["spill_stores"] == 0 and r["spill_loads"] == 0 for r in half),
          "ptxas: no bf16/f16 flash instantiation reported, or one spills")

    # ---------------------------------------------------------------- 2
    kernel_rows = phase_kernels(torch, cq, dev)

    # ---------------------------------------------------------------- 3
    data, centers = make_blobs()
    comm1 = htt.TorchCommunication([dev])
    X = htt.array(data, split=0, comm=comm1)
    mean, std = htt.mean(X, axis=0), htt.std(X, axis=0)
    d64 = data.astype(np.float64)
    check(np.allclose(mean.numpy(), d64.mean(0), rtol=1e-4, atol=1e-4), "mean != numpy")
    check(np.allclose(std.numpy(), d64.std(0), rtol=1e-4), "std != numpy")
    moments_ms = wall_ms(lambda: (htt.mean(X, axis=0), htt.std(X, axis=0)))

    X_sub = htt.array(data[:SUB], split=0, comm=comm1)
    D = htt.spatial.cdist(X_sub, quadratic_expansion=True)
    check(D.shape == (SUB, SUB) and D.split == 0, f"cdist shape {D.shape}")
    sample = data[:64].astype(np.float64)
    ref = np.sqrt(((sample[:, None, :] - d64[None, :SUB, :]) ** 2).sum(-1))
    got = D.larray[:64].cpu().numpy()
    check(bool(np.isfinite(got).all()), "cdist has non-finite values")
    check(np.allclose(got, ref, rtol=1e-4, atol=5e-2), "cdist != numpy on the first 64 rows")
    del D
    cdist_ms = wall_ms(lambda: htt.spatial.cdist(X_sub, quadratic_expansion=True))

    init1 = htt.array(centers, comm=comm1)
    km = htt.cluster.KMeans(n_clusters=K, init=init1, max_iter=ITERS, tol=-1.0).fit(X)
    np_centers = numpy_lloyd(data, centers, ITERS)
    c1 = km.cluster_centers_.numpy()
    check(km.n_iter_ == ITERS, f"n_iter {km.n_iter_}")
    check(np.allclose(c1, np_centers, rtol=1e-4, atol=1e-4), "KMeans centers != numpy Lloyd")
    labels1 = km.labels_.numpy()
    pred = km.predict(X).numpy()
    check(float((pred == labels1).mean()) >= 0.9999, "predict disagrees with the fit's labels")
    fit_ms = wall_ms(
        lambda: htt.cluster.KMeans(n_clusters=K, init=init1, max_iter=ITERS, tol=-1.0).fit(X), reps=3
    )
    print(f"one position: KMeans {ITERS / fit_ms * 1e3:.1f} iter/s, cdist "
          f"{SUB * SUB * 4 / cdist_ms / 1e6:.1f} GB/s, mean+std {N * F * 4 * 2 / moments_ms / 1e6:.1f} GB/s")

    # ---------------------------------------------------------------- 4
    comm4 = htt.TorchCommunication([dev] * POSITIONS)
    rng = np.random.default_rng(1)
    stacked_np = rng.normal(size=(POSITIONS, PAYLOAD)).astype(np.float32)
    stacked = torch.from_numpy(stacked_np).to(dev)
    X4 = htt.array(data, split=0, comm=comm4)
    init4 = htt.array(centers, comm=comm4)
    counted = (cq.quantize_blocks, cq.dequantize_blocks, cq.dequantize_fma_blocks,
               cq.dequantize_add_quantize_blocks)
    with cq.collective_precision("int8_block"):
        for fn in counted:
            fn.launches = 0
        red = comm4.allreduce(stacked, "sum")
        m4, v4, s4 = htt.mean(X4, axis=0), htt.var(X4, axis=0), htt.std(X4, axis=0)
        km4 = htt.cluster.KMeans(n_clusters=K, init=init4, max_iter=ITERS, tol=-1.0).fit(X4)
        torch.cuda.synchronize()
        launches = {f"blockquant_{fn.__name__.removesuffix('_blocks')}": fn.launches for fn in counted}

        exact = stacked_np.astype(np.float64).sum(0)
        bound = POSITIONS * float(np.abs(stacked_np).max(axis=1).sum()) / 254.0
        got = red.cpu().numpy()
        check(got.shape == (PAYLOAD,) and bool(np.isfinite(got).all()), "allreduce_q output")
        check(float(np.abs(got - exact).max()) <= bound, "allreduce_q outside p*sum(absmax)/254")
        check(bool((got != exact.astype(np.float32)).any()), "allreduce_q did not quantize")
        unfused = ring_unfused(torch, cq, stacked, POSITIONS)
        check(bitwise_equal(red, unfused), "allreduce_q != the ring of unfused kernels, bitwise")
        # the documented ring bound on the per-position partial sums, over N
        parts = d64.reshape(POSITIONS, N // POSITIONS, F).sum(1)
        m_bound = POSITIONS * float(np.abs(parts).max(axis=1).sum()) / 254.0 / N
        m_err = float(np.abs(m4.numpy() - d64.mean(0)).max())
        check(m_err <= m_bound, f"int8 mean error {m_err} outside its bound {m_bound}")
        # var/std: the same bound on the per-position centered sums of
        # squares, which is what rides the ring
        ssd = ((d64.reshape(POSITIONS, N // POSITIONS, F) - d64.mean(0)) ** 2).sum(1)
        v_bound = POSITIONS * float(np.abs(ssd).max(axis=1).sum()) / 254.0 / N
        v_err = float(np.abs(v4.numpy() - d64.var(0)).max())
        s_err = float((np.abs(s4.numpy() - d64.std(0)) * d64.std(0)).max())
        check(v_err <= v_bound, f"int8 var error {v_err} outside its bound {v_bound}")
        check(s_err <= v_bound, f"int8 std error outside its bound")
        # KMeans: the EF ring's error on a step's sums is at most the ring
        # bound plus the carried residual, (p+1) * sum_i absmax_i / 254,
        # divided by the cluster's count for its center
        agree = float((km4.labels_.numpy() == labels1).mean())
        shift = float(np.abs(km4.cluster_centers_.numpy() - c1).max())
        blocks = d64.reshape(POSITIONS, N // POSITIONS, F)
        lab = labels1.reshape(POSITIONS, -1)
        sums = np.stack([np.stack([blocks[i][lab[i] == k].sum(0) for k in range(K)]) for i in range(POSITIONS)])
        count = np.bincount(labels1, minlength=K).min()
        c_bound = (POSITIONS + 1) * float(np.abs(sums).reshape(POSITIONS, -1).max(1).sum()) / 254.0 / count
        check(agree >= 0.999, f"int8 KMeans labels agree on {agree:.5f} < 0.999")
        check(shift <= c_bound, f"int8 KMeans centers {shift} from exact, bound {c_bound}")
        allreduce_ms = wall_ms(lambda: comm4.allreduce(stacked, "sum"), reps=9)
        fit4_ms = wall_ms(
            lambda: htt.cluster.KMeans(n_clusters=K, init=init4, max_iter=ITERS, tol=-1.0).fit(X4),
            reps=3,
        )
    for name, count in launches.items():
        check(count > 0, f"{name} was not launched on the main path")
    # 34 rings (1 allreduce, 3 moments, 30 KMeans steps): 1 quantize, 3
    # hops and 1 dequantize each; 30 error-feedback residuals: 1 quantize
    # and 1 dequantize_fma each
    expected = {"blockquant_quantize": 64, "blockquant_dequantize": 34,
                "blockquant_dequantize_fma": 30, "blockquant_dequantize_add_quantize": 102}
    check(launches == expected, f"launches {launches} != {expected}")
    for row in kernel_rows:
        row["launches"] = launches[row["name"]]
    print(f"{POSITIONS} positions, int8_block: launches {launches} ({sum(launches.values())} in all); "
          f"allreduce bitwise equal to the unfused ring; allreduce error "
          f"{float(np.abs(got - exact).max()):.4g} (bound {bound:.4g}); var error {v_err:.4g} "
          f"(bound {v_bound:.4g}); KMeans labels agree {agree:.6f}, max center shift "
          f"{shift:.4g} (bound {c_bound:.4g})")

    # ---------------------------------------------------------------- 5
    attn_rows, attn_metrics = phase_attention_kernels(torch, fa, dev)

    # ---------------------------------------------------------------- 6
    attn_launches, path_metrics = phase_attention_path(torch, htt, fa, dev)
    for row in attn_rows:
        row["launches"] = attn_launches[row["name"]]

    # ---------------------------------------------------------------- 7
    lasso_launches, linalg_metrics = phase_linalg_lasso(torch, htt, cq, dev, data, counted)
    for row in kernel_rows:
        row["launches_by_phase"] = {"4": row["launches"], "7": lasso_launches[row["name"]]}
        row["launches"] += lasso_launches[row["name"]]
    # ---------------------------------------------------------------- 8
    rng_metrics = phase_rng(torch, htt, dev)
    kc_metrics = phase_kclusterers(torch, htt, dev, data, centers)
    nb_launches, est_metrics = phase_spectral_nb_knn(torch, htt, cq, dev, data, counted)
    for row in kernel_rows:
        row["launches_by_phase"]["8"] = nb_launches[row["name"]]
        row["launches"] += nb_launches[row["name"]]
    kernel_rows += attn_rows

    metrics = {
        "kmeans_iter_per_s": ITERS / fit_ms * 1e3,
        "cdist_gb_per_s": SUB * SUB * 4 / cdist_ms / 1e6,
        "moments_gb_per_s": N * F * 4 * 2 / moments_ms / 1e6,
        "allreduce_q_exact_payload_gb_per_s": PAYLOAD * 4 / allreduce_ms / 1e6,
        "kmeans_int8_4pos_iter_per_s": ITERS / fit4_ms * 1e3,
        "allreduce_q_ms": allreduce_ms,
        **attn_metrics,
        **path_metrics,
        **linalg_metrics,
        **rng_metrics,
        **kc_metrics,
        **est_metrics,
        "build_s": build_s,
        "run_s": time.perf_counter() - t_run,
        "card": card,
    }
    lines.append(json.dumps({"metrics": metrics}))
    lines.append(json.dumps({"kernels": kernel_rows}))
    lines.append(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    print(lines[0])
    print(card)
    print(lines[1])
    print(lines[2])
    if out_path:
        with open(out_path, "w") as fh:
            fh.write("\n".join([json.dumps({"card": card})] + lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
