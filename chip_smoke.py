#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``heat_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA device and the
CUDA toolkit:

    python3 chip_smoke.py [--out FILE]

Phases (any failure exits non-zero; nothing is caught and continued):

1. build the CUDA kernels from ``heat_tpu_torch/csrc`` (one ``nvcc`` per
   source, all at once) and print the card's name and power limit;
2. hold each kernel against its plain PyTorch version on the card,
   bitwise, at the main path's shape (8192 rows = 2^20 values) and at odd
   row counts, on random and special blocks (zero, NaN, +-Inf, the 1e36
   saturation block, subnormal, flushed scales, near FLT_MAX, ties), and
   time kernel, plain version and, where one exists, the single PyTorch
   call computing the same function;
3. the main path at ONE position, exact: 500 000 x 32 float32 blobs
   split over rows, mean/std, cdist on 20 000 rows, KMeans (k=8, 30
   Lloyd steps, explicit initial centers) and predict, checked against
   numpy;
4. the compressed path at FOUR positions on the one card under the
   ``int8_block`` policy: allreduce of a (4, 2^20) payload, mean/var/std,
   and the error-feedback KMeans fit, each held to the documented ring
   bound ``p * sum_i absmax_i / 254`` of what rides the ring (the labels
   to 99.9 % of the exact fit's); the kernels' launch counts are set to 0
   before this phase and read after it, and each must be above 0.

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
#: H100 SXM data sheet: HBM3 bandwidth and float32 (non-tensor-core) rate
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
FLT_MIN = float(np.finfo(np.float32).tiny)
SOURCE = "heat_tpu_torch/csrc/blockquant.cu"


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


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


def payload(rows: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, BLOCK)) * 3.0).astype(np.float32)
    sp = special_rows(rng)
    k = min(rows, len(sp))
    x[:k] = sp[:k] if rows >= len(sp) else sp[rng.choice(len(sp), size=k, replace=False)]
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


def bound_ms(nbytes: float, ops: float):
    b, o = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def phase_kernels(torch, cq, dev):
    """Phase 2: every kernel bitwise against its plain version, then timed."""
    for rows in (1, 3, 33, PAYLOAD // BLOCK):
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
        torch.cuda.synchronize()
        for what, a, b in pairs:
            check(bitwise_equal(a, b), f"{what} kernel != plain at rows={rows}")
        print(f"kernels == plain, bitwise, at rows={rows}")

    rows = PAYLOAD // BLOCK
    n = rows * BLOCK
    bufs = 16  # 16 x 4 MiB inputs: past the L2
    xs = [torch.randn(n, device=dev) for _ in range(bufs)]
    adds = [torch.randn(n, device=dev) for _ in range(bufs)]
    enc = [cq.quantize_blocks(x) for x in xs]
    torch.cuda.synchronize()
    q0, s0 = enc[0]
    x0 = xs[0]
    err = {
        "blockquant_quantize": max(
            max_abs_err(cq.quantize_blocks(x0)[1], cq.quantize_blocks_plain(x0.reshape(rows, BLOCK))[1]),
            max_abs_err(cq.quantize_blocks(x0)[0].float(),
                        cq.quantize_blocks_plain(x0.reshape(rows, BLOCK))[0].float()),
        ),
        "blockquant_dequantize": max_abs_err(cq.dequantize_blocks(q0, s0), cq.dequantize_blocks_plain(q0, s0)),
        "blockquant_dequantize_fma": max_abs_err(
            cq.dequantize_fma_blocks(q0, s0, adds[0]), cq.dequantize_fma_blocks_plain(q0, s0, adds[0])
        ),
    }
    qargs = [(x,) for x in xs]
    qargs_plain = [(x.reshape(rows, BLOCK),) for x in xs]
    dargs = [e for e in enc]
    fargs = [(e[0], e[1], a) for e, a in zip(enc, adds)]
    scale_b = rows * 4
    rows_out = []
    for name, kernel, plain, library, args, plain_args, nbytes, ops, replaces in (
        ("blockquant_quantize", cq.quantize_blocks, cq.quantize_blocks_plain, None,
         qargs, qargs_plain, n * 4 + n + scale_b, n * 6, "heat_tpu/comm/compressed.py:230"),
        ("blockquant_dequantize", cq.dequantize_blocks, cq.dequantize_blocks_plain,
         lambda q, s: torch.mul(q, s), dargs, dargs, n + scale_b + n * 4, n, "heat_tpu/comm/compressed.py:249"),
        ("blockquant_dequantize_fma", cq.dequantize_fma_blocks, cq.dequantize_fma_blocks_plain,
         lambda q, s, a: torch.addcmul(a.reshape(q.shape), q, s), fargs, fargs,
         n + scale_b + n * 4 + n * 4, n * 2, "heat_tpu/comm/compressed.py:249"),
    ):
        ms = device_ms(kernel, args)
        plain_ms = device_ms(plain, plain_args)
        lib_ms = device_ms(library, args) if library is not None else None
        b_ms, b_by = bound_ms(nbytes, ops)
        rows_out.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": None, "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        })
        print(f"{name}: {ms * 1e3:.2f} us (bound {b_ms * 1e3:.2f} us by {b_by}), "
              f"plain {plain_ms * 1e3:.2f} us, library "
              f"{'none: no single PyTorch call computes it' if lib_ms is None else f'{lib_ms * 1e3:.2f} us'}")
    return rows_out


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

    import heat_tpu_torch as htt
    from heat_tpu_torch import kernels
    from heat_tpu_torch.comm import compressed as cq

    lines = []

    # ---------------------------------------------------------------- 1
    t0 = time.perf_counter()
    built = kernels.build_all()
    build_s = time.perf_counter() - t0
    card = card_line()
    print(f"build: {build_s:.1f} s ({built}); card: {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    for line in kernels.build_log("blockquant").splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas:", line.strip())

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
    counted = (cq.quantize_blocks, cq.dequantize_blocks, cq.dequantize_fma_blocks)
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
    for row in kernel_rows:
        row["launches"] = launches[row["name"]]
    print(f"{POSITIONS} positions, int8_block: launches {launches}; allreduce error "
          f"{float(np.abs(got - exact).max()):.4g} (bound {bound:.4g}); var error {v_err:.4g} "
          f"(bound {v_bound:.4g}); KMeans labels agree {agree:.6f}, max center shift "
          f"{shift:.4g} (bound {c_bound:.4g})")

    metrics = {
        "kmeans_iter_per_s": ITERS / fit_ms * 1e3,
        "cdist_gb_per_s": SUB * SUB * 4 / cdist_ms / 1e6,
        "moments_gb_per_s": N * F * 4 * 2 / moments_ms / 1e6,
        "allreduce_q_exact_payload_gb_per_s": PAYLOAD * 4 / allreduce_ms / 1e6,
        "kmeans_int8_4pos_iter_per_s": ITERS / fit4_ms * 1e3,
        "allreduce_q_ms": allreduce_ms,
        "build_s": build_s,
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
