#!/usr/bin/env python3
"""Where the time goes on the PyTorch port's main path, on one GPU.

Run from the root of a checkout on a machine with a CUDA device:

    python3 scripts/profile_torch_slice.py [--out FILE]

Profiles, with ``torch.profiler`` (CPU and CUDA activity), one exact
KMeans fit (500 000 x 32 blobs, k=8, 30 Lloyd steps) at one position, one
cdist on 20 000 rows, and, at four positions on the one card under the
``int8_block`` policy, one allreduce of a (4, 2^20) payload and one
error-feedback KMeans fit; then, at the reference benchmark's attention
shape (S=4096, H=16, D=64, bf16, causal), one single-card
``flash_attention`` call and one zig-zag ``ring_attention`` call at four
positions; then one ``qr`` + ``svd`` of the tall-skinny 131 072 x 64
float32 matrix at one and at four positions, one Lasso coordinate-descent
sweep at one position (a fit with ``max_iter=1``, its set-up included), and
Lasso ISTA fits of 1 and 11 steps at four positions under ``int8_block``
(their difference is ten steps, without the step-size power iteration);
then the RNG's ``randperm(500000)``, a 300-step ``lanczos`` on the
20 000-row Spectral Laplacian and the whole ``Spectral.fit`` around it
(rbf, gamma 1e-3, 8 clusters), a 30-step ``KMedians.fit`` on the blobs at
one position, and GaussianNB fits on the blobs, exact at one position and
at four positions under ``int8_block``; then, at four positions on the
blobs, the distributed sorts (the 1-D ring rank sort of a column, the
resplit sort along axis 0), the ring take ``X[perm]`` and the ring put
``Y[perm] = X``, each beside its single library call (a stable
``torch.sort``, ``index_select``, ``index_copy_``); then, on a 2 x 4 grid of
positions, the grid SUMMA of two 1024 x 1024 float32 operands, the grid
CAQR QR of 4096 x 512 and the QDWH SVD of 1024 x 256 (``chip_smoke.py``
phase 11's operands), each beside ``torch.matmul``, ``torch.linalg.qr`` and
``torch.linalg.svd``.  For each it prints the wall time, the summed
device time of the kernels and their share of the wall time (the device's
busy share), the host's waits on the device (synchronize calls of the
CUDA runtime, and reads of a device scalar such as ``bool(t)``), and the
kernels that take the most device time, and the count of device
activities (kernel launches, copies, memsets).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def profile(torch, label: str, fn, top: int = 8) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()  # warm-up: builds, allocator, cuBLAS handles
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only (kernels, copies, memsets): the aten ops that
    # launched them report the same device time again
    kernels, syncs, reads = [], 0, 0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            if "Synchronize" in evt.key:
                syncs += int(evt.count)
            elif evt.key == "aten::_local_scalar_dense":
                reads += int(evt.count)
            continue
        if evt.key.startswith("Activity Buffer"):
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            kernels.append((evt.key, float(dev_us), int(evt.count)))
    kernels.sort(key=lambda k: -k[1])
    device_us = sum(k[1] for k in kernels)
    row = {
        "label": label,
        "wall_us": wall_us,
        "device_us": device_us,
        "busy_share": device_us / wall_us if wall_us else None,
        "sync_calls": syncs,
        "scalar_reads": reads,
        "launches": sum(k[2] for k in kernels),
        "top": [{"name": n[:90], "device_us": d, "calls": c} for n, d, c in kernels[:top]],
    }
    print(f"{label}: wall {wall_us:.0f} us, device {device_us:.0f} us, busy {row['busy_share']:.3f}, "
          f"{syncs} synchronize calls, {reads} scalar reads, {row['launches']} device activities")
    for k in row["top"]:
        print(f"    {k['device_us']:10.1f} us  {k['calls']:5d}x  {k['name']}")
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the rows as JSON lines to this file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_slice: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import heat_tpu_torch as htt
    from heat_tpu_torch.comm import compressed as cq

    dev = torch.device("cuda", 0)
    data, centers = cs.make_blobs()
    comm1 = htt.TorchCommunication([dev])
    comm4 = htt.TorchCommunication([dev] * cs.POSITIONS)
    X1 = htt.array(data, split=0, comm=comm1)
    X4 = htt.array(data, split=0, comm=comm4)
    Xs = htt.array(data[: cs.SUB], split=0, comm=comm1)
    init1, init4 = htt.array(centers, comm=comm1), htt.array(centers, comm=comm4)
    stacked = torch.from_numpy(
        np.random.default_rng(1).normal(size=(cs.POSITIONS, cs.PAYLOAD)).astype(np.float32)
    ).to(dev)

    def fit(x, init):
        return lambda: htt.cluster.KMeans(
            n_clusters=cs.K, init=init, max_iter=cs.ITERS, tol=-1.0
        ).fit(x)

    rows = [
        profile(torch, "kmeans exact, 1 position", fit(X1, init1)),
        profile(torch, "cdist 20000 rows, 1 position",
                lambda: htt.spatial.cdist(Xs, quadratic_expansion=True)),
        profile(torch, "mean+std axis 0, 1 position",
                lambda: (htt.mean(X1, axis=0), htt.std(X1, axis=0))),
    ]
    with cq.collective_precision("int8_block"):
        rows.append(profile(torch, "allreduce_q (4, 2^20), 4 positions",
                            lambda: comm4.allreduce(stacked, "sum")))
        rows.append(profile(torch, "kmeans int8_block, 4 positions", fit(X4, init4)))
    q, k, v = cs.attn_inputs((cs.ATTN_S, cs.ATTN_H, cs.ATTN_D), torch.bfloat16, seed=501, dev=dev)
    qd, kd, vd = (htt.array(t, split=0, comm=comm4) for t in (q, k, v))
    rows.append(profile(torch, "flash_attention bf16 causal S=4096, 1 card",
                        lambda: htt.parallel.flash_attention(q, k, v, causal=True)))
    rows.append(profile(torch, "ring_attention bf16 zig-zag causal S=4096, 4 positions",
                        lambda: htt.parallel.ring_attention(qd, kd, vd, causal=True), top=12))
    a = torch.from_numpy(
        np.random.default_rng(2).normal(size=(cs.QR_M, cs.QR_N)).astype(np.float32)
    ).to(dev)
    for comm, label in ((comm1, "1 position"), (comm4, "4 positions")):
        A = htt.array(a, split=0, comm=comm)
        rows.append(profile(torch, f"qr+svd {cs.QR_M}x{cs.QR_N}, {label}",
                            lambda: (htt.linalg.qr(A), htt.linalg.svd(A))))
    y = cs.lasso_target(data).astype(np.float32)
    Y1, Y4 = htt.array(y, split=0, comm=comm1), htt.array(y, split=0, comm=comm4)
    lasso = htt.regression.Lasso
    rows.append(profile(torch, "lasso cd, 1 sweep, 1 position",
                        lambda: lasso(lam=cs.LASSO_LAM, max_iter=1, tol=-1.0).fit(X1, Y1), top=10))
    with cq.collective_precision("int8_block"):
        for steps in (1, 11):
            rows.append(profile(
                torch, f"lasso gd int8_block, {steps} step(s), 4 positions",
                lambda: lasso(lam=cs.LASSO_LAM, max_iter=steps, tol=-1.0, solver="gd").fit(X4, Y4),
                top=12))
    rows.append(profile(torch, f"randperm({cs.N}), 1 position",
                        lambda: htt.random.randperm(cs.N, comm=comm1)))
    sub = htt.array(data[:: cs.N // cs.SUB], split=0, comm=comm1)
    spectral = lambda: htt.cluster.Spectral(  # noqa: E731
        n_clusters=cs.K, gamma=cs.SPECTRAL_GAMMA, metric="rbf", n_lanczos=cs.SPECTRAL_M)
    L = spectral()._laplacian.construct(sub)
    v0 = htt.full((cs.SUB,), 1.0 / np.sqrt(cs.SUB), dtype=htt.float32, comm=comm1)
    row = profile(torch, f"lanczos {cs.SPECTRAL_M} steps, {cs.SUB}^2 Laplacian, 1 position",
                  lambda: htt.linalg.lanczos(L, cs.SPECTRAL_M, v0=v0), top=10)
    steps = cs.SPECTRAL_M - 1
    print(f"    per step: {row['launches'] / steps:.1f} device activities, "
          f"{row['sync_calls'] / steps:.2f} synchronize calls, {row['scalar_reads'] / steps:.2f} scalar reads")
    rows.append(row)
    del L
    rows.append(profile(torch, f"Spectral.fit {cs.SUB} rows, 1 position", lambda: spectral().fit(sub), top=10))
    rows.append(profile(torch, f"KMedians.fit {cs.MED_STEPS} steps, 1 position",
                        lambda: htt.cluster.KMedians(n_clusters=cs.K, init=init1, max_iter=cs.MED_STEPS,
                                                     tol=-1.0).fit(X1), top=10))
    truth = np.repeat(np.arange(cs.K), cs.N // cs.K)
    y1, y4 = htt.array(truth, split=0, comm=comm1), htt.array(truth, split=0, comm=comm4)
    rows.append(profile(torch, "GaussianNB fit exact, 1 position",
                        lambda: htt.naive_bayes.GaussianNB().fit(X1, y1), top=10))
    with cq.collective_precision("int8_block"):
        rows.append(profile(torch, "GaussianNB fit int8_block, 4 positions",
                            lambda: htt.naive_bayes.GaussianNB().fit(X4, y4), top=10))
    col = X4[:, 0]
    perm = htt.random.randperm(cs.N, comm=comm4)
    Y4 = htt.zeros((cs.N, cs.F), split=0, comm=comm4)

    def put():
        Y4[perm] = X4

    for label, fn in (
        ("ring rank sort, 500000 rows", lambda: htt.sort(col)),
        ("  yardstick: torch.sort, stable", lambda: torch.sort(col.larray, stable=True)),
        ("resplit sort axis 0, 500000 x 32", lambda: htt.sort(X4, axis=0)),
        ("  yardstick: torch.sort dim 0, stable", lambda: torch.sort(X4.larray, dim=0, stable=True)),
        ("ring take X[perm], 500000 x 32", lambda: X4[perm]),
        ("  yardstick: index_select", lambda: torch.index_select(X4.larray, 0, perm.larray)),
        ("ring put Y[perm] = X, 500000 x 32", put),
        ("  yardstick: index_copy_", lambda: Y4.larray.clone().index_copy_(0, perm.larray, X4.larray)),
    ):
        rows.append(profile(torch, f"{label}, 4 positions", fn, top=6))

    grid = htt.grid_comm((2, 4), [dev] * 8)
    rng = np.random.default_rng(13)
    a, b = (rng.normal(size=(cs.SUMMA2D_N, cs.SUMMA2D_N)).astype(np.float32) for _ in range(2))
    rng = np.random.default_rng(29)
    qa = rng.normal(size=(cs.QR2D_M, cs.QR2D_N)).astype(np.float32)
    sa = rng.normal(size=(cs.SVD2D_M, cs.SVD2D_N)).astype(np.float32)
    A, B = htt.array(a, splits=(0, 1), comm=grid), htt.array(b, splits=(0, 1), comm=grid)
    QA, SA = htt.array(qa, splits=(0, 1), comm=grid), htt.array(sa, splits=(0, 1), comm=grid)
    for label, fn in (
        ("grid SUMMA 1024^3", lambda: A @ B),
        ("  yardstick: torch.matmul", lambda: torch.matmul(A.larray, B.larray)),
        (f"grid CAQR QR {cs.QR2D_M}x{cs.QR2D_N}", lambda: htt.linalg.qr(QA)),
        ("  yardstick: torch.linalg.qr", lambda: torch.linalg.qr(QA.larray)),
        (f"QDWH SVD {cs.SVD2D_M}x{cs.SVD2D_N}", lambda: htt.linalg.svd(SA)),
        ("  yardstick: torch.linalg.svd", lambda: torch.linalg.svd(SA.larray, full_matrices=False)),
    ):
        rows.append(profile(torch, f"{label}, 2x4 grid", fn, top=6))
    card = cs.card_line()
    print(card)
    if args.out:
        with open(args.out, "w") as fh:
            for r in rows:
                fh.write(json.dumps(dict(r, card=card)) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
