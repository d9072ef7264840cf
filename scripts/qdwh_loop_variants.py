#!/usr/bin/env python3
"""The QDWH polar SVD's two loop forms and two ``eigh`` precisions, on one GPU.

Run from the root of a checkout on a machine with a CUDA device:

    python3 scripts/qdwh_loop_variants.py [--out FILE]

The grid SVD (``heat_tpu_torch/core/linalg/svd.py``) stops its QDWH
iteration where the reference's on-device ``while_loop`` does.  Two ways
reproduce that stop exactly:

* ``sync`` (the port's): the ``l`` recurrence runs on the host, and once
  ``l`` has converged the step's norm ``delta`` is read from the device,
  one host sync an iteration;
* ``freeze``: all 12 iterations run, and a device-side flag freezes the
  iterate once the reference's condition fails; no sync in the loop, every
  iteration paid for.

Both run on ``chip_smoke.py`` phase 11's 1024 x 256 float32 operand (seed
29, ``bench.py:1487-1498``) at 2 x 2 and 2 x 4 positions on the one card:
the polar factor of each (bitwise equal, else the script fails), the
iteration count, the wall time of the loop (median of 5,
``chip_smoke.wall_ms``), its host syncs and its device time (profiler).
Then the whole ``svd`` with the small ``eigh`` of ``H = Up^T A`` in
float32 (cuSOLVER's ``syevd`` on the card) and in float64 rounded back
(the port's):
S's error against numpy's float64 SVD and the reconstruction (in units of
``eps s_max``), U's and V's orthonormality (in ``eps``), and the wall time.

Prints one JSON object per reading and, last, the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def freeze_loop(svd_mod, a, n):
    """The QDWH iteration over all ``_QDWH_MAXIT`` steps, the iterate
    frozen on the device once the reference's condition fails: the
    polar factor's blocks and the count of steps that ran unfrozen."""
    import torch

    x, eye, l, ltol, dtol, bounds, vcs = svd_mod._qdwh_setup(a, n)
    active = torch.ones((), dtype=torch.bool, device=a.device)
    ran = torch.zeros((), dtype=torch.int64, device=a.device)
    for _ in range(svd_mod._QDWH_MAXIT):
        x_new, delta, l = svd_mod._qdwh_step(x, eye, l, bounds, vcs)
        x = torch.where(active, x_new, x)
        ran = ran + active.to(torch.int64)
        active = active & ((delta > dtol) | bool(abs(l.dtype.type(1.0) - l) > ltol))
    return x, ran


def eigh32(h):
    """``eigh`` of ``H`` in its own float32 (cuSOLVER's ``syevd`` on the
    card), descending, as the port's float64 route orders it."""
    import torch

    evals, evecs = torch.linalg.eigh(h)
    return evals.flip(0), evecs.flip(1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the readings as JSON lines to this file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("qdwh_loop_variants: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import heat_tpu_torch as htt

    svd_mod = importlib.import_module("heat_tpu_torch.core.linalg.svd")
    dev = torch.device("cuda", 0)
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    rng = np.random.default_rng(29)
    rng.normal(size=(cs.QR2D_M, cs.QR2D_N))  # the QR operand comes first in the draw
    a = rng.normal(size=(cs.SVD2D_M, cs.SVD2D_N)).astype(np.float32)
    m, n = a.shape
    s64 = np.linalg.svd(a.astype(np.float64), compute_uv=False)
    smax, eps = float(s64[0]), cs.EPS32
    ok = True
    for mesh in cs.GRID_MESHES:
        comm = htt.grid_comm(mesh, [dev] * (mesh[0] * mesh[1]))
        x = htt.array(a, splits=(0, 1), comm=comm)
        blocks = comm.blocks(x._zeroed_buffer(), (0, 1))
        tag = f"{mesh[0]}x{mesh[1]}"
        loops = {
            "sync": lambda: svd_mod._qdwh_blocks(blocks, n),
            "freeze": lambda: freeze_loop(svd_mod, blocks, n),
        }
        ups = {}
        for name, fn in loops.items():
            up, k = fn()
            ups[name] = up
            dev_ms, syncs = cs.profile_counts(torch, fn)
            emit({"what": "qdwh_loop", "variant": name, "mesh": tag, "iterations": int(k),
                  "wall_ms": cs.wall_ms(fn), "device_ms": dev_ms, "syncs": syncs})
        same = bool(torch.equal(ups["sync"], ups["freeze"]))
        ok &= same
        emit({"what": "qdwh_loop_bitwise", "mesh": tag, "equal": same})

        ported = svd_mod._small_eigh  # float64, rounded back
        for prec in ("float32", "float64"):
            if prec == "float32":
                svd_mod._small_eigh = eigh32
            try:
                u, s, v = (t.numpy().astype(np.float64) for t in htt.linalg.svd(x))
                wall = cs.wall_ms(lambda: htt.linalg.svd(x))
            finally:
                svd_mod._small_eigh = ported
            emit({"what": "svd_eigh", "precision": prec, "mesh": tag, "wall_ms": wall,
                  "s_err_eps": float(np.abs(s - s64).max()) / (eps * smax),
                  "reconstruction_eps": float(np.abs(u @ np.diag(s) @ v.T - a).max()) / (eps * smax),
                  "u_orth_eps": float(np.abs(u.T @ u - np.eye(n)).max()) / eps,
                  "v_orth_eps": float(np.abs(v.T @ v - np.eye(n)).max()) / eps})
    card = cs.card_line()
    print(card)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write("\n".join(json.dumps(r) for r in rows + [{"card": card}]) + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
