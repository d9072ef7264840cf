#!/usr/bin/env python3
"""The alternatives behind the port's linear algebra and Lasso choices, on one GPU.

Run from the root of a checkout on a machine with a CUDA device:

    python3 scripts/linalg_variants.py [--out FILE]

1. The SVD of the 64 x 64 R of ``chip_smoke.py`` phase 7's 131 072 x 64
   float32 matrix: torch's default on CUDA (the Jacobi ``gesvdj`` for a
   small matrix), ``gesvd``, ``gesvda``, and the port's route (float64,
   rounded back); for each, ``||U S V^T - A|| / ||A||`` with ``U = Q U_R``
   and the milliseconds a call (``chip_smoke.wall_ms``).  Then the same
   routes on the R of 131 072 x 64 float32 matrices with condition
   numbers 1e3 and 1e6 (singular values spaced evenly in log between 1 and
   1/cond) and of rank 56 (the last 8 columns repeat the first 8): each
   route's largest error of a singular value (relative to it and to the
   largest) against R's own float64 SVD, so the QR's rounding does not
   enter, its ``||U_R S V_R^T - R|| / ||R||`` and the larger of
   ``max|U_R^T U_R - I|`` and ``max|V_R^T V_R - I|``.
2. ``htt.linalg.qr``, ``svd`` and ``svd(compute_uv=False)`` of that matrix
   at 1 and 4 positions: milliseconds a call.
3. The products over Lasso's (33, 500 000) design columns: the residual
   (``addmv``), the exact gradient (``mv``) and the per-position partials
   at 4 positions as a ``bmm`` (both orientations), ``einsum`` and four
   ``mv``s: microseconds of device time a call (``chip_smoke.device_ms``:
   32 calls in one CUDA graph).

Prints one JSON object per reading and, last, the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the readings as JSON lines to this file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("linalg_variants: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import heat_tpu_torch as htt

    dev = torch.device("cuda", 0)
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row))

    a = torch.from_numpy(
        np.random.default_rng(2).normal(size=(cs.QR_M, cs.QR_N)).astype(np.float32)
    ).to(dev)
    a64 = a.double()
    q, r = torch.linalg.qr(a)
    routes = {
        "default": lambda m: torch.linalg.svd(m, full_matrices=False),
        "gesvd": lambda m: torch.linalg.svd(m, full_matrices=False, driver="gesvd"),
        "gesvda": lambda m: torch.linalg.svd(m, full_matrices=False, driver="gesvda"),
        "float64": lambda m: tuple(t.float() for t in torch.linalg.svd(m.double(), full_matrices=False)),
    }
    for name, fn in routes.items():
        u, s, vh = fn(r)
        rec = ((q @ u).double() * s.double()) @ vh.double() - a64
        emit({"svd_of_r": name, "reconstruction": float(torch.linalg.norm(rec) / torch.linalg.norm(a64)),
              "ms": cs.wall_ms(lambda: fn(r), reps=20)})

    gen = torch.Generator(device=dev).manual_seed(3)
    eye = torch.eye(cs.QR_N, dtype=torch.float64, device=dev)
    for cond in (1e3, 1e6, "rank 56"):
        if cond == "rank 56":
            x = torch.randn(cs.QR_M, cs.QR_N, dtype=torch.float64, device=dev, generator=gen)
            x[:, -8:] = x[:, :8]
        else:
            left = torch.linalg.qr(torch.randn(cs.QR_M, cs.QR_N, dtype=torch.float64, device=dev, generator=gen))[0]
            right = torch.linalg.qr(torch.randn(cs.QR_N, cs.QR_N, dtype=torch.float64, device=dev, generator=gen))[0]
            x = (left * torch.logspace(0, -np.log10(cond), cs.QR_N, dtype=torch.float64, device=dev)) @ right.T
        rc = torch.linalg.qr(x.float())[1]
        r64 = rc.double()
        s64 = torch.linalg.svdvals(r64)
        for name, fn in routes.items():
            u, s, vh = fn(rc)
            u, s, v = u.double(), s.double(), vh.double().T
            rec = (u * s) @ v.T - r64
            emit({"svd_of_r": name, "cond": cond,
                  "s_rtol": float(((s - s64).abs() / s64).max()),
                  "s_err_over_smax": float((s - s64).abs().max() / s64[0]),
                  "reconstruction_of_r": float(torch.linalg.norm(rec) / torch.linalg.norm(r64)),
                  "orthonormality": max(float((u.T @ u - eye).abs().max()), float((v.T @ v - eye).abs().max()))})

    for p in (1, cs.POSITIONS):
        A = htt.array(a, split=0, comm=htt.TorchCommunication([dev] * p))
        for name, fn in (("qr", lambda: htt.linalg.qr(A)), ("svd", lambda: htt.linalg.svd(A)),
                         ("svdvals", lambda: htt.linalg.svd(A, compute_uv=False))):
            emit({"call": name, "positions": p, "ms": cs.wall_ms(fn)})

    n, m, p = cs.N, cs.F + 1, cs.POSITIONS
    c = n // p
    cols = torch.randn(m, n, device=dev)
    res, theta = torch.randn(n, device=dev), torch.randn(m, device=dev)
    blocks = cols.reshape(m, p, c).movedim(1, 0)
    for name, fn in (
        ("residual addmv(y, cols.T, theta)", lambda: torch.addmv(res, cols.T, theta)),
        ("gradient mv(cols, r)", lambda: torch.mv(cols, res)),
        ("partials bmm(blocks, r)", lambda: torch.bmm(blocks, res.view(p, c, 1))),
        ("partials bmm(r, blocks^T)", lambda: torch.bmm(res.view(p, 1, c), blocks.transpose(1, 2))),
        ("partials einsum", lambda: torch.einsum("pmc,pc->pm", blocks, res.view(p, c))),
        ("partials four mv", lambda: [torch.mv(blocks[i], res.view(p, c)[i]) for i in range(p)]),
    ):
        emit({"product": name, "device_us": cs.device_ms(fn, [()]) * 1e3})

    card = cs.card_line()
    print(card)
    if args.out:
        with open(args.out, "w") as fh:
            for row in rows:
                fh.write(json.dumps(dict(row, card=card)) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
