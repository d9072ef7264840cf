"""Iterative solvers: conjugate gradients (``lanczos`` awaits the RNG port).

Port of ``heat_tpu/core/linalg/solver.py``.  The iteration runs on the
operands' device; the host reads the residual norm once a step for the
convergence test.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import types
from .._operations import _out
from ..dndarray import DNDarray
from ..sanitation import sanitize_in
from .basics import _matmul_precision

__all__ = ["cg", "lanczos"]


def cg(A: DNDarray, b: DNDarray, x0: DNDarray, out: Optional[DNDarray] = None) -> DNDarray:
    """Conjugate gradients for a symmetric positive definite ``A``: at most
    ``len(b)`` steps, until the residual's norm is under 1e-10.  Operands
    promote to one inexact type (at least float32); a NaN keeps the
    iteration going, so it reaches the result."""
    sanitize_in(A)
    sanitize_in(b)
    sanitize_in(x0)
    if A.ndim != 2:
        raise RuntimeError("A needs to be a 2D matrix")
    if b.ndim != 1:
        raise RuntimeError("b needs to be a 1D vector")
    if x0.ndim != 1:
        raise RuntimeError("c needs to be a 1D vector")
    dtype = torch.promote_types(
        torch.promote_types(A.larray.dtype, b.larray.dtype),
        torch.promote_types(x0.larray.dtype, torch.float32),
    )
    arr, bv, x = (t.larray.to(dtype) for t in (A, b, x0))
    with _matmul_precision():
        r = bv - arr @ x
        p = r
        rsold = torch.dot(r, r)
        for _ in range(int(bv.shape[0])):
            if bool(torch.sqrt(rsold) < 1e-10):
                break
            Ap = arr @ p
            alpha = rsold / torch.dot(p, Ap)
            x = x + alpha * p
            r = r - alpha * Ap
            rsnew = torch.dot(r, r)
            p = r + (rsnew / rsold) * p
            rsold = rsnew
    result = DNDarray(x, tuple(x.shape), types.canonical_heat_type(dtype), x0.split, x0.device, x0.comm)
    return _out(out, result)


def lanczos(A: DNDarray, m: int, v0: Optional[DNDarray] = None, V_out=None, T_out=None):
    """Lanczos tridiagonalization: not ported yet.  The reference draws its
    breakdown-restart matrix (and, without ``v0``, its start vector) from
    ``random.rand``, whose threefry streams the port does not have yet."""
    sanitize_in(A)
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise RuntimeError("A needs to be a square matrix")
    if not isinstance(m, int) or m <= 0:
        raise RuntimeError("m must be a positive integer")
    raise NotImplementedError(
        "lanczos draws its restart vectors from random.rand and needs the threefry "
        "RNG port of core/random.py (ROADMAP queue A, item 5)"
    )
