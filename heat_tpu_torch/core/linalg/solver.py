"""Iterative solvers: conjugate gradients and Lanczos.

Port of ``heat_tpu/core/linalg/solver.py``.  The iterations run on the
operands' device.  ``cg``'s host reads the residual norm once a step for
the convergence test; ``lanczos`` decides its breakdown restarts on the
device and never syncs inside its loop, and runs in segments with its
carry snapshotted between them under ``checkpoint_every``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import random, types
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


def lanczos(
    A: DNDarray,
    m: int,
    v0: Optional[DNDarray] = None,
    V_out: Optional[DNDarray] = None,
    T_out: Optional[DNDarray] = None,
    checkpoint_every: int = 0,
    checkpoint_path: Optional[str] = None,
    resume=False,
):
    """Lanczos tridiagonalization of a symmetric ``A`` with full
    re-orthogonalization: ``(V, T)`` with ``V`` the (n, m) orthonormal
    Krylov basis (row-split when ``A`` is split) and ``T = V^T A V``
    tridiagonal.  Without ``v0`` the start vector is ``rand(n)``,
    normalized; every call draws ``rand(n, m)``, whose column ``i`` is step
    ``i``'s restart vector should ``w`` break down (norm under 1e-10).
    The restart is chosen on the device (``torch.where``), so the m - 1
    steps run without a host sync.

    With ``checkpoint_every=N`` the steps run in N-step segments,
    snapshotting the carry ``(V, T, w, v_prev)`` and the restart matrix
    between segments to ``checkpoint_path``; ``resume=True`` restarts from
    the snapshot and finishes bitwise equal to an uninterrupted run.
    ``resume="elastic"`` also takes a snapshot of another number of
    positions (the carry is replicated: it passes through)."""
    sanitize_in(A)
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise RuntimeError("A needs to be a square matrix")
    if not isinstance(m, int) or m <= 0:
        raise RuntimeError("m must be a positive integer")
    from ...resilience import elastic as _elastic
    from ...resilience.resume import LoopCheckpointer

    n = A.shape[0]
    arr = A.larray.to(torch.float32) if types.heat_type_is_exact(A.dtype) else A.larray
    dt = arr.dtype
    ckpt = LoopCheckpointer(
        checkpoint_path, checkpoint_every, "lanczos", {"n": int(n), "m": int(m)}, comm=A.comm,
        splits={"i": None, "V": None, "T": None, "w": None, "v_prev": None, "R": None},
    )

    with _matmul_precision():
        if resume:
            state, _ = ckpt.load(elastic=resume == "elastic")
            R = torch.as_tensor(state["R"], dtype=torch.float32).to(arr.device)
            V, T, w, v_prev = (torch.as_tensor(state[k]).to(device=arr.device, dtype=dt)
                               for k in ("V", "T", "w", "v_prev"))
            it = int(state["i"])
        else:
            if v0 is None:
                v = random.rand(n, dtype=types.float32, device=A.device, comm=A.comm).larray
                v = v / torch.linalg.vector_norm(v)
            else:
                sanitize_in(v0)
                v = v0.larray / torch.linalg.vector_norm(v0.larray)
            v = v.to(dt)
            R = random.rand(n, m, dtype=types.float32, device=A.device, comm=A.comm).larray
            V = torch.zeros((n, m), dtype=dt, device=arr.device)
            T = torch.zeros((m, m), dtype=dt, device=arr.device)
            V[:, 0] = v
            w = arr @ v
            alpha = torch.dot(w, v)
            T[0, 0] = alpha
            w, v_prev = w - alpha * v, v
            it = 1
        one = torch.ones((), dtype=dt, device=arr.device)
        while it < m:
            stop = ckpt.stop(it, m)
            with _elastic.dispatch_guard("lanczos.seg", A.comm):
                for i in range(it, stop):
                    Vi = V[:, :i]
                    beta = torch.linalg.vector_norm(w)
                    breakdown = beta < 1e-10
                    vr = R[:, i].to(dt)
                    vr = vr - Vi @ (Vi.T @ vr)
                    vr_nrm = torch.linalg.vector_norm(vr)
                    vr = torch.where(vr_nrm > 0, vr / vr_nrm, vr)
                    w = torch.where(breakdown, vr, w / torch.where(breakdown, one, beta))
                    w = w - Vi @ (Vi.T @ w)
                    nrm = torch.linalg.vector_norm(w)
                    w = torch.where(nrm > 0, w / nrm, w)
                    V[:, i] = w
                    wnew = arr @ w
                    alpha = torch.dot(wnew, w)
                    T[i, i] = alpha
                    T[i - 1, i] = beta
                    T[i, i - 1] = beta
                    w, v_prev = wnew - alpha * w - beta * v_prev, w
            it = stop
            if it >= m:
                break
            ckpt.tick(it, {"i": np.int32(it), "V": V, "T": T, "w": w, "v_prev": v_prev, "R": R})

    split = 0 if A.split is not None else None
    heat_dt = types.canonical_heat_type(dt)
    V_nd = DNDarray(V, (n, m), heat_dt, split, A.device, A.comm)
    T_nd = DNDarray(T, (m, m), heat_dt, None, A.device, A.comm)
    if V_out is not None:
        V_out._rebind(V_nd)
        T_out._rebind(T_nd)
        return V_out, T_out
    return V_nd, T_nd
