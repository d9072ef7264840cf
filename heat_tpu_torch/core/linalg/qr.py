"""Distributed QR decomposition.

Port of ``heat_tpu/core/linalg/qr.py`` on a 1-D communicator:

* **split 0, m >= n: TSQR.**  The rows, zero-padded to whole shards, are
  viewed as the ``(p, rows, n)`` stack of position blocks; one batched
  ``torch.linalg.qr`` factors every block, a second QR factors the
  ``(p*n, n)`` stack of their R factors, and one ``bmm`` corrects each
  block's Q by its slice of the second Q.  Zero pad rows leave R
  untouched and drop out of Q.  Shards with fewer rows than columns do
  not reduce: those inputs are factored whole, behind a ``UserWarning``.
* **split 1, m >= n: blocked CGS2** over column panels, one per position
  (``tiles_per_proc`` subdivides each): every panel is orthogonalised
  against the Q built so far by two classical Gram-Schmidt projections and
  then factored.
* **splits (0, 1) on a 2-D position grid, m >= n: the grid blocked CAQR**
  of the reference (:func:`_caqr_blocks`) over the stacked ``(r, c, mloc,
  nloc)`` blocks of the zero-padded operand: panel TSQR down the mesh rows,
  BCGS2 against the basis built so far, and the trailing update.  Q comes
  back at ``(0, 1)``, R at ``(None, 1)``.
* everything else (replicated, wide, one position): one ``torch.linalg.qr``.

Local factors are cuSOLVER's on the card (LAPACK's on the CPU); the signs
of R's rows and Q's columns are theirs.
"""

from __future__ import annotations

import collections
import warnings
from typing import Tuple

import numpy as np
import torch

from .. import _xproc, types
from ...comm._costs import grid_panel_bounds, grid_qr_model
from ...comm.overlap import overlap_enabled
from ..dndarray import DNDarray
from ..sanitation import sanitize_in
from .._compile import jitted
from .basics import _grid_dispatch, _matmul_precision
from .._split_semantics import split_semantics as _split_semantics

__all__ = ["QR", "qr"]

QR = collections.namedtuple("QR", "Q, R")


def _tsqr(a: DNDarray, arr: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-stage TSQR of the row-split ``arr`` (a's values at the
    factorization dtype); Q comes back at its true row count."""
    comm = a.comm
    m, n = a.shape
    p = comm.size
    if p == 1:
        return torch.linalg.qr(arr)
    if comm.shard_width(m) < n:
        warnings.warn(
            f"qr: {m}x{n} split=0 over {p} devices leaves shards with "
            f"fewer rows ({comm.shard_width(m)}) than columns ({n}); "
            "gathering for a single on-device QR (use fewer devices or a "
            "taller matrix for distributed TSQR)",
            stacklevel=3,
        )
        return torch.linalg.qr(arr)
    blocks = comm.blocks(comm.pad_to_shards(arr, axis=0), 0)  # (p, c, n)
    q1, r1 = torch.linalg.qr(blocks)
    q2, r = torch.linalg.qr(r1.reshape(p * n, n))
    q = torch.bmm(q1, q2.reshape(p, n, n)).reshape(-1, n)
    return q[:m], r


def _panels(n: int, comm, tiles_per_proc: int):
    """Column panels of the split-1 loop: each position's column block,
    cut into ``tiles_per_proc`` tiles."""
    c = comm.shard_width(n)
    bounds = []
    for r in range(comm.size):
        start, stop = r * c, min((r + 1) * c, n)
        if start >= stop:
            continue
        width = stop - start
        t = max(1, min(int(tiles_per_proc), width))
        tw = -(-width // t)
        for j in range(t):
            s, e = start + j * tw, min(start + (j + 1) * tw, stop)
            if s < e:
                bounds.append((s, e))
    return bounds


def _cgs2(a: DNDarray, arr: torch.Tensor, tiles_per_proc: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked classical Gram-Schmidt with reorthogonalisation over the
    column panels of the column-split ``arr``."""
    n = a.shape[1]
    r_full = torch.zeros((n, n), dtype=arr.dtype, device=arr.device)
    q_acc = arr[:, :0]
    for s, e in _panels(n, a.comm, tiles_per_proc):
        panel = arr[:, s:e]
        if s:
            y1 = q_acc.T @ panel
            panel = panel - q_acc @ y1
            y2 = q_acc.T @ panel
            panel = panel - q_acc @ y2
            r_full[:s, s:e] = y1 + y2
        qk, r_full[s:e, s:e] = torch.linalg.qr(panel)
        q_acc = torch.cat([q_acc, qk], dim=1)
    return q_acc, r_full


def _grid_panel_schedule(n: int, c: int, tiles_per_proc: int):
    """``(nloc, bounds, vcs)`` of the grid QR over ``n`` columns on ``c``
    mesh columns: the column block width, one ``(owner, local offset,
    width, padded global start)`` per panel (:func:`grid_panel_bounds`),
    and each mesh column's count of real columns."""
    nloc = -(-n // c)
    bounds = tuple((jc, lo, nb, jc * nloc + lo) for (jc, lo, nb) in grid_panel_bounds(n, c, tiles_per_proc))
    vcs = tuple(min(nloc, max(0, n - jc * nloc)) for jc in range(c))
    return nloc, bounds, vcs


def _index_sum(parts: torch.Tensor) -> torch.Tensor:
    """``parts[0] + parts[1] + ...`` in index order along the leading axis:
    the reference's sums of gathered blocks, whose order fixes the
    rounding."""
    acc = parts[0]
    for b in range(1, int(parts.shape[0])):
        acc = acc + parts[b]
    return acc


def _caqr_blocks(a: torch.Tensor, bounds, vcs) -> Tuple[torch.Tensor, torch.Tensor]:
    """The grid blocked CAQR (the reference's ``_caqr_shard_body``, serial
    arm) over the stacked blocks ``a`` of shape ``(r, c, mloc, nloc)``,
    position ``(i, j)``'s block at ``a[i, j]`` of a zero-padded operand.
    Returns Q's blocks, shaped as ``a``, and R as ``(c, c * nloc, nloc)``:
    mesh column ``j``'s block of columns (the same on every mesh row).

    Every position of a mesh row holds the owner's panel after the
    reference's broadcast, so the panel is factored once per mesh row.
    For each panel: index the owner's panel out of the blocks; project out
    the basis built so far twice (BCGS2), the coefficients summed down
    the mesh rows and the correction along the mesh columns, each in
    index order; factor it by TSQR (a batched QR of the ``r`` row blocks,
    a QR of their stacked ``(r * nb, nb)`` R factors, the Q correction);
    update the trailing columns by the coefficients ``W = Qp^T A`` in two
    column-disjoint subtracts, the next panel's columns, then the rest.
    Pad columns are in no panel."""
    r, c, mloc, nloc = (int(s) for s in a.shape)
    Np, dev = c * nloc, a.device
    cols = torch.arange(Np, device=dev)
    col_gids = cols.reshape(c, nloc)
    valid = (col_gids - torch.arange(c, device=dev)[:, None] * nloc) < torch.tensor(vcs, device=dev)[:, None]
    row_valid = valid.reshape(Np)
    q_acc = torch.zeros_like(a)
    r_acc = a.new_zeros((c, Np, nloc))
    zero = a.new_zeros(())
    for p, (jc, lo, nb, gstart) in enumerate(bounds):
        pan = a[:, jc, :, lo:lo + nb]  # (r, mloc, nb)
        if p:
            z = _index_sum(q_acc.transpose(-1, -2) @ pan[:, None])  # (c, nloc, nb)
            z = torch.where((valid & (col_gids < gstart))[..., None], z, zero)
            pan = pan - _index_sum((q_acc @ z).transpose(0, 1))
            zmask = (row_valid & (cols < gstart))[:, None]
            r_acc[jc, :, lo:lo + nb] += torch.where(zmask, z.reshape(Np, nb), zero)
        q1, r1 = torch.linalg.qr(pan)
        q2, rp = torch.linalg.qr(r1.reshape(r * nb, nb))
        qp = q1 @ q2.reshape(r, nb, nb)  # (r, mloc, nb)
        q_acc[:, jc, :, lo:lo + nb] = qp
        r_acc[jc, gstart:gstart + nb, lo:lo + nb] += rp
        w = _index_sum(qp.transpose(-1, -2)[:, None] @ a)  # (c, nb, nloc)
        trail = valid & (col_gids >= gstart + nb)
        if p + 1 < len(bounds):
            _, _, nbn, gsn = bounds[p + 1]
            nxt = valid & (col_gids >= gsn) & (col_gids < gsn + nbn)
        else:
            nxt = torch.zeros_like(trail)
        a = a - qp[:, None] @ torch.where(nxt[:, None, :], w, zero)
        a = a - qp[:, None] @ torch.where((trail & ~nxt)[:, None, :], w, zero)
        r_acc[:, gstart:gstart + nb, :] += torch.where(trail[:, None, :], w, zero)
    return q_acc, r_acc


def _grid_qr(a: DNDarray, dtype, tiles_per_proc: int, calc_q: bool) -> QR:
    """The grid CAQR of a ``(0, 1)`` operand with ``m >= n``: the zeroed
    at-rest buffer as its stacked blocks, :func:`_caqr_blocks`, and the
    results at the reference's layouts."""
    comm = a.comm
    m, n = a.shape
    r, c = comm.mesh_shape
    mloc = -(-m // r)
    nloc, bounds, vcs = _grid_panel_schedule(n, c, int(tiles_per_proc))
    nb_max = max(b[2] for b in bounds)
    if mloc < nb_max:
        raise ValueError(
            f"qr: grid CAQR needs row shards at least as tall as the widest "
            f"column panel: {m}x{n} over the {r}x{c} mesh leaves "
            f"({mloc}, {nloc}) shards with {mloc} rows < panel width "
            f"{nb_max}; use a taller matrix, a flatter mesh, or raise "
            f"tiles_per_proc"
        )
    buf = a._zeroed_buffer().to(dtype.torch_type())
    ov = overlap_enabled(len(bounds))
    with _matmul_precision():
        fn = jitted(("qr.grid", comm, bounds, vcs, tuple(buf.shape), str(buf.dtype)),
                    lambda: _caqr_blocks)
        q_blk, r_blk = _grid_dispatch(
            "qr2d", lambda: grid_qr_model(m, n, (r, c), tiles_per_proc=int(tiles_per_proc), overlap=ov),
            ov, lambda: fn(comm.blocks(buf, (0, 1)), bounds, vcs),
            mesh=f"{r}x{c}", panels=len(bounds), overlap=ov,
        )
    R = DNDarray(r_blk[:, :n].transpose(0, 1).reshape(n, c * nloc), (n, n), dtype, (None, 1), a.device, comm)
    if not calc_q:
        return QR(None, R)
    q = q_blk.transpose(1, 2).reshape(r * mloc, c * nloc)
    q[m:] = 0  # pad rows: the at-rest invariant
    return QR(DNDarray(q, (m, n), dtype, (0, 1), a.device, comm), R)


@_split_semantics("entry_qr")
def qr(a: DNDarray, tiles_per_proc: int = 1, calc_q: bool = True, overwrite_a: bool = False) -> QR:
    """Reduced QR factorization ``a = Q @ R`` of a 2-D DNDarray.

    ``tiles_per_proc`` subdivides each position's column panel on the
    split-1 and grid paths; split 0 ignores it.  ``calc_q=False`` returns
    ``QR(None, R)``.  Q keeps ``a``'s split; R is split on columns when
    ``a`` is, else replicated; on a grid Q is at ``(0, 1)`` and R at
    ``(None, 1)``, and a wide ``(0, 1)`` input raises ``ValueError``.
    ``overwrite_a`` is accepted and ignored (the input is never written).
    """
    sanitize_in(a)
    _xproc.refuse_across("linalg.qr", a)
    if not isinstance(tiles_per_proc, (int, np.integer)):
        raise TypeError(f"tiles_per_proc must be an int, got {type(tiles_per_proc)}")
    if tiles_per_proc < 1:
        raise ValueError(f"tiles_per_proc must be >= 1, got {tiles_per_proc}")
    if a.ndim != 2:
        raise ValueError(f"qr requires a 2-D DNDarray, got {a.ndim}-d")

    dtype = a.dtype if types.heat_type_is_inexact(a.dtype) else types.float32
    m, n = a.shape
    comm = a.comm
    if comm.mesh_ndim == 2 and comm.size > 1 and a.splits == (0, 1):
        if m < n:
            r_m, c_m = comm.mesh_shape
            raise ValueError(
                f"qr: wide inputs have no grid formulation: {m}x{n} with "
                f"splits (0, 1) on the {r_m}x{c_m} mesh; factor the "
                f"transpose (resplit its layout to (0, 1)) and transpose "
                f"back, or use svd for the spectral path"
            )
        return _grid_qr(a, dtype, int(tiles_per_proc), calc_q)
    arr = a.larray.to(dtype.torch_type())
    with _matmul_precision():
        if a.split == 0 and m >= n:
            q, r = jitted(("qr.tsqr", comm), lambda: _tsqr)(a, arr)
        elif a.split == 1 and m >= n and a.comm.size > 1:
            q, r = jitted(("qr.cgs2", comm), lambda: _cgs2)(a, arr, int(tiles_per_proc))
        else:
            q, r = torch.linalg.qr(arr)

    r_split = 1 if a.split == 1 else None
    R = DNDarray(r, tuple(r.shape), dtype, r_split, a.device, a.comm)
    if not calc_q:
        return QR(None, R)
    return QR(DNDarray(q, tuple(q.shape), dtype, a.split, a.device, a.comm), R)
