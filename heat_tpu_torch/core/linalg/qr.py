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
* everything else (replicated, wide, one position): one ``torch.linalg.qr``.

Local factors are cuSOLVER's on the card (LAPACK's on the CPU); the signs
of R's rows and Q's columns are theirs.  Grid CAQR on a 2-D position grid
is not ported.
"""

from __future__ import annotations

import collections
import warnings
from typing import Tuple

import numpy as np
import torch

from .. import types
from ..dndarray import DNDarray
from ..sanitation import sanitize_in
from .basics import _matmul_precision

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


def qr(a: DNDarray, tiles_per_proc: int = 1, calc_q: bool = True, overwrite_a: bool = False) -> QR:
    """Reduced QR factorization ``a = Q @ R`` of a 2-D DNDarray.

    ``tiles_per_proc`` subdivides each position's column panel on the
    split-1 path; split 0 ignores it.  ``calc_q=False`` returns ``QR(None,
    R)``.  Q keeps ``a``'s split; R is split on columns when ``a`` is, else
    replicated.  ``overwrite_a`` is accepted and ignored (the input is
    never written).
    """
    sanitize_in(a)
    if not isinstance(tiles_per_proc, (int, np.integer)):
        raise TypeError(f"tiles_per_proc must be an int, got {type(tiles_per_proc)}")
    if tiles_per_proc < 1:
        raise ValueError(f"tiles_per_proc must be >= 1, got {tiles_per_proc}")
    if a.ndim != 2:
        raise ValueError(f"qr requires a 2-D DNDarray, got {a.ndim}-d")

    dtype = a.dtype if types.heat_type_is_inexact(a.dtype) else types.float32
    arr = a.larray.to(dtype.torch_type())
    m, n = a.shape
    with _matmul_precision():
        if a.split == 0 and m >= n:
            q, r = _tsqr(a, arr)
        elif a.split == 1 and m >= n and a.comm.size > 1:
            q, r = _cgs2(a, arr, int(tiles_per_proc))
        else:
            q, r = torch.linalg.qr(arr)

    r_split = 1 if a.split == 1 else None
    R = DNDarray(r, tuple(r.shape), dtype, r_split, a.device, a.comm)
    if not calc_q:
        return QR(None, R)
    return QR(DNDarray(q, tuple(q.shape), dtype, a.split, a.device, a.comm), R)
