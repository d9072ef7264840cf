"""Singular value decomposition of a tall (or, transposed, wide) matrix.

Port of the 1-D path of ``heat_tpu/core/linalg/svd.py``: QR first (TSQR
when the rows are split, see :mod:`.qr`), then the SVD of the small
``(n, n)`` R on the same device (cuSOLVER on the card), in float64, and
``U = Q @ U_R``.  Only R reaches the SVD, so the matrix products carry
the work.  Wide matrices factor their transpose and swap U and V.  The
reference's host SVD of R (``HEAT_TPU_HOST_SVD`` and its float64 route)
works around a TPU compiler fault and the TPU's lack of float64, and is not
carried over.  The QDWH polar SVD on a 2-D position grid is not ported.
"""

from __future__ import annotations

import collections

import torch

from .. import types
from ..dndarray import DNDarray
from ..sanitation import sanitize_in
from .basics import _matmul_precision
from .qr import qr as _qr

__all__ = ["SVD", "svd"]

#: element cap of the silent replicate below: 1M elements (4 MB in float32)
#: replicate harmlessly, a larger wide-shard matrix keeps qr's gather warning
_SMALL_RESPLIT_MAX = 1 << 20

SVD = collections.namedtuple("SVD", "U, S, V")


def _small_svd(r: torch.Tensor, compute_uv: bool):
    """The SVD of the small ``(n, n)`` R, computed in float64 on R's device
    and rounded to R's type.  On the card torch's default for a float32 R,
    cuSOLVER's Jacobi ``gesvdj``, stops at a tolerance that leaves R
    reconstructed only to about 1e-5; ``gesvd`` is accurate but slow (many
    small kernels); the faster ``gesvda`` loses the orthonormality of U and
    V on an ill-conditioned or rank-deficient R (5.5e-6 at condition 1e6,
    3.6e-2 at rank 56 of 64, against under 1e-7 in float64:
    ``scripts/linalg_variants.py``; ``tests/test_torch_card.py`` holds
    such matrices).  In float64 each of these lies far under float32's
    rounding."""
    if not compute_uv:
        return torch.linalg.svdvals(r.double()).to(r.dtype)
    return tuple(t.to(r.dtype) for t in torch.linalg.svd(r.double(), full_matrices=False))


def _svd_tall(a: DNDarray, dtype, compute_uv: bool):
    """The QR-first SVD of an ``m >= n`` matrix."""
    comm, device = a.comm, a.device
    m, n = a.shape
    osplit = a.split
    if a.split == 0 and comm.size > 1 and comm.shard_width(m) < n and m * n <= _SMALL_RESPLIT_MAX:
        # shards wider than tall would send TSQR to its gather warning on
        # every call: a small matrix is replicated here, once and silently;
        # U still comes back row-split
        a = a.resplit(None)
    q, r = _qr(a if a.dtype is dtype else a.astype(dtype), calc_q=compute_uv)
    if not compute_uv:
        s = _small_svd(r.larray, False)
        return DNDarray(s, (n,), dtype, None, device, comm)
    ur, s, vh = _small_svd(r.larray, True)
    with _matmul_precision():
        u = q.larray @ ur
    U = DNDarray(u, (m, n), dtype, 0 if osplit == 0 else None, device, comm)
    S = DNDarray(s, (n,), dtype, None, device, comm)
    V = DNDarray(vh.T.contiguous(), (n, n), dtype, None, device, comm)
    return SVD(U, S, V)


def svd(a: DNDarray, full_matrices: bool = False, compute_uv: bool = True):
    """Reduced SVD ``a = U @ diag(S) @ V.T``: ``SVD(U, S, V)``, or only
    ``S`` (a DNDarray) with ``compute_uv=False``."""
    sanitize_in(a)
    if a.ndim != 2:
        raise ValueError(f"svd requires a 2-D DNDarray, got {a.ndim}-d")
    if full_matrices:
        raise NotImplementedError("full_matrices=True is not supported (reduced SVD only)")
    dtype = a.dtype if types.heat_type_is_inexact(a.dtype) else types.float32
    m, n = a.shape
    if m < n:
        res = svd(a.T, compute_uv=compute_uv)
        return res if not compute_uv else SVD(res.V, res.S, res.U)
    return _svd_tall(a, dtype, compute_uv)
