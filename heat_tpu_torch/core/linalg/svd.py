"""Singular value decomposition of a tall (or, transposed, wide) matrix.

Port of the 1-D path of ``heat_tpu/core/linalg/svd.py``: QR first (TSQR
when the rows are split, see :mod:`.qr`), then the SVD of the small
``(n, n)`` R on the same device (cuSOLVER on the card), in float64, and
``U = Q @ U_R``.  Only R reaches the SVD, so the matrix products carry
the work.  Wide matrices factor their transpose and swap U and V.  The
reference's host SVD of R (``HEAT_TPU_HOST_SVD`` and its float64 route)
works around a TPU compiler fault and the TPU's lack of float64, and is not
carried over.

On a 2-D position grid, ``(0, 1)`` and ``(1, 0)`` operands take the
reference's QDWH polar SVD (:func:`_qdwh_blocks`): a dynamically weighted
Halley iteration whose every step factors ``[sqrt(c) X; I]`` with the grid
CAQR of :mod:`.qr`, then the eigendecomposition of the small symmetric
``H = Up^T A``.  U comes back at ``(0, 1)``, S and V replicated; a wide
operand factors its transpose and swaps U with V.
"""

from __future__ import annotations

import collections
import math

import numpy as np
import torch

from .. import _xproc, types
from ...comm._costs import qdwh_svd_model
from ...comm.overlap import overlap_enabled
from .._compile import jitted
from ..dndarray import DNDarray
from ..sanitation import sanitize_in
from .basics import _grid_dispatch, _matmul_precision
from .qr import _caqr_blocks, _grid_panel_schedule, _index_sum
from .qr import qr as _qr
from .._split_semantics import split_semantics as _split_semantics

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


def _svd_pipeline(a: DNDarray, osplit, dtype, compute_uv: bool):
    """The QR-first SVD of an ``m >= n`` matrix, U laid out at ``osplit``
    (0 or replicated).

    Module-level, in the reference's shape, so that ``htt.fuse`` could run
    it as one program; :func:`svd` calls it unfused on every device, by a
    fixed choice: cuSOLVER's Jacobi SVD under ``torch.linalg.svd``
    (``gesvdj``, on R in float64) synchronizes with the host inside and
    fails under a CUDA graph capture (``CUSOLVER_STATUS_EXECUTION_FAILED``;
    ``chip_smoke.py`` phase 14 probes the capture of this pipeline on every
    run and requires it to raise)."""
    comm, device = a.comm, a.device
    m, n = a.shape
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


#: the QDWH iteration's cap: the cubic ``l`` recurrence reaches ``1 - eps``
#: from any float64 floor in at most 9 steps (the reference's constant)
_QDWH_MAXIT = 12
#: float32(1/3): the exponent of the reference's float32 ``cbrt``, XLA's
#: ``pow(|x|, 1/3)`` with the third rounded to float32
_THIRD32 = float(np.float32(1.0 / 3.0))


def _cbrt(x):
    """The reference's ``jnp.cbrt`` of a positive numpy float32 or float64
    scalar: ``pow(x, 1/3)`` with the third in ``x``'s type, computed in
    float64 and rounded once (within an ulp of XLA's on the CPU)."""
    third = _THIRD32 if x.dtype == np.float32 else 1.0 / 3.0
    return x.dtype.type(math.pow(float(x), third))


def _qdwh_coeffs(l):
    """The dynamically weighted Halley coefficients ``(a, b, c, l')`` from
    the lower bound ``l`` (a numpy float32 or float64 scalar) on the
    iterate's smallest singular value, in ``l``'s type, the reference's
    closed form step for step (Nakatsukasa, Bai and Gygi)."""
    t = l.dtype.type
    l2 = l * l
    d = _cbrt((t(4.0) * (t(1.0) - l2)) / (l2 * l2))
    sq = np.sqrt(t(1.0) + d)
    a = sq + t(0.5) * np.sqrt(t(8.0) - t(4.0) * d + (t(8.0) * (t(2.0) - l2)) / (l2 * sq))
    b = (a - t(1.0)) * (a - t(1.0)) / t(4.0)
    c = a + b - t(1.0)
    ln = min(l * (a + b * l2) / (t(1.0) + c * l2), t(1.0))
    return a, b, c, ln


def _qdwh_tols(n: int, np_dtype):
    """``(l0, ltol, dtol)``: the first lower bound and the two stopping
    tolerances (iterate while ``|1 - l| > ltol`` or the step's Frobenius
    norm ``delta > dtol``), the reference's."""
    eps = float(np.finfo(np_dtype).eps)
    return eps / n, 10.0 * eps, 10.0 * eps * float(n) ** 0.5


def _block_sumsq(x: torch.Tensor) -> torch.Tensor:
    """Sum of squares of the ``(r, c, ...)`` blocks, summed down the mesh
    rows, then along the columns, each in index order: the reference's
    scalar reduce."""
    return _index_sum(_index_sum((x * x).sum(dim=(-2, -1))))


def _qdwh_step(x, eye, l, bounds, vcs):
    """One QDWH iteration on the blocks ``x`` (``(r, c, mloc, nloc)``):
    ``X' = (b/c) X + ((a - b/c)/sqrt(c)) Q1 Q2^T`` from the grid CAQR of
    ``[sqrt(c) X; I]``, Q1 Q2^T summed over the mesh columns in index
    order.  Returns ``(X', delta, l')`` with ``delta`` = ``||X' - X||_F``
    on the device."""
    np_t = l.dtype.type
    ca, cb, cc, ln = _qdwh_coeffs(l)
    sc = np.sqrt(cc)
    mloc = int(x.shape[2])
    q, _ = _caqr_blocks(torch.cat([x * float(sc), eye], dim=2), bounds, vcs)
    q1, q2 = q[:, :, :mloc], q[:, :, mloc:]
    r, c = int(q.shape[0]), int(q.shape[1])
    q2f = q2.transpose(0, 1).reshape(c, -1, q.shape[3])  # (c, Npr, nloc): mesh column t's rows
    acc = _index_sum((q1 @ q2f.transpose(-1, -2)[None]).transpose(0, 1))  # (r, mloc, Npr)
    m_blk = acc[..., : c * int(x.shape[3])].reshape(r, mloc, c, -1).transpose(1, 2)
    x_new = x * float(cb / cc) + m_blk * float((ca - cb / cc) / np_t(sc))
    return x_new, torch.sqrt(_block_sumsq(x_new - x)), ln


def _qdwh_setup(a: torch.Tensor, n: int):
    """The QDWH iteration's start on the stacked blocks ``a`` (``(r, c,
    mloc, nloc)`` of a zero-padded ``(0, 1)`` operand with ``n`` real
    columns): ``(X0, I, l0, ltol, dtol, bounds, vcs)``, ``X0 = A /
    ||A||_F``, ``I`` the blocks of the identity over the padded columns
    (pad columns included, which keeps every stacked panel of full rank),
    the tolerances in the operand's numpy type and the panel schedule of
    the stacked CAQR."""
    r, c, mloc, nloc = (int(s) for s in a.shape)
    np_t = np.float32 if a.dtype == torch.float32 else np.float64
    Np = c * nloc
    nploc = -(-Np // r)
    _, bounds, vcs = _grid_panel_schedule(Np, c, 1)
    l0, ltol, dtol = _qdwh_tols(n, np_t)
    alpha = torch.sqrt(_block_sumsq(a))
    alpha = torch.where(alpha > 0, alpha, torch.ones_like(alpha))
    dev = a.device
    rows = torch.arange(r, device=dev)[:, None, None, None] * nploc + torch.arange(nploc, device=dev)[:, None]
    cols = torch.arange(c, device=dev)[None, :, None, None] * nloc + torch.arange(nloc, device=dev)
    return a / alpha, (rows == cols).to(a.dtype), np_t(l0), np_t(ltol), float(np_t(dtol)), bounds, vcs


def _qdwh_blocks(a: torch.Tensor, n: int):
    """The polar factor's blocks ``Up`` of the stacked blocks ``a`` by the
    reference's QDWH iteration, and the iteration count.

    The iteration stops at the cap or once both ``|1 - l| <= ltol`` and
    ``delta <= dtol``.  The ``l`` recurrence does not depend on the data,
    so it runs on the host; ``delta`` is read from the device (one host
    sync an iteration) only once ``l`` has converged, and the loop runs
    exactly the reference's iterations.  (Freezing the iterate under a
    device-side mask instead runs all 12 iterations without a sync:
    ``scripts/qdwh_loop_variants.py`` times both.)"""
    x, eye, l, ltol, dtol, bounds, vcs = _qdwh_setup(a, n)
    k, delta = 0, None
    while k < _QDWH_MAXIT and (abs(l.dtype.type(1.0) - l) > ltol or float(delta) > dtol):
        x, delta, l = _qdwh_step(x, eye, l, bounds, vcs)
        k += 1
    return x, k


def _small_eigh(h: torch.Tensor):
    """Eigenvalues (descending) and eigenvectors of the small symmetric
    ``h``, computed in float64 and rounded to ``h``'s type.  cuSOLVER's
    float32 ``syevd`` on the card misses the reference's gates on the
    1024 x 256 operand of ``chip_smoke.py`` phase 11 (S 763 eps s_max from
    numpy's, U and V orthonormal to 840 eps, against 50 and 200) where
    float64 gives 1.1 and 2.1, in no more time
    (``scripts/qdwh_loop_variants.py``)."""
    evals, evecs = torch.linalg.eigh(h.double())
    return evals.flip(0).to(h.dtype), evecs.flip(1).to(h.dtype)


def _grid_svd_parts(a: DNDarray, dtype, compute_uv: bool = True):
    """The grid QDWH SVD of a tall ``(0, 1)`` operand: ``(U's padded
    buffer or None, S, V, iterations)`` as tensors."""
    comm = a.comm
    m, n = a.shape
    r, c = comm.mesh_shape
    mloc, nloc = -(-m // r), -(-n // c)
    Np = c * nloc
    nploc = -(-Np // r)
    if mloc + nploc < nloc:
        raise ValueError(
            f"svd: grid QDWH needs stacked shards at least as tall as a "
            f"column panel: {m}x{n} over the {r}x{c} mesh stacks "
            f"({mloc} + {nploc}) rows against panel width {nloc}; use a "
            f"taller matrix or a flatter mesh"
        )
    buf = a._zeroed_buffer().to(dtype.torch_type())
    blocks = comm.blocks(buf, (0, 1))
    with _matmul_precision():
        up, iterations = _qdwh_blocks(blocks, n)
        # H = Up^T A: Up's blocks against each mesh row's whole padded rows,
        # summed down the mesh rows in index order
        a_rows = buf.reshape(r, mloc, Np)
        h = _index_sum(up.transpose(-1, -2) @ a_rows[:, None]).reshape(Np, Np)[:n, :n]
        s, v = _small_eigh(0.5 * (h + h.T))
        if not compute_uv:
            return None, s, v, iterations
        vp = buf.new_zeros((Np, Np))
        vp[:n, :n] = v
        u = _index_sum((up @ vp.reshape(c, nloc, Np)).transpose(0, 1))  # (r, mloc, Np)
    return u.reshape(r * mloc, Np), s, v, iterations


def _grid_svd(a: DNDarray, dtype, compute_uv: bool):
    """The grid QDWH SVD of a tall ``(0, 1)`` operand (``svd`` commits a
    ``(1, 0)`` one and factors a wide one's transpose)."""
    m, n = a.shape
    comm, device = a.comm, a.device
    fn = jitted(("svd.grid", comm, tuple(a._buffer.shape), str(a._buffer.dtype)),
                lambda: _grid_svd_parts)
    r, c = comm.mesh_shape
    ov = overlap_enabled(c)
    # credited at the iteration cap, as the reference's grid SVD is
    u, s, v, _ = _grid_dispatch(
        "svd2d", lambda: qdwh_svd_model(m, n, (r, c), iterations=_QDWH_MAXIT),
        ov, lambda: fn(a, dtype, compute_uv), mesh=f"{r}x{c}", iterations=_QDWH_MAXIT, overlap=ov,
    )
    S = DNDarray(s, (n,), dtype, None, device, comm)
    if not compute_uv:
        return S
    u[m:] = 0  # pad rows: the at-rest invariant
    U = DNDarray(u, (m, n), dtype, (0, 1), device, comm)
    return SVD(U, S, DNDarray(v, (n, n), dtype, None, device, comm))


@_split_semantics("entry_svd")
def svd(a: DNDarray, full_matrices: bool = False, compute_uv: bool = True):
    """Reduced SVD ``a = U @ diag(S) @ V.T``: ``SVD(U, S, V)``, or only
    ``S`` (a DNDarray) with ``compute_uv=False``.  On a 2-D position grid
    a ``(0, 1)`` or ``(1, 0)`` operand takes the QDWH polar SVD: U at
    ``(0, 1)``, S and V replicated (a wide operand's V at ``(0, 1)``)."""
    sanitize_in(a)
    _xproc.refuse_across("linalg.svd", a)
    if a.ndim != 2:
        raise ValueError(f"svd requires a 2-D DNDarray, got {a.ndim}-d")
    if full_matrices:
        raise NotImplementedError("full_matrices=True is not supported (reduced SVD only)")
    dtype = a.dtype if types.heat_type_is_inexact(a.dtype) else types.float32
    m, n = a.shape
    comm = a.comm
    if comm.mesh_ndim == 2 and comm.size > 1 and a.splits in ((0, 1), (1, 0)):
        # grid QDWH: a wide operand factors its transpose, re-committed to
        # (0, 1), and swaps U with V, as the reference's svd does it here
        # (the entry's declared semantics, not a summary of a helper's
        # recursion, is what the static analysis reads of this call)
        if m < n:
            res = svd(a.T.resplit((0, 1)), compute_uv=compute_uv)
            return res if not compute_uv else SVD(res.V, res.S, res.U)
        if a.splits == (1, 0):
            a = a.resplit((0, 1))
        return _grid_svd(a, dtype, compute_uv)
    if m < n:
        res = svd(a.T, compute_uv=compute_uv)
        return res if not compute_uv else SVD(res.V, res.S, res.U)
    return _svd_pipeline(a, a.split, dtype, compute_uv)
