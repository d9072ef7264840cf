"""K-Means clustering (Lloyd's algorithm).

Port of ``heat_tpu/cluster/kmeans.py``: the exact Lloyd loop and the
``int8_block`` error-feedback loop, both on the reference's explicit
carry ``(it, centers, shift[, error])`` and its ``tol`` rule (a step runs
while ``it < max_iter`` and ``shift > tol``; ``tol < 0`` runs exactly
``max_iter`` steps).  Each step assigns by ``argmin_k(|c|^2 - 2 x.c)`` —
the row norms are constant across the k candidates — and updates with the
selection-matrix product ``one_hot(labels).T @ X``.

Under a compressing collective policy on a row-split input over several
positions, each step's ``(k, f)`` per-position centroid sums ride the
quantized ring with an error-feedback residual in the carry, while the
``(k,)`` counts combine exactly.  With telemetry on, the fit credits the
byte ledger with all of the loop's rings in one entry, as the
reference's does.  Checkpointing and mini-batch fits are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..core.dndarray import DNDarray
from ..core.sanitation import sanitize_in
from ..telemetry import _core as _tel
from ._kcluster import _KCluster, _quadratic_cdist

__all__ = ["KMeans"]


def _assign(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Nearest-center labels of the rows of ``a`` (batched over any
    leading position axis)."""
    c2 = torch.sum(c * c, dim=1)
    return torch.argmin(c2 - 2.0 * torch.matmul(a, c.T), dim=-1)


def _one_hot(labels: torch.Tensor, k: int, dtype: torch.dtype) -> torch.Tensor:
    return (labels.unsqueeze(-1) == torch.arange(k, device=labels.device)).to(dtype)


class KMeans(_KCluster):
    """K-Means estimator.

    Parameters
    ----------
    n_clusters : int
    init : ``'random'`` | ``'probability_based'`` (k-means++, also
        ``'kmeans++'``) | DNDarray of initial centroids
    max_iter : int
    tol : float — convergence threshold on the squared centroid shift
    random_state : int or None
    """

    _init_plus_plus_alias = "kmeans++"

    def __init__(
        self,
        n_clusters: int = 8,
        init: Union[str, DNDarray] = "random",
        max_iter: int = 300,
        tol: float = 1e-4,
        random_state: Optional[int] = None,
    ):
        super().__init__(
            metric=_quadratic_cdist,
            n_clusters=n_clusters,
            init=init,
            max_iter=max_iter,
            tol=tol,
            random_state=random_state,
        )

    @staticmethod
    def _fit_segment(arr: torch.Tensor, tol: float, stop: int, carry):
        """Exact Lloyd steps on ``carry = (it, centers, shift)`` while
        ``it < stop`` and ``shift > tol``."""
        it, c, shift = carry
        k = c.shape[0]
        while it < stop and shift > tol:
            labels = _assign(arr, c)
            sel = _one_hot(labels, k, arr.dtype)
            sums = torch.matmul(sel.T, arr)
            counts = torch.sum(sel, dim=0)[:, None]
            nc = torch.where(counts > 0, sums / torch.clamp_min(counts, 1), c)
            shift = float(torch.sum((nc - c) ** 2))
            it, c = it + 1, nc
        return it, c, shift

    @staticmethod
    def _fit_segment_q(blocks: torch.Tensor, tol: float, stop: int, carry, *, mode: str):
        """The error-feedback loop on ``carry = (it, centers, shift,
        error)``: ``blocks`` is the ``(p, n/p, f)`` row blocks of the
        positions, ``error`` the stacked ``(p, k*f)`` residual."""
        from ..comm.compressed import ring_allreduce_q_ef

        it, c, shift, e = carry
        p = blocks.shape[0]
        k, f = c.shape
        while it < stop and shift > tol:
            labels = _assign(blocks, c)
            sel = _one_hot(labels, k, blocks.dtype)
            sums = torch.matmul(sel.transpose(1, 2), blocks)
            gcounts = torch.sum(sel, dim=(0, 1))[:, None]
            red, e = ring_allreduce_q_ef(sums.reshape(p, k * f), e, size=p, mode=mode)
            nc = torch.where(gcounts > 0.5, red.reshape(k, f) / torch.clamp_min(gcounts, 1.0), c)
            shift = float(torch.sum((nc - c) ** 2))
            it, c = it + 1, nc
        return it, c, shift, e

    def fit(self, x: DNDarray) -> "KMeans":
        """Lloyd iterations until the squared centroid shift is <= tol, or
        ``max_iter`` steps."""
        sanitize_in(x)
        if x.ndim != 2:
            raise ValueError(f"input needs to be 2D, but was {x.ndim}D")
        arr = x.larray.to(torch.float32)
        comm = x.comm
        n, f = int(x.shape[0]), int(x.shape[1])
        k = self.n_clusters

        mode = None
        if x.split == 0 and comm.size > 1 and n % comm.size == 0:
            from ..comm import compressed as _cq

            mode = _cq.reduce_mode(torch.float32, k * f * 4)

        self._initialize_cluster_centers(x)
        centers0 = self._cluster_centers.larray.to(torch.float32)
        # the reference compares in float32: tol rounds as it does there
        tol, stop = float(np.float32(self.tol)), int(self.max_iter)
        if mode is not None:
            p = comm.size
            error0 = torch.zeros((p, k * f), dtype=torch.float32, device=arr.device)
            blocks = arr.reshape(p, n // p, f)
            it, centers, _, _ = KMeans._fit_segment_q(
                blocks, tol, stop, (0, centers0, float("inf"), error0), mode=mode
            )
            if _tel.enabled and it > 0:
                from ..comm import compressed as _cq

                # the loop runs its rings on the ring primitive, below
                # allreduce_q's accounting: credit the ledger here, one
                # entry for the loop's ``it`` rings of k*f values
                _cq._account_wire("allreduce", mode, k * f, p, reps=it)
        else:
            it, centers, _ = KMeans._fit_segment(arr, tol, stop, (0, centers0, float("inf")))

        labels = _assign(arr, centers)
        self._inertia = torch.sum((arr - centers[labels]) ** 2)
        self._finalize_fit(x, centers, labels, it)
        return self
