"""K-Medians clustering.

Port of ``heat_tpu/cluster/kmedians.py``: the KMeans skeleton with each
center moved to its cluster's per-feature median.  The data never change
across the Lloyd steps, so every feature column is value-sorted once
(NaN last); each step then finds all k x f exact medians by bisection
over the sorted positions, counting the members at or below a probe
value with one product of the cluster one-hot and a 0/1 indicator.  From
the second step the brackets start around the last step's positions and
are validated exactly (two count probes), so the warm start changes the
number of bisection trips, never a median.

The counts are float32 products (cuBLAS has no int8 GEMM reachable from
``torch.matmul``, which the reference's int8 count uses): a sum of 0/1
terms is exact below 2^24 rows, so fits of more rows raise.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..core.dndarray import DNDarray
from ..core.sanitation import sanitize_in
from ._kcluster import _KCluster, _quadratic_cdist
from .kmeans import _assign

__all__ = ["KMedians"]

#: half-window (positions) of a warm-started bracket around the last
#: step's median position
_WARM_WINDOW = 64
#: float32 counts of 0/1 terms are exact below this many rows
_MAX_ROWS = 1 << 24


def _presort_values(arr: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The value-sorted columns (NaN last) and each column's finite range
    ``(svals, fmin, fmax)``, 0 for a column with no finite value."""
    svals = torch.sort(arr, dim=0).values
    finite = torch.isfinite(svals)
    fmax = torch.amax(torch.where(finite, svals, -float("inf")), dim=0)
    fmin = torch.amin(torch.where(finite, svals, float("inf")), dim=0)
    fmax = torch.where(torch.isfinite(fmax), fmax, torch.zeros_like(fmax))
    fmin = torch.where(torch.isfinite(fmin), fmin, torch.zeros_like(fmin))
    return svals, fmin, fmax


def _cluster_medians(arr, svals, fmin, fmax, labels, counts, k, prev_pos=None):
    """Exact per-cluster per-feature medians ``(k, f)`` and their sorted
    positions ``(k, f, 2)``.

    The t-th smallest member of cluster c in feature j is the value at the
    smallest position p of the sorted column with ``count(p) >= t``, where
    ``count(p)`` is the number of c's members with ``x[:, j] <=
    svals[p, j]`` (NaN members are never counted; probe values clamp to
    the column's finite range).  Both middle members (numpy's average of
    an even count) are searched side by side."""
    n, f = arr.shape
    t = torch.clamp_min(torch.stack([(counts - 1) // 2 + 1, counts // 2 + 1], dim=-1), 1)
    tkf = t[:, None, :].to(torch.float32)  # (k, 1, 2) target ranks
    onehot_t = (labels[None, :] == torch.arange(k, device=arr.device)[:, None]).to(torch.float32)

    def count_at(pos):
        pos = torch.clamp(pos, 0, n - 1)
        thr = torch.gather(svals, 0, pos.permute(2, 0, 1).reshape(2 * k, f)).reshape(2, k, f)
        thr = torch.minimum(torch.maximum(torch.where(torch.isnan(thr), fmax, thr), fmin), fmax)
        rows = thr[:, labels]  # (2, n, f): each row's own cluster's thresholds
        ind = torch.cat([arr <= rows[0], arr <= rows[1]], dim=1).to(torch.float32)
        cnt = onehot_t @ ind  # (k, 2f) counts, exact in float32 below 2^24 rows
        return torch.stack([cnt[:, :f], cnt[:, f:]], dim=-1)

    full_lo = torch.zeros((k, f, 2), dtype=torch.int64, device=arr.device)
    full_hi = torch.full((k, f, 2), n - 1, dtype=torch.int64, device=arr.device)
    if prev_pos is None:
        lo, hi = full_lo, full_hi
    else:
        lo = torch.clamp(prev_pos - _WARM_WINDOW, 0, n - 1)
        hi = torch.clamp(prev_pos + _WARM_WINDOW, 0, n - 1)
        ok = (count_at(hi) >= tkf) & ((lo == 0) | (count_at(lo - 1) < tkf))
        lo, hi = torch.where(ok, lo, full_lo), torch.where(ok, hi, full_hi)
    # each trip halves every bracket; a closed bracket stays put
    for _ in range(int(torch.max(hi - lo)).bit_length()):
        pos = lo + (hi - lo) // 2
        found = count_at(pos) >= tkf
        lo, hi = torch.where(found, lo, pos + 1), torch.where(found, pos, hi)
    # a slot with fewer counted members than its rank (an empty cluster, a
    # feature of NaN members) runs past the column: NaN, as the
    # reference's out-of-range gather fills it
    val = torch.gather(svals, 0, torch.clamp_max(lo, n - 1).permute(2, 0, 1).reshape(2 * k, f))
    val = torch.where(lo.permute(2, 0, 1).reshape(2 * k, f) < n, val, float("nan")).reshape(2, k, f)
    return (val[0] + val[1]) * 0.5, lo


class KMedians(_KCluster):
    """K-Medians estimator.

    Parameters
    ----------
    n_clusters : int
    init : ``'random'`` | ``'probability_based'`` (also ``'kmedians++'``)
        | DNDarray of initial centroids
    max_iter : int
    tol : float — threshold on the squared centroid shift (``tol < 0``
        runs exactly ``max_iter`` steps)
    random_state : int or None
    """

    _init_plus_plus_alias = "kmedians++"

    def __init__(
        self,
        n_clusters: int = 8,
        init: Union[str, DNDarray] = "random",
        max_iter: int = 300,
        tol: float = 1e-4,
        random_state: Optional[int] = None,
    ):
        super().__init__(
            metric=_quadratic_cdist, n_clusters=n_clusters, init=init, max_iter=max_iter,
            tol=tol, random_state=random_state,
        )

    @staticmethod
    def _fit_loop(arr: torch.Tensor, centers: torch.Tensor, tol: float, max_iter: int):
        """Lloyd steps with median updates while ``it < max_iter`` and the
        squared shift is over ``tol``; returns ``(centers, labels,
        n_iter)``.  An empty cluster, or a NaN median, keeps its
        coordinate."""
        if arr.shape[0] >= _MAX_ROWS:
            raise ValueError(f"KMedians counts in float32 and takes under {_MAX_ROWS} rows")
        k = centers.shape[0]
        svals, fmin, fmax = _presort_values(arr)
        it, shift, pos, c = 0, float("inf"), None, centers
        while it < max_iter and shift > tol:
            labels = _assign(arr, c)
            counts = torch.bincount(labels, minlength=k)
            med, pos = _cluster_medians(arr, svals, fmin, fmax, labels, counts, k, pos)
            nc = torch.where((counts > 0)[:, None] & ~torch.isnan(med), med, c)
            shift = float(torch.sum((nc - c) ** 2))
            it, c = it + 1, nc
        return c, _assign(arr, c), it

    def fit(self, x: DNDarray) -> "KMedians":
        """Median-update Lloyd steps until the squared centroid shift is
        at most ``tol``, or ``max_iter`` steps."""
        sanitize_in(x)
        if x.ndim != 2:
            raise ValueError(f"input needs to be 2D, but was {x.ndim}D")
        self._initialize_cluster_centers(x)
        arr = x.larray.to(torch.float32)
        centers = self._cluster_centers.larray.to(torch.float32)
        # the reference compares in float32: tol rounds as it does there
        centers, labels, n_iter = KMedians._fit_loop(
            arr, centers, float(np.float32(self.tol)), int(self.max_iter)
        )
        self._finalize_fit(x, centers, labels, n_iter)
        return self
