"""K-Medoids clustering: centers snapped to data points.

Port of ``heat_tpu/cluster/kmedoids.py``: each step takes a cluster's
mean and moves its center to the member nearest to it.  Snapped centers
converge exactly, so the fit stops when a step moves no center;
:meth:`KMedoids._step_loop` runs a fixed number of steps with no stop
test, as the reference benchmark times it.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..core.dndarray import DNDarray
from ..core.sanitation import sanitize_in
from ..spatial.distance import quadratic_d2
from ._kcluster import _KCluster, _quadratic_cdist
from .kmeans import _assign

__all__ = ["KMedoids"]


def _medoid_update(arr: torch.Tensor, labels: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Each cluster's mean snapped to its nearest member; an empty cluster
    keeps its medoid."""
    k = c.shape[0]
    member = labels[None, :] == torch.arange(k, device=arr.device)[:, None]  # (k, n)
    counts = torch.sum(member, dim=1)[:, None]
    means = (member.to(arr.dtype) @ arr) / torch.clamp_min(counts, 1)
    d2 = torch.where(member, quadratic_d2(means, arr), float("inf"))
    return torch.where(counts > 0, arr[torch.argmin(d2, dim=1)], c)


class KMedoids(_KCluster):
    """K-Medoids estimator.

    Parameters
    ----------
    n_clusters : int
    init : ``'random'`` | ``'probability_based'`` (also ``'kmedoids++'``)
        | DNDarray of initial centroids
    max_iter : int
    random_state : int or None
    """

    _init_plus_plus_alias = "kmedoids++"

    def __init__(
        self,
        n_clusters: int = 8,
        init: Union[str, DNDarray] = "random",
        max_iter: int = 300,
        random_state: Optional[int] = None,
    ):
        super().__init__(
            metric=_quadratic_cdist, n_clusters=n_clusters, init=init, max_iter=max_iter,
            tol=0.0, random_state=random_state,
        )

    @staticmethod
    def _step_loop(arr: torch.Tensor, centers: torch.Tensor, n: int) -> torch.Tensor:
        """Exactly ``n`` assign-and-snap steps, with no stop test."""
        for _ in range(int(n)):
            centers = _medoid_update(arr, _assign(arr, centers), centers)
        return centers

    def fit(self, x: DNDarray) -> "KMedoids":
        """Assign-and-snap steps until no medoid moves, or ``max_iter``
        steps."""
        sanitize_in(x)
        if x.ndim != 2:
            raise ValueError(f"input needs to be 2D, but was {x.ndim}D")
        self._initialize_cluster_centers(x)
        arr = x.larray.to(torch.float32)
        c = self._cluster_centers.larray.to(torch.float32)
        it, shift = 0, float("inf")
        while it < self.max_iter and shift > 0.0:
            nc = _medoid_update(arr, _assign(arr, c), c)
            shift = float(torch.sum((nc - c) ** 2))
            it, c = it + 1, nc
        self._finalize_fit(x, c, _assign(arr, c), it)
        return self
