"""Shared engine of the k-clustering estimators.

Port of ``heat_tpu/cluster/_kcluster.py``: centroid initialization from a
DNDarray of centroids, nearest-centroid assignment through the distance
metric, and the fit/predict skeleton.  ``init="random"`` and
``init="probability_based"`` draw from the reference's threefry streams,
which the port does not have yet (ROADMAP queue A, item 5: the RNG port
of ``core/random.py``); they raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from ..core import types
from ..core.base import BaseEstimator, ClusteringMixin
from ..core.dndarray import DNDarray
from ..core.sanitation import sanitize_predict_in

__all__ = ["_KCluster"]


def _quadratic_cdist(x: DNDarray, y: DNDarray) -> DNDarray:
    """Default k-clustering metric: the quadratic-expansion distances."""
    from ..spatial import distance

    return distance.cdist(x, y, quadratic_expansion=True)


class _KCluster(ClusteringMixin, BaseEstimator):
    """Base class of KMeans.

    Parameters
    ----------
    metric : callable(DNDarray, DNDarray) -> DNDarray
    n_clusters, init, max_iter, tol, random_state : as in the reference.
    """

    _init_plus_plus_alias: Optional[str] = None

    def __init__(
        self,
        metric: Callable,
        n_clusters: int,
        init: Union[str, DNDarray],
        max_iter: int,
        tol: float,
        random_state: Optional[int],
    ):
        if isinstance(init, str) and init == self._init_plus_plus_alias:
            init = "probability_based"
        self.n_clusters = n_clusters
        self.init = init
        self.max_iter = max_iter
        self.tol = tol
        self.random_state = random_state
        self._metric = metric
        self._cluster_centers = None
        self._labels = None
        self._inertia = None
        self._n_iter = None

    @property
    def cluster_centers_(self) -> DNDarray:
        return self._cluster_centers

    @property
    def labels_(self) -> DNDarray:
        return self._labels

    @property
    def inertia_(self) -> float:
        # fit() leaves a device scalar; the host sync happens here, once
        if self._inertia is not None and not isinstance(self._inertia, float):
            self._inertia = float(self._inertia)
        return self._inertia

    @property
    def n_iter_(self) -> int:
        if self._n_iter is not None and not isinstance(self._n_iter, int):
            self._n_iter = int(self._n_iter)
        return self._n_iter

    def _initialize_cluster_centers(self, x: DNDarray) -> None:
        """Initial centroids: a DNDarray of centroids, replicated."""
        if isinstance(self.init, DNDarray):
            if self.init.shape != (self.n_clusters, x.shape[1]):
                raise ValueError("passed centroids do not match cluster count or data shape")
            self._cluster_centers = self.init.resplit(None)
            return
        if self.init in ("random", "probability_based"):
            raise NotImplementedError(
                f"init={self.init!r} needs the threefry RNG port of core/random.py "
                "(ROADMAP queue A, item 5); pass a DNDarray of initial centroids"
            )
        raise ValueError(
            f"init needs to be one of 'random', DNDarray or 'probability_based', got {self.init}"
        )

    def _assign_to_cluster(self, x: DNDarray) -> DNDarray:
        """Nearest-centroid labels: ``metric(x, centers).argmin(axis=1)``."""
        if self._cluster_centers is None:
            raise RuntimeError(
                f"{type(self).__name__} has no cluster centers — call fit() first"
            )
        x = sanitize_predict_in(
            x, n_features=self._cluster_centers.shape[1], op=f"{type(self).__name__}.predict"
        )
        return self._metric(x, self._cluster_centers).argmin(axis=1)

    def _finalize_fit(self, x: DNDarray, centers: torch.Tensor, labels: torch.Tensor, n_iter) -> None:
        """Store the loop's results as DNDarrays: replicated centers,
        labels with the input's row split."""
        self._n_iter = n_iter
        self._cluster_centers = DNDarray(
            centers.to(x.dtype.torch_type()), (self.n_clusters, x.shape[1]), x.dtype,
            None, x.device, x.comm,
        )
        labels_split = x.split if x.split == 0 else None
        self._labels = DNDarray(
            labels, tuple(labels.shape), types.int64, labels_split, x.device, x.comm
        )

    def predict(self, x: DNDarray) -> DNDarray:
        """Nearest learned centroid of each sample."""
        return self._assign_to_cluster(x)
