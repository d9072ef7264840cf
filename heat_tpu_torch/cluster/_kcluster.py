"""Shared engine of the k-clustering estimators.

Port of ``heat_tpu/cluster/_kcluster.py``: centroid initialization (a
DNDarray of centroids, ``"random"`` rows or k-means++
``"probability_based"`` draws from the threefry streams of
:mod:`heat_tpu_torch.core.random`), nearest-centroid assignment through
the distance metric, and the fit/predict skeleton.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

from ..core import _xproc, factories, random, types
from ..core.base import BaseEstimator, ClusteringMixin
from ..core.dndarray import DNDarray
from ..core.fuse import fuse
from ..core.sanitation import sanitize_predict_in
from ..core._split_semantics import split_semantics as _split_semantics

__all__ = ["_KCluster"]


def _quadratic_cdist(x: DNDarray, y: DNDarray) -> DNDarray:
    """Default k-clustering metric: the quadratic-expansion distances."""
    from ..spatial import distance

    return distance.cdist(x, y, quadratic_expansion=True)


def _assign_program(x: DNDarray, centers: DNDarray, metric: Callable) -> DNDarray:
    return metric(x, centers).argmin(axis=1)


#: the assignment as one fused program (:func:`heat_tpu_torch.fuse`): a
#: module-level metric keys one cached program per operand signature
_fused_assign = fuse(_assign_program)


def _kmeanspp(arr: torch.Tensor, first: torch.Tensor, us: torch.Tensor) -> torch.Tensor:
    """The k-means++ draws on the device, with no host sync: center 0 is
    row ``first``; each next one folds the newest center into the running
    min-distance vector and takes the row where ``us[i]`` times the total
    falls in the float32 cumulative sum of the squared distances (the
    reference's d^2 CDF, searched on its left side)."""
    n, k = arr.shape[0], us.shape[0]
    centers = torch.zeros((k, arr.shape[1]), dtype=arr.dtype, device=arr.device)
    centers[0] = arr[first]
    dmin = torch.full((n,), float("inf"), dtype=arr.dtype, device=arr.device)
    for i in range(1, k):
        dmin = torch.minimum(dmin, torch.sum((arr - centers[i - 1]) ** 2, dim=1))
        cdf = torch.cumsum(dmin, dim=0)
        total = cdf[-1]
        draw = us[i] * torch.where(total > 0, total, torch.ones_like(total))
        idx = torch.clamp(torch.searchsorted(cdf, draw.reshape(1)), 0, n - 1)
        centers[i] = arr[idx[0]]
    return centers


def _rows(x: DNDarray, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of a row-split ``x``, whole in every process: across
    processes each process fills the rows it holds and every row is taken
    from its owner's part."""
    if not x._slabbed:
        return x.larray[idx]
    a, b = x.comm.process_rows(x.shape[0])
    mine = (idx >= a) & (idx < b)
    part = torch.zeros((int(idx.shape[0]),) + tuple(x.shape[1:]), dtype=x._local.dtype,
                       device=x._local.device)
    part[mine] = x._local[idx[mine] - a]
    parts = torch.stack(_xproc.all_gather(part))
    owner = torch.stack(_xproc.all_gather(mine.to(torch.int32))).argmax(dim=0)
    return parts[owner, torch.arange(int(idx.shape[0]), device=idx.device)]


class _KCluster(ClusteringMixin, BaseEstimator):
    """Base class of KMeans, KMedians and KMedoids.

    Parameters
    ----------
    metric : callable(DNDarray, DNDarray) -> DNDarray
    n_clusters, init, max_iter, tol, random_state : as in the reference.
    checkpoint_every, checkpoint_path : loop snapshots of the resumable
        fits (see :class:`~heat_tpu_torch.cluster.KMeans`).
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
        checkpoint_every: int = 0,
        checkpoint_path: Optional[str] = None,
    ):
        if isinstance(init, str) and init == self._init_plus_plus_alias:
            init = "probability_based"
        self.n_clusters = n_clusters
        self.init = init
        self.max_iter = max_iter
        self.tol = tol
        self.random_state = random_state
        self.checkpoint_every = checkpoint_every
        self.checkpoint_path = checkpoint_path
        self._metric = metric
        self._cluster_centers = None
        self._labels = None
        self._inertia = None
        self._n_iter = None

    def _checkpointer(self, algo: str, meta: dict, comm=None, splits=None):
        """The loop-snapshot driver of a resumable fit (KMeans; the other
        k-clusterers run unsegmented)."""
        from ..resilience.resume import LoopCheckpointer

        return LoopCheckpointer(
            self.checkpoint_path, self.checkpoint_every, algo, meta,
            comm=comm, splits=splits,
        )

    def _checkpoint_attrs(self):
        # fitted state lives in private storage behind the *_ properties
        return ["_cluster_centers", "_labels", "_inertia", "_n_iter"]

    @classmethod
    def from_fitted(cls, state: dict, device=None, comm=None):
        """A fitted estimator from numpy state — ``{"cluster_centers":
        (k, f) array, "n_iter": int, "inertia": float}`` (the last two
        optional), e.g. read off an estimator of the same name fitted by
        the JAX package — ready to ``predict``."""
        centers = factories.array(
            np.asarray(state["cluster_centers"]), split=None, device=device, comm=comm
        )
        est = cls(n_clusters=int(centers.shape[0]), init=centers)
        est._cluster_centers = centers
        est._n_iter = None if state.get("n_iter") is None else int(state["n_iter"])
        est._inertia = None if state.get("inertia") is None else float(state["inertia"])
        return est

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
        """Initial centroids, replicated: the given DNDarray, ``k`` rows at
        the first ``k`` places of ``randperm(n)`` (``"random"``), or the
        k-means++ draws (``"probability_based"``: the first row from
        ``randint``, then ``rand(k)`` against the d^2 CDF).  An int
        ``random_state`` reseeds the generator first."""
        if self.random_state is not None:
            random.seed(self.random_state)
        if isinstance(self.init, DNDarray):
            if self.init.shape != (self.n_clusters, x.shape[1]):
                raise ValueError("passed centroids do not match cluster count or data shape")
            self._cluster_centers = self.init.resplit(None)
            return
        if self.init == "random":
            idx = random.randperm(x.shape[0], device=x.device, comm=x.comm).larray[: self.n_clusters]
            centers = _rows(x, idx)
        elif self.init == "probability_based":
            if x._slabbed:
                _xproc.refuse("the k-means++ init")
            first = random.randint(0, x.shape[0], (1,), device=x.device, comm=x.comm).larray[0]
            us = random.rand(self.n_clusters, device=x.device, comm=x.comm).larray
            centers = _kmeanspp(x.larray.to(torch.float32), first, us).to(x.larray.dtype)
        else:
            raise ValueError(
                f"init needs to be one of 'random', DNDarray or 'probability_based', got {self.init}"
            )
        self._cluster_centers = DNDarray(
            centers, (self.n_clusters, x.shape[1]), x.dtype, None, x.device, x.comm
        )

    def _assign_to_cluster(self, x: DNDarray) -> DNDarray:
        """Nearest-centroid labels: ``metric(x, centers).argmin(axis=1)``,
        one fused program."""
        if self._cluster_centers is None:
            raise RuntimeError(
                f"{type(self).__name__} has no cluster centers — call fit() first"
            )
        x = sanitize_predict_in(
            x, n_features=self._cluster_centers.shape[1], op=f"{type(self).__name__}.predict"
        )
        return _fused_assign(x, self._cluster_centers, self._metric)

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
            labels, (int(x.shape[0]),), types.int64, labels_split, x.device, x.comm, slab=True
        )

    @_split_semantics("entry_split0")
    def predict(self, x: DNDarray) -> DNDarray:
        """Nearest learned centroid of each sample."""
        return self._assign_to_cluster(x)
