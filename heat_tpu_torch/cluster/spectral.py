"""Spectral clustering: graph Laplacian, Lanczos embedding, KMeans.

Port of ``heat_tpu/cluster/spectral.py``: the similarity (rbf or
euclidean) goes into a normalized symmetric :class:`Laplacian`,
``lanczos(L, m)`` from a deterministic start vector gives ``V`` and the
tridiagonal ``T``, whose eigenvectors (``numpy.linalg.eigh`` on the host:
``T`` is m x m) turn ``V`` into the spectral embedding; KMeans with
k-means++ draws (``random_state=0``) clusters its first k columns.  With
no ``n_clusters``, k is the largest gap among the first 15 eigenvalues.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import factories, types
from ..core.base import BaseEstimator, ClusteringMixin
from ..core.dndarray import DNDarray
from ..core.linalg import solver
from ..core.sanitation import sanitize_in
from ..graph import Laplacian
from ..spatial import distance
from .kmeans import KMeans

__all__ = ["Spectral"]


class Spectral(ClusteringMixin, BaseEstimator):
    """Spectral clustering estimator.

    Parameters
    ----------
    n_clusters : int or None — None: chosen by the spectral gap
    gamma : float — the rbf coefficient, ``sigma = sqrt(1 / (2 gamma))``
    metric : 'rbf' | 'euclidean'
    laplacian : 'fully_connected' | 'eNeighbour'
    threshold, boundary : the eNeighbour threshold and its side
    n_lanczos : int — the Krylov dimension
    assign_labels : 'kmeans'
    """

    def __init__(
        self,
        n_clusters: Optional[int] = None,
        gamma: float = 1.0,
        metric: str = "rbf",
        laplacian: str = "fully_connected",
        threshold: float = 1.0,
        boundary: str = "upper",
        n_lanczos: int = 300,
        assign_labels: str = "kmeans",
        **params,
    ):
        self.n_clusters = n_clusters
        self.gamma = gamma
        self.metric = metric
        self.laplacian = laplacian
        self.threshold = threshold
        self.boundary = boundary
        self.n_lanczos = n_lanczos
        self.assign_labels = assign_labels

        if metric == "rbf":
            sigma = float(np.sqrt(1.0 / (2.0 * gamma)))
            sim = lambda x: distance.rbf(x, sigma=sigma, quadratic_expansion=True)  # noqa: E731
        elif metric == "euclidean":
            sim = lambda x: distance.cdist(x, quadratic_expansion=True)  # noqa: E731
        else:
            raise NotImplementedError(f"Metric {metric} not implemented")

        self._laplacian = Laplacian(
            sim, definition="norm_sym", mode=laplacian, threshold_key=boundary,
            threshold_value=threshold,
        )
        self._labels = None
        self._cluster_centers = None
        self._kmeans = None
        self._embedding_dim = None

    @property
    def labels_(self) -> DNDarray:
        return self._labels

    @classmethod
    def from_fitted(cls, state: dict, device=None, comm=None, **params) -> "Spectral":
        """A fitted estimator from numpy state — ``{"embedding_dim": k,
        "cluster_centers": (k, k) array}`` (the inner KMeans's centers),
        e.g. read off a Spectral fitted by the JAX package — with the
        constructor's ``params``, ready to ``predict``."""
        sp = cls(**params)
        sp._kmeans = KMeans.from_fitted(
            {"cluster_centers": state["cluster_centers"]}, device=device, comm=comm
        )
        sp._cluster_centers = sp._kmeans.cluster_centers_
        sp._embedding_dim = int(state["embedding_dim"])
        return sp

    def _spectral_embedding(self, x: DNDarray):
        """The Laplacian's eigenvalue estimates (ascending) and the (n, m)
        embedding ``V @ evecs(T)``."""
        L = self._laplacian.construct(x)
        n = x.shape[0]
        m = min(self.n_lanczos, n)
        # a deterministic start vector: fit and predict on the same data
        # build the same Krylov basis (a random one could flip signs)
        v0 = factories.full((n,), 1.0 / np.sqrt(n), dtype=types.float32, device=x.device, comm=x.comm)
        V, T = solver.lanczos(L, m, v0=v0)
        evals, evecs = np.linalg.eigh(T.numpy())
        emb = V.larray @ torch.from_numpy(evecs).to(V.larray.dtype).to(V.larray.device)
        return evals, emb

    def _components(self, x: DNDarray, emb: torch.Tensor, k: int) -> DNDarray:
        comp = emb[:, :k].to(torch.float32)
        return DNDarray(comp, tuple(comp.shape), types.float32, x.split, x.device, x.comm)

    def fit(self, x: DNDarray) -> "Spectral":
        """Embed ``x`` and cluster the embedding."""
        sanitize_in(x)
        if x.split is not None and x.split != 0:
            raise NotImplementedError("Not implemented for other splitting-axes")
        evals, emb = self._spectral_embedding(x)
        k = self.n_clusters
        if k is None:
            diffs = np.diff(evals[: min(len(evals), 15)])
            k = max(int(np.argmax(diffs) + 1) if len(diffs) else 1, 1)
        kmeans = KMeans(n_clusters=k, init="probability_based", random_state=0)
        kmeans.fit(self._components(x, emb, k))
        self._labels = kmeans.labels_
        self._cluster_centers = kmeans.cluster_centers_
        self._kmeans = kmeans
        self._embedding_dim = k
        return self

    def predict(self, x: DNDarray) -> DNDarray:
        """Embed ``x`` and label it with the fitted KMeans."""
        sanitize_in(x)
        if self._kmeans is None:
            raise RuntimeError("Spectral has not been fitted — call fit() first")
        _, emb = self._spectral_embedding(x)
        return self._kmeans.predict(self._components(x, emb, self._embedding_dim))
