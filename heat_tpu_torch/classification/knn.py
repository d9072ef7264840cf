"""K-nearest-neighbour classification.

Port of ``heat_tpu/classification/knn.py``: the quadratic-expansion
distances of the queries to the training rows (one matrix product), the
k smallest per query (``torch.topk``), their one-hot labels summed into a
vote, and the class of most votes (the lowest class on a tie).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core import factories, types
from ..core.base import BaseEstimator, ClassificationMixin
from ..core.dndarray import DNDarray
from ..core.sanitation import sanitize_in, sanitize_predict_in
from ..spatial.distance import quadratic_d2
from ..core._split_semantics import split_semantics as _split_semantics

__all__ = ["KNN"]


class KNN(ClassificationMixin, BaseEstimator):
    """KNN classifier.

    Parameters
    ----------
    x : DNDarray — training samples (n, f)
    y : DNDarray — training labels: (n,) class ids or (n, c) one-hot
    num_neighbours : int — the k of kNN
    """

    def __init__(self, x: DNDarray, y: DNDarray, num_neighbours: int):
        self.num_neighbours = num_neighbours
        self.fit(x, y)

    @classmethod
    def from_fitted(cls, state: dict, split=0, device=None, comm=None) -> "KNN":
        """A classifier from numpy state — ``{"x": (n, f) training rows,
        "y": (n,) class ids or (n, c) one-hot labels, "num_neighbours":
        k}``, e.g. a JAX package KNN's ``x`` and ``y`` — laid out at
        ``split``, ready to ``predict``."""
        x = factories.array(np.asarray(state["x"]), split=split, device=device, comm=comm)
        y = factories.array(np.asarray(state["y"]), split=split, device=device, comm=comm)
        return cls(x, y, int(state["num_neighbours"]))

    @staticmethod
    def label_to_one_hot(a: DNDarray) -> DNDarray:
        """Dense float32 one-hot rows from class ids."""
        arr = a.larray.to(torch.int64)
        one_hot = F.one_hot(arr, int(torch.max(arr)) + 1).to(torch.float32)
        return DNDarray(one_hot, tuple(one_hot.shape), types.float32, a.split, a.device, a.comm)

    def fit(self, x: DNDarray, y: DNDarray) -> None:
        """Store the training set (a lazy learner)."""
        sanitize_in(x)
        sanitize_in(y)
        if x.shape[0] != y.shape[0]:
            raise ValueError(
                f"Number of samples and labels needs to be the same, got {x.shape[0]}, {y.shape[0]}"
            )
        k = self.num_neighbours
        if not isinstance(k, int) or not 0 < k <= x.shape[0]:
            raise ValueError(f"num_neighbours must be an int in [1, {x.shape[0]}], got {k}")
        self.x = x
        if y.ndim == 1:
            self.y = KNN.label_to_one_hot(y)
        elif y.ndim == 2:
            self.y = y
        else:
            raise ValueError(
                "Expected labels of shape (n_samples,) or (n_samples, n_classes) "
                f"but got {y.shape}"
            )

    @_split_semantics("entry_split0")
    def predict(self, x: DNDarray) -> DNDarray:
        """The majority class of each query row's k nearest training rows."""
        x = sanitize_predict_in(x, n_features=self.x.shape[1], op="KNN.predict")
        # promote, never truncate: float64 inputs order near ties in float64
        promoted = types.promote_types(types.promote_types(x.dtype, self.x.dtype), types.float32)
        dt = promoted.torch_type()
        d2 = quadratic_d2(x.larray.to(dt), self.x.larray.to(dt))
        idx = torch.topk(d2, self.num_neighbours, dim=1, largest=False).indices
        votes = torch.sum(self.y.larray.to(torch.float32)[idx], dim=1)
        pred = torch.argmax(votes, dim=1)
        split = x.split if x.split == 0 else None
        return DNDarray(pred, tuple(pred.shape), types.int64, split, x.device, x.comm)
