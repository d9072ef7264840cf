"""K-nearest-neighbour classification.

Port of ``heat_tpu/classification/knn.py``: the quadratic-expansion
distances of the queries to the training rows (one matrix product), the
k nearest per query in ``lax.top_k(-d2, k)``'s order, their one-hot
labels summed into a vote, and the class of most votes (the lowest class
on a tie), as one fused program (``_fused_knn_predict``).

The reference's order is XLA's total order of ``-d2``, ties to the lowest
index.  Negation flips the sign bit, so the total-order key of ``-d2`` is
the bitwise complement of ``d2``'s: the k nearest are the k smallest keys
of ``d2``, ties lowest column first (a NaN distance, whose negation is
-NaN, comes last).  For float32 one ``torch.topk`` over an int64 packs the
key above the column index, so every key is distinct and no row is
sorted whole; float64 keys fill 64 bits and take the stable sort of
:func:`~heat_tpu_torch.core.manipulations.topk`'s order.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core import factories, types
from ..core.base import BaseEstimator, ClassificationMixin
from ..core.dndarray import DNDarray
from ..core.fuse import fuse
from ..core.manipulations import _total_order_key
from ..core.sanitation import sanitize_in, sanitize_predict_in
from ..spatial.distance import quadratic_d2
from ..core._split_semantics import split_semantics as _split_semantics

__all__ = ["KNN"]


def _nearest(d2: torch.Tensor, k: int) -> torch.Tensor:
    """Column indices of the k smallest ``d2`` of each row, in the order
    of ``lax.top_k(-d2, k)`` (see the module docstring)."""
    if d2.dtype == torch.float32:
        bits = d2.view(torch.int32)
        # (key << 32) + column, built in place: a 20 000-square d2 keeps
        # its temporaries in a few GB of the program's graph pool
        packed = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
        packed.mul_(1 << 32).add_(torch.arange(d2.shape[1], dtype=torch.int64, device=d2.device))
        return torch.topk(packed, k, dim=1, largest=False).indices
    return torch.sort(_total_order_key(d2), dim=1, stable=True)[1][:, :k]


def _knn_predict_program(x: DNDarray, train_x: DNDarray, train_y: DNDarray, k: int, promoted):
    dt = promoted.torch_type()
    d2 = quadratic_d2(x.larray.to(dt), train_x.larray.to(dt))
    votes = torch.sum(train_y.larray.to(torch.float32)[_nearest(d2, k)], dim=1)  # (m, c)
    pred = torch.argmax(votes, dim=1)
    split = x.split if x.split == 0 else None
    return DNDarray(pred, tuple(pred.shape), types.int64, split, x.device, x.comm)


#: the predict as one fused program (:func:`heat_tpu_torch.fuse`), as the
#: reference's ``_fused_knn_predict``; the serving engine calls it
_fused_knn_predict = fuse(_knn_predict_program)


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
        """The majority class of each query row's k nearest training rows,
        one fused program."""
        x = sanitize_predict_in(x, n_features=self.x.shape[1], op="KNN.predict")
        # promote, never truncate: float64 inputs order near ties in float64
        promoted = types.promote_types(types.promote_types(x.dtype, self.x.dtype), types.float32)
        return _fused_knn_predict(x, self.x, self.y, self.num_neighbours, promoted)
