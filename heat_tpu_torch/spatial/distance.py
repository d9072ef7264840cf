"""Pairwise distances: :func:`cdist`, :func:`rbf`, :func:`manhattan` and
the quadratic-expansion core.

Port of ``heat_tpu/spatial/distance.py``.  The expansion ``|x|^2 + |y|^2
- 2 x.y`` turns the distance matrix into one float32 matrix product
(cuBLAS, TF32 off); the exact form takes the direct differences.
Row-split ``X`` gives a row-split result.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import types
from ..core.dndarray import DNDarray
from ..core.sanitation import sanitize_in

__all__ = ["cdist", "manhattan", "quadratic_d2", "rbf"]


def quadratic_d2(xa: torch.Tensor, ya: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances by the quadratic expansion, clamped at 0
    against rounding."""
    x2 = torch.sum(xa * xa, dim=-1, keepdim=True)
    y2 = torch.sum(ya * ya, dim=-1, keepdim=True).transpose(-1, -2)
    return torch.clamp_min(x2 + y2 - 2.0 * torch.matmul(xa, ya.transpose(-1, -2)), 0.0)


def _prep(x: DNDarray, y: Optional[DNDarray]):
    sanitize_in(x)
    if x.ndim != 2:
        raise NotImplementedError(f"X should be a 2D DNDarray, but is {x.ndim}D")
    if y is not None:
        sanitize_in(y)
        if y.ndim != 2:
            raise NotImplementedError(f"Y should be a 2D DNDarray, but is {y.ndim}D")
        if x.shape[1] != y.shape[1]:
            raise ValueError(
                f"inputs must have the same number of features, got {x.shape[1]} and {y.shape[1]}"
            )
    promoted = types.promote_types(x.dtype, types.float32)
    xa = x.larray.to(promoted.torch_type())
    ya = xa if y is None else y.larray.to(promoted.torch_type())
    return xa, ya, promoted


def _wrap(X: DNDarray, d: torch.Tensor, dtype) -> DNDarray:
    split = X.split if X.split == 0 else None
    return DNDarray(d, tuple(d.shape), dtype, split, X.device, X.comm)


def cdist(X: DNDarray, Y: Optional[DNDarray] = None, quadratic_expansion: bool = False) -> DNDarray:
    """Pairwise euclidean distances between the rows of ``X`` and ``Y``
    (``Y = X`` when omitted)."""
    xa, ya, dtype = _prep(X, Y)
    if quadratic_expansion:
        d = torch.sqrt(quadratic_d2(xa, ya))
    else:
        d = torch.cdist(xa, ya, compute_mode="donot_use_mm_for_euclid_dist")
    return _wrap(X, d, dtype)


def rbf(
    X: DNDarray, Y: Optional[DNDarray] = None, sigma: float = 1.0, quadratic_expansion: bool = False
) -> DNDarray:
    """The Gaussian kernel matrix ``exp(-d^2 / (2 sigma^2))`` of the rows
    of ``X`` and ``Y`` (``Y = X`` when omitted); ``2 sigma^2`` is taken in
    the operands' type, as the reference takes it."""
    xa, ya, dtype = _prep(X, Y)
    if quadratic_expansion:
        d2 = quadratic_d2(xa, ya)
    else:
        diff = xa[:, None, :] - ya[None, :, :]
        d2 = torch.sum(diff * diff, dim=-1)
    sig = torch.tensor(sigma, dtype=xa.dtype)
    return _wrap(X, torch.exp(-d2 / (2.0 * sig * sig).item()), dtype)


def manhattan(X: DNDarray, Y: Optional[DNDarray] = None, expand: bool = False) -> DNDarray:
    """Pairwise L1 distances of the rows of ``X`` and ``Y`` (``Y = X`` when
    omitted); ``expand`` is accepted as the reference accepts it, with one
    formulation behind it."""
    xa, ya, dtype = _prep(X, Y)
    del expand
    return _wrap(X, torch.cdist(xa, ya, p=1.0), dtype)
