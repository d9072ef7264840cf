"""Statistical reductions: ``mean``, ``var``, ``std``, ``min``, ``max``,
``argmin``.

Port of the part of ``heat_tpu/core/statistics.py`` the analytics path
calls, with its collective-precision seam :func:`_compressed_moment`:
mean/var/std whose axes cover the split axis run local partials plus the
quantized ring when the policy asks for compression.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _operations, types
from .dndarray import DNDarray
from .sanitation import merge_keepdims, sanitize_axis, sanitize_in

__all__ = ["argmin", "max", "mean", "min", "std", "var"]


def _wrap_reduced(x: DNDarray, res: torch.Tensor, axis, keepdims: bool = False) -> DNDarray:
    split = _operations._reduced_split(x, _operations._axes(x.ndim, axis), keepdims)
    if res.ndim == 0:
        split = None
    return DNDarray(
        res, tuple(res.shape), types.canonical_heat_type(res.dtype), split, x.device, x.comm
    )


def _compressed_moment(x: DNDarray, axis, keepdims: bool, kind: str, ddof: int = 0):
    """The collective-precision seam for mean/var/std whose axes cover the
    split: the replicated result, or None when the policy (or the
    geometry) keeps the exact path.  var/std combine the first moment
    exactly and compress only the centered second moment
    (:func:`heat_tpu_torch.comm.compressed.moments_q`)."""
    if x.split is None or x.comm.size <= 1 or types.heat_type_is_exact(x.dtype):
        return None
    axes = _operations._axes(x.ndim, axis)
    if x.split not in axes:
        return None
    mode = _operations._compressed_mode(x, axes)
    if mode is None:
        return None
    from ..comm import compressed as _cq

    buf = x._buffer
    true_n = math.prod(int(x.gshape[a]) for a in axes)
    if kind == "mean":
        return _cq.reduce_q(
            buf, comm=x.comm, split=x.split, axes=axes, keepdims=keepdims,
            mode=mode, mean_n=true_n, out_dtype=buf.dtype,
        )
    return _cq.moments_q(
        buf, comm=x.comm, split=x.split, axes=axes, keepdims=keepdims,
        mode=mode, true_n=true_n, split_valid=int(x.gshape[x.split]),
        ddof=ddof, finalize=kind, out_dtype=buf.dtype,
    )


def mean(x, axis=None, keepdims=None, keepdim=None) -> DNDarray:
    """Arithmetic mean over ``axis`` (int, tuple or None)."""
    keepdims = merge_keepdims(keepdims, keepdim)
    sanitize_in(x)
    axis = sanitize_axis(x.shape, axis)
    res = _compressed_moment(x, axis, keepdims, kind="mean")
    if res is None:
        a = x.larray
        if types.heat_type_is_exact(x.dtype):
            a = a.to(torch.float32)
        res = torch.mean(a, dim=_operations._axes(x.ndim, axis), keepdim=keepdims)
    return _wrap_reduced(x, res, axis, keepdims)


def _moment2(x, axis, ddof, kwargs, kind: str) -> DNDarray:
    sanitize_in(x)
    if "bessel" in kwargs:
        ddof = 1 if kwargs.pop("bessel") else 0
    if ddof not in (0, 1):
        raise ValueError(f"ddof must be 0 or 1, got {ddof}")
    axis = sanitize_axis(x.shape, axis)
    keepdims = merge_keepdims(kwargs.pop("keepdims", None), kwargs.pop("keepdim", None))
    if kwargs:
        raise TypeError(f"unexpected keyword arguments: {sorted(kwargs)}")
    res = _compressed_moment(x, axis, keepdims, kind=kind, ddof=ddof)
    if res is None:
        a = x.larray
        if types.heat_type_is_exact(x.dtype):
            a = a.to(torch.float32)
        res = torch.var(a, dim=_operations._axes(x.ndim, axis), correction=ddof, keepdim=keepdims)
        if kind == "std":
            res = torch.sqrt(res)
    return _wrap_reduced(x, res, axis, keepdims)


def var(x, axis=None, ddof: int = 0, **kwargs) -> DNDarray:
    """Variance with ``ddof`` in {0, 1} (``bessel=True`` also accepted)."""
    return _moment2(x, axis, ddof, kwargs, "var")


def std(x, axis=None, ddof: int = 0, **kwargs) -> DNDarray:
    """Standard deviation: ``sqrt(var)``."""
    return _moment2(x, axis, ddof, kwargs, "std")


def _amin(a: torch.Tensor, axes: tuple, keepdims: bool) -> torch.Tensor:
    return torch.amin(a, dim=axes, keepdim=keepdims) if axes else a.clone()


def _amax(a: torch.Tensor, axes: tuple, keepdims: bool) -> torch.Tensor:
    return torch.amax(a, dim=axes, keepdim=keepdims) if axes else a.clone()


def _argmin(a: torch.Tensor, axes: tuple, keepdims: bool) -> torch.Tensor:
    if len(axes) == a.ndim:
        r = torch.argmin(a.reshape(-1), dim=0)
        return r.reshape((1,) * a.ndim) if keepdims else r
    if len(axes) != 1:
        raise ValueError("argmin takes a single axis or None")
    return torch.argmin(a, dim=axes[0], keepdim=keepdims)


def min(x, axis=None, out=None, keepdims=None, keepdim=None) -> DNDarray:
    """Minimum over ``axis`` (NaN propagates)."""
    keepdims = merge_keepdims(keepdims, keepdim)
    return _operations.__reduce_op(_amin, x, axis, out, keepdims=keepdims)


def max(x, axis=None, out=None, keepdims=None, keepdim=None) -> DNDarray:
    """Maximum over ``axis`` (NaN propagates)."""
    keepdims = merge_keepdims(keepdims, keepdim)
    return _operations.__reduce_op(_amax, x, axis, out, keepdims=keepdims)


def argmin(x, axis: Optional[int] = None, out=None, keepdims=None, keepdim=None) -> DNDarray:
    """Index of the minimum (flat index for ``axis=None``); the first one
    on ties, int64."""
    keepdims = merge_keepdims(keepdims, keepdim)
    return _operations.__reduce_op(_argmin, x, axis, out, keepdims=keepdims, dtype=types.int64)
