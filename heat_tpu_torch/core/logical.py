"""Logical reductions and elementwise logical ops.

Port of ``heat_tpu/core/logical.py``: ``all``/``any`` run on the reduction
engine, the rest on the elementwise engines; ``allclose`` is a Python bool.
"""

from __future__ import annotations

import torch

from . import _operations
from .sanitation import as_tensors, merge_keepdims

__all__ = [
    "all", "allclose", "any", "isclose", "isfinite", "isinf", "isnan", "isneginf", "isposinf",
    "logical_and", "logical_not", "logical_or", "logical_xor",
]


def _all(a: torch.Tensor, axes: tuple, keepdims: bool) -> torch.Tensor:
    return torch.all(a, dim=axes, keepdim=keepdims) if axes else a.to(torch.bool)


def _any(a: torch.Tensor, axes: tuple, keepdims: bool) -> torch.Tensor:
    return torch.any(a, dim=axes, keepdim=keepdims) if axes else a.to(torch.bool)


def all(x, axis=None, out=None, keepdims=None, keepdim=None):
    """True where every element (along ``axis``) is nonzero."""
    return _operations.__reduce_op(_all, x, axis, out, keepdims=merge_keepdims(keepdims, keepdim))


def any(x, axis=None, out=None, keepdims=None, keepdim=None):
    """True where any element (along ``axis``) is nonzero."""
    return _operations.__reduce_op(_any, x, axis, out, keepdims=merge_keepdims(keepdims, keepdim))


def _promoted(a, b):
    """Two tensors of their common type (``b`` may be a Python number)."""
    b = torch.as_tensor(b, device=a.device)
    dtype = torch.result_type(a, b)
    return a.to(dtype), b.to(dtype)


def allclose(x, y, rtol: float = 1e-05, atol: float = 1e-08, equal_nan: bool = False) -> bool:
    """True when every ``|x - y| <= atol + rtol * |y|``."""
    return bool(torch.allclose(*_promoted(*as_tensors(x, y)), rtol=rtol, atol=atol, equal_nan=equal_nan))


def isclose(x, y, rtol: float = 1e-05, atol: float = 1e-08, equal_nan: bool = False):
    """Elementwise ``|x - y| <= atol + rtol * |y|``."""

    def _isclose(a, b):
        return torch.isclose(*_promoted(a, b), rtol=rtol, atol=atol, equal_nan=equal_nan)

    return _operations.__binary_op(_isclose, x, y)


def isfinite(x, out=None):
    """Elementwise finiteness."""
    return _operations.__local_op(torch.isfinite, x, out, no_cast=True)


def isinf(x, out=None):
    """Elementwise +-inf test."""
    return _operations.__local_op(torch.isinf, x, out, no_cast=True)


def isnan(x, out=None):
    """Elementwise NaN test."""
    return _operations.__local_op(torch.isnan, x, out, no_cast=True)


def isneginf(x, out=None):
    """Elementwise -inf test."""
    return _operations.__local_op(torch.isneginf, x, out, no_cast=True)


def isposinf(x, out=None):
    """Elementwise +inf test."""
    return _operations.__local_op(torch.isposinf, x, out, no_cast=True)


def _on_tensors(fn):
    """``fn`` of two tensors, taking a Python number second operand."""
    return lambda a, b: fn(*_promoted(a, b))


def logical_and(t1, t2):
    """Elementwise logical and."""
    return _operations.__binary_op(_on_tensors(torch.logical_and), t1, t2)


def logical_or(t1, t2):
    """Elementwise logical or."""
    return _operations.__binary_op(_on_tensors(torch.logical_or), t1, t2)


def logical_xor(t1, t2):
    """Elementwise logical xor."""
    return _operations.__binary_op(_on_tensors(torch.logical_xor), t1, t2)


def logical_not(t, out=None):
    """Elementwise logical not."""
    return _operations.__local_op(torch.logical_not, t, out, no_cast=True)
