"""Elementwise comparisons, ``ht.bool`` results.

Port of ``heat_tpu/core/relational.py``: each is a ``__binary_op``.
"""

from __future__ import annotations

import torch

from . import _operations
from .sanitation import as_tensors

__all__ = ["eq", "equal", "ge", "gt", "le", "lt", "ne"]


def eq(t1, t2):
    """Elementwise ==."""
    return _operations.__binary_op(torch.eq, t1, t2)


def equal(t1, t2) -> bool:
    """True when both have one shape and equal values."""
    a1, a2 = as_tensors(t1, t2)
    if tuple(a1.shape) != tuple(a2.shape):
        return False
    return bool(torch.all(a1 == a2))


def ge(t1, t2):
    """Elementwise >=."""
    return _operations.__binary_op(torch.ge, t1, t2)


def gt(t1, t2):
    """Elementwise >."""
    return _operations.__binary_op(torch.gt, t1, t2)


def le(t1, t2):
    """Elementwise <=."""
    return _operations.__binary_op(torch.le, t1, t2)


def lt(t1, t2):
    """Elementwise <."""
    return _operations.__binary_op(torch.lt, t1, t2)


def ne(t1, t2):
    """Elementwise !=."""
    return _operations.__binary_op(torch.ne, t1, t2)
