"""Arithmetic: ``add``, ``sub``, ``mul``, ``div``, ``pow``, ``neg``, ``sum``.

Port of the part of ``heat_tpu/core/arithmetics.py`` the analytics path
calls.  ``sum`` goes through the reduction engine and so through its
collective-precision seam.
"""

from __future__ import annotations

import torch

from . import _operations
from .sanitation import merge_keepdims

__all__ = ["add", "div", "mul", "neg", "pow", "sub", "sum"]


def add(t1, t2, out=None):
    """Elementwise ``t1 + t2``."""
    return _operations.__binary_op(torch.add, t1, t2, out)


def sub(t1, t2, out=None):
    """Elementwise ``t1 - t2``."""
    return _operations.__binary_op(torch.sub, t1, t2, out)


def mul(t1, t2, out=None):
    """Elementwise ``t1 * t2``."""
    return _operations.__binary_op(torch.mul, t1, t2, out)


def div(t1, t2, out=None):
    """Elementwise true division ``t1 / t2``."""
    return _operations.__binary_op(torch.true_divide, t1, t2, out)


def pow(t1, t2, out=None):
    """Elementwise ``t1 ** t2``."""
    return _operations.__binary_op(torch.pow, t1, t2, out)


def neg(x, out=None):
    """Elementwise ``-x``."""
    return _operations.__local_op(torch.neg, x, out, no_cast=True)


def sum(x, axis=None, out=None, keepdims=None, keepdim=None):
    """Sum over ``axis`` (None: all axes)."""
    keepdims = merge_keepdims(keepdims, keepdim)
    return _operations.__reduce_op(_operations._sum, x, axis, out, keepdims=keepdims)
