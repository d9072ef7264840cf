"""Exponential and logarithmic elementwise maps.

Port of ``heat_tpu/core/exponential.py``: each is a ``__local_op`` map;
exact input types are float-promoted by the engine.
"""

from __future__ import annotations

import torch

from . import _operations

__all__ = ["exp", "exp2", "expm1", "log", "log10", "log1p", "log2", "sqrt"]


def exp(x, out=None):
    """e**x."""
    return _operations.__local_op(torch.exp, x, out)


def expm1(x, out=None):
    """e**x - 1."""
    return _operations.__local_op(torch.expm1, x, out)


def exp2(x, out=None):
    """2**x."""
    return _operations.__local_op(torch.exp2, x, out)


def log(x, out=None):
    """Natural logarithm."""
    return _operations.__local_op(torch.log, x, out)


def log2(x, out=None):
    """Base-2 logarithm."""
    return _operations.__local_op(torch.log2, x, out)


def log10(x, out=None):
    """Base-10 logarithm."""
    return _operations.__local_op(torch.log10, x, out)


def log1p(x, out=None):
    """log(1 + x)."""
    return _operations.__local_op(torch.log1p, x, out)


def sqrt(x, out=None):
    """Square root."""
    return _operations.__local_op(torch.sqrt, x, out)
