"""Trigonometric and hyperbolic elementwise maps.

Port of ``heat_tpu/core/trigonometrics.py``: ``__local_op`` maps, and
``arctan2`` a ``__binary_op``; exact input types are float-promoted.
"""

from __future__ import annotations

import torch

from . import _operations

__all__ = [
    "acos", "arccos", "arcsin", "arctan", "arctan2", "asin", "atan", "atan2", "cos", "cosh",
    "deg2rad", "degrees", "rad2deg", "radians", "sin", "sinh", "tan", "tanh",
]


def arccos(x, out=None):
    """Inverse cosine."""
    return _operations.__local_op(torch.arccos, x, out)


def arcsin(x, out=None):
    """Inverse sine."""
    return _operations.__local_op(torch.arcsin, x, out)


def arctan(x, out=None):
    """Inverse tangent."""
    return _operations.__local_op(torch.arctan, x, out)


def _atan2(a, b):
    b = torch.as_tensor(b, device=a.device)
    a = a if a.is_floating_point() else a.to(torch.float32)
    b = b if b.is_floating_point() else b.to(torch.float32)
    return torch.atan2(a, b)


def arctan2(x1, x2):
    """Quadrant-aware inverse tangent of ``x1 / x2``."""
    return _operations.__binary_op(_atan2, x1, x2)


def cos(x, out=None):
    """Cosine."""
    return _operations.__local_op(torch.cos, x, out)


def cosh(x, out=None):
    """Hyperbolic cosine."""
    return _operations.__local_op(torch.cosh, x, out)


def deg2rad(x, out=None):
    """Degrees to radians."""
    return _operations.__local_op(torch.deg2rad, x, out)


def rad2deg(x, out=None):
    """Radians to degrees."""
    return _operations.__local_op(torch.rad2deg, x, out)


def sin(x, out=None):
    """Sine."""
    return _operations.__local_op(torch.sin, x, out)


def sinh(x, out=None):
    """Hyperbolic sine."""
    return _operations.__local_op(torch.sinh, x, out)


def tan(x, out=None):
    """Tangent."""
    return _operations.__local_op(torch.tan, x, out)


def tanh(x, out=None):
    """Hyperbolic tangent."""
    return _operations.__local_op(torch.tanh, x, out)


acos, asin, atan, atan2 = arccos, arcsin, arctan, arctan2
radians, degrees = deg2rad, rad2deg
