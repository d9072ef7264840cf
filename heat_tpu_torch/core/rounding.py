"""Rounding, clipping and sign.

Port of ``heat_tpu/core/rounding.py``: ``__local_op`` maps, except
``modf`` (two outputs).
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _operations
from .dndarray import DNDarray
from .sanitation import sanitize_in

__all__ = ["abs", "absolute", "ceil", "clip", "fabs", "floor", "modf", "round", "sign", "trunc"]


def abs(x, out=None, dtype=None):
    """Elementwise absolute value, in ``x``'s type (or ``dtype``)."""
    result = _operations.__local_op(torch.abs, x, out, no_cast=True)
    return result if dtype is None else result.astype(dtype)


absolute = abs


def fabs(x, out=None):
    """Absolute value as a float."""
    return _operations.__local_op(torch.abs, x, out)


def ceil(x, out=None):
    """Ceiling."""
    return _operations.__local_op(torch.ceil, x, out)


def clip(a, a_min, a_max, out=None):
    """Clamp the values to ``[a_min, a_max]`` (either bound may be None)."""
    sanitize_in(a)
    if a_min is None and a_max is None:
        raise ValueError("either a_min or a_max must be set")
    return _operations.__local_op(torch.clamp, a, out, no_cast=True, min=a_min, max=a_max)


def floor(x, out=None):
    """Floor."""
    return _operations.__local_op(torch.floor, x, out)


def modf(x, out=None) -> Tuple[DNDarray, DNDarray]:
    """Fractional and integral parts, both with ``x``'s sign."""
    sanitize_in(x)
    frac = _operations.__local_op(torch.frac, x)
    integ = _operations.__local_op(torch.trunc, x)
    if out is None:
        return frac, integ
    if not isinstance(out, tuple) or len(out) != 2:
        raise TypeError("out must be a 2-tuple of DNDarrays")
    return _operations._out(out[0], frac), _operations._out(out[1], integ)


def round(x, decimals: int = 0, out=None, dtype=None):
    """Round half to even, to ``decimals`` places."""
    result = _operations.__local_op(torch.round, x, out, decimals=decimals)
    return result if dtype is None else result.astype(dtype)


def _sign(a: torch.Tensor) -> torch.Tensor:
    """``torch.sign``, with NaN kept (torch's gives 0)."""
    return torch.where(torch.isnan(a), a, torch.sign(a)) if a.is_floating_point() else torch.sign(a)


def sign(x, out=None):
    """Elementwise sign, in ``x``'s type; NaN stays NaN."""
    return _operations.__local_op(_sign, x, out, no_cast=True)


def trunc(x, out=None):
    """Truncate toward zero."""
    return _operations.__local_op(torch.trunc, x, out)
