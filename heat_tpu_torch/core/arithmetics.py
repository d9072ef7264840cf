"""Elementwise arithmetic, bit operations, and sum/prod/cumulative
reductions.

Port of ``heat_tpu/core/arithmetics.py``.  Every function goes through
the op engine of :mod:`._operations`; ``sum`` through its
collective-precision seam, ``cumsum``/``cumprod`` along the split axis
through the two-level scan.

Division by zero gives numpy's values, on the CPU and on the card alike:
an integer ``floordiv``, ``mod``/``remainder`` or ``fmod`` by zero is 0,
a float ``floordiv`` by zero is ``x / 0`` (±inf, or NaN for 0 and NaN),
a float ``mod``/``fmod`` by zero NaN.  The zero divisors are masked
explicitly (torch raises for them on the CPU).  The reference differs
for the integer and float ``floordiv`` (ROADMAP, "Faults of the
reference").  Shifts by a negative count or by at least the type's width
give 0 (left) or the sign fill (right), as the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _operations, types
from .dndarray import DNDarray
from .sanitation import merge_keepdims, sanitize_in
from .stride_tricks import sanitize_axis

__all__ = [
    "add",
    "bitwise_and",
    "bitwise_not",
    "bitwise_or",
    "bitwise_xor",
    "cumprod",
    "cumproduct",
    "cumsum",
    "diff",
    "div",
    "divide",
    "floordiv",
    "floor_divide",
    "fmod",
    "invert",
    "left_shift",
    "mod",
    "remainder",
    "mul",
    "multiply",
    "neg",
    "pow",
    "power",
    "prod",
    "right_shift",
    "sub",
    "subtract",
    "sum",
]


def add(t1, t2, out=None):
    """Elementwise ``t1 + t2``."""
    return _operations.__binary_op(torch.add, t1, t2, out)


def sub(t1, t2, out=None):
    """Elementwise ``t1 - t2``."""
    return _operations.__binary_op(torch.sub, t1, t2, out)


subtract = sub


def mul(t1, t2, out=None):
    """Elementwise ``t1 * t2``."""
    return _operations.__binary_op(torch.mul, t1, t2, out)


multiply = mul


def _truediv(a, b):
    # int64 divides in float64, every other exact type in float32
    if a.dtype == torch.int64:
        a = a.to(torch.float64)
    return torch.true_divide(a, b)


def div(t1, t2, out=None):
    """Elementwise true division ``t1 / t2`` (float64 for int64
    operands, float32 for the other exact types)."""
    return _operations.__binary_op(_truediv, t1, t2, out)


divide = div


def _by_zero(fn, int_fill, float_fill):
    """``fn(a, b)`` with zero divisors masked: where ``b == 0`` the result
    is ``int_fill`` for exact types, ``float_fill(a, b)`` for floats."""

    def op(a, b):
        b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
        zero = b == 0
        exact = not a.dtype.is_floating_point
        out = fn(a, torch.where(zero, torch.ones_like(b), b) if exact else b)
        fill = torch.full_like(out, int_fill) if exact else float_fill(a, b)
        return torch.where(zero, fill, out)

    return op


_floordiv = _by_zero(torch.floor_divide, 0, torch.true_divide)
_remainder = _by_zero(torch.remainder, 0, lambda a, b: torch.full_like(a / b, float("nan")))
_fmod = _by_zero(torch.fmod, 0, lambda a, b: torch.full_like(a / b, float("nan")))


def floordiv(t1, t2, out=None):
    """Elementwise floor division ``t1 // t2``; by zero, numpy's values."""
    return _operations.__binary_op(_floordiv, t1, t2, out)


floor_divide = floordiv


def fmod(t1, t2, out=None):
    """Elementwise remainder with the sign of ``t1`` (C's ``fmod``)."""
    return _operations.__binary_op(_fmod, t1, t2, out)


def remainder(t1, t2, out=None):
    """Elementwise ``t1 % t2`` with the sign of ``t2`` (Python's)."""
    return _operations.__binary_op(_remainder, t1, t2, out)


def mod(t1, t2, out=None):
    """Alias of :func:`remainder`."""
    return remainder(t1, t2, out)


def pow(t1, t2, out=None):
    """Elementwise ``t1 ** t2``."""
    return _operations.__binary_op(torch.pow, t1, t2, out)


power = pow


def neg(x, out=None):
    """Elementwise ``-x`` (laid out at ``x.split``, as the reference's
    ``x * -1``)."""
    return _operations.__local_op(torch.neg, x, out, no_cast=True, keep_grid=False)


def _check_int(t1, t2, name):
    for t in (t1, t2):
        if isinstance(t, DNDarray) and types.heat_type_is_inexact(t.dtype):
            raise TypeError(f"Operation {name} not supported for float types, got {t.dtype.__name__}")
        if isinstance(t, float):
            raise TypeError(f"Operation {name} not supported for float scalars")


def _check_int_shift(t1, name):
    if isinstance(t1, DNDarray) and types.heat_type_is_inexact(t1.dtype):
        raise TypeError(f"Operation {name} not supported for float types, got {t1.dtype.__name__}")


def bitwise_and(t1, t2, out=None):
    """Elementwise AND of integers or booleans."""
    _check_int(t1, t2, "bitwise_and")
    return _operations.__binary_op(torch.bitwise_and, t1, t2, out)


def bitwise_or(t1, t2, out=None):
    """Elementwise OR of integers or booleans."""
    _check_int(t1, t2, "bitwise_or")
    return _operations.__binary_op(torch.bitwise_or, t1, t2, out)


def bitwise_xor(t1, t2, out=None):
    """Elementwise XOR of integers or booleans."""
    _check_int(t1, t2, "bitwise_xor")
    return _operations.__binary_op(torch.bitwise_xor, t1, t2, out)


def invert(t, out=None):
    """Elementwise bitwise NOT (logical NOT for booleans)."""
    if isinstance(t, DNDarray) and types.heat_type_is_inexact(t.dtype):
        raise TypeError(f"Operation is not supported for float types, got {t.dtype.__name__}")
    return _operations.__local_op(torch.bitwise_not, t, out, no_cast=True)


bitwise_not = invert


def _shift(left: bool):
    """A shift whose counts outside ``[0, width)`` give 0 (left) or the
    sign fill (right), whatever the device does with them."""

    def op(a, b):
        b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
        width = torch.iinfo(a.dtype).bits if a.dtype != torch.bool else 8
        valid = (b >= 0) & (b < width)
        count = torch.where(valid, b, torch.zeros_like(b))
        if left:
            return torch.where(valid, torch.bitwise_left_shift(a, count), torch.zeros_like(a))
        fill = torch.where(a < 0, torch.full_like(a, -1), torch.zeros_like(a))
        return torch.where(valid, torch.bitwise_right_shift(a, count), fill)

    return op


def left_shift(t1, t2, out=None):
    """Elementwise ``t1 << t2``."""
    _check_int_shift(t1, "left_shift")
    return _operations.__binary_op(_shift(True), t1, t2, out)


def right_shift(t1, t2, out=None):
    """Elementwise ``t1 >> t2`` (arithmetic for signed types)."""
    _check_int_shift(t1, "right_shift")
    return _operations.__binary_op(_shift(False), t1, t2, out)


def cumsum(a, axis, dtype=None, out=None):
    """Cumulative sum along ``axis``."""
    return _operations.__cum_op(torch.cumsum, a, axis, out, dtype)


def cumprod(a, axis, dtype=None, out=None):
    """Cumulative product along ``axis``."""
    return _operations.__cum_op(torch.cumprod, a, axis, out, dtype)


cumproduct = cumprod


def diff(a, n: int = 1, axis: int = -1, prepend=None, append=None):
    """The ``n``-th discrete difference along ``axis``, numpy's: a scalar
    ``prepend``/``append`` is broadcast to one slice, and the result's type
    promotes over the input and both edges.  The split stays where it
    was."""
    if n == 0:
        return a
    if n < 0:
        raise ValueError(f"diff requires that n be a positive number, got {n}")
    sanitize_in(a)
    axis = sanitize_axis(a.shape, axis)
    arr = a.larray

    def edge(v):
        if v is None or isinstance(v, (bool, int, float)):
            return v
        if isinstance(v, DNDarray):
            return v.larray
        return torch.as_tensor(v if isinstance(v, torch.Tensor) else np.asarray(v), device=arr.device)

    edges = {k: edge(v) for k, v in (("prepend", prepend), ("append", append)) if v is not None}
    typing = [e if isinstance(e, (bool, int, float)) else types.canonical_heat_type(e.dtype)
              for e in edges.values()]
    rtype = types._weak_result_type(a.dtype, *typing).torch_type()
    eshape = list(arr.shape)
    eshape[axis] = 1
    kw = {}
    for k, e in edges.items():
        e = torch.as_tensor(e, dtype=rtype, device=arr.device)
        kw[k] = e.expand(eshape) if e.ndim == 0 else e
    result = torch.diff(arr.to(rtype), n=n, dim=axis, **kw)
    return DNDarray(
        result, tuple(result.shape), types.canonical_heat_type(result.dtype), a.split, a.device, a.comm,
    )


def sum(x, axis=None, out=None, keepdims=None, keepdim=None):
    """Sum over ``axis`` (None: all axes)."""
    keepdims = merge_keepdims(keepdims, keepdim)
    return _operations.__reduce_op(_operations._sum, x, axis, out, keepdims=keepdims)


def prod(x, axis=None, out=None, keepdims=None, keepdim=None):
    """Product over ``axis`` (None: all axes); exact types give int64."""
    keepdims = merge_keepdims(keepdims, keepdim)
    return _operations.__reduce_op(_operations._prod, x, axis, out, keepdims=keepdims)


# split semantics (see core/_split_semantics.py); the table stays a literal dict
from ._split_semantics import declare_split_semantics_table  # noqa: E402

declare_split_semantics_table(
    __name__,
    {
        "binary": (
            "add", "sub", "mul", "div", "floordiv", "fmod", "remainder",
            "mod", "pow", "left_shift", "right_shift", "bitwise_and",
            "bitwise_or", "bitwise_xor",
        ),
        "elementwise": ("invert",),
        "reduction": ("sum", "prod"),
        "cumulative": ("cumsum", "cumprod"),
    },
)
