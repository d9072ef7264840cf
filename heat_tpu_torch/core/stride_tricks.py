"""Shape and axis normalization shared by every op.

Port of ``heat_tpu/core/stride_tricks.py`` (``broadcast_shape``,
``sanitize_axis``, ``sanitize_shape``, ``sanitize_slice``): pure shape
logic on numpy, the same rules and messages.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np

__all__ = ["broadcast_shape", "sanitize_axis", "sanitize_shape", "sanitize_slice"]


def broadcast_shape(shape_a: Sequence[int], shape_b: Sequence[int]) -> Tuple[int, ...]:
    """NumPy broadcast of two shapes; ``ValueError`` when they do not
    broadcast."""
    try:
        return tuple(np.broadcast_shapes(tuple(shape_a), tuple(shape_b)))
    except ValueError:
        raise ValueError(
            f"operands could not be broadcast, input shapes {tuple(shape_a)} {tuple(shape_b)}"
        ) from None


def sanitize_axis(
    shape: Sequence[int], axis: Union[int, None, Sequence[int]]
) -> Union[int, None, Tuple[int, ...]]:
    """Normalize ``axis`` (None, an int or a sequence of ints) against
    ``shape``: negative axes count from the end, out-of-range axes raise
    ``ValueError``, repeated axes too; a 0-d shape ignores axis 0/-1."""
    ndim = len(shape)
    if axis is None:
        return None
    if isinstance(axis, (list, tuple, np.ndarray)):
        out = []
        for a in (int(a) for a in axis):
            if a < -ndim or a >= max(ndim, 1):
                raise ValueError(f"axis {a} is out of bounds for {ndim}-dimensional shape")
            out.append(a % ndim if ndim else 0)
        if len(set(out)) != len(out):
            raise ValueError("duplicate axes given")
        return tuple(out)
    if not isinstance(axis, (int, np.integer)):
        raise TypeError(f"axis must be None or int or tuple of ints, got {type(axis)}")
    axis = int(axis)
    if ndim == 0 and axis in (-1, 0):
        return None
    if axis < -ndim or axis >= ndim:
        raise ValueError(f"axis {axis} is out of bounds for {ndim}-dimensional shape")
    return axis % ndim


def sanitize_shape(shape: Union[int, Sequence[int]], lval: int = 0) -> Tuple[int, ...]:
    """A shape argument as a tuple of ints, each at least ``lval``."""
    if isinstance(shape, (int, np.integer)):
        shape = (int(shape),)
    elif isinstance(shape, (list, tuple, np.ndarray)):
        shape = tuple(shape)
    else:
        raise TypeError(f"expected sequence object or single int, got {type(shape)}")
    out = []
    for s in shape:
        if not isinstance(s, (int, np.integer)):
            raise TypeError(f"expected int dimensions, got {type(s)}")
        s = int(s)
        if s < lval:
            raise ValueError(f"negative dimensions are not allowed, got {s}")
        out.append(s)
    return tuple(out)


def sanitize_slice(sl: slice, max_dim: int) -> slice:
    """``sl`` resolved against an axis of length ``max_dim``: explicit
    start, stop and step."""
    if not isinstance(sl, slice):
        raise TypeError("can only be applied to slice objects")
    return slice(*sl.indices(max_dim))
