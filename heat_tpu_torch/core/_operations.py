"""The generic op engine behind the elementwise ops and reductions.

Port of ``heat_tpu/core/_operations.py``: ``__binary_op``, ``__local_op``
and ``__reduce_op``.  Every op computes on the true-shape global views
with torch and re-wraps the result, which re-pads a ragged split axis with
zeros (the pad invariant of :mod:`.dndarray`).  Promotion is torch's,
which agrees with the reference's lattice on the slice's types.

The reduction engine keeps the reference's collective-precision seam: a
sum whose axes cover the split axis, on a communicator of several
positions, rides the block-scaled quantized ring
(:func:`heat_tpu_torch.comm.compressed.reduce_q`) when the policy asks for
compression.
"""

from __future__ import annotations

import builtins
import math
from typing import Callable, Optional

import numpy as np
import torch

from . import sanitation, types
from .dndarray import DNDarray

__all__ = ["__binary_op", "__local_op", "__reduce_op"]


def _axes(ndim: int, axis) -> tuple:
    if axis is None:
        return tuple(range(ndim))
    return (axis,) if isinstance(axis, int) else tuple(axis)


def _reduced_split(x: DNDarray, axes: tuple, keepdims: bool) -> Optional[int]:
    """Split of a reduction's result: None when the reduction crosses the
    split axis, else the split index shifted past removed axes."""
    split = x.split
    if split is None or split in axes:
        return None
    return split if keepdims else split - builtins.sum(1 for a in axes if a < split)


def _compressed_mode(x: DNDarray, axes: tuple) -> Optional[str]:
    """Wire mode of the per-position partials of a reduction of ``x`` over
    ``axes`` under the collective-precision policy, or None (exact)."""
    from ..comm import compressed as _cq

    out_elems = math.prod(int(s) for d, s in enumerate(x.gshape) if d not in axes)
    return _cq.reduce_mode(x._buffer.dtype, out_elems * 4)


def _out(out: Optional[DNDarray], wrapped: DNDarray) -> DNDarray:
    if out is None:
        return wrapped
    if not isinstance(out, DNDarray):
        raise TypeError(f"expected out to be None or a DNDarray, but was {type(out)}")
    if tuple(out.shape) != tuple(wrapped.shape):
        raise ValueError(f"expected out to have shape {wrapped.shape}, got {out.shape}")
    out._rebind(wrapped.astype(out.dtype))
    return out


def __binary_op(
    operation: Callable,
    t1,
    t2,
    out: Optional[DNDarray] = None,
    fn_kwargs: Optional[dict] = None,
) -> DNDarray:
    """Elementwise binary op with broadcasting.  The result takes the
    split of the split operand (re-anchored from the right when
    broadcasting prepends axes); two differently split operands compute
    on their global views and keep ``t1``'s split."""
    fn_kwargs = fn_kwargs or {}
    scalar_1, scalar_2 = np.isscalar(t1), np.isscalar(t2)
    if scalar_1 and scalar_2:
        from . import factories

        return factories.array(operation(torch.as_tensor(t1), torch.as_tensor(t2), **fn_kwargs))
    if scalar_1:
        anchor = t2
    elif isinstance(t1, DNDarray):
        anchor = t1
        if isinstance(t2, DNDarray) and t1.split is None and t2.split is not None:
            anchor = t2
    else:
        raise TypeError(f"expected a DNDarray or scalar, got {type(t1)}")
    if not isinstance(anchor, DNDarray):
        raise TypeError(f"expected a DNDarray or scalar, got {type(anchor)}")

    a1 = t1 if scalar_1 else t1.larray
    if scalar_2:
        a2 = t2
    elif isinstance(t2, DNDarray):
        a2 = t2.larray
    else:  # host data (a numpy array, a list) as the right operand
        a2 = torch.as_tensor(np.asarray(t2), device=a1.device)
    if scalar_1:
        result = operation(torch.as_tensor(t1, dtype=torch.result_type(a2, t1), device=a2.device), a2, **fn_kwargs)
    else:
        result = operation(a1, a2, **fn_kwargs)
    split = anchor.split
    if split is not None:
        split = split + (result.ndim - anchor.ndim)
        if split < 0 or result.ndim == 0:
            split = None
    wrapped = DNDarray(
        result, tuple(result.shape), types.canonical_heat_type(result.dtype),
        split, anchor.device, anchor.comm,
    )
    return _out(out, wrapped)


def __local_op(
    operation: Callable,
    x,
    out: Optional[DNDarray] = None,
    no_cast: bool = False,
    **kwargs,
) -> DNDarray:
    """Elementwise map; exact input types are float-promoted unless
    ``no_cast`` (int64 to float64, everything else to float32)."""
    sanitation.sanitize_in(x)
    arr = x.larray
    if not no_cast and types.heat_type_is_exact(x.dtype):
        arr = arr.to(torch.float64 if x.dtype is types.int64 else torch.float32)
    result = operation(arr, **kwargs)
    wrapped = DNDarray(
        result, tuple(result.shape), types.canonical_heat_type(result.dtype),
        x.split if result.ndim else None, x.device, x.comm,
    )
    return _out(out, wrapped)


def __reduce_op(
    reduction: Callable,
    x,
    axis,
    out: Optional[DNDarray] = None,
    keepdims: Optional[bool] = None,
    dtype=None,
) -> DNDarray:
    """Reduction over ``axis`` (None: all).  Reducing across the split
    axis gives a replicated result; otherwise the split index shifts past
    removed axes.  ``reduction(tensor, axes, keepdims)`` gets a tuple of
    axes."""
    sanitation.sanitize_in(x)
    axis = sanitation.sanitize_axis(x.shape, axis)
    keepdims = bool(keepdims) if keepdims is not None else False
    if dtype is not None:
        dtype = types.canonical_heat_type(dtype)
    cast = dtype.torch_type() if dtype is not None else None
    axes = _axes(x.ndim, axis)
    split = _reduced_split(x, axes, keepdims)

    result = None
    if split is None and x.split is not None and reduction is _sum and x.comm.size > 1:
        # collective-precision seam: local partials + the quantized ring
        mode = _compressed_mode(x, axes)
        if mode is not None:
            from ..comm import compressed as _cq

            result = _cq.reduce_q(
                x._buffer, comm=x.comm, split=x.split, axes=axes, keepdims=keepdims,
                mode=mode, out_dtype=cast or x._buffer.dtype,
            )
    if result is None:
        result = reduction(x.larray, axes, keepdims)
        if cast is not None:
            result = result.to(cast)
    if result.ndim == 0:
        split = None
    wrapped = DNDarray(
        result, tuple(result.shape), types.canonical_heat_type(result.dtype),
        split, x.device, x.comm,
    )
    return _out(out, wrapped)


def _sum(a: torch.Tensor, axes: tuple, keepdims: bool) -> torch.Tensor:
    """Sum over ``axes``; integer sums accumulate in int64, as torch's."""
    if not axes:
        return a.to(torch.int64) if a.dtype in (torch.bool, torch.int32) else a.clone()
    return torch.sum(a, dim=axes, keepdim=keepdims)
