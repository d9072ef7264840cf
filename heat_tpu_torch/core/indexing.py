"""Index discovery and conditional selection: ``nonzero`` and ``where``.

Port of ``heat_tpu/core/indexing.py``.  ``nonzero`` is data-dependent:
its result length is known only after the device has counted, so it
synchronizes with the host once, as the reference does.
"""

from __future__ import annotations

import numpy as np
import torch

from . import types
from .dndarray import DNDarray
from .sanitation import sanitize_in

__all__ = ["nonzero", "where"]


def nonzero(a: DNDarray) -> DNDarray:
    """Indices of the nonzero elements, in row-major order: an int64
    ``(nnz, ndim)`` array (``(nnz,)`` for a 1-D input), split on axis 0
    when ``a`` is split."""
    sanitize_in(a)
    idx = torch.nonzero(a.larray)
    if a.ndim == 1:
        idx = idx.reshape(-1)
    split = 0 if a.split is not None else None
    return DNDarray(idx, tuple(idx.shape), types.int64, split, a.device, a.comm)


def where(cond: DNDarray, x=None, y=None) -> DNDarray:
    """``x`` where ``cond`` is nonzero, else ``y`` (broadcast); with
    neither, :func:`nonzero`.  The result's type follows the reference's
    weak Python scalars (``where(c, int32_x, 0)`` is int32,
    ``where(c, int32_x, 0.5)`` float64); its split is ``cond``'s."""
    if x is None and y is None:
        return nonzero(cond)
    if x is None or y is None:
        raise TypeError("either both or neither of x and y should be given")
    from ._operations import _operand_type

    sanitize_in(cond)
    dev = cond.larray.device
    target = types._weak_result_type(_operand_type(x), _operand_type(y)).torch_type()

    def operand(v):
        if isinstance(v, DNDarray):
            return v.larray.to(target)
        return types._cast(torch.as_tensor(np.asarray(v), device=dev), target)

    garr = torch.where(cond.larray != 0, operand(x), operand(y))
    split = cond.split if garr.ndim else None
    return DNDarray(garr, tuple(garr.shape), types.canonical_heat_type(garr.dtype), split, cond.device, cond.comm)
