"""Carrying data and fitted state across from the JAX package.

The system runs no model, so what crosses over is the global data and the
fitted estimator state, both as numpy arrays: :func:`array_from_numpy`
takes the global array the JAX package's ``DNDarray.numpy()`` (or
``numpy.asarray`` of a jax array) returns, and
:meth:`heat_tpu_torch.cluster.KMeans.from_fitted` takes a fitted KMeans's
centers, iteration count and inertia.

numpy has no bfloat16: a JAX bfloat16 array leaves as an
``ml_dtypes.bfloat16`` array.  :func:`tensor_from_numpy` carries its bits
through a ``uint16`` view into a ``torch.bfloat16`` tensor, so nothing is
rounded on the way.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .core import factories
from .core.dndarray import DNDarray

__all__ = ["array_from_numpy", "tensor_from_numpy"]


def tensor_from_numpy(global_array) -> torch.Tensor:
    """A CPU tensor holding ``global_array`` with its dtype kept; a
    bfloat16 array (``ml_dtypes.bfloat16``) becomes ``torch.bfloat16`` bit
    for bit."""
    host = np.ascontiguousarray(np.asarray(global_array))
    if host.dtype.name == "bfloat16" and host.dtype.itemsize == 2:
        return torch.from_numpy(host.view(np.uint16).copy()).view(torch.bfloat16)
    if not host.flags.writeable:
        host = host.copy()
    return torch.from_numpy(host)


def array_from_numpy(global_array, split: Optional[int] = None, comm=None) -> DNDarray:
    """A port DNDarray holding ``global_array`` (its dtype kept, bfloat16
    included), laid out at ``split`` over ``comm``'s positions."""
    return factories.array(tensor_from_numpy(global_array), split=split, comm=comm)
