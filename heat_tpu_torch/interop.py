"""Carrying data and fitted state across from the JAX package.

The system runs no model, so what crosses over is the global data and the
fitted estimator state, both as numpy arrays: :func:`array_from_numpy`
takes the global array the JAX package's ``DNDarray.numpy()`` returns, and
:meth:`heat_tpu_torch.cluster.KMeans.from_fitted` takes a fitted KMeans's
centers, iteration count and inertia.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .core import factories
from .core.dndarray import DNDarray

__all__ = ["array_from_numpy"]


def array_from_numpy(global_array: np.ndarray, split: Optional[int] = None, comm=None) -> DNDarray:
    """A port DNDarray holding ``global_array`` (its dtype kept), laid out
    at ``split`` over ``comm``'s positions."""
    return factories.array(np.asarray(global_array), split=split, comm=comm)

