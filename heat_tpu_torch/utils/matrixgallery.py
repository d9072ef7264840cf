"""Test-matrix gallery.

Port of ``heat_tpu/utils/matrixgallery.py``: the ``parter`` Toeplitz
matrix ``A[i,j] = 1/(i - j + 0.5)``, whose singular values cluster at pi.
"""

from __future__ import annotations

from typing import Optional

from ..core import arithmetics, factories, manipulations, types
from ..core.dndarray import DNDarray

__all__ = ["parter"]


def parter(n: int, split: Optional[int] = None, device=None, comm=None) -> DNDarray:
    """The Parter matrix ``A[i,j] = 1/(i - j + 0.5)``, float32, laid out at
    ``split``."""
    if not isinstance(n, int):
        raise TypeError(f"n must be an int, got {type(n)}")
    ii = factories.arange(n, dtype=types.float32, device=device, comm=comm)
    jj = factories.arange(n, dtype=types.float32, device=device, comm=comm)
    rows = manipulations.expand_dims(ii, 1)  # (n, 1)
    cols = manipulations.expand_dims(jj, 0)  # (1, n)
    a = arithmetics.div(1.0, arithmetics.add(arithmetics.sub(rows, cols), 0.5))
    if split is not None:
        a = manipulations.resplit(a, split)
    return a
