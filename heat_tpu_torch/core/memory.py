"""Memory layout helpers.

Port of ``heat_tpu/core/memory.py``: ``copy`` and
``sanitize_memory_layout``.  As in the reference, the order flag is
validated and the buffer keeps its C-contiguous layout for both orders.
"""

from __future__ import annotations

__all__ = ["copy", "sanitize_memory_layout"]


def copy(x):
    """An independent copy of a DNDarray at ``x.split``, as the
    reference's (on a grid the copy keeps the compat view only): the
    at-rest buffer cloned where the layout is unchanged."""
    from .dndarray import DNDarray

    if not isinstance(x, DNDarray):
        raise TypeError(f"input needs to be a DNDarray, but was {type(x)}")
    src = x._slab if x.comm.mesh_ndim == 1 else x.larray
    return DNDarray(src.clone(), x.gshape, x.dtype, x.split, x.device, x.comm, slab=True)


def sanitize_memory_layout(x, order: str = "C"):
    """Validate a memory-order flag (``"C"`` or ``"F"``) and return ``x``
    unchanged."""
    if order not in ("C", "F"):
        raise ValueError(f"invalid memory layout {order!r}, expected 'C' or 'F'")
    return x
