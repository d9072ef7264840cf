"""The DNDarray: a global n-D tensor laid out over communicator positions.

Port of ``heat_tpu/core/dndarray.py``.  The backing store is ONE global
torch tensor on the communicator's device, in the reference's at-rest
form: the split axis of true length ``n`` is zero-padded to
``p * ceil(n/p)``, so position ``r``'s shard is rows ``[r*c, (r+1)*c)``.

Invariants:

* ``_buffer`` is the padded at-rest tensor; ``larray`` is its true-shape
  view (a ``narrow``, no copy), ``larray.shape == gshape`` always;
* pad rows are ZERO.  Every op computes on the true view and the
  constructor re-pads with zeros, so the compressed reductions may sum a
  whole shard without masking (the reference keeps pads unspecified and
  relies on callers; here the invariant is kept centrally);
* ``split`` is ``None`` (replicated) or an axis index.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import types
from .communication import TorchCommunication
from .devices import Device

__all__ = ["DNDarray"]


class DNDarray:
    """Distributed n-dimensional array.

    Parameters
    ----------
    array : torch.Tensor
        The global tensor, at its true shape or already in the padded
        at-rest form (pad rows zero) on the split axis.
    gshape : tuple of int
        TRUE global shape.
    dtype : heat type
    split : int or None
    device : Device
    comm : TorchCommunication
    """

    def __init__(
        self,
        array: torch.Tensor,
        gshape: Tuple[int, ...],
        dtype,
        split: Optional[int],
        device: Device,
        comm: TorchCommunication,
    ):
        self.__gshape = tuple(int(s) for s in gshape)
        self.__dtype = types.canonical_heat_type(dtype)
        self.__device = device
        self.__comm = comm
        ndim = len(self.__gshape)
        if split is not None:
            if ndim == 0:
                split = None
            elif not -ndim <= int(split) < ndim:
                raise ValueError(
                    f"split axis {split} out of range for {ndim}-dimensional "
                    f"shape {self.__gshape}"
                )
            else:
                split = int(split) % ndim
        self.__split = split
        self.__array = self.__commit(array)

    def __commit(self, array: torch.Tensor) -> torch.Tensor:
        """Bring ``array`` to the at-rest form: pad a ragged split axis."""
        split = self.__split
        if split is None:
            return array
        n = self.__gshape[split]
        pn = self.__comm.padded_size(n)
        have = int(array.shape[split])
        if have == pn:
            return array
        if have != n:
            raise ValueError(
                f"backing array axis {split} has length {have}; expected the "
                f"true length {n} or the padded length {pn} for gshape "
                f"{self.__gshape} over {self.__comm.size} position(s)"
            )
        return self.__comm.pad_to_shards(array, axis=split)

    # ------------------------------------------------------------------ #
    # metadata                                                            #
    # ------------------------------------------------------------------ #
    @property
    def comm(self) -> TorchCommunication:
        return self.__comm

    @property
    def device(self) -> Device:
        return self.__device

    @property
    def dtype(self):
        return self.__dtype

    @property
    def gshape(self) -> Tuple[int, ...]:
        return self.__gshape

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.__gshape

    @property
    def split(self) -> Optional[int]:
        return self.__split

    @property
    def ndim(self) -> int:
        return len(self.__gshape)

    @property
    def size(self) -> int:
        return int(np.prod(self.__gshape)) if self.__gshape else 1

    @property
    def larray(self) -> torch.Tensor:
        """The global tensor at its TRUE shape (a view of the buffer)."""
        arr = self.__array
        if self.__split is None:
            return arr
        return self.__comm.unpad(arr, self.__gshape[self.__split], self.__split)

    @property
    def _buffer(self) -> torch.Tensor:
        """The padded at-rest buffer (pad rows zero)."""
        return self.__array

    @property
    def padshape(self) -> Tuple[int, ...]:
        return tuple(int(s) for s in self.__array.shape)

    @property
    def lshape(self) -> Tuple[int, ...]:
        """Shape of position 0's shard."""
        _, lshape, _ = self.__comm.chunk(self.__gshape, self.__split, rank=0)
        return lshape

    # ------------------------------------------------------------------ #
    # conversion                                                          #
    # ------------------------------------------------------------------ #
    def numpy(self) -> np.ndarray:
        """The global array on the host (bfloat16 comes back as float32,
        numpy having no bfloat16)."""
        t = self.larray.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def item(self):
        if self.size != 1:
            raise ValueError("only one-element DNDarrays can be converted to Python scalars")
        return self.larray.reshape(()).item()

    def __float__(self) -> float:
        return float(self.item())

    def __int__(self) -> int:
        return int(self.item())

    def __len__(self) -> int:
        if not self.__gshape:
            raise TypeError("len() of a 0-d DNDarray")
        return self.__gshape[0]

    def __repr__(self) -> str:
        return (
            f"DNDarray({self.numpy()!r}, dtype=ht.{self.__dtype.__name__}, "
            f"device={self.__device}, split={self.__split})"
        )

    def astype(self, dtype) -> "DNDarray":
        """A copy cast to ``dtype``."""
        dtype = types.canonical_heat_type(dtype)
        buf = self.__array.to(dtype.torch_type(), copy=True)
        return DNDarray(buf, self.__gshape, dtype, self.__split, self.__device, self.__comm)

    def resplit(self, axis: Optional[int] = None) -> "DNDarray":
        """A copy laid out at ``axis`` (``None``: replicated)."""
        arr = self.__comm.resplit(self.larray, axis)
        if arr.untyped_storage().data_ptr() == self.__array.untyped_storage().data_ptr():
            arr = arr.contiguous().clone()
        return DNDarray(arr, self.__gshape, self.__dtype, axis, self.__device, self.__comm)

    # ------------------------------------------------------------------ #
    # arithmetic and reductions                                           #
    # ------------------------------------------------------------------ #
    def __add__(self, other):
        from . import arithmetics

        return arithmetics.add(self, other)

    def __radd__(self, other):
        from . import arithmetics

        return arithmetics.add(other, self)

    def __sub__(self, other):
        from . import arithmetics

        return arithmetics.sub(self, other)

    def __rsub__(self, other):
        from . import arithmetics

        return arithmetics.sub(other, self)

    def __mul__(self, other):
        from . import arithmetics

        return arithmetics.mul(self, other)

    def __rmul__(self, other):
        from . import arithmetics

        return arithmetics.mul(other, self)

    def __truediv__(self, other):
        from . import arithmetics

        return arithmetics.div(self, other)

    def __rtruediv__(self, other):
        from . import arithmetics

        return arithmetics.div(other, self)

    def __pow__(self, other):
        from . import arithmetics

        return arithmetics.pow(self, other)

    def __rpow__(self, other):
        from . import arithmetics

        return arithmetics.pow(other, self)

    def __neg__(self):
        from . import arithmetics

        return arithmetics.neg(self)

    def sum(self, axis=None, out=None, keepdims=None):
        from . import arithmetics

        return arithmetics.sum(self, axis=axis, out=out, keepdims=keepdims)

    def mean(self, axis=None, keepdims=None):
        from . import statistics

        return statistics.mean(self, axis=axis, keepdims=keepdims)

    def var(self, axis=None, ddof: int = 0, **kwargs):
        from . import statistics

        return statistics.var(self, axis=axis, ddof=ddof, **kwargs)

    def std(self, axis=None, ddof: int = 0, **kwargs):
        from . import statistics

        return statistics.std(self, axis=axis, ddof=ddof, **kwargs)

    def min(self, axis=None, out=None, keepdims=None):
        from . import statistics

        return statistics.min(self, axis=axis, out=out, keepdims=keepdims)

    def max(self, axis=None, out=None, keepdims=None):
        from . import statistics

        return statistics.max(self, axis=axis, out=out, keepdims=keepdims)

    def argmin(self, axis=None, out=None, keepdims=None):
        from . import statistics

        return statistics.argmin(self, axis=axis, out=out, keepdims=keepdims)

    def _rebind(self, other: "DNDarray") -> None:
        """Take over ``other``'s buffer, shape, type and layout (the
        ``out=`` contract of the op engine)."""
        self.__array = other._buffer
        self.__gshape = other.gshape
        self.__dtype = other.dtype
        self.__split = other.split
