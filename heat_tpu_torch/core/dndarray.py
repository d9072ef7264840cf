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
* ``split`` is ``None`` (replicated) or an axis index;
* ``splits`` is the layout as a tuple of mesh axes, one per dimension
  (:meth:`TorchCommunication.normalize_splits`): on a grid communicator
  (:func:`~.communication.grid_comm`) every dimension a mesh axis shards
  is padded to a multiple of that axis, and ``split`` is the tuple's
  compat view, the dimension mesh axis 0 shards.

The layout is canonical, so every array is balanced: ``balance_`` is a
no-op and ``redistribute_`` accepts only the canonical map, as in the
reference.  ``__setitem__`` and ``fill_diagonal`` write into a copy and
rebind it, so an array that shares storage with this one (a basic-index
view) keeps its values, as the reference's immutable arrays do.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from . import types
from ._compile import jitted
from ._tracing import require_concrete
from .communication import TorchCommunication
from .devices import Device

__all__ = ["DNDarray", "LocalIndex"]


#: Minimum element count of the operand before an array key along the split
#: axis takes the ring gather/scatter (:mod:`heat_tpu_torch.parallel.take`)
#: instead of one global index op; small operands keep the plain path.
#: Override with HEAT_TPU_RING_INDEX_MIN.
_RING_INDEX_MIN = int(os.environ.get("HEAT_TPU_RING_INDEX_MIN", str(1 << 22)))


def _inserts(k) -> bool:
    """``None`` and scalar bools insert an axis (of length 0 for False)."""
    return k is None or isinstance(k, (bool, np.bool_))


def _is_basic(k) -> bool:
    return k is None or k is Ellipsis or isinstance(k, (slice, int, np.integer, np.bool_))


def _basic_key(key, ndim: int) -> list:
    """``key`` (basic elements only) as a list of basic index elements, one
    per axis of the input and one per inserted axis, ``Ellipsis``
    expanded; too many indices raise ``IndexError``."""
    keyt = key if isinstance(key, tuple) else (key,)
    used = sum(1 for k in keyt if not _inserts(k) and k is not Ellipsis)
    if used > ndim:
        raise IndexError(
            f"too many indices for array: array is {ndim}-dimensional, but {used} were indexed"
        )
    if sum(1 for k in keyt if k is Ellipsis) > 1:
        raise IndexError("an index can only have a single ellipsis ('...')")
    fill = [slice(None)] * (ndim - used)
    expanded = []
    for k in keyt:
        expanded += fill if k is Ellipsis else [k]
    if not any(k is Ellipsis for k in keyt):
        expanded += fill
    return expanded


def _zeropad(arr: torch.Tensor, comm: TorchCommunication, splits) -> torch.Tensor:
    return comm.pad_to_shards(arr, splits=splits)


def _halo_concat(prev: torch.Tensor, buf: torch.Tensor, nxt: torch.Tensor, split: int, p: int,
                 h: int) -> torch.Tensor:
    """Each position's block between its neighbour strips, along ``split``."""
    blocks = buf.movedim(split, 0)
    blocks = blocks.reshape((p, -1) + tuple(blocks.shape[1:]))
    strip = lambda t: t.movedim(split, 0).reshape((p, h) + tuple(blocks.shape[2:]))  # noqa: E731
    out = torch.cat([strip(prev), blocks, strip(nxt)], dim=1)
    return out.reshape((-1,) + tuple(out.shape[2:])).movedim(0, split)


class LocalIndex:
    """Indexer over the raw global tensor (``x.lloc``), without split
    bookkeeping; assignment writes a copy and rebinds it."""

    __slots__ = ("__obj",)

    def __init__(self, obj: "DNDarray"):
        self.__obj = obj

    def __getitem__(self, key):
        return self.__obj.larray[key]

    def __setitem__(self, key, value):
        obj = self.__obj
        buf = obj._buffer.clone()
        arr = obj._true_view(buf)
        arr[key] = torch.as_tensor(value, dtype=arr.dtype, device=arr.device)
        obj._rebind(DNDarray(buf, obj.gshape, obj.dtype, obj._layout, obj.device, obj.comm))


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
    split : int, None or a splits tuple
        A tuple names the mesh axis sharding each dimension (or None).
    device : Device
    comm : TorchCommunication
    """

    def __init__(
        self,
        array: torch.Tensor,
        gshape: Tuple[int, ...],
        dtype,
        split,
        device: Device,
        comm: TorchCommunication,
    ):
        self.__gshape = tuple(int(s) for s in gshape)
        self.__dtype = types.canonical_heat_type(dtype)
        self.__device = device
        self.__comm = comm
        ndim = len(self.__gshape)
        if isinstance(split, (tuple, list)):
            splits = comm.normalize_splits(ndim, split)
            split = comm.split_view(splits)
        else:
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
            splits = comm.normalize_splits(ndim, split)
        self.__split = split
        self.__splits = splits
        self.__array = self.__commit(array)
        self.__halo_prev = None
        self.__halo_next = None
        self.__halo_size = 0

    def __commit(self, array: torch.Tensor) -> torch.Tensor:
        """Bring ``array`` to the at-rest form: pad every ragged sharded
        dimension (each may arrive at its true or its padded length)."""
        needs_pad = False
        for d, g in enumerate(self.__splits):
            if g is None:
                continue
            n = self.__gshape[d]
            pn = self.__comm.padded_size(n, mesh_axis=g)
            have = int(array.shape[d])
            if have == pn:
                continue
            if have != n:
                raise ValueError(
                    f"backing array axis {d} has length {have}; expected the "
                    f"true length {n} or the padded length {pn} for gshape "
                    f"{self.__gshape} over mesh {self.__comm.mesh_shape}"
                )
            needs_pad = True
        if not needs_pad:
            return array
        return self.__comm.pad_to_shards(array, splits=self.__splits)

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
        """The sharded axis (None: replicated); on a grid, the compat view
        of :attr:`splits`: the dimension mesh axis 0 shards."""
        return self.__split

    @property
    def splits(self) -> Tuple[Optional[int], ...]:
        """``splits[d]`` is the mesh axis sharding dimension ``d`` (None:
        unsharded); on one mesh axis the one-hot spelling of :attr:`split`."""
        return self.__splits

    @property
    def _layout(self):
        """The layout as the communicator's methods take it: ``split`` on
        one mesh axis, the splits tuple on a grid."""
        return self.__splits if self.__comm.mesh_ndim > 1 else self.__split

    @property
    def ndim(self) -> int:
        return len(self.__gshape)

    @property
    def size(self) -> int:
        return int(np.prod(self.__gshape)) if self.__gshape else 1

    @property
    def larray(self) -> torch.Tensor:
        """The global tensor at its TRUE shape (a view of the buffer)."""
        return self._true_view(self.__array)

    def _true_view(self, buf: torch.Tensor) -> torch.Tensor:
        """``buf`` (this array's buffer or a copy of it) narrowed to the
        true shape along every padded sharded dimension."""
        for d, g in enumerate(self.__splits):
            if g is not None:
                buf = self.__comm.unpad(buf, self.__gshape[d], d)
        return buf

    @property
    def _buffer(self) -> torch.Tensor:
        """The padded at-rest buffer (pad rows zero)."""
        return self.__array

    def _zeroed_buffer(self) -> torch.Tensor:
        """The at-rest buffer with every pad forced to zero, for consumers
        that take whole padded blocks (the grid QR and SVD): the buffer
        itself when no dimension is padded, else the true view re-padded
        with zeros (one copy), whatever the buffer's pads hold."""
        if self.__array.shape == torch.Size(self.__gshape):
            return self.__array
        comm, splits = self.__comm, self.__splits
        key = ("dnd.zeropad", comm, splits, tuple(self.__array.shape))
        return jitted(key, lambda: _zeropad)(self.larray, comm, splits)

    @property
    def padshape(self) -> Tuple[int, ...]:
        return tuple(int(s) for s in self.__array.shape)

    @property
    def lshape(self) -> Tuple[int, ...]:
        """Shape of position 0's shard (a grid's flat position 0)."""
        _, lshape, _ = self.__comm.chunk(self.__gshape, self._layout, rank=0)
        return lshape

    @property
    def lshape_map(self) -> np.ndarray:
        """``(positions, ndim)`` table of every position's shard shape."""
        return self.create_lshape_map()

    def create_lshape_map(self, force_check: bool = False) -> np.ndarray:
        """``(positions, max(ndim, 1))`` int64 table of every position's
        shard shape, from the canonical layout."""
        size = self.__comm.size
        out = np.zeros((size, max(self.ndim, 1)), dtype=np.int64)
        for r in range(size):
            _, lshape, _ = self.__comm.chunk(self.__gshape, self._layout, rank=r)
            out[r, : len(lshape)] = lshape
        return out

    @property
    def balanced(self) -> bool:
        """Always True: the canonical layout is balanced."""
        return True

    def is_balanced(self, force_check: bool = False) -> bool:
        """Always True: the canonical layout is balanced."""
        return True

    def balance_(self) -> None:
        """A no-op: the canonical layout is balanced."""

    def redistribute_(self, lshape_map=None, target_map=None) -> None:
        """Accepts the canonical shard map as the no-op it is; any other
        map asks for a layout the canonical equal-chunk layout cannot
        hold, and raises ``NotImplementedError``."""
        if target_map is None:
            return
        target = np.asarray(target_map)
        canonical = self.create_lshape_map()
        if target.size != canonical.size:
            raise ValueError(
                f"target_map must have shape {canonical.shape} "
                f"(one lshape row per shard), got {target.shape}"
            )
        target = target.reshape(canonical.shape)
        if np.array_equal(target, canonical):
            return
        raise NotImplementedError(
            "redistribute_: non-canonical per-position shard sizes are not "
            "representable; heat_tpu_torch always keeps the canonical "
            f"equal-chunk layout ({canonical.tolist()}). Requested {target.tolist()}."
        )

    def is_distributed(self) -> bool:
        """True when the data is split over more than one position."""
        return self.__split is not None and self.__comm.size > 1

    @property
    def gnumel(self) -> int:
        return self.size

    @property
    def lnumel(self) -> int:
        """Elements of position 0's shard."""
        return int(np.prod(self.lshape)) if self.lshape else 1

    @property
    def itemsize(self) -> int:
        return self.__array.element_size()

    @property
    def nbytes(self) -> int:
        """Bytes of the global array (at its true shape)."""
        return self.size * self.itemsize

    @property
    def gnbytes(self) -> int:
        return self.nbytes

    @property
    def lnbytes(self) -> int:
        return self.lnumel * self.itemsize

    @property
    def stride(self) -> Tuple[int, ...]:
        """C-order element strides of the global shape."""
        strides, acc = [], 1
        for s in reversed(self.__gshape):
            strides.append(acc)
            acc *= s
        return tuple(reversed(strides))

    @property
    def strides(self) -> Tuple[int, ...]:
        """C-order byte strides of the global shape."""
        return tuple(s * self.itemsize for s in self.stride)

    @property
    def numdims(self) -> int:
        """Deprecated alias of :attr:`ndim`."""
        warnings.warn("numdims is deprecated, use ndim instead", DeprecationWarning, stacklevel=2)
        return self.ndim

    @property
    def real(self) -> "DNDarray":
        return self

    @property
    def imag(self) -> "DNDarray":
        from . import factories

        return factories.zeros_like(self)

    @property
    def lloc(self) -> LocalIndex:
        """Raw indexer over the global tensor (no split bookkeeping)."""
        return LocalIndex(self)

    # ------------------------------------------------------------------ #
    # conversion                                                          #
    # ------------------------------------------------------------------ #
    def numpy(self) -> np.ndarray:
        """The global array on the host (bfloat16 comes back as float32,
        numpy having no bfloat16)."""
        require_concrete(".numpy()")
        t = self.larray.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        """The global array on the host, for numpy (a numpy operand on the
        left of a comparison computes through this, as in the reference)."""
        require_concrete("np.asarray()")
        arr = self.numpy()
        return arr.astype(dtype) if dtype is not None else arr

    def item(self):
        require_concrete(".item()")
        if self.size != 1:
            raise ValueError("only one-element DNDarrays can be converted to Python scalars")
        return self.larray.reshape(()).item()

    def __bool__(self) -> bool:
        require_concrete("bool()")
        return bool(self.item())

    def __float__(self) -> float:
        require_concrete("float()")
        return float(self.item())

    def __int__(self) -> int:
        require_concrete("int()")
        return int(self.item())

    def __len__(self) -> int:
        if not self.__gshape:
            raise TypeError("len() of a 0-d DNDarray")
        return self.__gshape[0]

    def __complex__(self) -> complex:
        require_concrete("complex()")
        return complex(self.item())

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __repr__(self) -> str:
        require_concrete("repr()")
        from . import printing

        return printing.__str__(self)

    def __str__(self) -> str:
        require_concrete("print()/str()")
        from . import printing

        return printing.__str__(self)

    def tolist(self, keepsplit: bool = False) -> list:
        """Nested Python lists of the global values."""
        require_concrete(".tolist()")
        return self.numpy().tolist()

    def save(self, path: str, *args, **kwargs) -> None:
        """Save to HDF5, NetCDF or CSV by file extension (:func:`~.io.save`)."""
        require_concrete(".save()")
        from . import io

        io.save(self, path, *args, **kwargs)

    def save_hdf5(self, path: str, dataset: str, mode: str = "w", **kwargs) -> None:
        """Save to an HDF5 dataset (:func:`~.io.save_hdf5`)."""
        require_concrete(".save_hdf5()")
        from . import io

        io.save_hdf5(self, path, dataset, mode, **kwargs)

    def save_netcdf(self, path: str, variable: str, mode: str = "w", **kwargs) -> None:
        """Save to a NetCDF variable (:func:`~.io.save_netcdf`)."""
        require_concrete(".save_netcdf()")
        from . import io

        io.save_netcdf(self, path, variable, mode, **kwargs)

    def copy(self) -> "DNDarray":
        """An independent copy."""
        from . import memory

        return memory.copy(self)

    def cpu(self) -> "DNDarray":
        """The array on the CPU."""
        return self.to_device("cpu")

    def to_device(self, device) -> "DNDarray":
        """The array on ``device``'s default communicator, at the same
        split (``self`` when it is there already)."""
        from .communication import comm_for_device
        from .devices import sanitize_device

        device = sanitize_device(device)
        if device is self.__device:
            return self
        comm = comm_for_device(device)
        return DNDarray(self.larray.to(comm.device), self.__gshape, self.__dtype, self.__split, device, comm)

    def astype(self, dtype, copy: bool = True) -> "DNDarray":
        """Cast to ``dtype``: a copy, or with ``copy=False`` this array,
        recast in place."""
        dtype = types.canonical_heat_type(dtype)
        buf = types._cast(self.__array, dtype.torch_type(), copy=True)
        if copy:
            return DNDarray(buf, self.__gshape, dtype, self._layout, self.__device, self.__comm)
        self.__array, self.__dtype = buf, dtype
        self._invalidate_halos()
        return self

    # ------------------------------------------------------------------ #
    # indexing                                                            #
    # ------------------------------------------------------------------ #
    def __process_key(self, key, scatter: bool = False):
        """The key with DNDarray, list and numpy-array elements as tensors
        on this array's device (lists are array keys), integer arrays
        fitted to their axis with jax's semantics as indices torch takes
        without raising (the reference's ``_fit_index_array``: negatives
        wrap once, what is still out of range clamps for a gather and
        becomes the sink one past the axis for a scatter; torch raises on
        the CPU and asserts on the device), and Python integers
        bounds-checked (out of range: ``IndexError``).  Returns ``(key,
        dims)``: ``dims`` gives each element's input axis (None where it
        consumes none or several)."""
        from ..parallel.take import _sanitize_index

        dev = self.__array.device

        def pre(k):
            if isinstance(k, DNDarray):
                return k.larray
            if isinstance(k, list):
                return np.asarray(k)
            return k

        def consumed(k):
            if _inserts(k):
                return 0
            if isinstance(k, (np.ndarray, torch.Tensor)) and k.dtype in (bool, np.bool_, torch.bool):
                return k.ndim
            return 1

        def one(k, dim):
            if isinstance(k, np.ndarray) and k.ndim == 0 and np.issubdtype(k.dtype, np.integer):
                k = int(k)
            if isinstance(k, (int, np.integer)) and not isinstance(k, (bool, np.bool_)):
                if dim is not None and dim < self.ndim:
                    n = self.__gshape[dim]
                    if not -n <= k < n:
                        raise IndexError(f"index {k} is out of bounds for axis {dim} with size {n}")
                return int(k)
            if isinstance(k, np.ndarray):
                if k.size == 0:  # numpy: a[[]] selects nothing
                    k = k.astype(np.int64)
                k = torch.from_numpy(np.ascontiguousarray(k))
            if isinstance(k, torch.Tensor):
                k = k.to(dev)
                if k.dtype != torch.bool and not k.dtype.is_floating_point and dim is not None and dim < self.ndim:
                    k = _sanitize_index(k, self.__gshape[dim], clip=not scatter)
            return k

        keyt = tuple(pre(k) for k in (key if isinstance(key, tuple) else (key,)))
        dims = []
        if any(k is Ellipsis for k in keyt):
            e = next(i for i, k in enumerate(keyt) if k is Ellipsis)
            dim = 0
            for k in keyt[:e]:
                dims.append(dim if consumed(k) == 1 else None)
                dim += consumed(k)
            dims.append(None)
            dim = self.ndim - sum(consumed(k) for k in keyt[e + 1:])
            for k in keyt[e + 1:]:
                dims.append(dim if consumed(k) == 1 else None)
                dim += consumed(k)
        else:
            dim = 0
            for k in keyt:
                dims.append(dim if consumed(k) == 1 else None)
                dim += consumed(k)
        return tuple(one(k, d) for k, d in zip(keyt, dims)), dims

    def __advanced_split(self, key: tuple, result_ndim: int) -> Optional[int]:
        """Split of an array-key result: the nearest shardable axis, as the
        reference's heuristic (a layout hint only: values never depend on
        it)."""
        if self.__split is None or result_ndim == 0:
            return None
        split, dim, dropped_before, split_key = self.__split, 0, 0, slice(None)
        for k in key:
            if k is Ellipsis:
                return min(split, result_ndim - 1)
            if k is None:
                continue
            if dim == split:
                split_key = k
                break
            if isinstance(k, (int, np.integer)):
                dropped_before += 1
            dim += 1
        if isinstance(split_key, (int, np.integer)):
            return min(max(split - dropped_before, 0), result_ndim - 1)
        return min(split - dropped_before, result_ndim - 1)

    def __ring_index_plan(self, key: tuple) -> Optional[torch.Tensor]:
        """The index tensor when the key is ONE 1-D integer array on the
        split axis, every other axis untouched, of an array split over
        several positions and at least ``_RING_INDEX_MIN`` elements: the
        key the ring gather/scatter serves.  Else None."""
        s = self.__split
        if (s is None or not self.is_distributed() or self.size < _RING_INDEX_MIN
                or self.__comm.mesh_ndim > 1):
            return None
        if len(key) > self.ndim:
            return None
        idx = None
        for d, k in enumerate(key):
            if isinstance(k, slice):
                if k != slice(None):
                    return None
            elif (isinstance(k, torch.Tensor) and k.ndim == 1 and k.shape[0] > 0
                  and k.dtype != torch.bool and not k.dtype.is_floating_point):
                if d != s or idx is not None:
                    return None
                idx = k
            else:
                return None
        return idx

    def __ring_getitem(self, idx: torch.Tensor) -> "DNDarray":
        """Gather along the split axis through the ring
        (:func:`heat_tpu_torch.parallel.take.ring_take`, clamping): the
        at-rest buffer goes in, the result's at-rest buffer comes out."""
        from ..parallel.take import ring_take

        s, n, m = self.__split, self.__gshape[self.__split], int(idx.shape[0])
        out = ring_take(self.__array.movedim(s, 0), idx, comm=self.__comm, n=n, padded_out=True, oob="clip")
        gshape = self.__gshape[:s] + (m,) + self.__gshape[s + 1:]
        return DNDarray(out.movedim(0, s).contiguous(), gshape, self.__dtype, s, self.__device, self.__comm)

    def __ring_setitem(self, idx: torch.Tensor, value) -> None:
        """Scatter along the split axis through the ring dual
        (:func:`heat_tpu_torch.parallel.take.ring_put`): out-of-range
        indices drop; the new buffer is built once from the old one."""
        from ..parallel.take import ring_put

        s, n, m = self.__split, self.__gshape[self.__split], int(idx.shape[0])
        vshape = self.__gshape[:s] + (m,) + self.__gshape[s + 1:]
        if (isinstance(value, DNDarray) and value.split == s and value.gshape == vshape
                and value._buffer.dtype == self.__array.dtype):
            value = value._buffer  # aligned at rest: pad rows are never written
        else:
            value = types._cast(self.__value_tensor(value), self.__array.dtype).expand(vshape)
        out = ring_put(n, idx, value.movedim(s, 0), comm=self.__comm, base=self.__array.movedim(s, 0),
                       padded_out=True)
        self.__array = out.movedim(0, s).contiguous()
        self._invalidate_halos()

    def __value_tensor(self, value) -> torch.Tensor:
        if isinstance(value, DNDarray):
            value = value.larray
        elif not isinstance(value, torch.Tensor):
            value = torch.as_tensor(np.asarray(value))
        return value.to(self.__array.device)

    def __getitem__(self, key) -> "DNDarray":
        """Indexing with global semantics.  Basic keys (integers, slices of
        any step, ``Ellipsis``, ``None``, scalar bools, which insert an
        axis of length 1 for True and 0 for False): a slice keeps the
        split on its axis, an integer that consumes the split axis hands
        it to the nearest remaining axis.  Array keys (integer or boolean
        arrays, lists, DNDarrays) follow jax: an out-of-range integer
        array clamps, a boolean mask gives a data-dependent length (one
        host sync).  One integer array on the split axis of a large split
        array takes the ring gather.  A 0-d result is replicated."""
        keyt = key if isinstance(key, tuple) else (key,)
        if all(_is_basic(k) for k in keyt):
            return self.__basic_getitem(key)
        tkey, _ = self.__process_key(key)
        ridx = self.__ring_index_plan(tkey)
        if ridx is not None:
            return self.__ring_getitem(ridx)
        result = self.larray[tkey]
        split = self.__advanced_split(tkey, result.ndim)
        return DNDarray(result, tuple(result.shape), self.__dtype, split, self.__device, self.__comm)

    def __basic_getitem(self, key) -> "DNDarray":
        arr, out_axis, in_axis, split = self.larray, 0, 0, None
        for k in _basic_key(key, self.ndim):
            if _inserts(k):
                arr = arr.unsqueeze(out_axis)
                if k is not None and not k:
                    arr = arr.narrow(out_axis, 0, 0)
                out_axis += 1
                continue
            if in_axis == self.__split:
                split = out_axis
            if isinstance(k, slice):
                start, stop, step = k.indices(int(arr.shape[out_axis]))
                if step > 0:
                    arr = arr[(slice(None),) * out_axis + (slice(start, stop, step),)]
                else:
                    arr = arr.index_select(out_axis, torch.arange(start, stop, step, device=arr.device))
                out_axis += 1
            else:
                arr = arr.select(out_axis, int(k))
            in_axis += 1
        if split is not None:
            split = None if arr.ndim == 0 else min(split, arr.ndim - 1)
        return DNDarray(arr, tuple(arr.shape), self.__dtype, split, self.__device, self.__comm)

    def __setitem__(self, key, value) -> None:
        """Assignment with global semantics; ``value`` (a DNDarray, tensor,
        array or scalar) is cast to this array's type and broadcast to the
        selection.  Array keys follow jax: an out-of-range integer array
        index drops its write, an out-of-range Python integer raises
        ``IndexError``; duplicate destinations are unspecified.  One
        integer array on the split axis of a large split array takes the
        ring scatter."""
        keyt = key if isinstance(key, tuple) else (key,)
        if all(_is_basic(k) for k in keyt):
            self.__basic_setitem(key, value)
            return
        tkey, dims = self.__process_key(key, scatter=True)
        ridx = self.__ring_index_plan(tkey)
        if ridx is not None:
            self.__ring_setitem(ridx, value)
            return
        # a copy with one sink row on every axis an integer array indexes:
        # dropped writes land there and are cut off
        sinks = sorted({d for k, d in zip(tkey, dims) if d is not None and isinstance(k, torch.Tensor)
                        and k.dtype != torch.bool})
        arr = self.larray
        work = arr.new_zeros(tuple(s + (d in sinks) for d, s in enumerate(arr.shape)))
        view = work[tuple(slice(0, s) for s in arr.shape)]
        view.copy_(arr)
        value = types._cast(self.__value_tensor(value), arr.dtype)
        work[tkey] = value
        self.__array = self.__commit(view.contiguous() if sinks else work)
        self._invalidate_halos()

    def __basic_setitem(self, key, value) -> None:
        # one copy of the buffer, written through its true-shape view (the
        # keys stay inside the true shape, so the pad stays zero); buffers
        # are never written in place, as the reference's are immutable: other
        # arrays and tensors taken from ``larray`` may share this one.
        # torch slices step forward only: a backward slice becomes the
        # forward slice over the same elements, the value flipped to match
        buf = self.__array.clone()
        arr = self._true_view(buf)
        tkey, flips, out_axis, in_axis = [], [], 0, 0
        for k in _basic_key(key, self.ndim):
            if _inserts(k):
                tkey.append(k)
                out_axis += 1
                continue
            n = self.__gshape[in_axis]
            if isinstance(k, slice):
                start, stop, step = k.indices(n)
                if step < 0:
                    count = len(range(start, stop, step))
                    last = start + (count - 1) * step
                    k = slice(last, start + 1, -step) if count else slice(0, 0)
                    flips.append(out_axis)
                tkey.append(k)
                out_axis += 1
            else:
                k = int(k)
                if not -n <= k < n:
                    raise IndexError(f"index {k} is out of bounds for axis {in_axis} with size {n}")
                tkey.append(k)
            in_axis += 1
        tkey = tuple(tkey)
        if isinstance(value, DNDarray):
            value = value.larray
        elif not isinstance(value, torch.Tensor):
            value = torch.as_tensor(np.asarray(value))
        target = arr[tkey].shape
        if value.ndim > len(target):
            raise ValueError(
                f"Cannot broadcast to shape with fewer dimensions: {tuple(value.shape)} to {tuple(target)}"
            )
        value = value.to(device=arr.device, dtype=arr.dtype).expand(target)
        arr[tkey] = value.flip(flips) if flips else value
        self.__array = buf
        self._invalidate_halos()

    def fill_diagonal(self, value) -> "DNDarray":
        """Set the main diagonal of a 2-D array to ``value``, in place."""
        if self.ndim != 2:
            raise ValueError("fill_diagonal requires a 2-D DNDarray")
        buf = self.__array.clone()
        idx = torch.arange(min(self.__gshape), device=buf.device)
        buf[idx, idx] = torch.as_tensor(value, dtype=buf.dtype, device=buf.device)
        self.__array = buf
        self._invalidate_halos()
        return self

    # ------------------------------------------------------------------ #
    # halos                                                               #
    # ------------------------------------------------------------------ #
    def get_halo(self, halo_size: int) -> None:
        """Fetch every shard's neighbour strips along the split axis
        (:func:`heat_tpu_torch.parallel.halo_exchange`): :attr:`halo_prev`
        and :attr:`halo_next` become tensors laid out like the array with
        ``halo_size`` rows per position along the split axis, the tail of
        position i-1 and the head of position i+1, zeros past the global
        edges (pad rows are zeros)."""
        if not isinstance(halo_size, int):
            raise TypeError(f"halo_size needs to be an integer, but was {type(halo_size)}")
        if halo_size < 0:
            raise ValueError(f"halo_size needs to be a non-negative integer, but was {halo_size}")
        if self.__split is None or halo_size == 0:
            self._invalidate_halos()
            return
        if self.__comm.mesh_ndim > 1:
            raise NotImplementedError("halos of an array on a position grid are not ported")
        from ..parallel.primitives import halo_exchange

        split = self.__split
        prev, nxt = halo_exchange(self.__array.movedim(split, 0), halo_size, comm=self.__comm)
        self.__halo_prev = prev.movedim(0, split)
        self.__halo_next = nxt.movedim(0, split)
        self.__halo_size = halo_size

    def _invalidate_halos(self) -> None:
        self.__halo_prev = None
        self.__halo_next = None
        self.__halo_size = 0

    @property
    def halo_prev(self) -> Optional[torch.Tensor]:
        return self.__halo_prev

    @property
    def halo_next(self) -> Optional[torch.Tensor]:
        return self.__halo_next

    @property
    def array_with_halos(self) -> torch.Tensor:
        """Every shard extended by its neighbour strips: along the split
        axis, ``positions * (shard_width + 2 * halo_size)`` rows, position
        p's block ``[prev strip | shard p (zero-padded) | next strip]``.
        Without halos (or replicated) the true-shape global tensor."""
        h = self.__halo_size
        if self.__split is None or not h:
            return self.larray
        comm = self.__comm
        fn = jitted(("dnd.halo_concat", comm), lambda: _halo_concat)
        return fn(self.__halo_prev, self.__array, self.__halo_next, self.__split, comm.size, h)

    @property
    def T(self) -> "DNDarray":
        """The array with its axes reversed."""
        return self.transpose()

    def resplit(self, axis=None) -> "DNDarray":
        """A copy laid out at ``axis`` (``None``: replicated; a splits
        tuple on a grid).  Under a solved ``htt.autoshard`` plan the
        placement is the plan's."""
        from . import manipulations

        axis = manipulations._planned_axis(self, axis)
        try:
            same = self.__comm.normalize_splits(self.ndim, axis) == self.__splits
        except (IndexError, ValueError):
            same = False  # the constructor below reports the bad axis
        if same:
            # the same layout: a copy, no layout commit
            return DNDarray(self.__array.clone(), self.__gshape, self.__dtype, self.__splits,
                            self.__device, self.__comm)
        arr = self.__comm.commit_split(self.larray, axis, src=self.__splits)
        if arr.untyped_storage().data_ptr() == self.__array.untyped_storage().data_ptr():
            arr = arr.contiguous().clone()
        return DNDarray(arr, self.__gshape, self.__dtype, axis, self.__device, self.__comm)

    def resplit_(self, axis=None) -> "DNDarray":
        """Lay this array out at ``axis`` (or a splits tuple), in place."""
        from . import manipulations

        res = manipulations._resplit(self, axis)
        if res.splits != self.__splits:
            self._rebind(res)
        return self

    # ------------------------------------------------------------------ #
    # operators and method forms: each calls its module function          #
    # ------------------------------------------------------------------ #
    def __add__(self, other):
        from . import arithmetics

        return arithmetics.add(self, other)

    def __radd__(self, other):
        from . import arithmetics

        return arithmetics.add(other, self)

    def __iadd__(self, other):
        from . import arithmetics

        res = arithmetics.add(self, other)
        if tuple(res.shape) != self.__gshape:
            raise ValueError(
                f"non-broadcastable output operand with shape {self.__gshape} "
                f"doesn't match the broadcast shape {tuple(res.shape)}"
            )
        self._rebind(res)
        return self

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

    def __floordiv__(self, other):
        from . import arithmetics

        return arithmetics.floordiv(self, other)

    def __rfloordiv__(self, other):
        from . import arithmetics

        return arithmetics.floordiv(other, self)

    def __mod__(self, other):
        from . import arithmetics

        return arithmetics.mod(self, other)

    def __rmod__(self, other):
        from . import arithmetics

        return arithmetics.mod(other, self)

    def __pow__(self, other):
        from . import arithmetics

        return arithmetics.pow(self, other)

    def __rpow__(self, other):
        from . import arithmetics

        return arithmetics.pow(other, self)

    def __neg__(self):
        from . import arithmetics

        return arithmetics.neg(self)

    def __pos__(self):
        return self

    def __abs__(self):
        from . import rounding

        return rounding.abs(self)

    def __invert__(self):
        from . import arithmetics

        return arithmetics.invert(self)

    def __lshift__(self, other):
        from . import arithmetics

        return arithmetics.left_shift(self, other)

    def __rshift__(self, other):
        from . import arithmetics

        return arithmetics.right_shift(self, other)

    def __and__(self, other):
        from . import arithmetics

        return arithmetics.bitwise_and(self, other)

    def __or__(self, other):
        from . import arithmetics

        return arithmetics.bitwise_or(self, other)

    def __xor__(self, other):
        from . import arithmetics

        return arithmetics.bitwise_xor(self, other)

    def __eq__(self, other):
        from . import relational

        return relational.eq(self, other)

    def __ne__(self, other):
        from . import relational

        return relational.ne(self, other)

    def __lt__(self, other):
        from . import relational

        return relational.lt(self, other)

    def __le__(self, other):
        from . import relational

        return relational.le(self, other)

    def __gt__(self, other):
        from . import relational

        return relational.gt(self, other)

    def __ge__(self, other):
        from . import relational

        return relational.ge(self, other)

    __hash__ = None  # elementwise ==, as the reference

    def add(self, other):
        from . import arithmetics

        return arithmetics.add(self, other)

    def sub(self, other):
        from . import arithmetics

        return arithmetics.sub(self, other)

    def mul(self, other):
        from . import arithmetics

        return arithmetics.mul(self, other)

    def div(self, other):
        from . import arithmetics

        return arithmetics.div(self, other)

    def fmod(self, other):
        from . import arithmetics

        return arithmetics.fmod(self, other)

    def pow(self, other):
        from . import arithmetics

        return arithmetics.pow(self, other)

    def prod(self, axis=None, out=None, keepdims=None, keepdim=None):
        from . import arithmetics

        return arithmetics.prod(self, axis, out, keepdims, keepdim)

    def sum(self, axis=None, out=None, keepdims=None, keepdim=None):
        from . import arithmetics

        return arithmetics.sum(self, axis, out, keepdims, keepdim)

    def cumsum(self, axis=0):
        from . import arithmetics

        return arithmetics.cumsum(self, axis)

    def cumprod(self, axis=0):
        from . import arithmetics

        return arithmetics.cumprod(self, axis)

    def exp(self, out=None):
        from . import exponential

        return exponential.exp(self, out)

    def expm1(self, out=None):
        from . import exponential

        return exponential.expm1(self, out)

    def exp2(self, out=None):
        from . import exponential

        return exponential.exp2(self, out)

    def log(self, out=None):
        from . import exponential

        return exponential.log(self, out)

    def log2(self, out=None):
        from . import exponential

        return exponential.log2(self, out)

    def log10(self, out=None):
        from . import exponential

        return exponential.log10(self, out)

    def log1p(self, out=None):
        from . import exponential

        return exponential.log1p(self, out)

    def sqrt(self, out=None):
        from . import exponential

        return exponential.sqrt(self, out)

    def sin(self, out=None):
        from . import trigonometrics

        return trigonometrics.sin(self, out)

    def cos(self, out=None):
        from . import trigonometrics

        return trigonometrics.cos(self, out)

    def tan(self, out=None):
        from . import trigonometrics

        return trigonometrics.tan(self, out)

    def sinh(self, out=None):
        from . import trigonometrics

        return trigonometrics.sinh(self, out)

    def cosh(self, out=None):
        from . import trigonometrics

        return trigonometrics.cosh(self, out)

    def tanh(self, out=None):
        from . import trigonometrics

        return trigonometrics.tanh(self, out)

    def arcsin(self, out=None):
        from . import trigonometrics

        return trigonometrics.arcsin(self, out)

    def arccos(self, out=None):
        from . import trigonometrics

        return trigonometrics.arccos(self, out)

    def arctan(self, out=None):
        from . import trigonometrics

        return trigonometrics.arctan(self, out)

    def abs(self, out=None, dtype=None):
        from . import rounding

        return rounding.abs(self, out, dtype)

    def absolute(self, out=None, dtype=None):
        return self.abs(out, dtype)

    def fabs(self, out=None):
        from . import rounding

        return rounding.fabs(self, out)

    def ceil(self, out=None):
        from . import rounding

        return rounding.ceil(self, out)

    def floor(self, out=None):
        from . import rounding

        return rounding.floor(self, out)

    def clip(self, a_min, a_max, out=None):
        from . import rounding

        return rounding.clip(self, a_min, a_max, out)

    def modf(self, out=None):
        from . import rounding

        return rounding.modf(self, out)

    def round(self, decimals=0, out=None, dtype=None):
        from . import rounding

        return rounding.round(self, decimals, out, dtype)

    def trunc(self, out=None):
        from . import rounding

        return rounding.trunc(self, out)

    def all(self, axis=None, out=None, keepdims=None, keepdim=None):
        from . import logical

        return logical.all(self, axis, out, keepdims, keepdim)

    def any(self, axis=None, out=None, keepdims=None, keepdim=None):
        from . import logical

        return logical.any(self, axis, out, keepdims, keepdim)

    def allclose(self, other, rtol=1e-05, atol=1e-08, equal_nan=False):
        from . import logical

        return logical.allclose(self, other, rtol, atol, equal_nan)

    def isclose(self, other, rtol=1e-05, atol=1e-08, equal_nan=False):
        from . import logical

        return logical.isclose(self, other, rtol, atol, equal_nan)

    def argmin(self, axis=None, out=None, keepdims=None):
        from . import statistics

        return statistics.argmin(self, axis=axis, out=out, keepdims=keepdims)

    def max(self, axis=None, out=None, keepdims=None, keepdim=None):
        from . import statistics

        return statistics.max(self, axis, out, keepdims, keepdim)

    def min(self, axis=None, out=None, keepdims=None, keepdim=None):
        from . import statistics

        return statistics.min(self, axis, out, keepdims, keepdim)

    def mean(self, axis=None, keepdims=None, keepdim=None):
        from . import statistics

        return statistics.mean(self, axis, keepdims=keepdims, keepdim=keepdim)

    def var(self, axis=None, ddof: int = 0, **kwargs):
        from . import statistics

        return statistics.var(self, axis, ddof=ddof, **kwargs)

    def std(self, axis=None, ddof: int = 0, **kwargs):
        from . import statistics

        return statistics.std(self, axis, ddof=ddof, **kwargs)

    def argmax(self, axis=None, out=None, **kwargs):
        from . import statistics

        return statistics.argmax(self, axis, out, **kwargs)

    def average(self, axis=None, weights=None, returned=False):
        from . import statistics

        return statistics.average(self, axis=axis, weights=weights, returned=returned)

    def median(self, axis=None, keepdim=None, keepdims=None):
        from . import statistics

        return statistics.median(self, axis, keepdim, keepdims=keepdims)

    def percentile(self, q, axis=None, out=None, interpolation="linear", keepdims=False):
        from . import statistics

        return statistics.percentile(self, q, axis, out, interpolation, keepdims)

    def skew(self, axis=None, unbiased=True):
        from . import statistics

        return statistics.skew(self, axis, unbiased)

    def kurtosis(self, axis=None, unbiased=True, Fischer=True):
        from . import statistics

        return statistics.kurtosis(self, axis, unbiased, Fischer)

    def expand_dims(self, axis):
        from . import manipulations

        return manipulations.expand_dims(self, axis)

    def flatten(self):
        from . import manipulations

        return manipulations.flatten(self)

    def ravel(self):
        from . import manipulations

        return manipulations.flatten(self)

    def reshape(self, *shape, **kwargs):
        from . import manipulations

        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return manipulations.reshape(self, shape, **kwargs)

    def squeeze(self, axis=None):
        from . import manipulations

        return manipulations.squeeze(self, axis)

    def unique(self, sorted=False, return_inverse=False, axis=None):
        from . import manipulations

        return manipulations.unique(self, sorted, return_inverse, axis)

    def flip(self, axis=None):
        from . import manipulations

        return manipulations.flip(self, axis)

    def sort(self, axis=-1, descending=False, out=None):
        from . import manipulations

        return manipulations.sort(self, axis, descending, out)

    def repeat(self, repeats, axis=None):
        from . import manipulations

        return manipulations.repeat(self, repeats, axis)

    def nonzero(self):
        from . import indexing

        return indexing.nonzero(self)

    def transpose(self, axes=None) -> "DNDarray":
        """The array with its axes permuted (default: reversed)."""
        from .linalg import basics

        return basics.transpose(self, axes)

    def tril(self, k=0):
        from .linalg import basics

        return basics.tril(self, k)

    def triu(self, k=0):
        from .linalg import basics

        return basics.triu(self, k)

    def dot(self, other, out=None):
        from .linalg import basics

        return basics.dot(self, other, out=out)

    def matmul(self, other, out=None, precision=None):
        from .linalg import basics

        return basics.matmul(self, other, out=out, precision=precision)

    def __matmul__(self, other):
        from .linalg import basics

        return basics.matmul(self, other)

    def qr(self, tiles_per_proc=1, calc_q=True, overwrite_a=False):
        from .linalg.qr import qr

        return qr(self, tiles_per_proc, calc_q, overwrite_a)

    def norm(self):
        from .linalg import basics

        return basics.norm(self)

    def _rebind(self, other: "DNDarray") -> None:
        """Take over ``other``'s buffer, shape, type and layout (the
        ``out=`` contract of the op engine)."""
        self.__array = other._buffer
        self.__gshape = other.gshape
        self.__dtype = other.dtype
        self.__split = other.split
        self.__splits = other.splits
        self._invalidate_halos()
