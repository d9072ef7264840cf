"""Shape and layout manipulations.

Port of ``heat_tpu/core/manipulations.py``.  Each function is its torch
equivalent on the global tensor plus the reference's split bookkeeping.
``sort`` along the split axis runs the distributed sort of
:mod:`heat_tpu_torch.parallel.sort`; ``unique`` and ``topk`` keep the
reference's numerics (its one host sync, its row hash, ``lax.top_k``'s
tie order), not torch's.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _xproc, factories, types
from ._tracing import NO_OVERRIDE, consume_layout_override, layout_plan_active
from .dndarray import DNDarray
from .sanitation import sanitize_in
from .stride_tricks import sanitize_axis

__all__ = [
    "balance",
    "column_stack",
    "concatenate",
    "diag",
    "diagonal",
    "dsplit",
    "expand_dims",
    "flatten",
    "flip",
    "fliplr",
    "flipud",
    "hsplit",
    "hstack",
    "pad",
    "redistribute",
    "repeat",
    "reshape",
    "resplit",
    "rot90",
    "row_stack",
    "shape",
    "sort",
    "split",
    "squeeze",
    "stack",
    "topk",
    "unique",
    "vsplit",
    "vstack",
]


def _rewrap(x: DNDarray, garr: torch.Tensor, split, dtype=None) -> DNDarray:
    """Wrap a result derived from ``x`` at ``split`` (None for a 0-d one)."""
    if garr.ndim == 0:
        split = None
    return DNDarray(
        garr, tuple(garr.shape), dtype or types.canonical_heat_type(garr.dtype), split, x.device, x.comm
    )


def balance(x: DNDarray, copy: bool = False) -> DNDarray:
    """A load-balanced array: the canonical layout always is, so ``x``
    itself (or a copy)."""
    sanitize_in(x)
    from .memory import copy as _copy

    return _copy(x) if copy else x


def redistribute(x: DNDarray, lshape_map=None, target_map=None) -> DNDarray:
    """``x`` after :meth:`DNDarray.redistribute_` (the canonical map only)."""
    sanitize_in(x)
    x.redistribute_(lshape_map, target_map)
    return x


def concatenate(arrays, axis: int = 0) -> DNDarray:
    """Join arrays along an existing axis, in their promoted type; the
    result takes the first split among them."""
    if not isinstance(arrays, (list, tuple)) or len(arrays) < 1:
        raise TypeError("arrays must be a non-empty sequence of DNDarrays")
    for a in arrays:
        sanitize_in(a)
    a0 = arrays[0]
    axis = sanitize_axis(a0.shape, axis)
    out_type = a0.dtype
    for a in arrays[1:]:
        if a.ndim != a0.ndim:
            raise ValueError("DNDarrays must have the same number of dimensions")
        if any(i != axis and s != t for i, (s, t) in enumerate(zip(a0.shape, a.shape))):
            raise ValueError(
                f"Arrays cannot be concatenated, shapes must be the same in "
                f"every axis except the selected axis: {a0.shape}, {a.shape}"
            )
        out_type = types.promote_types(out_type, a.dtype)
    garr = torch.cat([types._cast(a.larray, out_type.torch_type()) for a in arrays], dim=axis)
    split = a0.split if a0.split is not None else next((a.split for a in arrays if a.split is not None), None)
    return _rewrap(a0, garr, split, out_type)


def diag(a: DNDarray, offset: int = 0) -> DNDarray:
    """A 1-D array's diagonal matrix, or a 2-D array's diagonal."""
    sanitize_in(a)
    if a.ndim == 1:
        return _rewrap(a, torch.diag(a.larray, offset), a.split, a.dtype)
    return diagonal(a, offset=offset)


def diagonal(a: DNDarray, offset: int = 0, dim1: int = 0, dim2: int = 1) -> DNDarray:
    """The diagonal of the (dim1, dim2) planes, as a last axis."""
    sanitize_in(a)
    dim1 = sanitize_axis(a.shape, dim1)
    dim2 = sanitize_axis(a.shape, dim2)
    if dim1 == dim2:
        raise ValueError("dim1 and dim2 need to be different dimensions")
    garr = torch.diagonal(a.larray, offset=offset, dim1=dim1, dim2=dim2).contiguous()
    split = None if a.split in (dim1, dim2) else a.split
    if split is not None:
        split = split - sum(1 for d in (dim1, dim2) if d < split)
        split = min(max(split, 0), garr.ndim - 1)
    return _rewrap(a, garr, split, a.dtype)


def expand_dims(a: DNDarray, axis: int) -> DNDarray:
    """Insert a size-1 axis."""
    sanitize_in(a)
    if not isinstance(axis, (int, np.integer)):
        raise TypeError(f"axis must be an int, got {type(axis)}")
    if axis < -(a.ndim + 1) or axis > a.ndim:
        raise ValueError(f"axis {axis} out of bounds for expanding {a.ndim}-d array")
    axis = int(axis) % (a.ndim + 1)
    split = a.split if a.split is None or a.split < axis else a.split + 1
    return _rewrap(a, a.larray.unsqueeze(axis), split, a.dtype)


def flatten(a: DNDarray) -> DNDarray:
    """The array as 1-D, split on its one axis when ``a`` is split."""
    sanitize_in(a)
    return _rewrap(a, a.larray.reshape(-1), 0 if a.split is not None else None, a.dtype)


def flip(a: DNDarray, axis=None) -> DNDarray:
    """Reverse the order of elements along ``axis`` (None: every axis)."""
    sanitize_in(a)
    axis = sanitize_axis(a.shape, axis)
    dims = tuple(range(a.ndim)) if axis is None else ((axis,) if isinstance(axis, int) else axis)
    return _rewrap(a, torch.flip(a.larray, dims), a.split, a.dtype)


def fliplr(a: DNDarray) -> DNDarray:
    """Flip along axis 1."""
    if a.ndim < 2:
        raise IndexError("fliplr requires at least 2 dimensions")
    return flip(a, 1)


def flipud(a: DNDarray) -> DNDarray:
    """Flip along axis 0."""
    return flip(a, 0)


#: torch ``F.pad`` spellings of numpy's modes
_PAD_MODE_ALIASES = {"replicate": "edge", "circular": "wrap"}
_PAD_MODES = frozenset(
    {"constant", "edge", "linear_ramp", "maximum", "mean", "median",
     "minimum", "reflect", "symmetric", "wrap", "empty"}
)
#: the modes that only read existing elements: numpy's pad of the indices
#: of an axis gives each output element's source
_PAD_GATHER = frozenset({"edge", "reflect", "symmetric", "wrap"})


def _pad_widths(pad_width, ndim: int) -> List[Tuple[int, int]]:
    arr = np.broadcast_to(np.asarray(pad_width, dtype=np.int64), (ndim, 2))
    if (arr < 0).any():
        raise ValueError("index can't contain negative values")
    return [(int(b), int(e)) for b, e in arr]


def _stat(t: torch.Tensor, axis: int, mode: str) -> torch.Tensor:
    """``mode``'s statistic of ``t`` along ``axis`` (kept), as ``jnp.pad``
    computes it: integers round the mean and median half to even."""
    if mode == "maximum":
        return torch.amax(t, dim=axis, keepdim=True)
    if mode == "minimum":
        return torch.amin(t, dim=axis, keepdim=True)
    exact = not t.dtype.is_floating_point
    w = t.to(torch.float64 if t.dtype in (torch.int64, torch.float64) else torch.float32) if exact else t
    if mode == "mean":
        s = torch.mean(w, dim=axis, keepdim=True)
    else:
        from .statistics import _jnp_quantile

        s = _jnp_quantile(w.to(torch.float64) if exact else w, torch.tensor(0.5, dtype=torch.float64),
                          axis, "linear", True)
    if exact:
        s = torch.round(s)
    return types._cast(s, t.dtype)


def pad(array: DNDarray, pad_width, mode: str = "constant", constant_values=0) -> DNDarray:
    """Pad an array, in numpy's modes (and torch's ``replicate`` and
    ``circular`` spellings), axis by axis as ``jnp.pad``."""
    sanitize_in(array)
    if not isinstance(mode, str):
        raise TypeError(f"expected mode to be a string, but was {type(mode)}")
    mode = _PAD_MODE_ALIASES.get(mode, mode)
    if mode not in _PAD_MODES:
        raise NotImplementedError(f"pad mode {mode!r} not implemented")
    t = array.larray
    if t.ndim == 0:
        return _rewrap(array, t.clone(), None, array.dtype)
    widths = _pad_widths(pad_width, t.ndim)
    if mode in ("constant", "empty"):
        fill = constant_values if mode == "constant" else 0
        out = torch.full(tuple(s + b + e for s, (b, e) in zip(t.shape, widths)),
                         types._cast_scalar(fill, t.dtype), dtype=t.dtype, device=t.device)
        out[tuple(slice(b, b + s) for s, (b, _) in zip(t.shape, widths))] = t
        return _rewrap(array, out, array.split, array.dtype)
    for axis, (before, after) in enumerate(widths):
        n = int(t.shape[axis])
        if mode in _PAD_GATHER:
            src = np.pad(np.arange(n), (before, after), mode=mode)
            t = t.index_select(axis, torch.as_tensor(src, device=t.device))
            continue
        if mode == "linear_ramp":
            ends = (t.narrow(axis, 0, 1), t.narrow(axis, n - 1, 1))
            ramps = []
            for num, edge in zip((before, after), ends):
                frac = torch.arange(num, dtype=torch.float64, device=t.device) / max(num, 1)
                shape = [1] * t.ndim
                shape[axis] = num
                ramp = edge.to(torch.float64) * frac.reshape(shape)
                ramps.append(types._cast(ramp if t.dtype.is_floating_point else ramp.floor(), t.dtype))
            t = torch.cat([ramps[0], t, ramps[1].flip(axis)], dim=axis)
            continue
        stat = _stat(t, axis, mode)
        t = torch.cat([stat.repeat_interleave(before, dim=axis), t,
                       stat.repeat_interleave(after, dim=axis)], dim=axis)
    return _rewrap(array, t.contiguous(), array.split, array.dtype)


def repeat(a, repeats, axis: Optional[int] = None) -> DNDarray:
    """Repeat elements (each ``repeats`` times, or ``repeats[i]`` times);
    without ``axis`` over the flattened array."""
    if not isinstance(a, DNDarray):
        a = factories.array(a)
    if isinstance(repeats, DNDarray):
        repeats = repeats.numpy()
    axis = sanitize_axis(a.shape, axis)
    t = a.larray if axis is not None else a.larray.reshape(-1)
    reps = repeats if isinstance(repeats, (int, np.integer)) else torch.as_tensor(np.asarray(repeats), device=t.device)
    garr = torch.repeat_interleave(t, reps, dim=0 if axis is None else axis)
    split = a.split if axis is not None else (0 if a.split is not None else None)
    if garr.ndim == 1:
        split = 0 if a.split is not None else None
    return _rewrap(a, garr, split, a.dtype)


def reshape(a: DNDarray, shape, new_split: Optional[int] = None, **kwargs) -> DNDarray:
    """The array in a new global shape (one -1 allowed), split at
    ``new_split`` (default: the same axis, else 0)."""
    sanitize_in(a)
    if isinstance(shape, (int, np.integer)):
        shape = (int(shape),)
    shape = tuple(int(s) for s in shape)
    if any(s == -1 for s in shape):
        known = int(np.prod([s for s in shape if s != -1]))
        shape = tuple(a.size // max(known, 1) if s == -1 else s for s in shape)
    if int(np.prod(shape)) != a.size:
        raise ValueError(f"cannot reshape array of size {a.size} into shape {shape}")
    if new_split is None:
        new_split = a.split if (a.split is not None and a.split < len(shape)) else (
            0 if a.split is not None and len(shape) > 0 else None
        )
    else:
        new_split = sanitize_axis(shape, new_split)
    if a._slabbed:
        return _xp_reshape(a, shape, new_split)
    garr = a.larray.reshape(shape)
    return _rewrap(a, garr, new_split, a.dtype)


def _xp_reshape(a: DNDarray, shape: Tuple[int, ...], new_split) -> DNDarray:
    """:func:`reshape` across processes.  Row-major order makes each
    process's rows of an axis-0 split one contiguous range of flat
    elements, so at split 0 on both sides each process sends each other
    process the overlap of its range with the other's new range, in one
    message; other splits go through split 0 on the way in and out."""
    if not shape or not a.ndim:
        _xproc.refuse("a reshape to or from 0-d")
    src = a if a.split == 0 else a.resplit(0)
    comm = a.comm
    inner_in, inner_out = int(np.prod(a.shape[1:])), int(np.prod(shape[1:]))
    have = [tuple(v * inner_in for v in comm.process_rows(a.shape[0], k)) for k in range(comm.nprocs)]
    want = [tuple(v * inner_out for v in comm.process_rows(shape[0], k)) for k in range(comm.nprocs)]
    flat = src._local.reshape(-1)
    lo, hi = have[comm.rank]
    sends, recvs = {}, {}
    for j in range(comm.nprocs):
        s0, s1 = max(lo, want[j][0]), min(hi, want[j][1])
        sends[j] = flat[max(s0 - lo, 0):max(s1 - lo, 0)]
        r0, r1 = max(have[j][0], want[comm.rank][0]), min(have[j][1], want[comm.rank][1])
        recvs[j] = ((max(r1 - r0, 0),), flat.dtype)
    got = _xproc.exchange(sends, recvs, flat.device)
    rows = (want[comm.rank][1] - want[comm.rank][0]) // max(inner_out, 1)
    local = torch.cat([got[j] for j in range(comm.nprocs)]).reshape((rows,) + tuple(shape[1:]))
    out = DNDarray(local, shape, a.dtype, 0, a.device, comm, slab=True)
    return out if new_split == 0 else out.resplit(new_split)


def _planned_axis(arr: DNDarray, axis):
    """``axis``, or the placement a solved ``htt.autoshard`` plan gives a
    resplit of this signature (shape, dtype name, src, requested dst).

    Resplits the plan never priced (the implicit reshard of a binary op)
    get no override and run as written; an override equal to
    ``arr.split`` elides the hop through the same-layout early-out.  On a
    grid, or for a splits tuple, the plan has no say (its seam is 1-D)."""
    if not layout_plan_active() or arr.comm.mesh_ndim > 1 or isinstance(axis, (tuple, list)):
        return axis
    requested = sanitize_axis(arr.shape, axis) if axis is not None else None
    override = consume_layout_override(
        arr.shape, getattr(arr.dtype, "__name__", str(arr.dtype)), arr.split, requested)
    return axis if override is NO_OVERRIDE else override


def resplit(arr: DNDarray, axis=None) -> DNDarray:
    """The array laid out at ``axis`` (None: replicated); the same layout
    shares the at-rest buffer.  ``axis`` may be a splits tuple, the grid's
    spelling (on one mesh axis it is its ``split`` int); on a grid an int
    lays the array out over mesh axis 0 alone.  Under a solved
    ``htt.autoshard`` plan the placement is the plan's."""
    sanitize_in(arr)
    return _resplit(arr, _planned_axis(arr, axis))


def _resplit(arr: DNDarray, axis) -> DNDarray:
    """:func:`resplit` at exactly ``axis``: no plan is consulted (the
    in-place ``resplit_`` takes this path, as in the reference)."""
    comm = arr.comm
    if isinstance(axis, (tuple, list)) or comm.mesh_ndim > 1:
        if not isinstance(axis, (tuple, list)):
            axis = sanitize_axis(arr.shape, axis)
        splits = comm.normalize_splits(arr.ndim, axis)
        if comm.mesh_ndim == 1:
            axis = comm.split_view(splits)
        else:
            if splits == arr.splits:
                return DNDarray(arr._buffer, arr.shape, arr.dtype, splits, arr.device, comm)
            garr = comm.commit_split(arr.larray, splits, src=arr.splits)
            return DNDarray(garr, arr.shape, arr.dtype, splits, arr.device, comm)
    axis = sanitize_axis(arr.shape, axis)
    if axis == arr.split:
        return DNDarray(arr._slab, arr.shape, arr.dtype, axis, arr.device, arr.comm, slab=True)
    if comm.spans_processes:
        garr = comm.commit_split(arr._slab, axis, src=arr.split, gshape=arr.shape)
        return DNDarray(garr, arr.shape, arr.dtype, axis, arr.device, comm, slab=True)
    garr = arr.comm.commit_split(arr.larray, axis, src=arr.split)
    return DNDarray(garr, arr.shape, arr.dtype, axis, arr.device, arr.comm)


def rot90(m: DNDarray, k: int = 1, axes=(0, 1)) -> DNDarray:
    """Rotate by 90 degrees ``k`` times in the plane of ``axes``."""
    sanitize_in(m)
    axes = tuple(sanitize_axis(m.shape, ax) for ax in axes)
    if len(set(axes)) != 2:
        raise ValueError("axes must be different")
    garr = torch.rot90(m.larray, k, dims=axes).contiguous()
    split = m.split
    if split in axes and k % 2 == 1:
        split = axes[0] if split == axes[1] else axes[1]
    return _rewrap(m, garr, split, m.dtype)


def sort(a: DNDarray, axis: int = -1, descending: bool = False, out=None):
    """Stable sort along ``axis``: ``(values, int32 original indices)``,
    NaN last in both directions, ties in index order.  Along the split
    axis of an array over several positions the distributed sort runs
    (:func:`heat_tpu_torch.parallel.sort.sort_axis0`); elsewhere the axis
    is local and one stable argsort does."""
    sanitize_in(a)
    axis = sanitize_axis(a.shape, axis)
    if axis is None:
        axis = a.ndim - 1
    from ..parallel import sort as _psort

    if a._slabbed:
        return _xp_sort(a, axis, descending, out)
    arr = a.larray
    if a.split == axis and _psort.supports_axis(arr.dtype, a.shape, axis, a.comm):
        values, indices = _psort.sort_axis0(arr.movedim(axis, 0), a.shape[axis], comm=a.comm,
                                            descending=descending)
        values, indices = values.movedim(0, axis), indices.movedim(0, axis)
    else:
        key = _psort.descending_key(arr) if descending else arr
        indices = _psort.stable_argsort(key, axis)
        values = _psort.from_bits(torch.gather(_psort.as_bits(arr), axis, indices), arr.dtype)
    vals = _rewrap(a, values.contiguous(), a.split, a.dtype)
    idx = _rewrap(a, indices.to(torch.int32).contiguous(), a.split, types.int32)
    if out is not None:
        out._rebind(vals)
        return out, idx
    return vals, idx


def _xp_sort(a: DNDarray, axis: int, descending: bool, out):
    """:func:`sort` across processes.  Along another axis each process
    sorts its rows.  Along the split axis this slice gathers the array
    into every process, runs the one-process sort on the same number of
    positions and keeps each process's slab, so values and indices are
    the one-process sort's; a sort that moves only each element's share
    across processes is ROADMAP A3b2."""
    if out is not None:
        _xproc.refuse("sort with out=")
    if axis == a.split:
        vals, idx = sort(a._gathered(), axis, descending)
        return (DNDarray(vals.larray, a.gshape, a.dtype, a.split, a.device, a.comm),
                DNDarray(idx.larray, a.gshape, types.int32, a.split, a.device, a.comm))
    from ..parallel import sort as _psort

    arr = a._local
    key = _psort.descending_key(arr) if descending else arr
    indices = _psort.stable_argsort(key, axis)
    values = _psort.from_bits(torch.gather(_psort.as_bits(arr), axis, indices), arr.dtype)
    return (DNDarray(values.contiguous(), a.gshape, a.dtype, a.split, a.device, a.comm, slab=True),
            DNDarray(indices.to(torch.int32).contiguous(), a.gshape, types.int32, a.split, a.device,
                     a.comm, slab=True))


def shape(a: DNDarray) -> tuple:
    """The global shape of ``a``."""
    if not isinstance(a, DNDarray):
        raise TypeError(f"Expected a to be a DNDarray but was {type(a)}")
    return a.gshape


def split(ary: DNDarray, indices_or_sections, axis: int = 0) -> List[DNDarray]:
    """Split into sub-arrays: ``indices_or_sections`` equal parts (which
    must divide the axis) or the parts between the given indices."""
    sanitize_in(ary)
    axis = sanitize_axis(ary.shape, axis)
    if isinstance(indices_or_sections, (int, np.integer)):
        if ary.shape[axis] % int(indices_or_sections) != 0:
            raise ValueError("array split does not result in an equal division")
        sections = int(indices_or_sections)
    else:
        if isinstance(indices_or_sections, DNDarray):
            indices_or_sections = indices_or_sections.numpy()
        sections = [int(i) for i in np.asarray(indices_or_sections).reshape(-1)]
    parts = torch.tensor_split(ary.larray, sections, dim=axis)
    return [_rewrap(ary, p.contiguous(), ary.split, ary.dtype) for p in parts]


def dsplit(ary: DNDarray, indices_or_sections) -> List[DNDarray]:
    """:func:`split` along axis 2."""
    return split(ary, indices_or_sections, axis=2)


def hsplit(ary: DNDarray, indices_or_sections) -> List[DNDarray]:
    """:func:`split` along axis 1 (axis 0 of a 1-D array)."""
    if ary.ndim < 2:
        return split(ary, indices_or_sections, axis=0)
    return split(ary, indices_or_sections, axis=1)


def vsplit(ary: DNDarray, indices_or_sections) -> List[DNDarray]:
    """:func:`split` along axis 0."""
    return split(ary, indices_or_sections, axis=0)


def squeeze(x: DNDarray, axis=None) -> DNDarray:
    """Remove size-1 axes (``axis``: those only, which must be size 1)."""
    sanitize_in(x)
    axis = sanitize_axis(x.shape, axis)
    if axis is not None:
        axes = (axis,) if isinstance(axis, int) else axis
        for ax in axes:
            if x.shape[ax] != 1:
                raise ValueError(
                    f"cannot select an axis to squeeze out which has size not equal to one, axis {ax}")
    else:
        axes = tuple(i for i, s in enumerate(x.shape) if s == 1)
    garr = x.larray.reshape(tuple(s for i, s in enumerate(x.shape) if i not in axes))
    split = x.split
    if split is not None:
        split = None if split in axes else split - sum(1 for ax in axes if ax < split)
    return _rewrap(x, garr, split, x.dtype)


def stack(arrays: Sequence[DNDarray], axis: int = 0, out=None) -> DNDarray:
    """Join equal-shaped arrays along a new axis, in their promoted type."""
    if len(arrays) < 2:
        raise ValueError("stack expects a sequence of at least 2 DNDarrays")
    for a in arrays:
        sanitize_in(a)
    a0 = arrays[0]
    for a in arrays[1:]:
        if a.shape != a0.shape:
            raise ValueError(f"all input arrays must have the same shape, {a.shape} != {a0.shape}")
    ndim_out = a0.ndim + 1
    if not -ndim_out <= axis < ndim_out:
        raise ValueError(f"axis {axis} is out of bounds for the {ndim_out}-dimensional result")
    axis = axis % ndim_out
    out_type = a0.dtype
    for a in arrays[1:]:
        out_type = types.promote_types(out_type, a.dtype)
    garr = torch.stack([types._cast(a.larray, out_type.torch_type()) for a in arrays], dim=axis)
    split = a0.split
    if split is not None and axis <= split:
        split += 1
    result = _rewrap(a0, garr, split, out_type)
    if out is not None:
        out._rebind(result)
        return out
    return result


def column_stack(arrays) -> DNDarray:
    """Stack 1-D arrays as columns (2-D arrays as they are) along axis 1."""
    reshaped = []
    for a in arrays:
        sanitize_in(a)
        reshaped.append(expand_dims(a, 1) if a.ndim == 1 else a)
    return concatenate(reshaped, axis=1)


def row_stack(arrays) -> DNDarray:
    """Stack 1-D arrays as rows (2-D arrays as they are) along axis 0."""
    reshaped = []
    for a in arrays:
        sanitize_in(a)
        reshaped.append(expand_dims(a, 0) if a.ndim == 1 else a)
    return concatenate(reshaped, axis=0)


def hstack(tup) -> DNDarray:
    """Concatenate along axis 1 (axis 0 for 1-D arrays)."""
    arrays = list(tup)
    if all(a.ndim == 1 for a in arrays):
        return concatenate(arrays, axis=0)
    return concatenate(arrays, axis=1)


def vstack(tup) -> DNDarray:
    """:func:`row_stack`."""
    return row_stack(list(tup))


# --------------------------------------------------------------------- #
# unique                                                                  #
# --------------------------------------------------------------------- #
def _neq_prev(s: torch.Tensor) -> torch.Tensor:
    """Element-wise ``s != roll(s, 1)`` along axis 0, NaN equal to NaN."""
    prev = torch.roll(s, 1, dims=0)
    neq = s != prev
    if s.dtype.is_floating_point:
        neq = neq & ~(torch.isnan(s) & torch.isnan(prev))
    return neq


def _groups(mask: torch.Tensor, comm) -> torch.Tensor:
    """Group id of every sorted element: the count of first occurrences
    up to it, less one (over the positions: a two-level prefix sum)."""
    if comm is not None and comm.size > 1 and mask.shape[0]:
        from ..parallel import prefix_sum

        return prefix_sum(mask.to(torch.int64), comm=comm) - 1
    return torch.cumsum(mask.to(torch.int64), 0) - 1


def _compact(values: torch.Tensor, mask: torch.Tensor, groups: torch.Tensor, n_unique: int) -> torch.Tensor:
    """The first occurrences of ``values`` packed into ``(n_unique, ...)``
    (the rest land on one sink row, cut off)."""
    sink = torch.where(mask, groups, n_unique)
    out = values.new_zeros((n_unique + 1,) + tuple(values.shape[1:]))
    out[sink] = values
    return out[:n_unique]


def _unique_mask_1d(flat: torch.Tensor, comm=None):
    """Sorted order, sorted values, first-occurrence mask and group ids of
    a flat tensor (NaNs collapse to one).  Over several positions with an
    orderable dtype the sort is the ring rank sort."""
    from ..parallel import sort as _psort

    if comm is not None and _psort.supports(flat.dtype, flat.shape[0], comm):
        s, order = _psort.ring_rank_sort(flat, flat.shape[0], comm=comm)
        order = order.to(torch.int64)
    else:
        order = _psort.stable_argsort(flat, 0)
        s = flat[order]
    neq = _neq_prev(s)
    if s.shape[0]:
        neq[0] = True
    return order, s, neq, _groups(neq, comm)


def unique(a: DNDarray, sorted: bool = False, return_inverse: bool = False, axis=None):
    """Unique elements in sorted order (``axis``: unique slices along it).
    The count of uniques is the one value that reaches the host: the
    output length depends on the data.  Slices wider than
    :data:`_UNIQUE_AXIS_MAX_LEXSORT_KEYS` elements sort by a 64-bit row
    hash and come back in hash order unless ``sorted=True``.  With
    ``return_inverse`` also the int64 index of each element's unique."""
    sanitize_in(a)
    if axis is not None:
        axis = sanitize_axis(a.shape, axis)
        return _unique_axis(a, axis, return_inverse, sorted)
    flat = a.larray.reshape(-1)
    comm = a.comm if a.split is not None else None
    order, s, mask, groups = _unique_mask_1d(flat, comm=comm)
    n_unique = int(mask.sum())  # the one host sync
    result = _rewrap(a, _compact(s, mask, groups, n_unique), 0 if a.split is not None else None, a.dtype)
    if return_inverse:
        inv = torch.empty_like(groups).scatter_(0, order, groups)
        return result, factories.array(inv.reshape(a.larray.shape), dtype=types.int64, device=a.device,
                                       comm=a.comm)
    return result


#: above this many flattened columns, axis-unique sorts by a row hash
#: (the exact lexicographic sort takes one stable sort a column)
_UNIQUE_AXIS_MAX_LEXSORT_KEYS = 64


def _lexsort_rows(rows: torch.Tensor) -> torch.Tensor:
    """``np.lexsort`` order of the rows, column 0 the primary key: one
    stable sort a column, the last column first."""
    from ..parallel.sort import stable_argsort

    order = torch.arange(rows.shape[0], device=rows.device)
    for j in range(rows.shape[1] - 1, -1, -1):
        order = order[stable_argsort(rows[order, j], 0)]
    return order


def _unique_axis(a: DNDarray, axis: int, return_inverse: bool, sort_result: bool = False):
    """Unique slices along ``axis``: an exact lexicographic sort of the
    flattened remaining axes (hashed for wide slices), then the flat
    case's mask, count and compaction."""
    moved = a.larray.movedim(axis, 0)
    n = moved.shape[0]
    rows = moved.reshape(n, -1)
    m = rows.shape[1]
    if m > _UNIQUE_AXIS_MAX_LEXSORT_KEYS:
        return _unique_axis_hashed(a, axis, return_inverse, moved, rows, sort_result)
    order = _lexsort_rows(rows)
    s = rows[order]
    neq = _neq_prev(s).any(dim=1) if m else torch.zeros((n,), dtype=torch.bool, device=rows.device)
    if n:
        neq[0] = True
    groups = torch.cumsum(neq.to(torch.int64), 0) - 1
    n_unique = int(neq.sum())  # the one host sync
    uniq = _compact(s, neq, groups, n_unique)
    garr = uniq.reshape((n_unique,) + tuple(moved.shape[1:])).movedim(0, axis).contiguous()
    result = _rewrap(a, garr, 0 if a.split is not None else None, a.dtype)
    if return_inverse:
        inv = torch.empty_like(groups).scatter_(0, order, groups)
        return result, factories.array(inv, dtype=types.int64, device=a.device, comm=a.comm)
    return result


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c) -> torch.Tensor:
    """``x * c mod 2**32`` of 32-bit values held in int64 (``c`` an int or
    such a tensor), in two 16-bit halves so no product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _row_words(rows: torch.Tensor) -> torch.Tensor:
    """The rows as 32-bit words in int64: rows equal under unique()'s rules
    (``-0.0`` equal to ``+0.0``, NaN to NaN) have equal words.  Floats
    canonicalize the zero and NaN first; a 64-bit element gives two words
    (high, low); narrower ones widen."""
    dt = rows.dtype
    if dt == torch.bool:
        return rows.to(torch.int64)
    if dt.is_floating_point:
        rows = torch.where(rows == 0, torch.zeros((), dtype=dt, device=rows.device), rows)
        rows = torch.where(torch.isnan(rows), torch.full((), float("nan"), dtype=dt, device=rows.device), rows)
    width = rows.element_size() * 8
    if width == 64:
        bits = rows.view(torch.int64)
        n, m = bits.shape
        return torch.stack([(bits >> 32) & _M32, bits & _M32], dim=-1).reshape(n, 2 * m)
    signed = {8: torch.int8, 16: torch.int16, 32: torch.int32}[width]
    if dt == torch.uint8:
        return rows.to(torch.int64)
    return rows.view(signed).to(torch.int64) & ((1 << width) - 1)


def _hash_rows(words: torch.Tensor, seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's two 32-bit polynomial row hashes of a 32-bit word
    matrix, bit for bit, in int64 lanes (a mask after every multiply, add
    and shift): a seeded murmur-style mixer a word, then a fold with
    per-hash odd multipliers."""
    w = words.shape[1]
    x = words ^ ((0x9E3779B9 * (seed + 1)) & _M32)
    x = _mul32(x ^ (x >> 16), 0x85EBCA6B)
    x = _mul32(x ^ (x >> 13), 0xC2B2AE35)
    x = x ^ (x >> 16)

    def fold(mult: int) -> torch.Tensor:
        out, acc = [], 1
        for _ in range(w):
            out.append(acc)
            acc = (acc * mult) & _M32
        powers = torch.tensor(out[::-1], dtype=torch.int64, device=words.device)
        return _mul32(x, powers).sum(dim=1) & _M32

    return fold(2654435761), fold(0x01000193)


def _unique_axis_hashed(a: DNDarray, axis: int, return_inverse: bool, moved, rows, sort_result: bool = False):
    """Axis-unique for wide slices: each row compressed to a 64-bit hash,
    the rows sorted by it (the ring rank sort over several positions),
    then the exact mask, count and compaction on the sorted rows.  Hash
    collisions between unequal rows are detected exactly and retried
    with a fresh seed.  The result is in hash order, or lexicographic
    with ``sorted=True`` (a host pass over the uniques only)."""
    from ..parallel import sort as _psort
    from ..parallel import take as _take

    n = moved.shape[0]
    words = _row_words(rows)
    comm = a.comm if a.split is not None else None
    ring = comm is not None and comm.size > 1
    for seed in range(4):
        h1, h2 = _hash_rows(words, seed)
        # the (h1, h2) order as one int64: (h1 - 2**31) * 2**32 + h2
        key = (h1 - (1 << 31)) * (1 << 32) + h2
        if comm is not None and _psort.supports(key.dtype, n, comm):
            order = _psort.ring_rank_sort(key, n, comm=comm)[1].to(torch.int64)
        else:
            order = _psort.stable_argsort(key, 0)
        if ring:
            s = _take.ring_take(rows, order, comm=comm)
            sh1, sh2 = _hash_rows(_row_words(s), seed)
        else:
            s = rows[order]
            sh1, sh2 = h1[order], h2[order]
        same_hash = (sh1 == torch.roll(sh1, 1)) & (sh2 == torch.roll(sh2, 1))
        neq = _neq_prev(s).any(dim=1)
        if n and bool((same_hash & neq & (torch.arange(n, device=neq.device) > 0)).any()):
            continue  # an exact collision check failed: re-seed
        if n:
            neq[0] = True
        break
    else:
        raise RuntimeError(
            "unique(axis=...): persistent 64-bit hash collisions; cannot group rows device-resident"
        )
    groups = _groups(neq, comm)
    n_unique = int(neq.sum())  # the one host sync
    uniq = _compact(s, neq, groups, n_unique)
    remap = None
    if sort_result and n_unique:
        host = uniq.cpu().numpy() if uniq.dtype != torch.bfloat16 else uniq.float().cpu().numpy()
        perm = np.lexsort(tuple(host[:, j] for j in range(host.shape[1] - 1, -1, -1)))
        uniq = uniq[torch.as_tensor(perm, device=uniq.device)]
        remap = torch.as_tensor(np.argsort(perm), device=uniq.device)
    garr = uniq.reshape((n_unique,) + tuple(moved.shape[1:])).movedim(0, axis).contiguous()
    result = _rewrap(a, garr, 0 if a.split is not None else None, a.dtype)
    if return_inverse:
        sorted_groups = remap[groups] if remap is not None else groups
        if ring:
            inv = _take.ring_put(n, order, sorted_groups, comm=comm)
        else:
            inv = torch.empty_like(sorted_groups).scatter_(0, order, sorted_groups)
        return result, factories.array(inv, dtype=types.int64, device=a.device, comm=a.comm)
    return result


# --------------------------------------------------------------------- #
# topk                                                                    #
# --------------------------------------------------------------------- #
def _total_order_key(t: torch.Tensor) -> torch.Tensor:
    """int64 key of XLA's total order (``lax.top_k``'s): for floats -NaN <
    -inf < ... < -0.0 < +0.0 < ... < inf < NaN, by the folded bits."""
    if t.dtype == torch.float64:
        bits = t.view(torch.int64)
        return torch.where(bits < 0, bits ^ 0x7FFFFFFFFFFFFFFF, bits)
    if t.dtype.is_floating_point:
        bits = t.to(torch.float32).view(torch.int32).to(torch.int64)
        return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return t.to(torch.int64)


def topk(a: DNDarray, k: int, dim: int = -1, largest: bool = True, sorted: bool = True, out=None):
    """The ``k`` largest (or smallest) elements along ``dim`` and their
    int64 indices, as ``lax.top_k`` gives them: in XLA's total order (NaN
    above every number, ``+0.0`` above ``-0.0``), ties lowest index first.
    ``largest=False`` is the reference's top-k of ``-x`` (``~x`` for
    integers), which is the total order reversed.  The result is always
    sorted."""
    sanitize_in(a)
    dim = sanitize_axis(a.shape, dim)
    if dim is None:
        dim = a.ndim - 1
    from ..parallel.sort import as_bits, from_bits

    moved = a.larray.movedim(dim, -1)
    key = _total_order_key(moved)
    # a stable ascending sort: ties keep the lowest index first
    idx = torch.sort(~key if largest else key, dim=-1, stable=True)[1][..., :k]
    vals = from_bits(torch.gather(as_bits(moved), -1, idx), moved.dtype)
    split = a.split if a.split != dim else None
    values = _rewrap(a, vals.movedim(-1, dim).contiguous(), split, a.dtype)
    indices = _rewrap(a, idx.movedim(-1, dim).contiguous(), split, types.int64)
    if out is not None:
        out[0]._rebind(values)
        out[1]._rebind(indices)
        return out
    return values, indices


# split semantics (see core/_split_semantics.py); the table stays a literal dict
from ._split_semantics import declare_split_semantics_table  # noqa: E402

declare_split_semantics_table(
    __name__,
    {
        "concat": ("concatenate", "hstack", "vstack", "row_stack", "column_stack"),
        "stack": ("stack",),
        "expand_dims": ("expand_dims",),
        "squeeze": ("squeeze",),
        "flatten": ("flatten", "ravel"),
        "reshape": ("reshape",),
        "resplit": ("resplit", "resplit_"),
        "elementwise": ("flip", "fliplr", "flipud"),
    },
)
