"""The generic op engine behind the elementwise ops and reductions.

Port of ``heat_tpu/core/_operations.py``: ``__binary_op``,
``__local_op``, ``__reduce_op`` and ``__cum_op``.  Every op computes on
the true-shape global views with torch and re-wraps the result, which
re-pads a ragged split axis with zeros (the pad invariant of
:mod:`.dndarray`).  Promotion is torch's,
which agrees with the reference's lattice on the slice's types, with the
reference's weak Python scalars on top.  A cumulative op along the split
axis runs as the two-level scan of
:func:`heat_tpu_torch.parallel.prefix_scan`.

The reduction engine keeps the reference's collective-precision seam: a
sum whose axes cover the split axis, on a communicator of several
positions, rides the block-scaled quantized ring
(:func:`heat_tpu_torch.comm.compressed.reduce_q`) when the policy asks for
compression.

Across processes (:func:`~.communication.init_multihost`) each op runs on
the process's slab of a split operand: an elementwise map and a reduction
along other axes need nothing else; a reduction over the split axis folds
the slab, then combines the processes' partials in process order (the
combine of :data:`XP_COMBINE`: a reduction without one, such as an
argmin over the split axis, refuses); a cumulative op along the split
runs the two-level scan with the earlier processes' position totals.

On a grid communicator the layouts follow the reference's: an elementwise
map keeps the input's splits tuple, every other op lays its result out at
the ``split`` compat int (the tuple that shards one dimension over mesh
axis 0), and reductions compute on the true view, so no pad reaches a
result (the reference's reductions keep mesh axis 1's pad, see ROADMAP's
faults of the reference).  The quantized ring runs on one mesh axis only:
a grid array reduces exactly.
"""

from __future__ import annotations

import builtins
import math
from typing import Callable, Optional

import numpy as np
import torch

from . import _xproc, sanitation, types
from ..telemetry import _core as _tel
from ._compile import cache_stable, counted, jitted
from ._tracing import record_dispatch
from .dndarray import DNDarray

__all__ = ["__binary_op", "__local_op", "__reduce_op", "__cum_op"]


def _freeze(statics: tuple):
    """Hashable view of an op's static parameters (a kwargs dict among them
    as its sorted items), or None if one is unhashable or an array (which
    hashes by identity: a key per call)."""
    out = []
    for v in statics:
        if isinstance(v, dict):
            v = tuple(sorted(v.items()))
            if any(isinstance(w, (torch.Tensor, DNDarray, np.ndarray)) for _, w in v):
                return None
        out.append(v)
    out = tuple(out)
    try:
        hash(out)
    except TypeError:
        return None
    return out


def _run(site: str, operation: Callable, statics: tuple, fn: Callable, *args):
    """``fn(*args)`` as the op's one dispatch.  With telemetry on it runs
    as the :func:`~._compile.jitted` entry keyed on ``(site, operation,
    statics)`` when ``operation`` is call-stable and the statics hashable,
    else keyless (a per-call identity would only grow the seen keys); with
    telemetry off nothing is keyed."""
    if not _tel.enabled:
        record_dispatch()
        return fn(*args)
    frozen = _freeze(statics)
    if frozen is not None and cache_stable(operation):
        return jitted((site, operation, frozen), lambda: fn)(*args)  # spmdlint: disable=SPMD401 -- site is the caller's namespace string; operation passed cache_stable()
    return counted(fn)(*args)


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
    return _cq.reduce_mode(x._slab.dtype, out_elems * 4)


#: how the per-process partials of a reduction over the split axis
#: combine across processes, by reduction (the modules that define a
#: reduction register it); the partials stack along a new axis 0
XP_COMBINE = {}


def _host_shape(t) -> tuple:
    if isinstance(t, DNDarray):
        return tuple(t.gshape)
    if np.isscalar(t):
        return ()
    return tuple(np.asarray(t).shape)


def _xp_operand(t, gshape: tuple, split: int, comm, target, dev):
    """A non-scalar operand's part beside a slab at ``split`` of a result
    of global shape ``gshape``: a slab's true rows; a whole operand
    (replicated, or host data) cut to this process's rows where it spans
    the split axis."""
    ndim = len(gshape)
    if isinstance(t, DNDarray):
        if t._slabbed:
            if t.split + ndim - t.ndim != split or t.gshape[t.split] != gshape[split]:
                _xproc.refuse("an elementwise op of differently split operands")
            return t._local.to(target)
        arr = t.larray.to(target)
    else:
        arr = types._cast(torch.as_tensor(np.asarray(t), device=dev), target)
    d = split - (ndim - arr.ndim)
    if d >= 0 and int(arr.shape[d]) != 1:
        a, b = comm.process_rows(gshape[split])
        arr = arr.narrow(d, a, b - a)
    return arr


def _out(out: Optional[DNDarray], wrapped: DNDarray) -> DNDarray:
    if out is None:
        return wrapped
    if not isinstance(out, DNDarray):
        raise TypeError(f"expected out to be None or a DNDarray, but was {type(out)}")
    if tuple(out.shape) != tuple(wrapped.shape):
        raise ValueError(f"expected out to have shape {wrapped.shape}, got {out.shape}")
    out._rebind(wrapped.astype(out.dtype))
    return out


def _operand_type(t):
    """What an operand counts as for promotion: a DNDarray its type, a
    Python scalar itself (weak), a numpy scalar or host data (a list, a
    numpy array) the numpy type it converts to."""
    if isinstance(t, DNDarray):
        return t.dtype
    if isinstance(t, (bool, int, float)) and not isinstance(t, np.generic):
        return t
    return types.canonical_heat_type(np.asarray(t).dtype)


def __binary_op(
    operation: Callable,
    t1,
    t2,
    out: Optional[DNDarray] = None,
    fn_kwargs: Optional[dict] = None,
) -> DNDarray:
    """Elementwise binary op with broadcasting.  Both operands are cast to
    the type the reference computes in (:func:`types._weak_result_type`:
    Python scalars are weak, a Python ``float`` beside an exact array
    gives float64) before ``operation`` runs.  The result takes the split
    of the split operand (re-anchored from the right when broadcasting
    prepends axes); of two differently split operands of one rank, ``t2``
    is resplit to ``t1``'s split first (under a compressing collective
    precision its moving pieces go through the wire format, as in the
    reference)."""
    fn_kwargs = fn_kwargs or {}
    scalar_1, scalar_2 = np.isscalar(t1), np.isscalar(t2)
    if scalar_1 and scalar_2:
        from . import factories

        target = types._weak_result_type(_operand_type(t1), _operand_type(t2)).torch_type()
        return factories.array(
            operation(torch.tensor(types._cast_scalar(t1, target), dtype=target),
                      torch.tensor(types._cast_scalar(t2, target), dtype=target), **fn_kwargs)
        )
    if scalar_1:
        anchor = t2
    elif isinstance(t1, DNDarray):
        anchor = t1
        if isinstance(t2, DNDarray):
            if t1.split is None and t2.split is not None:
                anchor = t2
            elif t2.split is not None and t2.split != t1.split and t1.ndim == t2.ndim:
                # both split, differently: t2 laid out at t1's split, as the
                # reference does (through the redistribution seam)
                t2 = t2.resplit(t1.split)
    else:
        raise TypeError(f"expected a DNDarray or scalar, got {type(t1)}")
    if not isinstance(anchor, DNDarray):
        raise TypeError(f"expected a DNDarray or scalar, got {type(anchor)}")

    target = types._weak_result_type(_operand_type(t1), _operand_type(t2)).torch_type()
    if anchor._slabbed:
        return _out(out, _xp_binary(operation, t1, t2, anchor, target, fn_kwargs))
    dev = anchor.larray.device

    def operand(t, first: bool):
        if isinstance(t, DNDarray):
            return t.larray.to(target)
        if np.isscalar(t):
            value = t.item() if isinstance(t, np.generic) else t
            if isinstance(value, bool) and target != torch.bool:
                value = int(value)
            value = types._cast_scalar(value, target)
            # torch takes a scalar as the second operand only; the first is
            # filled on the device (a host copy could not be captured)
            return torch.full((), value, dtype=target, device=dev) if first else value
        return types._cast(torch.as_tensor(np.asarray(t), device=dev), target)

    result = _run("binary", operation, (fn_kwargs,), lambda x, y: operation(x, y, **fn_kwargs),
                  operand(t1, True), operand(t2, False))
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


def _xp_binary(operation, t1, t2, anchor: DNDarray, target, fn_kwargs: dict) -> DNDarray:
    """:func:`__binary_op` across processes: the op on this process's
    rows of every operand, wrapped as the result's slab."""
    gshape = tuple(torch.broadcast_shapes(_host_shape(t1), _host_shape(t2)))
    split = anchor.split + (len(gshape) - anchor.ndim)
    if gshape[split] != anchor.gshape[anchor.split]:
        _xproc.refuse("an elementwise op that broadcasts the split axis")
    dev, comm = anchor.comm.device, anchor.comm

    def operand(t, first: bool):
        if np.isscalar(t):
            value = t.item() if isinstance(t, np.generic) else t
            if isinstance(value, bool) and target != torch.bool:
                value = int(value)
            value = types._cast_scalar(value, target)
            return torch.full((), value, dtype=target, device=dev) if first else value
        return _xp_operand(t, gshape, split, comm, target, dev)

    result = _run("binary", operation, (fn_kwargs,), lambda x, y: operation(x, y, **fn_kwargs),
                  operand(t1, True), operand(t2, False))
    return DNDarray(result, gshape, types.canonical_heat_type(result.dtype), split, anchor.device,
                    comm, slab=True)


def __local_op(
    operation: Callable,
    x,
    out: Optional[DNDarray] = None,
    no_cast: bool = False,
    keep_grid: bool = True,
    **kwargs,
) -> DNDarray:
    """Elementwise map; exact input types are float-promoted unless
    ``no_cast`` (int64 to float64, everything else to float32).  The
    result keeps ``x``'s splits tuple, or with ``keep_grid=False`` (maps
    the reference computes another way) its ``split``."""
    sanitation.sanitize_in(x)
    cast = None
    if not no_cast and types.heat_type_is_exact(x.dtype):
        cast = torch.float64 if x.dtype is types.int64 else torch.float32
    if x._slabbed:
        result = _run("local", operation, (cast, kwargs),
                      lambda a: operation(a.to(cast) if cast else a, **kwargs), x._local)
        if tuple(result.shape) != tuple(x._local.shape):
            _xproc.refuse(f"{getattr(operation, '__name__', 'a map')} (it changes the shape)")
        wrapped = DNDarray(result, x.gshape, types.canonical_heat_type(result.dtype), x.split,
                           x.device, x.comm, slab=True)
        return _out(out, wrapped)
    result = _run("local", operation, (cast, kwargs),
                  lambda a: operation(a.to(cast) if cast else a, **kwargs), x.larray)
    wrapped = DNDarray(
        result, tuple(result.shape), types.canonical_heat_type(result.dtype),
        (x._layout if keep_grid else x.split) if result.ndim else None, x.device, x.comm,
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
    if x._slabbed:
        return _out(out, _xp_reduce(reduction, x, axes, keepdims, cast, split))

    result = None
    if (split is None and x.split is not None and reduction is _sum and x.comm.size > 1
            and x.comm.mesh_ndim == 1):
        # collective-precision seam: local partials + the quantized ring
        mode = _compressed_mode(x, axes)
        if mode is not None:
            from ..comm import compressed as _cq

            result = _cq.reduce_q(
                x._buffer, comm=x.comm, split=x.split, axes=axes, keepdims=keepdims,
                mode=mode, out_dtype=cast or x._buffer.dtype,
            )
    if result is None:
        def f(a):
            r = reduction(a, axes, keepdims)
            return r.to(cast) if cast is not None else r

        result = _run("reduce", reduction, (axes, keepdims, cast), f, x.larray)
    if result.ndim == 0:
        split = None
    wrapped = DNDarray(
        result, tuple(result.shape), types.canonical_heat_type(result.dtype),
        split, x.device, x.comm,
    )
    return _out(out, wrapped)


def _reduced_gshape(x: DNDarray, axes: tuple, keepdims: bool) -> tuple:
    return tuple(1 if d in axes else s for d, s in enumerate(x.gshape) if keepdims or d not in axes)


def _xp_reduce(reduction, x: DNDarray, axes: tuple, keepdims: bool, cast, split) -> DNDarray:
    """:func:`__reduce_op` across processes.  Along other axes the slab
    reduces alone.  Over the split axis a sum the collective precision
    compresses rides the quantized ring across the processes; any other
    reduction folds each process's true rows and combines the partials
    of the processes that hold rows, in process order."""
    comm = x.comm

    def f(a, keep):
        r = reduction(a, axes, keep)
        return r.to(cast) if cast is not None else r

    if split is not None:
        result = _run("reduce", reduction, (axes, keepdims, cast), lambda a: f(a, keepdims), x._local)
        return DNDarray(result, _reduced_gshape(x, axes, keepdims),
                        types.canonical_heat_type(result.dtype), split, x.device, comm, slab=True)
    gshape = _reduced_gshape(x, axes, keepdims)
    if reduction is _sum:
        mode = _compressed_mode(x, axes)
        if mode is not None:
            from ..comm import compressed as _cq

            result = _cq.reduce_q(x._slab, comm=comm, split=x.split, axes=axes, keepdims=keepdims,
                                  mode=mode, out_dtype=cast or x._slab.dtype)
            return DNDarray(result, gshape, types.canonical_heat_type(result.dtype), None,
                            x.device, comm)
    combine = XP_COMBINE.get(reduction)
    if combine is None:
        _xproc.refuse(f"{getattr(reduction, '__name__', 'this reduction')} over the split axis")
    n = x.gshape[x.split]
    held = [k for k in range(comm.nprocs) if comm.process_rows(n, k)[1] > comm.process_rows(n, k)[0]]
    local = x._local
    if comm.rank not in held:  # a stand-in of the partial's shape and type
        local = torch.zeros_like(x._slab.narrow(x.split, 0, 1))
    part = _run("reduce", reduction, (axes, True, cast), lambda a: f(a, True), local)
    parts = torch.stack(_xproc.all_gather(part))[held]
    result = combine(parts)
    if not keepdims:
        result = result.reshape(gshape)
    return DNDarray(result, gshape, types.canonical_heat_type(result.dtype), None, x.device, comm)


def _sum(a: torch.Tensor, axes: tuple, keepdims: bool) -> torch.Tensor:
    """Sum over ``axes``; integer sums accumulate in int64, as torch's."""
    if not axes:
        return a.to(torch.int64) if a.dtype in (torch.bool, torch.int32) else a.clone()
    return torch.sum(a, dim=axes, keepdim=keepdims)


def _prod(a: torch.Tensor, axes: tuple, keepdims: bool) -> torch.Tensor:
    """Product over ``axes``; exact types accumulate in int64, as the
    reference's."""
    if not axes:
        return a.to(torch.int64) if not a.dtype.is_floating_point else a.clone()
    for ax in sorted(axes, reverse=True):
        a = torch.prod(a, dim=ax, keepdim=keepdims)
    return a


XP_COMBINE[_sum] = lambda t: torch.sum(t, dim=0)
XP_COMBINE[_prod] = lambda t: torch.prod(t, dim=0)


def __cum_op(
    operation: Callable,
    x,
    axis: int,
    out: Optional[DNDarray] = None,
    dtype=None,
) -> DNDarray:
    """Cumulative ``torch.cumsum``/``torch.cumprod`` along ``axis``.  Along
    the split axis of a communicator of several positions it runs as the
    two-level scan (a local scan per position, then each position combines
    the totals of those before it); a long axis scans in blocks
    (:func:`heat_tpu_torch.parallel.primitives.local_scan`).  Integer
    results keep the input's type (bool counts in int64), as the
    reference's, and ``dtype`` casts the result."""
    sanitation.sanitize_in(x)
    axis = sanitation.sanitize_axis(x.shape, axis)
    if axis is None:
        raise NotImplementedError("cumulative operations require an explicit axis")
    cast = types.canonical_heat_type(dtype).torch_type() if dtype is not None else None
    from ..parallel.primitives import local_scan, prefix_scan

    scan_op = {torch.cumsum: "sum", torch.cumprod: "prod"}[operation]
    comm = x.comm if axis == x.split and x.comm.size > 1 else None

    def f(arr):
        if comm is not None:
            r = prefix_scan(arr, scan_op, comm=comm, axis=axis)
        else:
            r = local_scan(arr, scan_op, axis)
        if arr.dtype != torch.bool:
            r = r.to(arr.dtype)
        return r.to(cast) if cast is not None else r

    if x._slabbed:
        from ..parallel.primitives import xp_prefix_scan

        def g(slab):
            if axis == x.split:
                r = xp_prefix_scan(slab, scan_op, x.comm, axis, x.gshape[axis])
            else:
                r = local_scan(x._true_view(slab), scan_op, axis)
            if slab.dtype != torch.bool:
                r = r.to(slab.dtype)
            return r.to(cast) if cast is not None else r

        result = _run("cum", operation, (axis, cast, x.comm), g, x._slab)
        wrapped = DNDarray(result, x.gshape, types.canonical_heat_type(result.dtype), x.split,
                           x.device, x.comm, slab=True)
        return _out(out, wrapped)
    result = _run("cum", operation, (axis, cast, comm), f, x.larray)
    wrapped = DNDarray(
        result, x.gshape, types.canonical_heat_type(result.dtype), x.split, x.device, x.comm,
    )
    return _out(out, wrapped)
