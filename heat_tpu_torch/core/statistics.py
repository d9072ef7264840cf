"""Statistical reductions and order statistics.

Port of ``heat_tpu/core/statistics.py``, with its collective-precision
seam :func:`_compressed_moment`: mean/var/std (and so an unweighted
``average``) whose axes cover the split axis run local partials plus the
quantized ring when the policy asks for compression.  ``percentile`` and
``median`` sort over the positions (:mod:`heat_tpu_torch.parallel.sort`)
where the reference does; ``histogram`` and ``histc`` follow
``jnp.histogram``'s binning, and ``bincount`` ``jnp.bincount``'s types.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

import builtins

import numpy as np

from . import _operations, _xproc, factories, types
from ._compile import jitted
from .dndarray import DNDarray
from .fuse import fuse
from .sanitation import merge_keepdims, sanitize_axis, sanitize_in

__all__ = [
    "argmax",
    "argmin",
    "average",
    "bincount",
    "cov",
    "histc",
    "histogram",
    "kurtosis",
    "max",
    "maximum",
    "mean",
    "median",
    "min",
    "minimum",
    "percentile",
    "skew",
    "std",
    "var",
]


def _wrap_reduced(x: DNDarray, res: torch.Tensor, axis, keepdims: bool = False) -> DNDarray:
    axes = _operations._axes(x.ndim, axis)
    split = _operations._reduced_split(x, axes, keepdims)
    if res.ndim == 0:
        split = None
    if x._slabbed:  # a slab along the kept split axis, else whole
        return DNDarray(res, _operations._reduced_gshape(x, axes, keepdims),
                        types.canonical_heat_type(res.dtype), split, x.device, x.comm, slab=True)
    return DNDarray(
        res, tuple(res.shape), types.canonical_heat_type(res.dtype), split, x.device, x.comm
    )


def _xp_moment(x: DNDarray, dims: tuple, keepdims: bool, cast, kind: str, ddof: int = 0):
    """Exact mean, var or std over ``dims`` across processes: each process
    folds its true rows, the partial sums combine in process order, and
    var/std take a second pass about the combined mean; along other axes
    the slab reduces alone."""
    a = x._local.to(cast) if cast is not None else x._local
    if x.split not in dims:
        if kind == "mean":
            return torch.mean(a, dim=dims, keepdim=keepdims)
        r = torch.var(a, dim=dims, correction=ddof, keepdim=keepdims)
        return torch.sqrt(r) if kind == "std" else r

    def combined(t):
        return torch.stack(_xproc.all_gather(torch.sum(t, dim=dims, keepdim=True))).sum(dim=0)

    count = math.prod(int(x.gshape[d]) for d in dims)
    mu = combined(a) / count
    if kind == "mean":
        res = mu
    else:
        res = combined((a - mu) ** 2) / (count - ddof)
        res = torch.sqrt(res) if kind == "std" else res
    shape = _operations._reduced_gshape(x, dims, keepdims)
    return res.reshape(shape)


def _compressed_moment(x: DNDarray, axis, keepdims: bool, kind: str, ddof: int = 0):
    """The collective-precision seam for mean/var/std whose axes cover the
    split: the replicated result, or None when the policy (or the
    geometry) keeps the exact path.  var/std combine the first moment
    exactly and compress only the centered second moment
    (:func:`heat_tpu_torch.comm.compressed.moments_q`)."""
    if (x.split is None or x.comm.size <= 1 or x.comm.mesh_ndim > 1
            or types.heat_type_is_exact(x.dtype)):
        return None
    axes = _operations._axes(x.ndim, axis)
    if x.split not in axes:
        return None
    mode = _operations._compressed_mode(x, axes)
    if mode is None:
        return None
    from ..comm import compressed as _cq

    buf = x._slab
    true_n = math.prod(int(x.gshape[a]) for a in axes)
    if kind == "mean":
        return _cq.reduce_q(
            buf, comm=x.comm, split=x.split, axes=axes, keepdims=keepdims,
            mode=mode, mean_n=true_n, out_dtype=buf.dtype,
        )
    return _cq.moments_q(
        buf, comm=x.comm, split=x.split, axes=axes, keepdims=keepdims,
        mode=mode, true_n=true_n, split_valid=int(x.gshape[x.split]),
        ddof=ddof, finalize=kind, out_dtype=buf.dtype,
    )


def mean(x, axis=None, keepdims=None, keepdim=None) -> DNDarray:
    """Arithmetic mean over ``axis`` (int, tuple or None)."""
    keepdims = merge_keepdims(keepdims, keepdim)
    sanitize_in(x)
    axis = sanitize_axis(x.shape, axis)
    res = _compressed_moment(x, axis, keepdims, kind="mean")
    if res is None and x._slabbed:
        cast = torch.float32 if types.heat_type_is_exact(x.dtype) else None
        res = _xp_moment(x, _operations._axes(x.ndim, axis), keepdims, cast, "mean")
    if res is None:
        cast = torch.float32 if types.heat_type_is_exact(x.dtype) else None
        dims = _operations._axes(x.ndim, axis)
        fn = jitted(
            ("stat.mean", dims, cast, keepdims),
            lambda: lambda a: torch.mean(a.to(cast) if cast else a, dim=dims, keepdim=keepdims),
        )
        res = fn(x.larray)
    return _wrap_reduced(x, res, axis, keepdims)


def _moment2(x, axis, ddof, kwargs, kind: str) -> DNDarray:
    sanitize_in(x)
    if "bessel" in kwargs:
        ddof = 1 if kwargs.pop("bessel") else 0
    if ddof not in (0, 1):
        raise ValueError(f"ddof must be 0 or 1, got {ddof}")
    axis = sanitize_axis(x.shape, axis)
    keepdims = merge_keepdims(kwargs.pop("keepdims", None), kwargs.pop("keepdim", None))
    if kwargs:
        raise TypeError(f"unexpected keyword arguments: {sorted(kwargs)}")
    res = _compressed_moment(x, axis, keepdims, kind=kind, ddof=ddof)
    if res is None and x._slabbed:
        cast = torch.float32 if types.heat_type_is_exact(x.dtype) else None
        res = _xp_moment(x, _operations._axes(x.ndim, axis), keepdims, cast, kind, ddof)
    if res is None:
        cast = torch.float32 if types.heat_type_is_exact(x.dtype) else None
        dims = _operations._axes(x.ndim, axis)

        def make():
            def f(a):
                r = torch.var(a.to(cast) if cast else a, dim=dims, correction=ddof, keepdim=keepdims)
                return torch.sqrt(r) if kind == "std" else r

            return f

        res = jitted(("stat.moment2", kind, dims, ddof, cast, keepdims), make)(x.larray)
    return _wrap_reduced(x, res, axis, keepdims)


def var(x, axis=None, ddof: int = 0, **kwargs) -> DNDarray:
    """Variance with ``ddof`` in {0, 1} (``bessel=True`` also accepted)."""
    return _moment2(x, axis, ddof, kwargs, "var")


def std(x, axis=None, ddof: int = 0, **kwargs) -> DNDarray:
    """Standard deviation: ``sqrt(var)``."""
    return _moment2(x, axis, ddof, kwargs, "std")


def _amin(a: torch.Tensor, axes: tuple, keepdims: bool) -> torch.Tensor:
    return torch.amin(a, dim=axes, keepdim=keepdims) if axes else a.clone()


def _amax(a: torch.Tensor, axes: tuple, keepdims: bool) -> torch.Tensor:
    return torch.amax(a, dim=axes, keepdim=keepdims) if axes else a.clone()


_operations.XP_COMBINE[_amin] = lambda t: torch.amin(t, dim=0)
_operations.XP_COMBINE[_amax] = lambda t: torch.amax(t, dim=0)


def _arg(fn, a: torch.Tensor, axes: tuple, keepdims: bool) -> torch.Tensor:
    if len(axes) == a.ndim:
        r = fn(a.reshape(-1), dim=0)
        return r.reshape((1,) * a.ndim) if keepdims else r
    if len(axes) != 1:
        raise ValueError(f"{fn.__name__} takes a single axis or None")
    return fn(a, dim=axes[0], keepdim=keepdims)


def _argmin(a: torch.Tensor, axes: tuple, keepdims: bool) -> torch.Tensor:
    return _arg(torch.argmin, a, axes, keepdims)


def _argmax(a: torch.Tensor, axes: tuple, keepdims: bool) -> torch.Tensor:
    return _arg(torch.argmax, a, axes, keepdims)


def min(x, axis=None, out=None, keepdims=None, keepdim=None) -> DNDarray:
    """Minimum over ``axis`` (NaN propagates)."""
    keepdims = merge_keepdims(keepdims, keepdim)
    return _operations.__reduce_op(_amin, x, axis, out, keepdims=keepdims)


def max(x, axis=None, out=None, keepdims=None, keepdim=None) -> DNDarray:
    """Maximum over ``axis`` (NaN propagates)."""
    keepdims = merge_keepdims(keepdims, keepdim)
    return _operations.__reduce_op(_amax, x, axis, out, keepdims=keepdims)


def argmin(x, axis: Optional[int] = None, out=None, keepdims=None, keepdim=None) -> DNDarray:
    """Index of the minimum (flat index for ``axis=None``); the first one
    on ties, int64."""
    keepdims = merge_keepdims(keepdims, keepdim)
    return _operations.__reduce_op(_argmin, x, axis, out, keepdims=keepdims, dtype=types.int64)


def argmax(x, axis: Optional[int] = None, out=None, keepdims=None, keepdim=None, **kwargs) -> DNDarray:
    """Index of the maximum (flat index for ``axis=None``); the first one on
    ties and the first NaN, int64."""
    keepdims = merge_keepdims(keepdims, keepdim)
    return _operations.__reduce_op(_argmax, x, axis, out, keepdims=keepdims, dtype=types.int64)


def _tensor_pair(fn):
    """``fn`` taking a Python scalar second operand as a tensor of the
    first's type (``torch.maximum`` takes tensors only)."""
    def op(a, b):
        if not isinstance(b, torch.Tensor):
            b = torch.tensor(b, dtype=a.dtype, device=a.device)
        return fn(a, b)

    return op


_maximum, _minimum = _tensor_pair(torch.maximum), _tensor_pair(torch.minimum)


def maximum(x1, x2, out=None) -> DNDarray:
    """Elementwise maximum (NaN propagates)."""
    return _operations.__binary_op(_maximum, x1, x2, out)


def minimum(x1, x2, out=None) -> DNDarray:
    """Elementwise minimum (NaN propagates)."""
    return _operations.__binary_op(_minimum, x1, x2, out)


def _sum_type(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the type ``jnp.sum`` accumulates it in: integers and bool
    in int64."""
    return t if t.dtype.is_floating_point else t.to(torch.int64)


def average(x: DNDarray, axis=None, weights=None, returned: bool = False):
    """Weighted average over ``axis``.  Without weights it is :func:`mean`
    (and so rides the quantized ring under a compressing policy); with
    them ``sum(x * w) / sum(w)`` in the reference's types (exact inputs
    sum in int64 and divide to float64).  ``returned`` also gives the
    sum of the weights (the count without weights)."""
    sanitize_in(x)
    axis = sanitize_axis(x.shape, axis)
    if weights is None:
        result = mean(x, axis)
        if returned:
            n = x.size if axis is None else math.prod(x.shape[a] for a in _operations._axes(x.ndim, axis))
            return result, factories.full_like(result, float(n))
        return result
    arr = x.larray
    w = weights.larray if isinstance(weights, DNDarray) else torch.as_tensor(np.asarray(weights))
    w = w.to(arr.device)
    if w.ndim == 1 and axis is not None and not isinstance(axis, tuple) and w.shape[0] == arr.shape[axis]:
        bshape = [1] * arr.ndim
        bshape[axis] = -1
        wb = w.reshape(bshape)
    elif tuple(w.shape) == tuple(arr.shape):
        wb = w
    else:
        raise ValueError("weights differ in shape from a and do not match the axis length")
    target = types.promote_types(x.dtype, types.canonical_heat_type(w.dtype)).torch_type()
    dims = _operations._axes(arr.ndim, axis)
    wsum = _sum_type(types._cast(wb, target).expand(arr.shape)).sum(dim=dims)
    if bool((wsum == 0).any()):
        raise ZeroDivisionError("Weights sum to zero, can't be normalized")
    prod = types._cast(arr, target) * types._cast(wb, target)
    num = _sum_type(prod).sum(dim=dims)
    res = num / wsum if num.dtype.is_floating_point else num.to(torch.float64) / wsum.to(torch.float64)
    result = _wrap_reduced(x, res, axis)
    if returned:
        return result, _wrap_reduced(x, torch.broadcast_to(wsum, res.shape).clone(), axis)
    return result


def bincount(x: DNDarray, weights=None, minlength: int = 0) -> DNDarray:
    """Occurrences of each value of a 1-D integer array, as
    ``jnp.bincount``: negative values count as 0, the length is
    ``max(max + 1, minlength)``; int64 counts, or the weights' type."""
    sanitize_in(x)
    arr = x.larray
    if arr.ndim != 1:
        raise ValueError("bincount expects a 1-d array")
    length = builtins.max(int(arr.max()) + 1 if arr.numel() else 0, int(minlength))
    if weights is None:
        w = torch.ones((), dtype=torch.int64, device=arr.device).expand(arr.shape)
    else:
        w = weights.larray if isinstance(weights, DNDarray) else torch.as_tensor(np.asarray(weights))
        w = w.to(arr.device)
        if not w.dtype.is_floating_point:
            w = w.to(torch.int64)
    res = torch.zeros(length, dtype=w.dtype, device=arr.device).index_add_(0, arr.clamp(min=0).to(torch.int64), w)
    return factories.array(res, split=None, device=x.device, comm=x.comm)


def cov(m: DNDarray, y: Optional[DNDarray] = None, rowvar: bool = True, bias: bool = False, ddof=None) -> DNDarray:
    """Covariance matrix of the variables in the rows (``rowvar``) or
    columns of ``m`` (and ``y``); exact inputs in float32 (int64 in
    float64), as ``jnp.mean`` promotes them.  The product runs at full
    float32 precision (TF32 off)."""
    sanitize_in(m)
    if ddof is not None and not isinstance(ddof, int):
        raise TypeError("ddof must be integer")

    def rows(a: torch.Tensor, name: str) -> torch.Tensor:
        if a.ndim > 2:
            raise ValueError(f"{name} has more than 2 dimensions")
        if a.ndim == 1:
            a = a.reshape(1, -1)
        if not rowvar and a.shape[0] != 1:
            a = a.T
        return a

    arr = rows(m.larray, "m")
    if y is not None:
        sanitize_in(y)
        arr = torch.cat([arr, rows(y.larray, "y").to(arr.dtype)], dim=0)
    if not arr.dtype.is_floating_point:
        arr = arr.to(torch.float64 if arr.dtype == torch.int64 else torch.float32)
    if ddof is None:
        ddof = 0 if bias else 1
    xc = arr - torch.mean(arr, dim=1, keepdim=True)
    res = (xc @ xc.T) / (arr.shape[1] - ddof)
    return factories.array(res, split=m.split if m.split in (0, 1) else None, device=m.device, comm=m.comm)


def _inexact(dtype: torch.dtype) -> torch.dtype:
    """The floating type ``jnp`` computes an array of ``dtype`` in."""
    return dtype if dtype.is_floating_point else torch.float64 if dtype == torch.int64 else torch.float32


def _histogram(a: torch.Tensor, bins, range_, weights: Optional[torch.Tensor], density):
    """``jnp.histogram``: the input (and weights) in their common floating
    type, edges from a linspace over the range in that type, a value's
    bin by a right search over the edges, the last edge in the last bin,
    NaN in none."""
    dtype = _inexact(a.dtype)
    if weights is not None:
        weights = weights.to(a.device)
        dtype = torch.promote_types(dtype, _inexact(weights.dtype))
    a = a.reshape(-1).to(dtype)
    if np.ndim(bins) == 1:
        edges = torch.as_tensor(np.asarray(bins), device=a.device).to(dtype)
    else:
        if range_ is None:
            lo, hi = a.min(), a.max()
        else:
            lo, hi = (torch.tensor(float(v), dtype=torch.float64).to(dtype).to(a.device) for v in range_)
        if bool(lo == hi):
            lo, hi = lo - 0.5, hi + 0.5
        edges = factories._linspace_tensor(lo, hi, int(bins) + 1, dtype)
    nb = int(edges.shape[0])
    idx = torch.searchsorted(edges, a, right=True)
    idx = torch.where(a == edges[-1], nb - 1, idx)
    idx = torch.where(torch.isnan(a), nb, idx)
    w = torch.ones_like(a) if weights is None else weights.reshape(-1).to(dtype)
    counts = torch.zeros(nb + 1, dtype=dtype, device=a.device).index_add_(0, idx, w)[1:nb]
    if density:
        counts = counts / torch.diff(edges) / counts.sum()
    return counts, edges


def histogram(a: DNDarray, bins=10, range=None, normed=None, weights=None, density=None):
    """numpy-style histogram with ``jnp.histogram``'s binning:
    ``(counts, edges)``, replicated."""
    sanitize_in(a)
    w = weights.larray if isinstance(weights, DNDarray) else (
        None if weights is None else torch.as_tensor(np.asarray(weights)))
    hist, edges = _histogram(a.larray, bins, range, w, density)
    return (factories.array(hist, device=a.device, comm=a.comm),
            factories.array(edges, device=a.device, comm=a.comm))


def histc(input: DNDarray, bins: int = 100, min: float = 0.0, max: float = 0.0, out=None) -> DNDarray:
    """torch-style histogram over ``[min, max]`` (both 0: the data's range),
    binned as :func:`histogram`, in the input's type."""
    sanitize_in(input)
    arr = input.larray
    lo, hi = float(min), float(max)
    if lo == 0.0 and hi == 0.0:
        lo, hi = float(arr.min()), float(arr.max())
    hist, _ = _histogram(arr, bins, (lo, hi), None, None)
    result = factories.array(types._cast(hist, input.dtype.torch_type()), dtype=input.dtype,
                             device=input.device, comm=input.comm)
    if out is not None:
        out._rebind(result)
        return out
    return result


def _moments(x: DNDarray, axis, orders):
    """The float32 (float64 for float64 input) array, its size along the
    reduced axes, and its central moments of the given orders."""
    arr = x.larray.to(torch.float64 if x.dtype is types.float64 else torch.float32)
    dims = _operations._axes(arr.ndim, axis)
    diff = arr - torch.mean(arr, dim=dims, keepdim=True)
    n = arr.numel() if axis is None else arr.shape[axis]
    return n, [torch.mean(diff ** k, dim=dims) for k in orders]


def _kurtosis_program(x: DNDarray, axis, unbiased: bool, Fischer: bool) -> DNDarray:
    n, (m2, m4) = _moments(x, axis, (2, 4))
    g2 = m4 / torch.where(m2 == 0, torch.ones_like(m2), m2 ** 2)
    if unbiased:
        g2 = ((n - 1) / ((n - 2) * (n - 3))) * ((n + 1) * g2 - 3 * (n - 1)) + 3
    return _wrap_reduced(x, g2 - 3 if Fischer else g2, axis)


_fused_kurtosis = fuse(_kurtosis_program)


def kurtosis(x: DNDarray, axis=None, unbiased: bool = True, Fischer: bool = True) -> DNDarray:
    """Fourth standardized moment (minus 3 with ``Fischer``), with the
    unbiased correction by default: one fused program
    (:func:`heat_tpu_torch.fuse`) per (shape, axis, flags) signature."""
    sanitize_in(x)
    axis = sanitize_axis(x.shape, axis)
    return _fused_kurtosis(x, axis, unbiased, Fischer)


def _skew_program(x: DNDarray, axis, unbiased: bool) -> DNDarray:
    n, (m2, m3) = _moments(x, axis, (2, 3))
    g1 = m3 / torch.where(m2 == 0, torch.ones_like(m2), m2 ** 1.5)
    if unbiased and n > 2:
        g1 = g1 * math.sqrt(n * (n - 1.0)) / (n - 2.0)
    return _wrap_reduced(x, g1, axis)


_fused_skew = fuse(_skew_program)


def skew(x: DNDarray, axis=None, unbiased: bool = True) -> DNDarray:
    """Third standardized moment, with the unbiased correction by
    default: one fused program per (shape, axis, flags) signature."""
    sanitize_in(x)
    axis = sanitize_axis(x.shape, axis)
    return _fused_skew(x, axis, unbiased)


_METHODS = ("linear", "lower", "higher", "midpoint", "nearest")


def median(x: DNDarray, axis=None, keepdim=None, out=None, keepdims=None) -> DNDarray:
    """The 50th percentile.  The third positional parameter is ``keepdim``
    (the reference's signature): an output array there raises."""
    if isinstance(keepdim, DNDarray):
        raise TypeError(
            "median()'s third positional parameter is keepdim (reference "
            "signature); pass the output buffer as out=..."
        )
    return percentile(x, 50.0, axis=axis, out=out, keepdims=merge_keepdims(keepdims, keepdim))


def percentile(x: DNDarray, q, axis=None, out=None, interpolation: str = "linear", keepdims=None,
               keepdim=None) -> DNDarray:
    """The ``q``-th percentile(s) along ``axis``, numpy's methods.  A split
    array sorts over the positions: the ring rank sort for ``axis=None``,
    the distributed axis sort along the split axis; any other axis sorts
    locally.  Exact inputs interpolate in float64; an empty region gives
    NaN; a ``q`` array of any rank puts its axes first."""
    keepdims = merge_keepdims(keepdims, keepdim)
    sanitize_in(x)
    axis = sanitize_axis(x.shape, axis)
    if interpolation not in _METHODS:
        raise KeyError(interpolation)
    method = interpolation
    qa = torch.as_tensor(np.asarray(q, dtype=np.float64))
    exact = types.heat_type_is_exact(x.dtype)
    idt = torch.float64 if exact else x._buffer.dtype
    axes = _operations._axes(x.ndim, axis)
    from ..parallel import sort as _psort

    if (x.size == 0) if axis is None else any(x.shape[a] == 0 for a in axes):
        tail = tuple((1 if d in axes else s) for d, s in enumerate(x.shape) if keepdims or d not in axes)
        res = torch.full(tuple(qa.shape) + tail, float("nan"), dtype=idt, device=x._buffer.device)
    elif axis is None and x.split is not None and _psort.supports(x._buffer.dtype, x.size, x.comm):
        svals, _ = _psort.ring_rank_sort(x.larray.reshape(-1), x.size, comm=x.comm, want_indices=False)
        res = _interp_sorted(svals.to(idt), qa, method)
        if keepdims:
            res = res.reshape(tuple(qa.shape) + (1,) * x.ndim)
    elif (isinstance(axis, int) and axis == x.split
          and _psort.supports_axis(x._buffer.dtype, x.shape, axis, x.comm)):
        svals, _ = _psort.sort_axis0(x.larray.movedim(axis, 0), x.shape[axis], comm=x.comm, want_indices=False)
        res = _interp_sorted(svals.to(idt), qa, method)
        if keepdims:
            res = res.unsqueeze(qa.ndim + axis)
    else:
        arr = x.larray.to(torch.float64) if exact else x.larray
        res = _jnp_quantile(arr, (qa / 100.0).reshape(-1) if qa.ndim > 1 else qa / 100.0, axis, method, keepdims)
        if qa.ndim > 1:
            res = res.reshape(tuple(qa.shape) + tuple(res.shape[1:]))
    if qa.ndim == 0:
        result = _wrap_reduced(x, res, axis, keepdims)
    else:  # a q axis in front: replicated
        result = DNDarray(res, tuple(res.shape), types.canonical_heat_type(res.dtype), None, x.device, x.comm)
    if out is not None:
        out._rebind(result)
        return out
    return result


def _interp_sorted(svals: torch.Tensor, qa: torch.Tensor, method: str) -> torch.Tensor:
    """numpy-method percentile lookup on a tensor sorted along axis 0 (NaN
    last): shape ``qa.shape + svals.shape[1:]``.  The position q/100 (n -
    1) is host data, in float64; ``linear`` interpolates in ``svals``'
    type.  A NaN in a fiber (its last sorted value) makes its every
    quantile NaN."""
    n, batch = svals.shape[0], svals.ndim - 1
    pos = qa.numpy().astype(np.float64) / 100.0 * (n - 1)
    lo = np.clip(np.floor(pos).astype(np.int64), 0, n - 1)
    hi = np.clip(np.ceil(pos).astype(np.int64), 0, n - 1)
    dev = svals.device
    take = lambda i: svals[torch.as_tensor(i, device=dev)]  # noqa: E731
    vlo, vhi = take(lo), take(hi)
    if method == "lower":
        res = vlo
    elif method == "higher":
        res = vhi
    elif method == "nearest":
        res = take(np.clip(np.round(pos).astype(np.int64), 0, n - 1))
    elif method == "midpoint":
        res = (vlo + vhi) / 2.0
    else:
        frac = torch.as_tensor((pos - lo).reshape(pos.shape + (1,) * batch)).to(svals.dtype).to(dev)
        res = vlo * (1 - frac) + vhi * frac
    if svals.dtype.is_floating_point:
        res = torch.where(torch.isnan(svals[-1]), torch.full((), float("nan"), dtype=res.dtype, device=dev), res)
    return res


def _jnp_quantile(a: torch.Tensor, q: torch.Tensor, axis, method: str, keepdims: bool) -> torch.Tensor:
    """``jnp.quantile``'s formula (q in [0, 1], float64, rank <= 1): a fiber
    with a NaN is all NaN, the sorted fiber's neighbours at q (n - 1) are
    weighted in q's float64 and the result rounded to ``a``'s type."""
    out_keep = None
    if axis is None:
        if keepdims:
            out_keep = (1,) * a.ndim
        a, axis = a.reshape(-1), 0
    elif isinstance(axis, tuple):
        keep = [d for d in range(a.ndim) if d not in axis]
        out_keep = tuple(1 if d in axis else s for d, s in enumerate(a.shape)) if keepdims else None
        a = a.permute(keep + list(axis)).reshape(tuple(a.shape[d] for d in keep) + (-1,))
        axis, keepdims = a.ndim - 1, False
    nan = torch.isnan(a).any(dim=axis, keepdim=True)
    a = torch.where(nan, torch.full((), float("nan"), dtype=a.dtype, device=a.device), a)
    a = torch.sort(a, dim=axis)[0]
    n = a.shape[axis]
    qq = q.to(torch.float64).to(a.device) * (n - 1)
    low, high = torch.floor(qq), torch.ceil(qq)
    high_w = qq - low
    low_w = 1 - high_w
    low = low.clamp(0, n - 1).to(torch.int64)
    high = high.clamp(0, n - 1).to(torch.int64)

    def pick(i: torch.Tensor) -> torch.Tensor:
        v = torch.index_select(a, axis, i.reshape(-1))  # q along axis
        v = v.movedim(axis, 0).reshape(tuple(i.shape) + tuple(s for d, s in enumerate(a.shape) if d != axis))
        return v.unsqueeze(i.ndim + axis) if keepdims else v

    lv, hv = pick(low), pick(high)
    wshape = tuple(q.shape) + (1,) * (lv.ndim - q.ndim)
    if method == "linear":
        res = lv.to(torch.float64) * low_w.reshape(wshape) + hv.to(torch.float64) * high_w.reshape(wshape)
    elif method == "lower":
        res = lv
    elif method == "higher":
        res = hv
    elif method == "nearest":
        res = torch.where((high_w <= 0.5).reshape(wshape), lv, hv)
    else:
        res = (lv + hv) * 0.5
    if out_keep is not None:
        res = res.reshape(tuple(q.shape) + out_keep)
    return res.to(a.dtype)


# split semantics (see core/_split_semantics.py); the table stays a literal dict
from ._split_semantics import declare_split_semantics_table  # noqa: E402

declare_split_semantics_table(
    __name__,
    {
        "reduction": (
            "argmax", "argmin", "max", "mean", "median", "min", "std",
            "var", "kurtosis", "skew",
        ),
        "binary": ("maximum", "minimum"),
    },
)
