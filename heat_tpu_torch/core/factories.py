"""Array constructors: ``array``, ``asarray``, ``arange``, ``empty``,
``zeros``, ``ones``, ``full``, their ``*_like`` forms, ``eye``,
``linspace`` and ``logspace``.

Port of ``heat_tpu/core/factories.py``.  Python scalars and lists default
to 32-bit types (int32 / float32) unless their values need 64 bits; numpy
arrays and tensors keep their dtype.  The data lands on the
communicator's device.  ``order`` is validated and the buffer stays
C-contiguous, as in the reference.  ``splits=`` (on ``array``, ``empty``,
``zeros``, ``ones``, ``full`` and ``eye``) is the grid spelling of the
layout: a tuple naming the mesh axis that shards each dimension, e.g.
``splits=(0, 1)`` on a :func:`~.communication.grid_comm` shards both
dimensions of a matrix; ``split`` and ``splits`` are mutually exclusive.

``linspace`` evaluates the reference's formula in float64 (``start * (1 -
i/d) + stop * i/d``, then ``stop``) as its compiled program does, fused
multiply-adds included (:func:`_linspace_grid`), and rounds once into the
target type: float32 grids are the reference's bit for bit, on the CPU
and on the card, and float64 grids at all but a few points.
``logspace`` raises ``base`` to that float32 grid in float64 and rounds
once, which gives the correctly rounded float32 power unless the float64
power lies within its own error of a float32 rounding tie (the
reference's float32 ``pow`` is the host libm's ``powf``, one ulp off at
about 1 point in 2 000).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import devices, types
from .communication import TorchCommunication, comm_for_device, get_comm, sanitize_comm
from .dndarray import DNDarray
from .memory import sanitize_memory_layout
from .stride_tricks import sanitize_axis, sanitize_shape

__all__ = [
    "arange",
    "array",
    "asarray",
    "empty",
    "empty_like",
    "eye",
    "full",
    "full_like",
    "linspace",
    "logspace",
    "ones",
    "ones_like",
    "zeros",
    "zeros_like",
]


def _setup(device, comm) -> Tuple[devices.Device, TorchCommunication]:
    """Resolve ``(device, comm)``: an explicit communicator fixes the
    device; an explicit device picks the default communicator when it lives
    there, else that device's own; neither means the default communicator."""
    if comm is not None:
        comm = sanitize_comm(comm)
        dev = devices.sanitize_device(comm.device)
        if device is not None and devices.sanitize_device(device) is not dev:
            raise ValueError(f"device {device} does not match the communicator's {comm.device}")
        return dev, comm
    if device is None:
        comm = get_comm()
        return devices.sanitize_device(comm.device), comm
    device = devices.sanitize_device(device)
    from . import communication

    dc = communication._default_comm
    if dc is not None and devices.sanitize_device(dc.device) is device:
        return device, dc
    return device, comm_for_device(device)


def _resolve_layout(shape, split, splits, comm):
    """One layout from the two spellings: ``splits`` (a mesh-axis tuple,
    checked against the communicator's mesh) or the ``split`` int (a
    tuple given as ``split`` counts as ``splits``)."""
    if splits is not None:
        if split is not None:
            raise ValueError("split and splits are mutually exclusive parameters")
        return comm.normalize_splits(len(tuple(shape)), splits)
    if isinstance(split, (tuple, list)):
        return comm.normalize_splits(len(tuple(shape)), split)
    return sanitize_axis(tuple(shape), split)


def _wrap(garr: torch.Tensor, dtype, split, device, comm, splits=None) -> DNDarray:
    layout = _resolve_layout(tuple(garr.shape), split, splits, comm)
    return DNDarray(garr, tuple(garr.shape), dtype, layout if garr.ndim else None, device, comm)


def array(
    obj,
    dtype=None,
    copy: bool = True,
    ndmin: int = 0,
    order: str = "C",
    split: Optional[int] = None,
    is_split: Optional[int] = None,
    device=None,
    comm=None,
    splits=None,
) -> DNDarray:
    """The master constructor.  ``split`` lays a global array out along an
    axis; ``is_split`` declares ``obj`` a sequence of per-position pieces
    to concatenate along that axis; ``splits`` is a grid layout.  A
    DNDarray on the same communicator keeps its whole layout, one from
    another communicator its ``split``."""
    if split is not None and is_split is not None:
        raise ValueError("split and is_split are mutually exclusive parameters")
    if splits is not None and (split is not None or is_split is not None):
        raise ValueError("splits is mutually exclusive with split/is_split")
    device, comm = _setup(device, comm)
    sanitize_memory_layout(None, order)
    target = comm.device

    if is_split is not None:
        if isinstance(obj, (list, tuple)) and all(
            isinstance(p, (DNDarray, np.ndarray, torch.Tensor)) for p in obj
        ):
            pieces = [
                p.larray if isinstance(p, DNDarray) else torch.as_tensor(p) for p in obj
            ]
            obj = torch.cat([p.to(target) for p in pieces], dim=is_split)
        split = is_split

    if isinstance(obj, DNDarray):
        garr = obj.larray
        if split is None and is_split is None and splits is None:
            split = obj._layout if obj.comm == comm else obj.split
        inferred = obj.dtype
    elif isinstance(obj, torch.Tensor):
        garr = obj
        inferred = types.canonical_heat_type(obj.dtype)
    elif isinstance(obj, np.ndarray):
        # np.ascontiguousarray would make a 0-d array 1-d
        host = obj if obj.flags.c_contiguous else np.ascontiguousarray(obj)
        if not host.flags.writeable:
            host = host.copy()
        garr = torch.from_numpy(host)
        inferred = types.canonical_heat_type(obj.dtype)
    else:
        host = np.array(obj)
        inferred = types.canonical_heat_type(host.dtype)
        if host.dtype in (np.int64, np.float64):
            seq = obj if isinstance(obj, (list, tuple)) else [obj]
            inferred = types._infer_list_type(seq, np.atleast_1d(host))
        garr = torch.from_numpy(host)

    dtype = inferred if dtype is None else types.canonical_heat_type(dtype)
    was = garr
    garr = types._cast(garr.to(device=target), dtype.torch_type())
    if copy and garr.data_ptr() == was.data_ptr():
        garr = garr.clone()
    garr = garr.contiguous()

    if not isinstance(ndmin, (int, np.integer)) or isinstance(ndmin, bool):
        raise TypeError(f"expected ndmin to be int, but was {type(ndmin)}")
    extra = abs(int(ndmin)) - garr.ndim
    if extra > 0:
        garr = garr.reshape((1,) * extra + tuple(garr.shape))
    return _wrap(garr, dtype, split, device, comm, splits)


def arange(*args, dtype=None, split=None, device=None, comm=None) -> DNDarray:
    """Evenly spaced values in [start, stop).  int32 for integer
    arguments, float32 otherwise."""
    if len(args) == 1:
        start, stop, step = 0, args[0], 1
    elif len(args) == 2:
        start, stop, step = args[0], args[1], 1
    elif len(args) == 3:
        start, stop, step = args
    else:
        raise TypeError(
            f"function takes minimum one and at most 3 positional arguments ({len(args)} given)"
        )
    device, comm = _setup(device, comm)
    all_int = all(isinstance(a, (int, np.integer)) for a in (start, stop, step))
    if dtype is None:
        dtype = types.int32 if all_int else types.float32
    dtype = types.canonical_heat_type(dtype)
    garr = torch.arange(start, stop, step, dtype=dtype.torch_type(), device=comm.device)
    return _wrap(garr, dtype, split, device, comm)


def asarray(obj, dtype=None, order="C", is_split=None, device=None) -> DNDarray:
    """``array`` without a copy: a DNDarray of the asked type comes back
    as it is."""
    sanitize_memory_layout(None, order)
    if (
        isinstance(obj, DNDarray)
        and is_split is None
        and (dtype is None or obj.dtype is types.canonical_heat_type(dtype))
    ):
        return obj
    return array(obj, dtype=dtype, copy=False, is_split=is_split, device=device)


def _factory(shape, fill, dtype, split, device, comm, order="C", splits=None) -> DNDarray:
    shape = sanitize_shape(shape)
    dtype = types.canonical_heat_type(dtype)
    device, comm = _setup(device, comm)
    layout = _resolve_layout(shape, split, splits, comm)
    sanitize_memory_layout(None, order)
    fill = types._cast_scalar(fill, dtype.torch_type())
    garr = torch.full(shape, fill, dtype=dtype.torch_type(), device=comm.device)
    return _wrap(garr, dtype, layout, device, comm)


def empty(shape, dtype=types.float32, split=None, device=None, comm=None, order="C", splits=None) -> DNDarray:
    """An array of the shape; its values are zeros, as the reference's."""
    return _factory(shape, 0, dtype, split, device, comm, order, splits)


def zeros(shape, dtype=types.float32, split=None, device=None, comm=None, order="C", splits=None) -> DNDarray:
    """Array of zeros."""
    return _factory(shape, 0, dtype, split, device, comm, order, splits)


def ones(shape, dtype=types.float32, split=None, device=None, comm=None, order="C", splits=None) -> DNDarray:
    """Array of ones."""
    return _factory(shape, 1, dtype, split, device, comm, order, splits)


def full(
    shape, fill_value, dtype=types.float32, split=None, device=None, comm=None, order="C", splits=None
) -> DNDarray:
    """Constant-filled array."""
    return _factory(shape, fill_value, dtype, split, device, comm, order, splits)


def _factory_like(a, dtype, split, factory, device, comm, order="C", **kwargs) -> DNDarray:
    """``factory`` at ``a``'s shape; type, split, device and communicator
    default to ``a``'s when it is a DNDarray (the type to
    ``heat_type_of(a)`` otherwise)."""
    shape = a.shape if hasattr(a, "shape") else np.asarray(a).shape
    if dtype is None:
        dtype = a.dtype if isinstance(a, DNDarray) else types.heat_type_of(a)
    if isinstance(a, DNDarray):
        split = a.split if split is None else split
        device = a.device if device is None else device
        comm = a.comm if comm is None and devices.sanitize_device(device) is a.device else comm
    return factory(shape, dtype=dtype, split=split, device=device, comm=comm, order=order, **kwargs)


def empty_like(a, dtype=None, split=None, device=None, comm=None, order="C") -> DNDarray:
    """:func:`empty` at ``a``'s shape."""
    return _factory_like(a, dtype, split, empty, device, comm, order)


def zeros_like(a, dtype=None, split=None, device=None, comm=None, order="C") -> DNDarray:
    """:func:`zeros` at ``a``'s shape."""
    return _factory_like(a, dtype, split, zeros, device, comm, order)


def ones_like(a, dtype=None, split=None, device=None, comm=None, order="C") -> DNDarray:
    """:func:`ones` at ``a``'s shape."""
    return _factory_like(a, dtype, split, ones, device, comm, order)


def full_like(a, fill_value, dtype=types.float32, split=None, device=None, comm=None, order="C") -> DNDarray:
    """:func:`full` at ``a``'s shape (float32 unless ``dtype`` says
    otherwise, as the reference's)."""
    return _factory_like(a, dtype, split, full, device, comm, order, fill_value=fill_value)


def eye(shape, dtype=types.float32, split=None, device=None, comm=None, order="C", splits=None) -> DNDarray:
    """Ones on the main diagonal of an ``n x n`` (an int) or ``n x m``
    matrix, zeros elsewhere."""
    sanitize_memory_layout(None, order)
    if isinstance(shape, (int, np.integer)):
        gshape = (int(shape), int(shape))
    else:
        shape = sanitize_shape(shape)
        gshape = (shape[0], shape[1] if len(shape) > 1 else shape[0])
    dtype = types.canonical_heat_type(dtype)
    device, comm = _setup(device, comm)
    layout = _resolve_layout(gshape, split, splits, comm)
    garr = torch.eye(gshape[0], gshape[1], dtype=dtype.torch_type(), device=comm.device)
    return _wrap(garr, dtype, layout, device, comm)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` in float64 with one rounding, from float64 operations
    alone (Veltkamp's split, Dekker's product, Knuth's sum), so the CPU
    and the card round alike."""
    p = a * b

    def split(x):
        t = 134217729.0 * x  # 2**27 + 1
        hi = t - (t - x)
        return hi, x - hi

    ah, al = split(a)
    bh, bl = split(b if isinstance(b, torch.Tensor) else torch.full_like(a, b))
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    bb = s - p
    return s + (((p - (s - bb)) + (c - bb)) + e)


#: the reference's compiled float64 grid: XLA folds ``i / d`` into ``i *
#: fl(1/d)`` and ``stop * i/d`` into ``i * fl(stop/d)``; LLVM then
#: contracts the final sum into an FMA and, in its vectorized loop (grids
#: of more than this many steps, whole vectors of 16), ``1 - i * r`` too.
#: Both matter: ``start * (1 - i/d) + stop * i/d`` rounded once to float32
#: is one ulp off at a point of 5 of the 24 float32 grids of the tests;
#: the final FMA alone gets those right, but float16 and int32 grids of
#: 1 001 and 500 000 points and ~30 % of float64 points still differ
_LINSPACE_UNROLLED, _LINSPACE_VECTOR = 172, 16
#: the same program computed in float32 (``jnp.linspace(..., dtype=float32)``,
#: ``jnp.histogram``'s edges) runs vectors of 32 past 351 steps
_LINSPACE32_UNROLLED, _LINSPACE32_VECTOR = 351, 32
#: with bounds that are not compile-time constants (``jnp.histogram``'s
#: edges), grids of at most this many steps contract the other product of
#: the sum at ``i = 1``: ``fma(start, t, stop * r)``.  Bitwise, in float32
#: and float64, at 300-400 random grids of 2 to 700 points against the
#: reference's on the CPU
_LINSPACE_TRACED_SMALL = 33


def _linspace_grid(start, stop, div: int, device, dtype=torch.float64, traced: bool = False) -> torch.Tensor:
    """``start * (1 - i/div) + stop * i/div`` for ``i < div`` as the
    reference's compiled program evaluates it in ``dtype``, returned in
    float64.  ``start`` and ``stop`` are floats or 0-d tensors; ``traced``
    bounds are not compile-time constants there.  A narrower ``dtype``
    rounds each operation's float64 result to it (float64 carries twice
    its digits and more, so each basic operation rounds as in ``dtype``
    itself)."""
    wide = dtype == torch.float64
    rnd = (lambda t: t) if wide else (lambda t: t.to(dtype).to(torch.float64))  # noqa: E731
    unrolled, vector = (_LINSPACE_UNROLLED, _LINSPACE_VECTOR) if wide else (_LINSPACE32_UNROLLED, _LINSPACE32_VECTOR)
    i = torch.arange(div, dtype=torch.float64, device=device)
    r = rnd(torch.tensor(1.0 / div, dtype=torch.float64, device=device))
    t = rnd(1.0 - rnd(i * r))
    if div > unrolled:
        body = div - div % vector
        t = torch.where(i < body, rnd(_fma(-i, r, 1.0)), t)
    sr, st = rnd(stop * r), rnd(start * t)
    out = rnd(_fma(i, sr, st))
    if traced and 1 < div <= _LINSPACE_TRACED_SMALL:
        out[1] = rnd(_fma(torch.as_tensor(start, dtype=torch.float64).reshape(1), t[1:2], sr))[0]
    return out


def _linspace_tensor(start: torch.Tensor, stop: torch.Tensor, num: int, dtype: torch.dtype) -> torch.Tensor:
    """``jnp.linspace(start, stop, num, dtype=dtype)`` for 0-d tensor
    bounds, computed in ``dtype`` (what ``jnp.histogram``'s edges are)."""
    start, stop = start.to(torch.float64), stop.to(torch.float64)
    if num == 1:
        return start.reshape(1).to(dtype)
    grid = _linspace_grid(start, stop, num - 1, start.device, dtype, traced=True)
    return torch.cat([grid, stop.reshape(1)]).to(dtype)


def linspace(
    start,
    stop,
    num: int = 50,
    endpoint: bool = True,
    retstep: bool = False,
    dtype=None,
    split=None,
    device=None,
    comm=None,
):
    """``num`` evenly spaced samples over ``[start, stop]`` (``[start,
    stop)`` without the endpoint); with ``retstep``, also the spacing."""
    num = int(num)
    if num <= 0:
        raise ValueError(f"number of samples 'num' must be non-negative, but was {num}")
    device, comm = _setup(device, comm)
    start_f, stop_f = float(start), float(stop)
    step = (stop_f - start_f) / max(num - (1 if endpoint else 0), 1)
    f64 = dict(dtype=torch.float64, device=comm.device)
    if num > 1:
        garr = _linspace_grid(start_f, stop_f, num - 1 if endpoint else num, comm.device)
        if endpoint:
            garr = torch.cat([garr, torch.full((1,), stop_f, **f64)])
    else:
        garr = torch.full((1,), start_f, **f64)
    dtype = types.canonical_heat_type(dtype) if dtype is not None else types.float32
    ht = _wrap(types._cast(garr, dtype.torch_type()), dtype, split, device, comm)
    return (ht, step) if retstep else ht


def logspace(
    start,
    stop,
    num: int = 50,
    endpoint: bool = True,
    base: float = 10.0,
    dtype=None,
    split=None,
    device=None,
    comm=None,
) -> DNDarray:
    """``num`` samples ``base ** linspace(start, stop, num)``: float32
    unless ``dtype`` says otherwise."""
    y = linspace(start, stop, num=num, endpoint=endpoint, split=split, device=device, comm=comm)
    garr = torch.pow(float(base), y.larray.to(torch.float64)).to(torch.float32)
    result = DNDarray(garr, y.gshape, types.float32, y.split, y.device, y.comm)
    return result if dtype is None else result.astype(types.canonical_heat_type(dtype))


# split semantics (see core/_split_semantics.py); the table stays a literal dict
from ._split_semantics import declare_split_semantics_table  # noqa: E402

declare_split_semantics_table(
    __name__,
    {
        "factory": (
            "array", "arange", "empty", "zeros", "ones", "full", "eye",
            "linspace", "logspace",
        ),
        "factory_like": ("empty_like", "zeros_like", "ones_like", "full_like"),
    },
)
