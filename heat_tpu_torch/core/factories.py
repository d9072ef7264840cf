"""Array constructors: ``array``, ``arange``, ``zeros``, ``ones``, ``full``.

Port of ``heat_tpu/core/factories.py``.  Python scalars and lists default
to 32-bit types (int32 / float32) unless their values need 64 bits; numpy
arrays and tensors keep their dtype.  The data lands on the
communicator's device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import devices, types
from .communication import TorchCommunication, comm_for_device, get_comm, sanitize_comm
from .dndarray import DNDarray
from .sanitation import sanitize_axis

__all__ = ["arange", "array", "full", "ones", "zeros"]


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


def _wrap(garr: torch.Tensor, dtype, split, device, comm) -> DNDarray:
    split = sanitize_axis(tuple(garr.shape), split)
    return DNDarray(garr, tuple(garr.shape), dtype, split, device, comm)


def _host_dtype(obj, host: np.ndarray):
    """32-bit default for python scalars and lists, unless the values
    need 64 bits."""
    if host.dtype == np.int64:
        if host.size and (host.min() < -(2**31) or host.max() >= 2**31):
            return types.int64
        return types.int32
    if host.dtype == np.float64:
        finite = host[np.isfinite(host)]
        if finite.size and np.max(np.abs(finite)) > np.finfo(np.float32).max:
            return types.float64
        return types.float32
    return types.canonical_heat_type(host.dtype)


def array(
    obj,
    dtype=None,
    copy: bool = True,
    ndmin: int = 0,
    split: Optional[int] = None,
    is_split: Optional[int] = None,
    device=None,
    comm=None,
) -> DNDarray:
    """The master constructor.  ``split`` lays a global array out along an
    axis; ``is_split`` declares ``obj`` a sequence of per-position pieces
    to concatenate along that axis."""
    if split is not None and is_split is not None:
        raise ValueError("split and is_split are mutually exclusive parameters")
    device, comm = _setup(device, comm)
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
        if split is None and is_split is None:
            split = obj.split
        inferred = obj.dtype
    elif isinstance(obj, torch.Tensor):
        garr = obj
        inferred = types.canonical_heat_type(obj.dtype)
    elif isinstance(obj, np.ndarray):
        host = np.ascontiguousarray(obj)
        if not host.flags.writeable:
            host = host.copy()
        garr = torch.from_numpy(host)
        inferred = types.canonical_heat_type(obj.dtype)
    else:
        host = np.array(obj)
        inferred = _host_dtype(obj, host)
        garr = torch.from_numpy(host)

    dtype = inferred if dtype is None else types.canonical_heat_type(dtype)
    was = garr
    garr = garr.to(device=target, dtype=dtype.torch_type())
    if copy and garr.data_ptr() == was.data_ptr():
        garr = garr.clone()
    garr = garr.contiguous()

    if not isinstance(ndmin, (int, np.integer)) or isinstance(ndmin, bool):
        raise TypeError(f"expected ndmin to be int, but was {type(ndmin)}")
    extra = abs(int(ndmin)) - garr.ndim
    if extra > 0:
        garr = garr.reshape((1,) * extra + tuple(garr.shape))
    return _wrap(garr, dtype, split, device, comm)


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


def _sanitize_shape(shape) -> Tuple[int, ...]:
    shape = (shape,) if isinstance(shape, (int, np.integer)) else tuple(shape)
    if any(int(s) < 0 for s in shape):
        raise ValueError(f"negative dimensions are not allowed: {shape}")
    return tuple(int(s) for s in shape)


def _factory(shape, fill, dtype, split, device, comm) -> DNDarray:
    shape = _sanitize_shape(shape)
    dtype = types.canonical_heat_type(dtype)
    device, comm = _setup(device, comm)
    garr = torch.full(shape, fill, dtype=dtype.torch_type(), device=comm.device)
    return _wrap(garr, dtype, split, device, comm)


def zeros(shape, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Array of zeros."""
    return _factory(shape, 0, dtype, split, device, comm)


def ones(shape, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Array of ones."""
    return _factory(shape, 1, dtype, split, device, comm)


def full(shape, fill_value, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Constant-filled array."""
    return _factory(shape, fill_value, dtype, split, device, comm)
