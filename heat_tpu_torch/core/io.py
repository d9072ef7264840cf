"""Parallel IO: HDF5, NetCDF-3, CSV.

Port of ``heat_tpu/core/io.py``.  A sharded load reads each position's
slab of the file once, straight into that position's rows of the padded
device buffer (pad rows zero); a save writes the array one position's
slab at a time, so host memory holds one slab.  Every save stages into a
temporary file in the target's directory and publishes it with
:func:`os.replace` after a clean close: a crash (or an injected
preemption) mid-save leaves the previous file byte-identical.

Backends: ``h5py`` for HDF5 (optional, as in the reference), and scipy's
classic NetCDF-3 reader and writer for NetCDF (``netCDF4`` is not used;
NetCDF-4 files are out of reach).  CSV parses on the native threaded
scanner (:mod:`heat_tpu_torch.native`), with numpy as the fallback.

The file opens run under the bounded, seeded io retry policy with the
``io_open`` fault seam in front of them; loads credit ``io:read`` and
``io:h2d`` spans and ``account_bytes("io", ...)`` while telemetry is on.
Across processes (:func:`heat_tpu_torch.init_multihost`) a load reads
each process's own positions' slabs into its slab, and a save has one
writer, process 0, which fetches every other process's rows one process
at a time; the writer's outcome is gathered, so a failed save raises on
every process (the reference's failure flag), and every process may read
the file once the save returns.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

import numpy as np
import torch

from ..telemetry import _core as _tel
from . import _xproc, factories, types
from .dndarray import DNDarray
from .stride_tricks import sanitize_axis

try:
    import h5py
except ImportError:
    h5py = None

try:
    # scipy's NetCDF-3 reader/writer (classic format: no groups, no
    # 64-bit integer variables)
    from scipy.io import netcdf_file as _scipy_nc
except ImportError:
    _scipy_nc = None

__all__ = [
    "load",
    "load_csv",
    "load_hdf5",
    "load_netcdf",
    "save",
    "save_csv",
    "save_hdf5",
    "save_netcdf",
    "supports_hdf5",
    "supports_netcdf",
]

__HDF5_EXTENSIONS = frozenset([".h5", ".hdf5"])
#: public alias: estimator checkpointing shares the routing table
HDF5_EXTENSIONS = __HDF5_EXTENSIONS
__NETCDF_EXTENSIONS = frozenset([".nc", ".nc4", ".netcdf"])
__CSV_EXTENSIONS = frozenset([".csv", ".txt"])


def supports_hdf5() -> bool:
    """True when h5py is importable."""
    return h5py is not None


def supports_netcdf() -> bool:
    """True when a NetCDF backend (scipy's NetCDF-3) is importable."""
    return _scipy_nc is not None


def _np_dtype(hdtype) -> np.dtype:
    """The host dtype of a heat type (bfloat16, which numpy lacks, as
    float32: an exact widening)."""
    return np.dtype(hdtype._np_type if hdtype._np_type is not None else np.float32)


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _faults():
    """Lazy import of the fault seams (the resilience package imports
    this module: the dependency stays one-way at import time)."""
    from ..resilience import faults

    return faults


def _retry_open(fn, site: str):
    """Run a file-open probe under the bounded, seeded io retry policy: a
    transient ``OSError`` (a flaky filesystem, an injected ``io_error``
    fault) heals on retry with every attempt incident-logged and counted;
    only an exhausted policy propagates."""
    from ..resilience import retry as _r

    return _r.call(fn, policy=_r.IO_POLICY, site=site)


def _named_member(path: str, mapping, name: str, kind: str):
    """Look up ``name`` in a file's member ``mapping`` (an h5py File, the
    NetCDF ``.variables``), naming both the file and the missing member on
    failure."""
    try:
        return mapping[name]
    except KeyError:
        try:
            available = ", ".join(sorted(map(str, mapping.keys()))) or "<none>"
        except Exception:  # noqa: BLE001 — the lookup error is the story
            available = "<unknown>"
        raise ValueError(
            f"{path}: no {kind} named {name!r} (available: {available})"
        ) from None


# --------------------------------------------------------------------- #
# atomic writes                                                          #
# --------------------------------------------------------------------- #
def _atomic_begin(path: str, mode: str = "w") -> str:
    """Start an atomic write of ``path``: the temporary path to write to,
    in the target's directory so :func:`os.replace` stays a rename.
    Append modes copy the existing file in first."""
    tmp = f"{path}.tmp-{os.getpid()}"
    if mode not in ("w", "w-") and os.path.exists(path):
        shutil.copyfile(path, tmp)
    return tmp


def _atomic_commit(tmp: str, path: str) -> None:
    """Publish a finished atomic write (rename over the target)."""
    os.replace(tmp, path)


def _atomic_abort(tmp: Optional[str]) -> None:
    """Discard a failed atomic write; the target was never touched."""
    if tmp is not None:
        try:
            os.remove(tmp)
        except OSError:
            pass


def _sharded_from_reader(shape, hdtype, split, device, comm, read_slices) -> DNDarray:
    """A DNDarray built by reading each position's slab of the file once
    into that position's rows of the padded buffer on the device (pad
    rows zero); one read of the whole file when nothing is split or there
    is one position."""
    device, comm = factories._setup(device, comm)
    shape = tuple(int(s) for s in shape)
    split = sanitize_axis(shape, split)
    hdtype = types.canonical_heat_type(hdtype)
    tdtype = hdtype.torch_type()
    target = comm.device
    total_bytes = int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=tdtype).element_size()

    def _read(index, sharded):
        if not _tel.enabled:
            return np.asarray(read_slices(index))
        with _tel.span("io:read", sharded=sharded):
            block = np.asarray(read_slices(index))
        _tel.account_bytes("io", "read", block.nbytes, block.nbytes)
        return block

    def _tensor(block):
        return torch.from_numpy(np.ascontiguousarray(block)).to(tdtype)

    # across processes each process reads its own positions' slabs into
    # its slab of the buffer
    first, local = comm.local_position(), comm.local_size
    slab = comm.spans_processes and split is not None

    def _commit():
        if split is None or comm.size == 1:
            return _tensor(_read(tuple(slice(None) for _ in shape), False)).to(target)
        padded = list(shape)
        padded[split] = comm.padded_size(shape[split]) // comm.nprocs
        offset = first * comm.shard_width(shape[split]) if slab else 0
        buf = torch.zeros(padded, dtype=tdtype, device=target)
        for r in range(first, first + local):
            _, _, slices = comm.chunk(shape, split, rank=r)
            if any(s.stop <= s.start for s in slices):
                continue
            into = tuple(slice(s.start - offset, s.stop - offset) if d == split else s
                         for d, s in enumerate(slices))
            buf[into].copy_(_tensor(_read(slices, True)))
        return buf

    if _tel.enabled:
        with _tel.span("io:h2d", bytes=total_bytes):
            garr = _commit()
        _tel.account_bytes("io", "h2d", total_bytes, total_bytes)
    else:
        garr = _commit()
    return DNDarray(garr, shape, hdtype, split, device, comm, slab=slab)


def load_hdf5(
    path: str,
    dataset: str,
    dtype=types.float32,
    split: Optional[int] = None,
    device=None,
    comm=None,
) -> DNDarray:
    """Load an HDF5 dataset with one slab read a position."""
    if not supports_hdf5():
        raise RuntimeError("h5py is required for HDF5 support")
    if not isinstance(path, str):
        raise TypeError(f"path must be str, not {type(path)}")
    if not isinstance(dataset, str):
        raise TypeError(f"dataset must be str, not {type(dataset)}")
    dtype = types.canonical_heat_type(dtype)

    def _probe():
        _faults().io_open(path)
        with h5py.File(path, "r") as handle:
            return tuple(_named_member(path, handle, dataset, "dataset").shape)

    gshape = _retry_open(_probe, "io.load_hdf5")
    np_dtype = _np_dtype(dtype)

    def read_slices(index):
        with h5py.File(path, "r") as f:
            return np.asarray(f[dataset][index], dtype=np_dtype)

    return _sharded_from_reader(gshape, dtype, split, device, comm, read_slices)


def _emit_slabs(data, write):
    """Feed host slabs of ``data`` (a DNDarray, or a host array written
    whole, as a replicated one) to ``write(slices, block)`` one position
    at a time (host memory holds one slab).  A ``write`` failure is
    returned, not raised, for the caller to raise after closing the file.
    The ``save-slab`` preemption seam sits before each write.

    Across processes process 0 writes (``write`` is None elsewhere) and
    fetches every other process's true rows, one process at a time; every
    process calls this, each sending its rows once."""
    if isinstance(data, DNDarray) and data._slabbed:
        return _xp_emit_slabs(data, write)
    if write is None:  # not the writer: a whole array is written by process 0
        return None
    if isinstance(data, np.ndarray) or data.split is None:
        block = data if isinstance(data, np.ndarray) else _host(data.larray)
        try:
            _faults().preempt_point("save-slab")
            write(tuple(slice(0, s) for s in data.shape), block)
        except Exception as e:  # noqa: BLE001 — deferred to the caller
            return e
        return None
    for r in range(data.comm.size):
        _, _, slices = data.comm.chunk(data.shape, data.split, rank=r)
        if any(s.stop <= s.start for s in slices):
            continue
        try:
            _faults().preempt_point("save-slab")
            write(slices, _host(data.larray[slices]))
        except Exception as e:  # noqa: BLE001 — deferred to the caller
            return e
    return None


def _xp_emit_slabs(data: DNDarray, write):
    """:func:`_emit_slabs` of a slab array across processes."""
    comm, split = data.comm, data.split
    n, err = data.shape[split], None
    for k in range(comm.nprocs):
        a, b = comm.process_rows(n, k)
        if b <= a:
            continue
        if comm.rank == k and k != 0:
            _xproc.exchange({0: data._local}, {}, data._local.device)
            continue
        if comm.rank != 0:
            continue
        if k == 0:
            block = data._local
        else:
            shape = list(data.shape)
            shape[split] = b - a
            block = _xproc.exchange({}, {k: (shape, data._local.dtype)}, data._local.device)[k]
        if write is None or err is not None:
            continue
        slices = tuple(slice(a, b) if d == split else slice(0, s) for d, s in enumerate(data.shape))
        try:
            _faults().preempt_point("save-slab")
            write(slices, _host(block))
        except Exception as e:  # noqa: BLE001 — deferred to the caller
            err = e
    return err


def _xp_raise(err: Optional[BaseException], path: str) -> None:
    """Across processes: the writer's outcome on every process, so a
    failed save raises everywhere (the reference's gathered failure
    flag); also the point after which every process may read the file."""
    said = _xproc.all_gather_object(None if err is None else f"{type(err).__name__}: {err}")
    if err is not None:
        raise err
    failed = [m for m in said if m is not None]
    if failed:
        raise OSError(f"saving {path} failed on the writer (process 0): {failed[0]}")


def _writer_save(data: DNDarray, prepare, path: str, mode: str = "w") -> None:
    """Save through ``prepare(target) -> (write, close)`` on a staged
    temporary file, committed over ``path`` only after a clean close; on
    any error the temporary is discarded and the previous file survives.
    Across processes process 0 is the only writer, and its failure raises
    on every process."""
    across = data.comm.spans_processes
    writer = not across or data.comm.rank == 0
    err, close, tmp, write = None, None, None, None
    try:
        if writer:
            _faults().io_open(path)
            tmp = _atomic_begin(path, mode)
            write, close = prepare(tmp)
    except Exception as e:  # noqa: BLE001
        err = e
    if err is None or across:
        try:
            err = _emit_slabs(data, write if err is None else None) or err
        except Exception as e:  # noqa: BLE001
            err = err or e
    if close is not None:
        try:
            close()
        except Exception as e:  # noqa: BLE001
            err = err or e
    if tmp is not None:
        if err is None:
            try:
                _atomic_commit(tmp, path)
            except Exception as e:  # noqa: BLE001
                err = e
        else:
            _atomic_abort(tmp)
    if across:
        _xp_raise(err, path)
    if err is not None:
        raise err


def _save_hdf5_many(path: str, datasets, attrs=None, mode: str = "w") -> None:
    """Write several datasets, in the order given as ``(key, array)``
    pairs (a DNDarray, or a host array written as a replicated one), plus
    file attributes in one file open and one atomic commit (shared by the
    estimator checkpoints and the loop snapshots).  Across processes
    process 0 writes every dataset and the attributes in one pass, and
    its failure raises on every process."""
    datasets = list(datasets)
    across = any(isinstance(a, DNDarray) and a.comm.spans_processes for _, a in datasets)
    writer = not across or _xproc.group_rank() == 0
    err, f, tmp = None, None, None
    try:
        if writer:
            _faults().io_open(path)
            tmp = _atomic_begin(path, mode)
            f = h5py.File(tmp, mode)
    except Exception as e:  # noqa: BLE001
        err = e
    try:
        for key, arr in datasets:
            write = None
            if f is not None and err is None:
                dtype = arr.dtype if isinstance(arr, np.ndarray) else _np_dtype(arr.dtype)
                write = f.create_dataset(key, arr.shape, dtype=dtype).__setitem__
            if write is None and not across:
                break
            err = _emit_slabs(arr, write) or err
            if err is not None and not across:
                break
        if err is None and attrs and f is not None:
            for k, v in attrs.items():
                f.attrs[k] = v
    except Exception as e:  # noqa: BLE001
        err = err or e
    if f is not None:
        try:
            f.close()
        except Exception as e:  # noqa: BLE001
            err = err or e
    if tmp is not None:
        if err is None:
            try:
                _atomic_commit(tmp, path)
            except Exception as e:  # noqa: BLE001
                err = e
        else:
            _atomic_abort(tmp)
    if across:
        _xp_raise(err, path)
    if err is not None:
        raise err


def save_hdf5(data: DNDarray, path: str, dataset: str, mode: str = "w", **kwargs) -> None:
    """Save to HDF5, one position's slab at a time."""
    if not supports_hdf5():
        raise RuntimeError("h5py is required for HDF5 support")
    if not isinstance(data, DNDarray):
        raise TypeError(f"data must be a DNDarray, not {type(data)}")
    if not isinstance(path, str):
        raise TypeError(f"path must be str, not {type(path)}")

    def prepare(target):
        f = h5py.File(target, mode)
        try:
            dset = f.create_dataset(dataset, data.shape, dtype=_np_dtype(data.dtype), **kwargs)
        except Exception:
            f.close()
            raise
        return dset.__setitem__, f.close

    _writer_save(data, prepare, path, mode)


def _netcdf_shape(path: str, variable: str) -> tuple:
    """The shape of a NetCDF-3 variable, from a mapped open (an unmapped
    one reads every variable whole); no reference into the mapping
    outlives the file, a missing variable raising only once it is
    closed."""
    with _scipy_nc(path, "r", mmap=True) as handle:
        names = list(handle.variables)
        shape = tuple(int(s) for s in handle.variables[variable].shape) if variable in names else None
    if shape is None:
        _named_member(path, dict.fromkeys(names), variable, "variable")
    return shape


def load_netcdf(
    path: str,
    variable: str,
    dtype=types.float32,
    split: Optional[int] = None,
    device=None,
    comm=None,
) -> DNDarray:
    """Load a NetCDF-3 variable with one slab read a position."""
    if not supports_netcdf():
        raise RuntimeError("a NetCDF backend (scipy) is required")
    dtype = types.canonical_heat_type(dtype)
    np_dtype = _np_dtype(dtype)

    def _probe():
        _faults().io_open(path)
        return _netcdf_shape(path, variable)

    def read_slices(index):
        # the file is mapped and only the slab copied out (an unmapped
        # open reads every variable whole)
        with _scipy_nc(path, "r", mmap=True) as f:
            return np.array(f.variables[variable][index], dtype=np_dtype)

    gshape = _retry_open(_probe, "io.load_netcdf")
    return _sharded_from_reader(gshape, dtype, split, device, comm, read_slices)


def save_netcdf(
    data: DNDarray, path: str, variable: str, mode: str = "w", dimension_names=None, **kwargs
) -> None:
    """Save to NetCDF-3, one position's slab at a time."""
    if not supports_netcdf():
        raise RuntimeError("a NetCDF backend (scipy) is required")
    if not isinstance(data, DNDarray):
        raise TypeError(f"data must be a DNDarray, not {type(data)}")
    if dimension_names is None:
        dimension_names = [f"dim_{i}" for i in range(data.ndim)]
    np_dtype = _np_dtype(data.dtype)
    if kwargs:
        raise TypeError(
            f"NetCDF-3 (scipy backend) does not support createVariable "
            f"options {sorted(kwargs)}; install netCDF4 for them"
        )
    # classic NetCDF-3 typecodes: int8/int16/int32, float32/float64
    classic_ok = (np_dtype.kind == "i" and np_dtype.itemsize <= 4) or (
        np_dtype.kind == "f" and np_dtype.itemsize in (4, 8)
    )
    if not classic_ok:
        raise TypeError(
            f"NetCDF-3 (scipy backend) cannot store dtype {np_dtype}; "
            "cast to a signed int <= 32 bits or float32/float64, or "
            "install netCDF4"
        )

    def prepare(target):
        f = _scipy_nc(target, "w" if mode == "w" else "a")
        try:
            for name, length in zip(dimension_names, data.shape):
                if name not in f.dimensions:
                    f.createDimension(name, length)
            var = f.createVariable(variable, np_dtype, tuple(dimension_names))
        except Exception:
            f.close()
            raise
        return var.__setitem__, f.close

    _writer_save(data, prepare, path, mode)


def load_csv(
    path: str,
    header_lines: int = 0,
    sep: str = ",",
    dtype=types.float32,
    encoding: str = "utf-8",
    split: Optional[int] = None,
    device=None,
    comm=None,
) -> DNDarray:
    """Load a CSV file on the native threaded scanner (byte ranges a
    thread, a range owning the lines that start in it); numpy parses
    exotic encodings, ragged rows, or on hosts without a toolchain."""
    if not isinstance(path, str):
        raise TypeError(f"path must be str, not {type(path)}")
    if not isinstance(sep, str):
        raise TypeError(f"separator must be str, not {type(sep)}")
    if not isinstance(header_lines, int):
        raise TypeError(f"header_lines must be int, not {type(header_lines)}")
    dtype = types.canonical_heat_type(dtype)
    data = None
    if encoding in ("utf-8", "ascii", "utf8"):
        from .. import native

        data = native.fastcsv_parse(path, header_lines=header_lines, sep=sep)
        if data is not None:
            data = data.astype(_np_dtype(dtype), copy=False)
    if data is None:
        data = np.genfromtxt(
            path,
            delimiter=sep,
            skip_header=header_lines,
            dtype=_np_dtype(dtype),
            encoding=encoding,
        )
    return factories.array(data, dtype=dtype, split=split, device=device, comm=comm)


def save_csv(
    data: DNDarray,
    path: str,
    header_lines: Optional[str] = None,
    sep: str = ",",
    decimals: int = -1,
    encoding: str = "utf-8",
    **kwargs,
) -> None:
    """Save a 1-D or 2-D DNDarray to CSV (``%s`` per value, or ``decimals``
    fixed digits)."""
    if data.ndim > 2:
        raise ValueError("save_csv supports 1-D and 2-D arrays")
    arr = _host(data.larray)
    fmt = f"%.{decimals}f" if decimals >= 0 else "%s"
    tmp = None
    try:
        _faults().io_open(path)
        tmp = _atomic_begin(path)
        _faults().preempt_point("save-slab")
        np.savetxt(tmp, arr, delimiter=sep, header=header_lines or "", fmt=fmt, encoding=encoding)
        _atomic_commit(tmp, path)
    except Exception:
        _atomic_abort(tmp)
        raise


def load(path: str, *args, **kwargs) -> DNDarray:
    """Load by file extension: ``.h5``/``.hdf5``, ``.nc``/``.nc4``/
    ``.netcdf``, ``.csv``/``.txt``."""
    if _tel.enabled:
        _tel.inc("io.loads")
        with _tel.span("io:load", path=str(path)):
            return _load_impl(path, *args, **kwargs)
    return _load_impl(path, *args, **kwargs)


def _load_impl(path: str, *args, **kwargs) -> DNDarray:
    if not isinstance(path, str):
        raise TypeError(f"Expected path to be str, but was {type(path)}")
    ext = os.path.splitext(path)[-1].strip().lower()
    if ext in __HDF5_EXTENSIONS:
        if not supports_hdf5():
            raise RuntimeError(f"hdf5 is required for file extension {ext}")
        return load_hdf5(path, *args, **kwargs)
    if ext in __NETCDF_EXTENSIONS:
        if not supports_netcdf():
            raise RuntimeError(f"netcdf is required for file extension {ext}")
        return load_netcdf(path, *args, **kwargs)
    if ext in __CSV_EXTENSIONS:
        return load_csv(path, *args, **kwargs)
    raise ValueError(f"Unsupported file extension {ext}")


def save(data: DNDarray, path: str, *args, **kwargs) -> None:
    """Save by file extension; an estimator goes to
    :func:`heat_tpu_torch.save_estimator`."""
    if _tel.enabled:
        _tel.inc("io.saves")
        with _tel.span("io:save", path=str(path)):
            return _save_impl(data, path, *args, **kwargs)
    return _save_impl(data, path, *args, **kwargs)


def _save_impl(data: DNDarray, path: str, *args, **kwargs) -> None:
    from .base import BaseEstimator

    if isinstance(data, BaseEstimator):
        if args or kwargs:
            raise TypeError(
                "estimator checkpoints take no dataset/option arguments: "
                "use htt.save(estimator, path)"
            )
        from .checkpoint import save_estimator

        return save_estimator(data, path)
    if not isinstance(path, str):
        raise TypeError(f"Expected path to be str, but was {type(path)}")
    ext = os.path.splitext(path)[-1].strip().lower()
    if ext in __HDF5_EXTENSIONS:
        if not supports_hdf5():
            raise RuntimeError(f"hdf5 is required for file extension {ext}")
        return save_hdf5(data, path, *args, **kwargs)
    if ext in __NETCDF_EXTENSIONS:
        if not supports_netcdf():
            raise RuntimeError(f"netcdf is required for file extension {ext}")
        return save_netcdf(data, path, *args, **kwargs)
    if ext in __CSV_EXTENSIONS:
        return save_csv(data, path, *args, **kwargs)
    raise ValueError(f"Unsupported file extension {ext}")
