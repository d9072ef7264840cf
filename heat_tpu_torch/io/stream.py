"""Out-of-core streaming: chunked reads double-buffered against compute.

Port of ``heat_tpu/io/stream.py``, the io half of the mini-batch fits
(``KMeans(mini_batch=...)``, ``Lasso(solver="gd", mini_batch=...)``): a
:class:`StreamSource` gives row-wise random access to an on-disk HDF5 or
NetCDF-3 dataset (or to an in-memory array, the bitwise twin), and
:func:`stream_chunks` turns it into a sequence of zero-padded chunks on
the communicator's device.

Determinism contract (what makes the streaming fits' twins bitwise):

- the chunk geometry is a pure function of ``(rows, mini_batch)``: step
  ``s`` is chunk ``t = s % h`` of an ``h = ceil(n / mb)``-chunk epoch,
  global rows ``[t*mb, min(n, (t+1)*mb))``, zero-padded to
  ``ceil(mb/p)*p`` rows, with the valid count beside it;
- the prefetch policy changes host scheduling only: both arms read the
  same bytes in the same order and hand the fit the same tensors, so
  prefetch on is bitwise prefetch off;
- every chunk read crosses the ``io_open(..., site="stream.read")`` fault
  seam under the bounded, seeded io retry policy.

On a CUDA device the copy runs the way the card wants it: each chunk is
read into a pinned host slab (two per source, reused), copied with a
``non_blocking`` copy on a dedicated copy stream, and an event recorded
there; the consuming stream waits on that event before it reads the
chunk, and the chunk is recorded on the consuming stream for the caching
allocator.  A slab is refilled only after its last copy's event has
completed.  Under ``set_prefetch("on")`` one worker thread reads and
copies chunk ``t+1`` while the caller consumes chunk ``t``.

Host memory is bounded: at most two chunk slabs are live under prefetch,
one without; :func:`slab_peak` reports the high-water mark.
"""

from __future__ import annotations

import contextlib
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core import factories
from ..core._compile import register_key_context
from ..core import io as _cio
from ..core import types
from ..core.dndarray import DNDarray
from ..telemetry import _core as _tel

__all__ = [
    "ArraySource",
    "HDF5Source",
    "NetCDFSource",
    "StreamSource",
    "as_source",
    "get_prefetch",
    "prefetch",
    "prefetch_enabled",
    "reset_slab_peak",
    "set_prefetch",
    "slab_peak",
    "stream_chunks",
]

_MODES = ("on", "off", "auto")
_PREFETCH = "auto"


# --------------------------------------------------------------------- #
# policy                                                                 #
# --------------------------------------------------------------------- #
def set_prefetch(mode: str) -> None:
    """Set the process-wide host-to-device prefetch policy.

    ``"on"``
        Double-buffered streaming: chunk ``t+1``'s read and device copy run
        on a worker thread while chunk ``t`` is consumed (two host slabs
        live).
    ``"off"``
        Strictly sequential read, copy, compute (one slab live): the exact
        twin every overlapped stream is held against.
    ``"auto"``
        The default: prefetch when the stream's device is a CUDA device
        (the copy engine runs beside the kernels; the reference turns it
        on for a TPU), sequential on the CPU.
    """
    global _PREFETCH
    if mode not in _MODES:
        raise ValueError(f"unknown prefetch mode {mode!r}: expected one of {_MODES}")
    _PREFETCH = mode


def get_prefetch() -> str:
    """The current process-wide prefetch policy."""
    return _PREFETCH


@contextlib.contextmanager
def prefetch(mode: str):
    """Context-manager form of :func:`set_prefetch`."""
    prev = _PREFETCH
    set_prefetch(mode)
    try:
        yield
    finally:
        set_prefetch(prev)


@register_key_context
def _prefetch_token() -> Tuple:
    """The prefetch policy's contribution to every program cache key:
    the chunk programs do not depend on the schedule, but keying on the
    policy keeps each arm's first-call telemetry attributable to its own
    setting.  The device check inside :func:`prefetch_enabled` is not
    part of the token."""
    return ("prefetch", _PREFETCH)


def prefetch_enabled(device: Optional[torch.device] = None) -> bool:
    """Whether :func:`stream_chunks` double-buffers under the current
    policy: ``"auto"`` is on for a CUDA ``device`` (the default
    communicator's device when None) and off on the CPU."""
    if _PREFETCH == "off":
        return False
    if _PREFETCH == "on":
        return True
    if device is None:
        from ..core.communication import get_comm

        device = get_comm().device
    return torch.device(device).type == "cuda"


# --------------------------------------------------------------------- #
# host-slab accounting                                                   #
# --------------------------------------------------------------------- #
class _SlabLedger:
    """Live and peak count of host chunk slabs (a slab is live from the
    moment its read is scheduled until its consumer returns).  The streaming memory
    contract, at most 2 slabs under prefetch and 1 without, is asserted
    against this ledger."""

    def __init__(self):
        self._lock = threading.Lock()
        self.live = 0
        self.peak = 0

    def acquire(self) -> None:
        with self._lock:
            self.live += 1
            if self.live > self.peak:
                self.peak = self.live
                if _tel.enabled:
                    _tel.gauge("io.stream.host_slabs_peak", float(self.peak))

    def release(self) -> None:
        with self._lock:
            self.live = max(0, self.live - 1)

    def reset(self) -> None:
        with self._lock:
            self.peak = self.live


_SLABS = _SlabLedger()


def slab_peak() -> int:
    """High-water mark of simultaneously live host chunk slabs since the
    last :func:`reset_slab_peak`."""
    return _SLABS.peak


def reset_slab_peak() -> None:
    """Reset the slab high-water mark."""
    _SLABS.reset()


# --------------------------------------------------------------------- #
# sources                                                                #
# --------------------------------------------------------------------- #
class StreamSource:
    """Row-wise random-access reader over a (possibly on-disk) dataset.

    Subclasses provide ``shape`` (global), ``np_dtype``, and
    ``read(lo, hi)`` returning host rows ``[lo, hi)`` as a numpy array.
    ``read`` must be safe to call from a worker thread (the file sources
    open a fresh handle per call) and a pure function of the row range.
    """

    #: fault-seam label for in-memory sources; file sources override
    path = "<memory>"

    shape: Tuple[int, ...]
    np_dtype: np.dtype

    @property
    def rows(self) -> int:
        return int(self.shape[0])

    def read(self, lo: int, hi: int) -> np.ndarray:
        raise NotImplementedError

    def __len__(self) -> int:
        return self.rows


class ArraySource(StreamSource):
    """In-memory stream source: a DNDarray, tensor or array fed through
    the same chunk geometry, pads and chunk updates as an on-disk stream
    (the twin that makes streamed against resident a bitwise gate)."""

    def __init__(self, array, dtype=types.float32):
        hdtype = types.canonical_heat_type(dtype)
        self.np_dtype = _cio._np_dtype(hdtype)
        if isinstance(array, DNDarray):
            array = array.larray
        if isinstance(array, torch.Tensor):
            array = _cio._host(array)
        self._arr = np.asarray(array, dtype=self.np_dtype)
        self.shape = tuple(int(s) for s in self._arr.shape)

    def read(self, lo: int, hi: int) -> np.ndarray:
        return self._arr[int(lo):int(hi)]


class HDF5Source(StreamSource):
    """Chunked reader over one HDF5 dataset (a fresh file handle per
    read)."""

    def __init__(self, path: str, dataset: str, dtype=types.float32):
        if not _cio.supports_hdf5():
            raise RuntimeError("h5py is required for HDF5 support")
        if not isinstance(path, str):
            raise TypeError(f"path must be str, not {type(path)}")
        if not isinstance(dataset, str):
            raise TypeError(f"dataset must be str, not {type(dataset)}")
        self.path = path
        self.dataset = dataset
        self.np_dtype = _cio._np_dtype(types.canonical_heat_type(dtype))

        def _probe():
            _cio._faults().io_open(path)
            with _cio.h5py.File(path, "r") as handle:
                member = _cio._named_member(path, handle, dataset, "dataset")
                return tuple(int(s) for s in member.shape)

        self.shape = _cio._retry_open(_probe, "io.stream.open")

    def read(self, lo: int, hi: int) -> np.ndarray:
        with _cio.h5py.File(self.path, "r") as f:
            return np.asarray(f[self.dataset][int(lo):int(hi)], dtype=self.np_dtype)


class NetCDFSource(StreamSource):
    """Chunked reader over one NetCDF-3 variable (scipy's reader, a fresh
    mapped handle per read, the chunk's rows copied out)."""

    def __init__(self, path: str, variable: str, dtype=types.float32):
        if not _cio.supports_netcdf():
            raise RuntimeError("a NetCDF backend (scipy) is required")
        if not isinstance(path, str):
            raise TypeError(f"path must be str, not {type(path)}")
        if not isinstance(variable, str):
            raise TypeError(f"variable must be str, not {type(variable)}")
        self.path = path
        self.variable = variable
        self.np_dtype = _cio._np_dtype(types.canonical_heat_type(dtype))

        def _probe():
            _cio._faults().io_open(path)
            return _cio._netcdf_shape(path, variable)

        self.shape = _cio._retry_open(_probe, "io.stream.open")

    def read(self, lo: int, hi: int) -> np.ndarray:
        # mapped, the chunk copied out: an unmapped open reads the whole
        # file on every call
        with _cio._scipy_nc(self.path, "r", mmap=True) as f:
            return np.array(f.variables[self.variable][int(lo):int(hi)], dtype=self.np_dtype)


def as_source(data, dtype=types.float32) -> StreamSource:
    """Coerce ``data`` to a :class:`StreamSource`: sources pass through,
    DNDarrays, tensors and array-likes wrap as the in-memory twin."""
    if isinstance(data, StreamSource):
        return data
    return ArraySource(data, dtype=dtype)


# --------------------------------------------------------------------- #
# the chunk pipeline                                                     #
# --------------------------------------------------------------------- #
def _read_chunk(source: StreamSource, lo: int, hi: int) -> np.ndarray:
    """One slab read across the fault seam under the seeded io retry
    policy (a transient ``OSError`` heals with the attempt incident-logged;
    only an exhausted policy propagates)."""
    from ..resilience import retry as _retry

    def _read():
        _cio._faults().io_open(source.path, site="stream.read")
        return source.read(lo, hi)

    return _retry.call(_read, policy=_retry.IO_POLICY, site="io.stream.read")


class _PinnedSlabs:
    """Two pinned host slabs of one source's padded chunk shape, used in
    turn; each remembers the event of the last copy made from it, and is
    handed out again only once that copy has completed."""

    def __init__(self, shape, dtype: torch.dtype):
        self._slabs = [torch.empty(shape, dtype=dtype, pin_memory=True) for _ in range(2)]
        self._events = [None, None]
        self._next = 0

    def take(self):
        i = self._next
        self._next = 1 - i
        if self._events[i] is not None:
            self._events[i].synchronize()
        return i, self._slabs[i]

    def copied(self, i: int, event) -> None:
        self._events[i] = event


def stream_chunks(
    sources: Union[StreamSource, Sequence[StreamSource]],
    mini_batch: int,
    start: int,
    stop: int,
    *,
    comm=None,
    device=None,
) -> Iterator[Tuple[Tuple[torch.Tensor, ...], int]]:
    """Yield the chunks of global steps ``[start, stop)`` on the device.

    Each yield is ``(tensors, nvalid)``: one zero-padded tensor per source
    (``ceil(mb/p)*p`` rows, ``p`` the communicator's positions, so every
    mesh size divides it) and the chunk's count of valid rows.  Step ``s``
    maps to chunk ``s % h`` of an ``h = ceil(n/mb)``-chunk epoch, so a fit
    resuming from a snapshotted step re-enters mid-epoch at the right
    place.  Several sources (an X and a y stream) are read over the same
    rows each step.

    Under :func:`prefetch_enabled` the next chunk's read and copy run on
    one worker thread while the caller consumes the current one (at most
    2 host slabs live); otherwise strictly sequentially (1).  With
    telemetry on, reads and copies credit ``io:read``/``io:h2d`` spans
    and ``account_bytes("io", ...)``.
    """
    if isinstance(sources, StreamSource):
        sources = (sources,)
    sources = tuple(sources)
    if not sources:
        raise ValueError("stream_chunks needs at least one source")
    device, comm = factories._setup(device, comm)
    if comm.spans_processes:
        from ..core import _xproc

        _xproc.refuse("io streaming")
    mb = int(mini_batch)
    if mb <= 0:
        raise ValueError(f"mini_batch must be >= 1, got {mb}")
    n = sources[0].rows
    for s in sources[1:]:
        if s.rows != n:
            raise ValueError(f"stream sources disagree on length: {n} vs {s.rows} rows")
    h = max(1, -(-n // mb))
    p = comm.size
    rows_dev = -(-mb // p) * p
    target = comm.device
    on_cuda = target.type == "cuda"
    shapes = [(rows_dev,) + tuple(src.shape[1:]) for src in sources]
    tdtypes = [torch.from_numpy(np.empty(0, src.np_dtype)).dtype for src in sources]
    if on_cuda:
        copy_stream = torch.cuda.Stream(device=target)
        pools = [_PinnedSlabs(sh, dt) for sh, dt in zip(shapes, tdtypes)]

    def _read(src, lo, hi, nv):
        if _tel.enabled:
            with _tel.span("io:read", path=str(src.path), rows=nv):
                block = np.asarray(_read_chunk(src, lo, hi))
            _tel.account_bytes("io", "read", block.nbytes, block.nbytes)
        else:
            block = np.asarray(_read_chunk(src, lo, hi))
        if block.shape != (nv,) + tuple(src.shape[1:]):
            raise ValueError(
                f"{src.path}: read({lo}, {hi}) returned shape "
                f"{block.shape}, expected {(nv,) + tuple(src.shape[1:])}"
            )
        return block

    def _to_device(j, block, nv):
        """The padded chunk on the device (and, on a CUDA device, the
        event its copy records on the copy stream)."""
        if not on_cuda:
            buf = torch.zeros(shapes[j], dtype=tdtypes[j], device=target)
            buf[:nv] = torch.from_numpy(np.ascontiguousarray(block))
            return buf, None
        i, slab = pools[j].take()
        slab[:nv].copy_(torch.from_numpy(np.ascontiguousarray(block)))
        slab[nv:].zero_()
        with torch.cuda.stream(copy_stream):
            out = torch.empty(shapes[j], dtype=tdtypes[j], device=target)
            out.copy_(slab, non_blocking=True)
            event = torch.cuda.Event()
            event.record(copy_stream)
        pools[j].copied(i, event)
        return out, event

    def _build(step: int):
        """Read and copy one chunk; the caller took its slab ticket, which
        a failed build gives back."""
        t = step % h
        lo = t * mb
        hi = min(n, lo + mb)
        nv = hi - lo
        try:
            chunks, events = [], []
            for j, src in enumerate(sources):
                block = _read(src, lo, hi, nv)
                nbytes = int(np.prod(shapes[j])) * block.itemsize
                if _tel.enabled:
                    with _tel.span("io:h2d", path=str(src.path), bytes=nbytes):
                        out, event = _to_device(j, block, nv)
                    _tel.account_bytes("io", "h2d", nbytes, nbytes)
                else:
                    out, event = _to_device(j, block, nv)
                chunks.append(out)
                events.append(event)
            if _tel.enabled:
                _tel.inc("io.stream.chunks")
            return tuple(chunks), nv, events
        except BaseException:
            _SLABS.release()
            raise

    def _ready(chunks, events):
        """Make the consuming stream wait for the chunks' copies."""
        if on_cuda:
            consumer = torch.cuda.current_stream(target)
            for out, event in zip(chunks, events):
                consumer.wait_event(event)
                out.record_stream(consumer)
        return chunks

    if not prefetch_enabled(target):
        for step in range(int(start), int(stop)):
            _SLABS.acquire()
            chunks, nv, events = _build(step)
            try:
                yield _ready(chunks, events), nv
            finally:
                _SLABS.release()
        return

    def _submit(step: int):
        # the next chunk's slab is taken when its build is scheduled,
        # while the current chunk's is still live
        _SLABS.acquire()
        return ex.submit(_build, step)

    ex = ThreadPoolExecutor(max_workers=1, thread_name_prefix="htt-stream")
    fut = None
    try:
        if int(start) < int(stop):
            fut = _submit(int(start))
        for step in range(int(start), int(stop)):
            chunks, nv, events = fut.result()
            fut = _submit(step + 1) if step + 1 < int(stop) else None
            try:
                yield _ready(chunks, events), nv
            finally:
                _SLABS.release()
    finally:
        if fut is not None:
            # an abandoned in-flight build (early generator close, a
            # consumer fault) still holds a slab ticket: drain it
            try:
                fut.result()
            except BaseException:
                pass
            else:
                _SLABS.release()
        ex.shutdown(wait=True)
