"""Whole-pipeline programs over DNDarrays: ``htt.fuse``.

Port of ``heat_tpu/core/fuse.py``.  Every eager op of the port is one
library-level dispatch (:mod:`heat_tpu_torch.core._compile`), and each
launches its CUDA kernels from Python, so a pipeline of N ops pays N
rounds of host work.  ``fuse`` closes the gap on the card as the
reference closes it on the TPU: the pipeline is traced once and replayed
as ONE program.

What a fused program is
-----------------------
* **On a CUDA device** the program is a ``torch.cuda.CUDAGraph``.  The
  first call of a new key (1) runs ``fn`` once under
  :func:`~heat_tpu_torch.core._tracing.trace_mode` on the device's capture
  stream (a side stream): the warm-up, which loads kernels, creates
  library handles and workspaces, and yields the output structure and
  metadata; (2) captures ``fn`` under ``trace_mode()`` with
  ``capture_error_mode="thread_local"`` on the same stream over static
  input buffers; (3) replays the graph.  A later call copies its operands
  into the static buffers, replays, and returns **fresh output tensors**:
  the graph's own output buffers are never handed out, because the next
  replay would overwrite a result the caller still holds.  Every program
  of a device allocates from one shared graph memory pool, so replays of
  different programs are chained on the device (each waits for the
  previous one's event) and never run concurrently.
* **On the CPU there is no graph.**  Each call runs ``fn`` under
  ``trace_mode()`` over the operands and counts one dispatch: the plain
  version of the capture, which the tests use.  Nothing on the card takes
  it.
* **No fallback on the card.**  A capture that fails raises:
  :class:`FuseTraceError` where a value-forcing entry point was reached
  (a host read cannot be captured), otherwise a ``RuntimeError`` naming
  the function and the CUDA error.  ``fuse`` never quietly runs eagerly;
  a library pipeline that the library itself cannot run captured (one
  whose solver synchronizes with the host inside) is simply not fused.

Per call, ``fuse`` flattens ``(args, kwargs)`` with its own small
flattener (tuples, lists, dicts, namedtuples; DNDarrays, tensors and
numpy arrays are leaves): a DNDarray is a dynamic operand (its at-rest
buffer) plus static metadata; a tensor or numpy array is an ``("arr",)``
operand, moved to the program's device before any capture (a pageable
host-to-device copy cannot be captured); every other leaf is static.
The cache key is ``(fn, donate, plan_token, treedef, keyparts, comm,
context_token())``.  ``fn`` identity follows
:func:`~heat_tpu_torch.core._compile.cache_stable`: lambdas, closures and
unhashable or unstable static leaves get a transient program per call.
A nested ``fuse`` inlines into the enclosing trace, and a call made while
the caller captures a CUDA graph of its own is traced into that graph.

Under an active guard policy the program has one more output,
``guards.health_flag`` over every inexact result, read once after the
replay; an unhealthy result goes through ``guards.handle``, whose
``"degrade"`` re-runs the call under ``collective_precision("f32")`` (a
program of its own, keyed by the policy) unless ``donate=True`` consumed
the inputs.

``donate=True``: the first call's operand tensors become the program's
static inputs, with no copy-in; the caller's DNDarrays are consumed, as
in the reference.  A later call copies in unless it passes those very
tensors.

The cache is bounded.  On a CUDA device a cached program keeps its
static inputs, its outputs and the temporaries of its capture in the
device's shared graph pool (they are allocated at the start of the
capture, and the first replay copies the operands in), and none of it
goes back to the caching allocator while the pool lives.  So each
device's pool may hold at most ``fuse.set_cache_limit(nbytes)`` bytes
(default: an eighth of the device's memory; ``fuse.cache_bytes()`` reads
it): a build that takes it past the limit retires the pool with every
program in it, and the pool's memory goes back to the device.
``fuse.clear_cache()`` retires every pool.  At most ``_MAX_PROGRAMS``
programs, least recently used first out, are kept on all devices.

``fuse.trace()`` exposes the bare tracing mode as a context manager.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..telemetry import _core as _tel
from . import _compile, devices
from ._compile import cache_stable
from ._tracing import (
    FuseTraceError,
    applying_layout_plan,
    in_trace,
    record_dispatch,
    trace_mode,
)
from .dndarray import DNDarray

__all__ = ["fuse", "FuseTraceError"]

#: cached programs, least recently used first
_FUSE_CACHE: "OrderedDict[Tuple, _Program]" = OrderedDict()
_CACHE_LOCK = threading.RLock()
_MAX_PROGRAMS = 1024
#: bytes the programs of one CUDA device may hold; None: an eighth of the
#: device's memory
_LIMIT: Optional[int] = None

#: active AOT capture sinks (:func:`heat_tpu_torch.core.aot.capture_programs`):
#: each is a dict keyed by fuse-cache key, fed one entry per distinct
#: cache-keyed call
_CAPTURE_SINKS: list = []

_LEAF = "*"


def _flatten(obj, leaves: list):
    """Append ``obj``'s leaves to ``leaves`` and return its treedef: a
    hashable nest of ``(kind, ...)`` tuples with :data:`_LEAF` marks."""
    if isinstance(obj, (DNDarray, torch.Tensor, np.ndarray)):
        leaves.append(obj)
        return _LEAF
    kind = type(obj)
    if kind is tuple or kind is list:
        return (kind.__name__, tuple(_flatten(o, leaves) for o in obj))
    if kind is dict:
        keys = tuple(obj)
        return ("dict", keys, tuple(_flatten(obj[k], leaves) for k in keys))
    if isinstance(obj, tuple) and hasattr(kind, "_fields"):
        return ("namedtuple", kind, tuple(_flatten(o, leaves) for o in obj))
    leaves.append(obj)
    return _LEAF


def _unflatten(treedef, leaves):
    """Inverse of :func:`_flatten` over an iterator of leaves."""
    if treedef == _LEAF:
        return next(leaves)
    kind = treedef[0]
    if kind == "dict":
        return {k: _unflatten(t, leaves) for k, t in zip(treedef[1], treedef[2])}
    children = [_unflatten(t, leaves) for t in treedef[-1]]
    if kind == "tuple":
        return tuple(children)
    if kind == "list":
        return children
    return treedef[1](*children)


def _guards():
    """Lazy import of the health-guard seam (the resilience package sits
    above core in the import graph)."""
    from ..resilience import guards

    return guards


class _Pool:
    """One device's shared graph memory pool and its replay chain.  The
    pool holds every cached program's static inputs and outputs and the
    temporaries of its capture."""

    def __init__(self, device: torch.device):
        self.handle = torch.cuda.graph_pool_handle()
        self.lock = threading.Lock()
        self.last = None  # the event the last replay recorded
        self.bytes = 0  # the pool's segments after its last capture
        # a pool whose last graph is destroyed is released, and its handle
        # may not be captured into again: one graph of one fill holds it
        # until the pool is retired
        self.keeper = torch.cuda.CUDAGraph()
        with torch.cuda.device(device), torch.cuda.graph(self.keeper, pool=self.handle):
            self.kept = torch.zeros(1, device=device)

    def measure(self) -> None:
        """Read the bytes of the pool's segments from the allocator."""
        self.bytes = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                         if tuple(seg["segment_pool_id"]) == tuple(self.handle))

    def release(self) -> None:
        """Let the pool go once its last program's graph is destroyed;
        nothing is captured into it after this."""
        with self.lock:
            if self.last is not None:
                self.last.synchronize()
            self.keeper = self.kept = None


_POOLS: Dict[torch.device, _Pool] = {}
#: each device's one stream for warm-ups and captures, for the life of the
#: process: cuBLAS keeps a 32 MiB workspace for every stream it has run on
#: (allocated in the graph pool when its first call is a captured one), so
#: a stream per pool or per build would leave one behind each time
_STREAMS: Dict[torch.device, Any] = {}
#: pools a failed capture left recording: kept, never captured into again
_RETIRED: List[_Pool] = []


def _pool(device: torch.device) -> _Pool:
    with _CACHE_LOCK:
        if device not in _POOLS:
            _POOLS[device] = _Pool(device)
        return _POOLS[device]


def _stream(device: torch.device):
    with _CACHE_LOCK:
        if device not in _STREAMS:
            _STREAMS[device] = torch.cuda.Stream(device=device)
        return _STREAMS[device]


class _Program:
    """A traced pipeline plus its output re-wrap recipe, and on a CUDA
    device its captured graph over static buffers.

    ``guarded`` marks programs traced under an active health-guard
    policy: they carry one extra output, the on-device health flag over
    every inexact result buffer.  ``plan`` is a solved layout plan's
    decisions: every trace (the warm-up and the capture alike) runs under
    them afresh, since a trace consumes the overrides it applies.
    """

    __slots__ = ("fn", "slots", "treedef", "device", "plan", "out_treedef", "out_meta",
                 "guarded", "static_in", "static_out", "graph", "in_bytes", "pool")

    def __init__(self, fn: Callable, slots: Tuple, treedef, device: torch.device, plan=None):
        self.fn = fn
        self.slots = slots
        self.treedef = treedef
        self.device = device
        self.plan = plan
        self.out_treedef = None
        self.out_meta = None
        self.guarded = False
        self.graph = None
        self.pool = None
        self.static_in = None
        self.static_out = None
        self.in_bytes = 0

    def trace(self, operands) -> List[torch.Tensor]:
        """Run ``fn`` under trace mode over ``operands`` (one per dynamic
        slot) and return its raw output tensors; the first run records
        the output structure, later runs leave the compile cache's
        counters alone."""
        it = iter(operands)
        leaves = []
        for slot in self.slots:
            if slot[0] == "dnd":
                _, gshape, dtype, layout, device, comm = slot
                leaves.append(DNDarray(next(it), gshape, dtype, layout,
                                       devices.sanitize_device(device), comm))
            elif slot[0] == "arr":
                leaves.append(next(it))
            else:
                leaves.append(slot[1])
        args, kwargs = _unflatten(self.treedef, iter(leaves))
        # a program already built (or installed) is not built again: its
        # op lookups are not the compile cache's misses or hits
        replaying = (_compile._uncounted() if self.out_meta is not None
                     else contextlib.nullcontext())
        planned = (applying_layout_plan(self.plan) if self.plan is not None
                   else contextlib.nullcontext())
        with trace_mode(), replaying, planned:
            out = self.fn(*args, **kwargs)
            out_leaves: list = []
            out_treedef = _flatten(out, out_leaves)
            raws, meta = [], []
            for leaf in out_leaves:
                if isinstance(leaf, DNDarray):
                    raws.append(leaf._buffer)
                    meta.append(("dnd", leaf.gshape, leaf.dtype, leaf._layout, str(leaf.device),
                                 leaf.comm))
                elif isinstance(leaf, torch.Tensor):
                    raws.append(leaf)
                    meta.append(("raw",))
                else:
                    # a trace-time constant (python scalar, string, host
                    # array): deterministic given the key, so baked in
                    meta.append(("const", leaf))
            guarded = _guards().active()
            if guarded:
                raws.append(_guards().health_flag(raws))
        if self.out_meta is None:
            self.out_treedef, self.out_meta, self.guarded = out_treedef, tuple(meta), guarded
        return raws

    def capture(self, operands, donate: bool, name: str) -> None:
        """Warm up, then capture the trace over static input buffers: the
        caller's tensors under ``donate``, else buffers allocated in the
        pool at the start of the capture (the first replay copies in)."""
        dev = self.device
        # the warm-up runs on the capture stream: what the capture needs per
        # stream (cuBLAS's workspace) is made there, outside the pool
        side = _stream(dev)
        failure = None
        while True:
            pool = _pool(dev)
            with pool.lock:  # taken after the cache lock, never before it
                if pool.keeper is None:  # retired by another thread
                    continue
                current = torch.cuda.current_stream(dev)
                if pool.last is not None:
                    current.wait_event(pool.last)
                side.wait_stream(current)
                with torch.cuda.stream(side):
                    self.trace(list(operands) if donate else [op.clone() for op in operands])
                current.wait_stream(side)
                graph = torch.cuda.CUDAGraph()
                try:
                    with torch.cuda.graph(graph, pool=pool.handle, stream=side,
                                          capture_error_mode="thread_local"):
                        static_in = (list(operands) if donate
                                     else [torch.empty_like(op) for op in operands])
                        static_out = self.trace(static_in)
                except Exception as exc:
                    failure = exc
                else:
                    pool.measure()
            break
        if failure is not None:
            # a capture the card refused can leave the allocator recording
            # into the pool: later programs take a new pool
            with _CACHE_LOCK:
                if _POOLS.get(dev) is pool:
                    _RETIRED.append(_POOLS.pop(dev))
            if isinstance(failure, FuseTraceError):
                raise failure
            first = failure.__context__  # the call that broke the capture
            detail = f"{failure}" + (f" (first: {first})" if first is not None else "")
            raise RuntimeError(
                f"htt.fuse: capturing {name} as a CUDA graph failed: {detail}"
            ) from failure
        self.graph, self.pool, self.static_in, self.static_out = graph, pool, static_in, static_out
        if donate:
            self.in_bytes = sum(t.numel() * t.element_size() for t in static_in)

    def replay(self, operands) -> List[torch.Tensor]:
        """Copy the operands in, replay once, and return fresh copies of
        the outputs."""
        pool = self.pool
        with pool.lock:
            stream = torch.cuda.current_stream(self.device)
            if pool.last is not None:
                stream.wait_event(pool.last)
            for dst, src in zip(self.static_in, operands):
                if dst.data_ptr() != src.data_ptr():
                    dst.copy_(src)
            self.graph.replay()
            out = [r.clone() for r in self.static_out]
            pool.last = torch.cuda.Event()
            pool.last.record(stream)
        return out

    def run(self, operands, donate: bool, name: str) -> List[torch.Tensor]:
        if self.device.type != "cuda":
            return self.trace(operands)
        if self.graph is None:
            self.capture(operands, donate, name)
        return self.replay(operands)


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current>``: one key per card for its pool and
    its byte count."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _program_device(operands, comm) -> torch.device:
    if comm is not None:
        return _indexed(comm.device)
    for op in operands:
        if isinstance(op, torch.Tensor):
            return _indexed(op.device)
    if devices.get_device() is devices.gpu:
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class _FusedFunction:
    """The callable returned by :func:`fuse`."""

    def __init__(self, fn: Callable, donate: bool = False, layout_plan=None):
        self._fn = fn
        self._donate = bool(donate)
        self._stable = cache_stable(fn)
        # a solved layout plan: its decisions steer every resplit inside
        # the trace, and its fingerprint joins the cache key
        self._layout_plan = layout_plan
        self._plan_token = layout_plan["fingerprint"] if layout_plan else None
        functools.update_wrapper(self, fn)

    def __call__(self, *args, **kwargs):
        if in_trace():
            # nested fuse (or inside fuse.trace()): inline into the
            # enclosing trace instead of building a second program
            return self._fn(*args, **kwargs)
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            # inside a CUDA graph the caller is capturing: traced into it,
            # under the program's layout plan as any trace of it
            planned = (applying_layout_plan(self._layout_plan["decisions"])
                       if self._layout_plan is not None else contextlib.nullcontext())
            with trace_mode(), planned:
                return self._fn(*args, **kwargs)
        leaves: list = []
        treedef = _flatten((args, kwargs), leaves)
        operands, slots, keyparts = [], [], []
        comm = None
        for leaf in leaves:
            if isinstance(leaf, DNDarray):
                buf = leaf._buffer
                operands.append(buf)
                slots.append(("dnd", leaf.gshape, leaf.dtype, leaf._layout, str(leaf.device),
                              leaf.comm))
                keyparts.append(("dnd", tuple(buf.shape), str(buf.dtype), leaf.gshape,
                                 leaf.dtype, leaf._layout, str(leaf.device), leaf.comm))
                comm = comm if comm is not None else leaf.comm
            elif isinstance(leaf, (torch.Tensor, np.ndarray)):
                operands.append(leaf)
                slots.append(("arr",))
                keyparts.append(("arr", tuple(leaf.shape), str(leaf.dtype)))
            else:
                slots.append(("static", leaf))
                keyparts.append(("static", leaf))
        device = _program_device(operands, comm)
        # host data is moved to the device BEFORE any capture
        operands = [torch.as_tensor(op, device=device) if isinstance(op, np.ndarray) else op
                    for op in operands]
        slots = tuple(slots)
        name = getattr(self._fn, "__name__", "<pipeline>")

        program = None
        key = None
        if self._stable and self._cacheable_statics(leaves):
            # context_token(): process-wide state (collective precision,
            # guard policy, io prefetch) that changes what the program
            # computes: a new policy traces a new program
            key = (self._fn, self._donate, self._plan_token, treedef,
                   tuple(keyparts), comm, _compile.context_token())
            try:
                with _CACHE_LOCK:
                    program = _FUSE_CACHE.get(key)
                    if program is not None:
                        _FUSE_CACHE.move_to_end(key)
            except TypeError:  # unhashable static leaf slipped through
                key = None
        building = program is None
        if building:
            if _tel.enabled:
                _tel.inc("fuse.cache.misses")
            program = _Program(self._fn, slots, treedef, device,
                               self._layout_plan["decisions"] if self._layout_plan else None)
        elif _tel.enabled:
            _tel.inc("fuse.cache.hits")

        # AOT capture: operand specs snapshotted BEFORE the call (donation
        # may consume the buffers), the entry recorded after it
        capture_specs = None
        if _CAPTURE_SINKS and key is not None:
            capture_specs = tuple((tuple(op.shape), str(op.dtype)) for op in operands)

        if _tel.enabled:
            site = "fuse:build" if building else "fuse:replay"
            with _tel.span(site, name=name):
                raws = program.run(operands, self._donate, name)
        else:
            raws = program.run(operands, self._donate, name)
        if building and key is not None:
            program = _admit(key, program)
        record_dispatch()

        if capture_specs is not None:
            entry = {
                "fn": self._fn,
                "donate": self._donate,
                "plan_token": self._plan_token,
                "treedef": treedef,
                "keyparts": tuple(keyparts),
                "comm": comm,
                "program": program,
                "specs": capture_specs,
            }
            for sink in _CAPTURE_SINKS:
                sink.setdefault(key, entry)

        flag = None
        if program.guarded:
            flag = raws[-1]
            raws = raws[:-1]
        result = _rewrap(program, raws)
        del program  # a retired pool goes with its last program
        _flush()

        if flag is not None and not bool(flag):
            if self._donate:
                # the unhealthy call consumed its inputs: nothing is left
                # to re-run the exact path on
                degrade_fn = None
            else:
                def degrade_fn():
                    from ..comm.compressed import collective_precision

                    # the policy change flows into the cache key, so the
                    # exact re-run gets (and caches) a program of its own
                    with collective_precision("f32"):
                        return self(*args, **kwargs)

            return _guards().handle(f"fuse:{name}", result, degrade_fn)
        return result

    @staticmethod
    def _cacheable_statics(leaves) -> bool:
        """Static leaves must be hashable, and callable statics must have a
        call-stable identity, or every call would add a dead entry."""
        for leaf in leaves:
            if isinstance(leaf, (DNDarray, torch.Tensor, np.ndarray)):
                continue
            if callable(leaf) and not cache_stable(leaf):
                return False
            try:
                hash(leaf)
            except TypeError:
                return False
        return True


def _limit(device: torch.device) -> int:
    if _LIMIT is not None:
        return _LIMIT
    return torch.cuda.get_device_properties(device).total_memory // 8


def _held(device: torch.device) -> int:
    """Bytes the cached programs of a CUDA device hold: the segments of
    the device's pool (static inputs and outputs, capture temporaries)
    plus the caller's tensors that donated programs keep."""
    pool = _POOLS.get(device)
    return (pool.bytes if pool is not None else 0) + sum(
        p.in_bytes for p in _FUSE_CACHE.values() if p.device == device)


def _admit(key: Tuple, program: _Program) -> _Program:
    """Cache ``program`` under ``key`` (a racing thread's program wins),
    evict the least recently used past ``_MAX_PROGRAMS``, and retire the
    device's pool once it holds more than the limit."""
    with _CACHE_LOCK:
        program = _FUSE_CACHE.setdefault(key, program)
        _FUSE_CACHE.move_to_end(key)
        while len(_FUSE_CACHE) > _MAX_PROGRAMS:
            _FUSE_CACHE.popitem(last=False)
        dev = program.device
        if dev.type == "cuda" and dev in _POOLS and _held(dev) > _limit(dev):
            _retire(dev)
        size = len(_FUSE_CACHE)
    if _tel.enabled:
        _tel.gauge("fuse.cache.size", size)
    return program


#: set when a pool was retired: its memory goes back to the device once
#: its last program is gone (see :func:`_flush`)
_FLUSH = False


def _retire(device: torch.device) -> None:
    """Drop the device's pool and every cached program captured into it;
    the next :func:`_flush` hands the pool's memory back to the device."""
    global _FLUSH
    pool = _POOLS.pop(device)
    for k in [k for k, p in _FUSE_CACHE.items() if p.pool is pool]:
        del _FUSE_CACHE[k]
    pool.release()
    _FLUSH = True


def _flush() -> None:
    """After a retirement, free the cached blocks: a retired pool whose
    graphs are all destroyed is freed with them (the allocator would free
    it on its own only when an allocation fails)."""
    global _FLUSH
    if _FLUSH:
        _FLUSH = False
        torch.cuda.empty_cache()


def _rewrap(program: _Program, raws) -> Any:
    it = iter(raws)
    out_leaves = []
    for meta in program.out_meta:
        if meta[0] == "dnd":
            _, gshape, dtype, layout, device, comm = meta
            out_leaves.append(DNDarray(next(it), gshape, dtype, layout,
                                       devices.sanitize_device(device), comm))
        elif meta[0] == "raw":
            out_leaves.append(next(it))
        else:
            out_leaves.append(meta[1])
    return _unflatten(program.out_treedef, iter(out_leaves))


def fuse(fn: Optional[Callable] = None, *, donate: bool = False, layout_plan=None):
    """Run a DNDarray pipeline as one program (one dispatch): on a CUDA
    device one CUDA-graph replay, on the CPU one traced call.

    Use as a decorator (``@htt.fuse`` / ``@htt.fuse(donate=True)``) or
    inline (``fused = htt.fuse(my_pipeline)``).  See the module docstring
    for capture, caching, static-argument and donation semantics.

    ``layout_plan`` is the autoshard seam: a solved plan dict whose
    decisions override the hand-placed resplits during tracing and whose
    fingerprint becomes part of the cache key.
    """
    if fn is None:
        return functools.partial(fuse, donate=donate, layout_plan=layout_plan)
    return _FusedFunction(fn, donate=donate, layout_plan=layout_plan)


#: context-manager variant: bare tracing mode without program or cache
fuse.trace = trace_mode


def fuse_cache_size() -> int:
    """Number of cached fused programs (mainly for tests)."""
    return len(_FUSE_CACHE)


def fuse_clear_cache() -> None:
    """Drop all cached fused programs and retire every device's graph
    pool, whose memory goes back to the device."""
    with _CACHE_LOCK:
        _FUSE_CACHE.clear()
        for device in list(_POOLS):
            _retire(device)
    _flush()


def fuse_set_cache_limit(nbytes: Optional[int]) -> Optional[int]:
    """Bound the bytes each CUDA device's cached programs may hold (None:
    an eighth of the device's memory); returns the previous setting.  The
    bound applies from the next program built."""
    global _LIMIT
    with _CACHE_LOCK:
        prev, _LIMIT = _LIMIT, None if nbytes is None else int(nbytes)
    return prev


def fuse_cache_bytes(device=None) -> int:
    """Bytes the cached programs of a CUDA device hold (the graph pool's
    segments plus donated tensors); 0 off the card."""
    if device is None:
        if not torch.cuda.is_available():
            return 0
        device = torch.device("cuda", torch.cuda.current_device())
    with _CACHE_LOCK:
        return _held(_indexed(torch.device(device)))


fuse.cache_size = fuse_cache_size
fuse.clear_cache = fuse_clear_cache
fuse.set_cache_limit = fuse_set_cache_limit
fuse.cache_bytes = fuse_cache_bytes
