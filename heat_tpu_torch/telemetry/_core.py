"""Process-wide telemetry runtime: spans, counters, gauges, events.

Port of ``heat_tpu/telemetry/_core.py`` (stdlib only, copied).  This
module is the single registry behind ``heat_tpu_torch.telemetry``: the
instrumented paths (the compressed rings' spans and exact-vs-wire byte
ledger, the communicator's collectives and reshards, estimator
``fit``/``predict``, guard incidents) report here, and every exporter
(``snapshot()``, the JSONL sink, the Perfetto trace writer in
:mod:`heat_tpu_torch.telemetry.export`, ``/metrics``) reads from here.

Overhead contract
-----------------
Telemetry is off by default and *disabled mode costs one predicate per
site*: instrumented library code guards every report with
``if _core.enabled:`` — a module-attribute load and a branch, no object
allocation, no lock, no clock read, no kernel launch and no host sync.
Enabling flips one module-level flag.

The one always-on piece of state is the *dispatch counter*
(:func:`record_dispatch`, :func:`counting_dispatches`), guarded by the
registry lock so threaded callers do not lose increments.  Its callers
are the compiled-program layer's, which the port has not brought yet; the
kernels count their own launches (``quantize_blocks.launches`` & co.).

Determinism
-----------
``enable(deterministic=True)`` replaces the wall clock with a monotone
integer sequence: every ``clock()`` read returns the next integer, so
span timestamps and durations become pure functions of the event order
and two identical runs (after ``reset()``) produce bitwise-identical
event streams.  ``set_clock()`` injects an arbitrary clock — the
resilience incident log stamps its records through :func:`clock`, so
chaos runs can pin time entirely.

Kept free of torch imports so every module can import it without
ordering constraints.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from .hist import Histogram

__all__ = [
    "enabled",
    "enable",
    "disable",
    "is_enabled",
    "is_deterministic",
    "clock",
    "set_clock",
    "span",
    "inc",
    "gauge",
    "observe",
    "histogram",
    "record_event",
    "account_bytes",
    "events",
    "snapshot",
    "reset",
    "set_jsonl",
    "jsonl_path",
    "set_max_events",
    "trace_ctx",
    "current_trace",
    "record_dispatch",
    "dispatch_count",
    "reset_dispatch_count",
    "counting_dispatches",
]

#: THE module-level flag.  Instrumented hot paths read this attribute
#: directly (``if _core.enabled:``); everything else in this module is
#: behind that predicate.
enabled: bool = False

_lock = threading.RLock()
_deterministic = False
_det_seq = 0
_wall: Callable[[], float] = time.monotonic  # injectable via set_clock()

_counters: Dict[str, int] = {}
_gauges: Dict[str, float] = {}
#: per-site span aggregates: site -> [count, total_seconds]
_spans: Dict[str, List[float]] = {}
#: streaming histograms (telemetry.hist.Histogram) fed by observe()
_hists: Dict[str, Histogram] = {}
#: the bounded event list (newest last); spans append one event at exit
_events: List[dict] = []
_MAX_EVENTS = 1 << 16

#: the flight recorder's always-on ring append, registered by
#: :mod:`heat_tpu_torch.telemetry.flight` at import so _emit never has to
#: import it (None until that module loads)
_flight_append: Optional[Callable[[dict], None]] = None

#: the ambient request-trace ids (tentpole: request-scoped tracing).
#: A contextvar, not a threading.local: worker threads and async callers
#: each see the ids of their own context.
_trace_var: "contextvars.ContextVar[Tuple[str, ...]]" = contextvars.ContextVar(
    "heat_tpu_trace_ids", default=()
)

#: optional JSONL sink: every event is also appended to this file
_jsonl = None  # type: Optional[Any]
_jsonl_path: Optional[str] = None

#: Perfetto trace-event buffer; managed by telemetry.export.  Lives here
#: so span/event emission never has to import the exporter.
_trace_buf: Optional[List[dict]] = None

#: thread ids -> small stable indices (first-seen order), so exported
#: ``tid`` values are deterministic in single-threaded runs
_tids: Dict[int, int] = {}


# --------------------------------------------------------------------- #
# clock                                                                 #
# --------------------------------------------------------------------- #
def clock() -> float:
    """The telemetry timestamp source (seconds, monotonic).

    In deterministic mode every read returns the next integer of a
    monotone sequence instead of a wall-clock value; :func:`reset`
    rewinds the sequence, making event streams bitwise replayable.
    The resilience incident log (:mod:`heat_tpu_torch.resilience.incidents`)
    stamps its records through this function, so a test can pin incident
    timestamps with :func:`set_clock` or deterministic mode.
    """
    global _det_seq
    if _deterministic:
        with _lock:
            t = float(_det_seq)
            _det_seq += 1
        return t
    return _wall()


def set_clock(fn: Optional[Callable[[], float]]) -> None:
    """Inject a replacement wall clock (``None`` restores
    ``time.monotonic``).  Ignored while deterministic mode is active."""
    global _wall
    _wall = time.monotonic if fn is None else fn


# --------------------------------------------------------------------- #
# enable / disable                                                      #
# --------------------------------------------------------------------- #
def enable(deterministic: bool = False) -> None:
    """Turn telemetry collection on.

    ``deterministic=True`` switches :func:`clock` to the monotone
    integer sequence (see the module docstring)."""
    global enabled, _deterministic, _det_seq
    with _lock:
        _deterministic = bool(deterministic)
        if _deterministic:
            _det_seq = 0
        enabled = True


def disable() -> None:
    """Turn telemetry collection off (recorded data stays until
    :func:`reset`; :func:`snapshot` answers ``{}`` while disabled)."""
    global enabled, _deterministic
    with _lock:
        enabled = False
        _deterministic = False


def is_enabled() -> bool:
    return enabled


def is_deterministic() -> bool:
    return _deterministic


def reset() -> None:
    """Drop all recorded counters, gauges, span aggregates, and events,
    and rewind the deterministic sequence.  The dispatch counter is NOT
    touched — it predates telemetry and tests scope it with
    :func:`counting_dispatches` instead."""
    global _det_seq
    with _lock:
        _counters.clear()
        _gauges.clear()
        _spans.clear()
        _hists.clear()
        _events.clear()
        _tids.clear()
        if _trace_buf is not None:
            _trace_buf.clear()
        _det_seq = 0


# --------------------------------------------------------------------- #
# emission                                                              #
# --------------------------------------------------------------------- #
def _tid() -> int:
    ident = threading.get_ident()
    t = _tids.get(ident)
    if t is None:
        t = len(_tids) + 1
        _tids[ident] = t
    return t


def _emit(ev: dict) -> None:
    """Append one event under the lock: bounded in-memory list, JSONL
    sink, the flight-recorder ring, and the Perfetto buffer when a trace
    is being collected.

    Overflow of the bounded list is NEVER silent: the drop is counted
    under ``telemetry.events.dropped`` — surfaced by ``snapshot()`` and
    the ``/metrics`` endpoint — so a long-running server that outlives
    the buffer shows exactly how much of the stream it lost.  The JSONL
    sink, flight ring, and trace buffer still receive the event (each is
    bounded or externally drained on its own)."""
    with _lock:
        if len(_events) < _MAX_EVENTS:
            _events.append(ev)
        else:
            _counters["telemetry.events.dropped"] = (
                _counters.get("telemetry.events.dropped", 0) + 1
            )
        if _jsonl is not None:
            _jsonl.write(json.dumps(ev, sort_keys=True, default=str) + "\n")
        if _flight_append is not None:
            _flight_append(ev)
        if _trace_buf is not None:
            _trace_buf.append(_trace_event(ev))


def set_max_events(n: Optional[int]) -> int:
    """Cap the bounded in-memory event list at ``n`` (``None`` restores
    the default 2**16); returns the previous cap.  Tests shrink the cap
    to exercise the ``telemetry.events.dropped`` overflow accounting
    without emitting 65k events."""
    global _MAX_EVENTS
    with _lock:
        prev = _MAX_EVENTS
        _MAX_EVENTS = (1 << 16) if n is None else int(n)
    return prev


def _trace_event(ev: dict) -> dict:
    """Map one telemetry event onto the Chrome/Perfetto trace_event
    schema (https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU):
    spans become complete ("X") slices, everything else an instant."""
    ts = int(ev.get("ts", 0.0) * 1e6)
    args = {
        k: v for k, v in ev.items() if k not in ("type", "site", "ts", "dur")
    }
    out = {
        "name": ev.get("site", ev.get("type", "event")),
        "cat": ev.get("type", "event"),
        "ts": ts,
        "tid": ev.get("tid", 0),
    }
    if ev.get("type") == "span":
        out["ph"] = "X"
        out["dur"] = int(ev.get("dur", 0.0) * 1e6)
    else:
        out["ph"] = "i"
        out["s"] = "t"
    if args:
        out["args"] = args
    return out


def record_event(etype: str, site: str = "", **fields) -> None:
    """Record one instant event (guard incidents, checkpoint saves,
    retries …) of type ``etype``.  No-op while disabled.
    Events emitted inside a :func:`trace_ctx` carry the active request
    ids under ``rid``."""
    if not enabled:
        return
    ev = {"type": etype, "site": site, "ts": clock(), "tid": _tid()}
    rids = _trace_var.get()
    if rids:
        ev["rid"] = list(rids)
    ev.update(fields)
    _emit(ev)


def inc(name: str, n: int = 1) -> None:
    """Add ``n`` to a named counter.  No-op while disabled."""
    if not enabled:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def gauge(name: str, value: float) -> None:
    """Set a named gauge to ``value``.  No-op while disabled.

    While a Perfetto trace is being collected the update also lands on
    the timeline as a counter ("C") event, so live gauges — e.g. the
    exact-vs-wire compression ratio — render as a graph over time."""
    if not enabled:
        return
    with _lock:
        _gauges[name] = value
        if _trace_buf is not None:
            _trace_buf.append(
                {
                    "name": name,
                    "ph": "C",
                    "ts": int(clock() * 1e6),
                    "tid": 0,
                    "args": {"value": value},
                }
            )


def observe(name: str, value: float) -> None:
    """Record one observation into the named streaming histogram
    (:class:`heat_tpu_torch.telemetry.hist.Histogram` — fixed memory,
    log-bucketed, quantiles within the documented ~4.4% relative bound).
    No-op while disabled; the histogram appears in ``snapshot()`` under
    ``hists`` and on ``/metrics`` as a Prometheus histogram."""
    if not enabled:
        return
    with _lock:
        h = _hists.get(name)
        if h is None:
            h = _hists[name] = Histogram()
        h.record(value)


def histogram(name: str) -> Optional[Histogram]:
    """The live histogram registered under ``name`` (None if nothing has
    been observed there).  The object is shared — copy() before mutating."""
    with _lock:
        return _hists.get(name)


# --------------------------------------------------------------------- #
# request-scoped trace context                                          #
# --------------------------------------------------------------------- #
@contextlib.contextmanager
def trace_ctx(*request_ids):
    """Tag everything telemetry records in this context with request ids.

    The tentpole of request-scoped observability: ``trace_ctx("rq-17")``
    installs the id in a contextvar, and every span and instant event
    that closes inside the context carries ``rid=[...]`` — on the event
    stream, in the JSONL sink, in the flight-recorder ring, and in the
    Perfetto export (as ``args.rid``), so one slow request can be walked
    from its reply back through any nested ``comm:*`` spans to the
    device dispatch that served it.

    Nested contexts ACCUMULATE: a micro-batch context carrying every
    coalesced request's id may sit inside (or around) a single request's
    context, and the union is what lands on the events.  Ids may be
    strings or anything ``str()``-able; an iterable argument is
    flattened one level so ``trace_ctx(ids_list)`` works.

    Cost: one contextvar set/reset per ``with`` block — no predicate on
    the telemetry flag, because the context must already be installed
    when collection is enabled mid-request; the per-site disabled cost
    contract is untouched (sites still guard on ``_core.enabled``).

    Host-side only: inside a captured CUDA graph the context manager runs
    at capture time and tags nothing at replay.
    """
    flat: List[str] = []
    for rid in request_ids:
        if isinstance(rid, (list, tuple, set, frozenset)):
            flat.extend(str(r) for r in rid)
        else:
            flat.append(str(rid))
    token = _trace_var.set(_trace_var.get() + tuple(flat))
    try:
        yield tuple(flat)
    finally:
        _trace_var.reset(token)


def current_trace() -> Tuple[str, ...]:
    """The active request ids (empty tuple outside any trace_ctx)."""
    return _trace_var.get()


def account_bytes(op: str, mode: str, exact_bytes: int, wire_bytes: int) -> None:
    """Credit one collective's traffic to the exact-vs-wire ledger.

    ``exact_bytes`` is what the payload would cost on the wire as exact
    f32 (the common denominator the bench suite already reports in);
    ``wire_bytes`` what the resolved precision mode actually ships.  The
    per-mode compression ratio is maintained as a live gauge
    ``comm.wire_ratio.<mode>`` — for ``int8_block`` ring traffic it sits
    at ``(BLOCK + 4) / (4 * BLOCK)`` = 0.258x (see heat_tpu_torch.comm).
    No-op while disabled."""
    if not enabled:
        return
    with _lock:
        _counters[f"comm.collectives.{op}"] = (
            _counters.get(f"comm.collectives.{op}", 0) + 1
        )
        for name, val in (
            (f"comm.exact_bytes.{mode}", exact_bytes),
            (f"comm.wire_bytes.{mode}", wire_bytes),
            ("comm.exact_bytes", exact_bytes),
            ("comm.wire_bytes", wire_bytes),
        ):
            _counters[name] = _counters.get(name, 0) + int(val)
        exact = _counters[f"comm.exact_bytes.{mode}"]
        if exact:
            _gauges[f"comm.wire_ratio.{mode}"] = (
                _counters[f"comm.wire_bytes.{mode}"] / exact
            )
        total_exact = _counters["comm.exact_bytes"]
        if total_exact:
            _gauges["comm.wire_ratio"] = _counters["comm.wire_bytes"] / total_exact


# --------------------------------------------------------------------- #
# spans                                                                 #
# --------------------------------------------------------------------- #
class _Span:
    """One ``telemetry.span("site")`` — context manager and decorator.

    Enter/exit are each a single predicate when telemetry is disabled.
    On exit the span lands twice: in the per-site aggregate (count +
    total seconds, what ``snapshot()`` reports) and as one event on the
    stream (what the JSONL sink and the Perfetto exporter consume).
    Exceptions propagate; the span still records, tagged with the
    exception type."""

    __slots__ = ("site", "fields", "_t0")

    def __init__(self, site: str, fields: Optional[dict] = None):
        self.site = site
        self.fields = fields or None
        self._t0 = None

    def __enter__(self):
        if enabled:
            self._t0 = clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._t0 is None:
            return False
        t1 = clock()
        dur = t1 - self._t0
        ev = {
            "type": "span",
            "site": self.site,
            "ts": self._t0,
            "dur": dur,
            "tid": _tid(),
        }
        rids = _trace_var.get()
        if rids:
            ev["rid"] = list(rids)
        if self.fields:
            ev.update(self.fields)
        if exc_type is not None:
            ev["error"] = exc_type.__name__
        with _lock:
            agg = _spans.get(self.site)
            if agg is None:
                _spans[self.site] = [1, dur]
            else:
                agg[0] += 1
                agg[1] += dur
            _emit(ev)
        self._t0 = None
        return False

    def __call__(self, fn):
        """Decorator form: ``@telemetry.span("site")``.  The wrapper
        re-checks the flag per call, so decoration at import time with
        telemetry disabled still records once it is enabled."""
        site, fields = self.site, self.fields

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not enabled:
                return fn(*args, **kwargs)
            with _Span(site, fields):
                return fn(*args, **kwargs)

        wrapper.__telemetry_site__ = site
        return wrapper


def span(site: str, **fields) -> _Span:
    """A host-side timing span — use as a ``with`` block or a decorator.

    NOTE: spans are host-side by construction.  Around an asynchronous
    kernel launch a span measures the enqueue, not the device time; a span
    inside CUDA-graph capture measures the capture.
    """
    return _Span(site, fields or None)


# --------------------------------------------------------------------- #
# reading                                                               #
# --------------------------------------------------------------------- #
def events() -> Tuple[dict, ...]:
    """Snapshot of the recorded event stream (oldest first)."""
    with _lock:
        return tuple(_events)


def snapshot() -> dict:
    """The in-memory export: counters, gauges, and per-site span totals.

    Empty dict while telemetry is disabled — the cheap way for callers
    to branch on "was anything collected"."""
    if not enabled:
        return {}
    with _lock:
        return {
            "counters": dict(_counters),
            "gauges": dict(_gauges),
            "spans": {
                site: {"count": int(c), "total_s": t}
                for site, (c, t) in sorted(_spans.items())
            },
            "hists": {name: _hists[name].state() for name in sorted(_hists)},
            "events": len(_events),
        }


# --------------------------------------------------------------------- #
# JSONL sink                                                            #
# --------------------------------------------------------------------- #
def set_jsonl(path: Optional[str]) -> None:
    """Stream every subsequent event to ``path`` as one JSON object per
    line (``None`` closes the sink)."""
    global _jsonl, _jsonl_path
    with _lock:
        if _jsonl is not None:
            _jsonl.close()
            _jsonl = None
            _jsonl_path = None
        if path is not None:
            _jsonl = open(path, "a", buffering=1)
            _jsonl_path = str(path)


def jsonl_path() -> Optional[str]:
    return _jsonl_path


# --------------------------------------------------------------------- #
# dispatch counter                                                      #
# --------------------------------------------------------------------- #
_dispatches = 0


def record_dispatch() -> None:
    """Count one device program launch.  Always on (dispatch-count gates
    read it with telemetry disabled); the increment is lock-guarded, so
    threaded callers do not lose launches.  With telemetry enabled the launch also lands on
    the ``dispatches`` registry counter."""
    global _dispatches
    with _lock:
        _dispatches += 1
        if enabled:
            _counters["dispatches"] = _counters.get("dispatches", 0) + 1


def dispatch_count() -> int:
    """Device program launches recorded since the last reset."""
    return _dispatches


def reset_dispatch_count() -> None:
    global _dispatches
    with _lock:
        _dispatches = 0


class _DispatchWindow:
    """Handle yielded by :func:`counting_dispatches`: ``.count`` is the
    number of dispatches since the window opened."""

    __slots__ = ("_base",)

    def __init__(self, base: int):
        self._base = base

    @property
    def count(self) -> int:
        return _dispatches - self._base


@contextlib.contextmanager
def counting_dispatches():
    """Scoped dispatch counting.

    Yields a window whose ``.count`` property reads the launches made
    since entry — a baseline diff, not a global reset, so concurrent
    tests (or nested windows) never leak counter state into each other::

        with counting_dispatches() as d:
            program(x)
        assert d.count == 1
    """
    yield _DispatchWindow(_dispatches)
