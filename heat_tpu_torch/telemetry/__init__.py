"""``heat_tpu_torch.telemetry`` — unified runtime observability.

Port of ``heat_tpu/telemetry``: one registry for everything the runtime
can tell you about itself, with the reference's ``__all__``.

- **spans** — ``telemetry.span("site")`` (context manager + decorator),
  emitted by the ported paths: the compressed collectives
  (``commq:allreduce``/``commq:allgather`` around the
  ``comm:<ring>:step:issue``/``:consume`` pair), the communicator's exact
  collectives and reshards, and estimator ``fit``/``predict``
  (``fit:<Class>``);
- **counters & gauges** — collective invocations with exact-vs-wire byte
  accounting per precision mode (the compression ratio is the live gauge
  ``comm.wire_ratio.<mode>``), ring dispatches, guard incidents, retries;
- **exporters** — ``snapshot()`` (in-memory dict), a JSONL sink
  (``set_jsonl(path)``), and Chrome/Perfetto trace-event JSON
  (``start_trace(path)`` / ``stop_trace()``, optionally with a
  ``torch.profiler`` device capture beside it);
- **request tracing** — ``trace_ctx("req-1")`` tags every span and event
  emitted inside the context with the active request ids (``rid``);
- **streaming histograms & SLOs** — ``observe(name, value)`` feeds a
  fixed-memory log-bucketed :class:`~heat_tpu_torch.telemetry.hist.Histogram`
  (quantiles within a documented ~4.4% relative bound, mergeable across
  threads); :class:`~heat_tpu_torch.telemetry.slo.SloMonitor` turns a
  latency stream into multi-window burn-rate gauges and a structured
  incident when the error budget burns;
- **flight recorder** — :mod:`heat_tpu_torch.telemetry.flight`, an
  always-on bounded ring of recent events that dumps a deterministic
  postmortem JSON whenever an incident records;
- **live endpoint** — :class:`~heat_tpu_torch.telemetry.httpz.MetricsServer`,
  a loopback-only ``/metrics`` (Prometheus text) + ``/healthz`` +
  ``/varz`` listener.

Disabled (the default) it costs one predicate per instrumented site: no
allocation, no clock read, no launch and no host sync.
``enable(deterministic=True)`` swaps timestamps for a monotone sequence
so tests can assert on event streams bitwise.  ``HEAT_TELEMETRY=1``
enables collection from the environment.
"""

from ._core import (
    account_bytes,
    clock,
    counting_dispatches,
    disable,
    dispatch_count,
    enable,
    events,
    gauge,
    inc,
    is_deterministic,
    is_enabled,
    current_trace,
    histogram,
    jsonl_path,
    observe,
    record_dispatch,
    record_event,
    reset,
    reset_dispatch_count,
    set_clock,
    set_jsonl,
    set_max_events,
    snapshot,
    span,
    trace_ctx,
)
from .export import start_trace, stop_trace, trace_active
from .hist import Histogram
from .slo import SloMonitor
from . import flight
from .httpz import MetricsServer, prometheus_text

__all__ = [
    "enable",
    "disable",
    "is_enabled",
    "is_deterministic",
    "enabled",
    "clock",
    "set_clock",
    "span",
    "inc",
    "gauge",
    "record_event",
    "account_bytes",
    "events",
    "snapshot",
    "reset",
    "set_jsonl",
    "jsonl_path",
    "record_dispatch",
    "dispatch_count",
    "reset_dispatch_count",
    "counting_dispatches",
    "start_trace",
    "stop_trace",
    "trace_active",
    "trace_ctx",
    "current_trace",
    "observe",
    "histogram",
    "set_max_events",
    "Histogram",
    "SloMonitor",
    "flight",
    "MetricsServer",
    "prometheus_text",
]


def __getattr__(name):
    # `telemetry.enabled` must track the live flag; a from-import at
    # package init would freeze the boolean at its import-time value
    if name == "enabled":
        from . import _core

        return _core.enabled
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
