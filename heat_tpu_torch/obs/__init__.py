"""``heat_tpu_torch.obs``: the observability facade.

Port of ``heat_tpu/obs``: one import surface for the request-scoped
observability layer built on :mod:`heat_tpu_torch.telemetry`:

- :func:`trace_ctx`: request-scoped trace context (everything emitted
  inside ``with obs.trace_ctx("req-42"):`` carries the id under ``rid``);
- :func:`observe` / :class:`Histogram`: fixed-memory streaming latency
  distributions;
- :class:`SloMonitor`: multi-window burn-rate SLO alerting;
- :mod:`flight <heat_tpu_torch.telemetry.flight>`: the flight recorder;
- :class:`MetricsServer`: the loopback ``/metrics`` + ``/healthz`` +
  ``/varz`` endpoint.

Everything here is re-exported from :mod:`heat_tpu_torch.telemetry`;
this module adds no state.
"""

from ..telemetry import (  # noqa: F401
    Histogram,
    MetricsServer,
    SloMonitor,
    current_trace,
    flight,
    histogram,
    observe,
    prometheus_text,
    trace_ctx,
)
from ..telemetry._core import snapshot  # noqa: F401

__all__ = [
    "trace_ctx",
    "current_trace",
    "observe",
    "histogram",
    "snapshot",
    "Histogram",
    "SloMonitor",
    "flight",
    "MetricsServer",
    "prometheus_text",
]
