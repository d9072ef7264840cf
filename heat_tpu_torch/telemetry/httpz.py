"""Live introspection endpoint: ``/metrics``, ``/healthz``, ``/varz``.

Port of ``heat_tpu/telemetry/httpz.py`` (stdlib only, copied).  A
stdlib-only (``http.server``) HTTP listener that runs on its own
daemon thread — entirely off the request path: handlers READ the
telemetry registry under its lock and serialize; they never touch the
device or the arrays.

- ``GET /metrics`` — Prometheus text exposition (version 0.0.4):
  every telemetry counter as a ``counter`` (name suffixed ``_total``),
  every gauge as a ``gauge`` (``comm.wire_ratio`` and friends included),
  every streaming histogram as a Prometheus ``histogram``
  (``_bucket{le="..."}`` cumulative counts from the log8 buckets, plus
  ``_sum``/``_count``), and the always-on extras: the device dispatch
  counter (``heat_dispatches_total``, live even with telemetry
  disabled) and ``heat_telemetry_enabled``.  Metric names are the
  telemetry names with non-``[a-zA-Z0-9_:]`` characters mapped to
  ``_`` and a ``heat_`` prefix; values are rendered with ``repr`` so
  they parse back to exactly the ``snapshot()`` numbers.
- ``GET /healthz`` — 200 ``ok`` while the process serves.
- ``GET /varz`` — one JSON document: the full ``telemetry.snapshot()``,
  dispatch count, flight-recorder status, and whatever dict the owning
  component contributes.

**Security note:** the listener binds ``127.0.0.1`` ONLY — it exposes
operational internals (model names, tenant ids, latency distributions)
with no authentication, so it must never face a network.  A non-loopback
bind host is rejected at construction (the shared ``heat_tpu_torch.net``
policy); fleet deployments should scrape via a node-local agent or an
authenticated sidecar.
"""

from __future__ import annotations

import http.server
import json
import re
from typing import Callable, Dict, Optional

from ..net._base import LOOPBACK_HOSTS, LoopbackHTTPServer
from . import _core
from . import flight as _flight

__all__ = ["MetricsServer", "prometheus_text", "sanitize_metric_name"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_LOOPBACK = LOOPBACK_HOSTS  # alias; the policy lives in heat_tpu_torch.net


def sanitize_metric_name(name: str) -> str:
    """Telemetry name -> Prometheus metric name (``heat_`` prefix,
    illegal characters to ``_``)."""
    out = _NAME_RE.sub("_", name)
    if not out or not (out[0].isalpha() or out[0] in "_:"):
        out = "_" + out
    return "heat_" + out


def _fmt(v) -> str:
    """Render one sample value.  Integers print as integers; floats via
    repr (shortest round-trip), so a scraper parses back the exact
    ``snapshot()`` value."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    f = float(v)
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    return repr(f)


def prometheus_text() -> str:
    """The ``/metrics`` document, built from the live registry.

    Counters/gauges/histograms come straight off the telemetry store
    (empty while collection is disabled); the dispatch counter and the
    enabled/flight flags are always present, so a scrape of a quiet
    process still proves liveness."""
    with _core._lock:
        counters = dict(_core._counters)
        gauges = dict(_core._gauges)
        hists = {name: _core._hists[name] for name in sorted(_core._hists)}
        hist_rows = {
            name: (h.prom_buckets(), h.count, h.sum) for name, h in hists.items()
        }
    lines = []
    for name in sorted(counters):
        m = sanitize_metric_name(name) + "_total"
        lines.append(f"# HELP {m} heat_tpu telemetry counter {name}")
        lines.append(f"# TYPE {m} counter")
        lines.append(f"{m} {_fmt(counters[name])}")
    for name in sorted(gauges):
        m = sanitize_metric_name(name)
        lines.append(f"# HELP {m} heat_tpu telemetry gauge {name}")
        lines.append(f"# TYPE {m} gauge")
        lines.append(f"{m} {_fmt(gauges[name])}")
    for name, (buckets, count, total) in hist_rows.items():
        m = sanitize_metric_name(name)
        lines.append(f"# HELP {m} heat_tpu streaming histogram {name} (log8 buckets)")
        lines.append(f"# TYPE {m} histogram")
        for le, cum in buckets:
            lines.append(f'{m}_bucket{{le="{_fmt(le)}"}} {cum}')
        lines.append(f'{m}_bucket{{le="+Inf"}} {count}')
        lines.append(f"{m}_sum {_fmt(total)}")
        lines.append(f"{m}_count {count}")
    # the always-on tail: liveness with zero telemetry configured
    lines.append("# HELP heat_dispatches_total device program launches")
    lines.append("# TYPE heat_dispatches_total counter")
    lines.append(f"heat_dispatches_total {_core.dispatch_count()}")
    lines.append("# HELP heat_telemetry_enabled telemetry collection flag")
    lines.append("# TYPE heat_telemetry_enabled gauge")
    lines.append(f"heat_telemetry_enabled {1 if _core.is_enabled() else 0}")
    lines.append("# HELP heat_flight_ring_events flight-recorder ring occupancy")
    lines.append("# TYPE heat_flight_ring_events gauge")
    lines.append(f"heat_flight_ring_events {len(_flight.ring())}")
    return "\n".join(lines) + "\n"


class _Handler(http.server.BaseHTTPRequestHandler):
    # set per-server via the class attribute trick below
    varz_fn: Optional[Callable[[], Dict]] = None

    def _send(self, code: int, body: str, ctype: str) -> None:
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):  # noqa: N802 - http.server API
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            self._send(
                200, prometheus_text(),
                "text/plain; version=0.0.4; charset=utf-8",
            )
        elif path == "/healthz":
            self._send(200, "ok\n", "text/plain; charset=utf-8")
        elif path == "/varz":
            doc = {
                "telemetry": _core.snapshot(),
                "telemetry_enabled": _core.is_enabled(),
                "dispatches": _core.dispatch_count(),
                "flight": {
                    "enabled": _flight.is_enabled(),
                    "capacity": _flight.capacity(),
                    "events": len(_flight.ring()),
                    "last_dump": _flight.last_dump_path(),
                },
            }
            fn = type(self).varz_fn
            if fn is not None:
                try:
                    doc.update(fn())
                except Exception as e:  # introspection must not 500 the scrape
                    doc["varz_error"] = f"{type(e).__name__}: {e}"
            self._send(
                200, json.dumps(doc, sort_keys=True, default=str) + "\n",
                "application/json",
            )
        else:
            self._send(404, "not found\n", "text/plain; charset=utf-8")

    def log_message(self, fmt, *args):  # silence per-request stderr lines
        pass


class MetricsServer(LoopbackHTTPServer):
    """The loopback-only introspection listener (see module docs).

    ``port=0`` (default) picks a free ephemeral port — read it back from
    ``.port``.  ``varz`` is an optional ``() -> dict`` merged into the
    ``/varz`` document.  Lifecycle (daemon serving thread, synchronous
    idempotent ``close()``, context-manager form) comes from the shared
    ``heat_tpu_torch.net`` base.
    """

    def __init__(
        self,
        *,
        port: int = 0,
        host: str = "127.0.0.1",
        varz: Optional[Callable[[], Dict]] = None,
    ):
        handler = type("_BoundHandler", (_Handler,), {"varz_fn": staticmethod(varz) if varz else None})
        super().__init__(handler, port=port, host=host, name="heat-metrics")
