"""Chrome/Perfetto trace export for the telemetry event stream.

Port of ``heat_tpu/telemetry/export.py``.  ``start_trace(path)`` begins
buffering every span, event, and gauge update as a Chrome
``trace_event`` record; ``stop_trace()`` writes the buffered timeline as
trace-event JSON (``{"traceEvents": [...]}``) that chrome://tracing and
https://ui.perfetto.dev load directly.  Host spans carry ``ph="X"``
(complete slices), instant events ``ph="i"``, gauges ``ph="C"`` (counter
tracks) — so one timeline shows the Python orchestration layer: the
compressed rings' issue/consume pairs, reshards, collectives, incidents.

Pass ``device_trace_dir=...`` to also run :class:`torch.profiler.profile`
(CPU and, where a CUDA device is present, CUDA activities) for the same
window: ``stop_trace`` writes its Chrome trace JSON, which names every
kernel launched, under that directory, and loading both into the
Perfetto UI lines Python orchestration up over device execution.  Torch
is imported lazily; a profiler that cannot start degrades to a host-only
capture with a warning, as the reference's does.

``HEAT_TELEMETRY=1`` in the environment enables collection at import
time; ``HEAT_TELEMETRY_JSONL=<path>`` opens the JSONL sink and
``HEAT_TELEMETRY_TRACE=<path>`` starts a trace that is flushed at
process exit.  ``HEAT_FLIGHT_DIR=<dir>`` points the always-on flight
recorder's postmortem dumps at a directory (the recorder itself needs no
flag — it is on by default).
"""

from __future__ import annotations

import atexit
import json
import os
import warnings
from typing import Optional

from . import _core

__all__ = ["start_trace", "stop_trace", "trace_active"]

_trace_path: Optional[str] = None
#: the running torch.profiler session and the directory its trace goes to
_device_prof = None
_device_dir: Optional[str] = None


def trace_active() -> bool:
    return _trace_path is not None


def start_trace(path: str, device_trace_dir: Optional[str] = None) -> None:
    """Begin collecting a Chrome/Perfetto trace into ``path``.

    Implicitly enables telemetry (a trace of nothing is useless); the
    enabled flag stays on after ``stop_trace`` — call
    :func:`heat_tpu_torch.telemetry.disable` to turn collection back off.
    """
    global _trace_path, _device_prof, _device_dir
    if _trace_path is not None:
        raise RuntimeError(f"a trace is already being collected into {_trace_path}")
    if not _core.enabled:
        _core.enable()
    _trace_path = str(path)
    with _core._lock:
        _core._trace_buf = []
    if device_trace_dir is not None:
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            else:
                warnings.warn("no CUDA device: the device trace holds host activity only")
            prof = profile(activities=activities)
            prof.start()
            _device_prof, _device_dir = prof, str(device_trace_dir)
        except Exception as e:
            warnings.warn(f"device trace capture unavailable ({e}); host-only trace")
            _device_prof = _device_dir = None


def _stop_device_trace() -> None:
    """Stop the profiler and write its Chrome trace JSON (atomically) as
    ``device-<pid>-<n>.json`` under the directory ``start_trace`` named."""
    global _device_prof, _device_dir
    prof, out_dir = _device_prof, _device_dir
    _device_prof = _device_dir = None
    try:
        prof.stop()
        os.makedirs(out_dir, exist_ok=True)
        n = sum(1 for f in os.listdir(out_dir) if f.startswith(f"device-{os.getpid()}-"))
        path = os.path.join(out_dir, f"device-{os.getpid()}-{n}.json")
        tmp = path + ".tmp"
        prof.export_chrome_trace(tmp)
        os.replace(tmp, path)
    except Exception as e:
        warnings.warn(f"device trace stop failed ({e})")


def stop_trace() -> Optional[str]:
    """Stop collecting and write the trace-event JSON; returns the path
    (``None`` when no trace was active)."""
    global _trace_path
    if _device_prof is not None:
        _stop_device_trace()
    if _trace_path is None:
        return None
    path = _trace_path
    _trace_path = None
    with _core._lock:
        buf, _core._trace_buf = _core._trace_buf, None
    doc = {
        "traceEvents": [dict(ev, pid=os.getpid()) for ev in (buf or [])],
        "displayTimeUnit": "ms",
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)  # atomic: a reader never sees half a trace
    return path


def _env_autostart() -> None:
    """The environment hooks (see module docstring)."""
    if os.environ.get("HEAT_TELEMETRY") == "1":
        _core.enable()
    jsonl = os.environ.get("HEAT_TELEMETRY_JSONL")
    if jsonl:
        _core.enable()
        _core.set_jsonl(jsonl)
    trace = os.environ.get("HEAT_TELEMETRY_TRACE")
    if trace:
        start_trace(trace)
        atexit.register(stop_trace)
    flight_dir = os.environ.get("HEAT_FLIGHT_DIR")
    if flight_dir:
        from . import flight

        flight.set_dump_dir(flight_dir)


_env_autostart()
