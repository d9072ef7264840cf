"""The always-on flight recorder: a bounded ring of recent events.

Port of ``heat_tpu/telemetry/flight.py`` (stdlib only, copied; field
names and strings kept, so a postmortem compares byte for byte with the
reference's).  Telemetry proper is opt-in (one predicate per site while
disabled) — which means that when an incident fires in a
process that never enabled collection, there is *no* surrounding context
for the postmortem: no events before the guard tripped, no counters, no
idea what the engine was doing.  The flight recorder closes that gap the
way a real flight recorder does: a small, bounded, lock-guarded ring of
recent events that is **on by default** and cheap enough to stay on —
recording one note costs one module-flag predicate, one clock read, one
dict, and one deque append (the deque's ``maxlen`` does the eviction, so
there is no growth and no compaction pause).  The ring holds the last
``capacity`` (default 256) events and nothing else, so its memory is
bounded by construction.

Two feeds:

- with telemetry ENABLED, every event `_core._emit` handles (spans,
  instants, incidents) is mirrored into the ring via the
  ``_core._flight_append`` hook this module registers at import — the
  ring is then simply the tail of the full stream;
- with telemetry DISABLED, instrumented sites record nothing (their
  contract), but *critical* paths — the resilience incident log — call
  :func:`note` directly, so the ring always holds at least the
  incident-adjacent history.

Postmortems: whenever :mod:`heat_tpu_torch.resilience.incidents` records an
incident it calls :func:`on_incident`, which snapshots the ring plus the
live counters/gauges/histograms/dispatch count into one deterministic
JSON artifact (canonical key order, stable field set).  With a dump
directory configured (``set_dump_dir`` or ``HEAT_FLIGHT_DIR``) the
artifact is written atomically as ``postmortem-<seq>-<kind>.json``;
otherwise it is retained in memory (:func:`last_dump`).  Under
``telemetry.enable(deterministic=True)`` every timestamp in the
artifact comes from the monotone sequence clock, so two runs of the
same seeded chaos scenario produce **byte-identical** dumps — the
replayability contract the chaos lane asserts.

Like the rest of :mod:`heat_tpu_torch.telemetry`, this module imports
no torch.
"""

from __future__ import annotations

import collections
import json
import os
import threading
from typing import Any, Dict, Optional, Tuple

from . import _core

__all__ = [
    "note",
    "enable",
    "disable",
    "is_enabled",
    "ring",
    "clear",
    "capacity",
    "set_capacity",
    "set_dump_dir",
    "dump_dir",
    "postmortem",
    "dump_postmortem",
    "on_incident",
    "last_dump",
    "last_dump_path",
    "encode",
]

#: THE module flag — :func:`note` is a no-op when False.  On by default:
#: the recorder is the part of observability that must not need turning on.
_active: bool = True

_lock = threading.Lock()
_ring: "collections.deque[dict]" = collections.deque(maxlen=256)
_dump_dir: Optional[str] = None
_last_dump: Optional[dict] = None
_last_dump_path: Optional[str] = None
_n_dumps = 0


def _append(ev: dict) -> None:
    """The `_core._emit` mirror hook: called under _core's lock with the
    already-built event; the deque append is itself thread-safe but the
    flight lock also serializes against ring() snapshots."""
    if not _active:
        return
    with _lock:
        _ring.append(ev)


# register the mirror: every telemetry event also lands on the ring
_core._flight_append = _append


def note(etype: str, site: str = "", **fields) -> None:
    """Record one event on the ring regardless of the telemetry flag.

    This is the always-on entry point for critical paths (incidents,
    degrades): one predicate, one clock read, one dict, one bounded
    append.  Events noted inside a :func:`heat_tpu_torch.telemetry.trace_ctx`
    carry the active request ids under ``rid``."""
    if not _active:
        return
    ev: Dict[str, Any] = {"type": etype, "site": site, "ts": _core.clock()}
    rids = _core.current_trace()
    if rids:
        ev["rid"] = list(rids)
    if fields:
        ev.update(fields)
    with _lock:
        _ring.append(ev)


def enable() -> None:
    global _active
    _active = True


def disable() -> None:
    """Turn the recorder off (for A/B overhead measurements; production
    keeps it on — that is the point of a flight recorder)."""
    global _active
    _active = False


def is_enabled() -> bool:
    return _active


def ring() -> Tuple[dict, ...]:
    """Snapshot of the ring, oldest first."""
    with _lock:
        return tuple(_ring)


def clear() -> None:
    with _lock:
        _ring.clear()


def capacity() -> int:
    return _ring.maxlen or 0


def set_capacity(n: int) -> None:
    """Resize the ring to hold the last ``n`` events (keeps the newest
    tail of the current contents)."""
    global _ring
    n = int(n)
    if n < 1:
        raise ValueError(f"flight ring needs capacity >= 1, got {n}")
    with _lock:
        _ring = collections.deque(_ring, maxlen=n)


def set_dump_dir(path: Optional[str]) -> None:
    """Directory postmortem artifacts are written to (``None`` keeps
    dumps in memory only; ``HEAT_FLIGHT_DIR`` sets this at import)."""
    global _dump_dir
    _dump_dir = None if path is None else str(path)


def dump_dir() -> Optional[str]:
    return _dump_dir


# --------------------------------------------------------------------- #
# postmortem artifacts
# --------------------------------------------------------------------- #
def encode(doc: dict) -> str:
    """THE canonical serialization for postmortem artifacts: sorted keys,
    fixed separators, ``str()`` fallback — byte-stable for any given
    document, which is what makes dump determinism assertable."""
    return json.dumps(doc, sort_keys=True, separators=(",", ":"), default=str)


def postmortem(incident: Optional[Any] = None) -> dict:
    """Build the postmortem document: the ring, the live telemetry
    counters/gauges/histograms (straight off the registry — present even
    while ``snapshot()`` answers ``{}`` because collection is disabled;
    they are then simply empty), the incident log tail, and the
    triggering incident when given."""
    from ..resilience import incidents as _incidents

    with _lock:
        ring_events = list(_ring)
    with _core._lock:
        counters = dict(_core._counters)
        gauges = dict(_core._gauges)
        hists = {name: _core._hists[name].state() for name in sorted(_core._hists)}
    doc: Dict[str, Any] = {
        "schema": 1,
        "kind": "heat_tpu-flight-postmortem",
        "ring": ring_events,
        "ring_capacity": capacity(),
        "counters": counters,
        "gauges": gauges,
        "hists": hists,
        "dispatches": _core.dispatch_count(),
        "telemetry_enabled": _core.is_enabled(),
        "deterministic": _core.is_deterministic(),
        "chaos_seed": os.environ.get("HEAT_CHAOS_SEED"),
        "incident_log": [inc.render() for inc in _incidents.incident_log()],
    }
    if incident is not None:
        doc["incident"] = {
            "seq": incident.seq,
            "kind": incident.kind,
            "site": incident.site,
            "policy": incident.policy,
            "action": incident.action,
            "detail": incident.detail,
            "timestamp": incident.timestamp,
        }
    return doc


def dump_postmortem(incident: Optional[Any] = None) -> Optional[str]:
    """Build and persist one postmortem.  Returns the artifact path, or
    ``None`` when no dump directory is configured (the document is still
    retained — :func:`last_dump`).  Writes are same-dir-temp +
    ``os.replace``: a reader never sees half a file."""
    global _last_dump, _last_dump_path, _n_dumps
    doc = postmortem(incident)
    _last_dump = doc
    _n_dumps += 1
    if _dump_dir is None:
        _last_dump_path = None
        return None
    os.makedirs(_dump_dir, exist_ok=True)
    seq = incident.seq if incident is not None else _n_dumps
    kind = incident.kind if incident is not None else "manual"
    name = f"postmortem-{seq:04d}-{kind}.json"
    path = os.path.join(_dump_dir, name)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        fh.write(encode(doc))
        fh.write("\n")
    os.replace(tmp, path)
    _last_dump_path = path
    return path


def on_incident(incident, *, already_streamed: bool = False) -> Optional[str]:
    """The hook :mod:`heat_tpu_torch.resilience.incidents` calls for every
    recorded incident: note it on the ring (skipped when telemetry is
    enabled and the incident event already arrived via the `_emit`
    mirror — ``already_streamed``) and dump the postmortem artifact."""
    if not _active:
        return None
    if not already_streamed:
        note(
            "incident",
            site=incident.site,
            kind=incident.kind,
            policy=incident.policy,
            action=incident.action,
            detail=incident.detail,
            seq=incident.seq,
        )
    return dump_postmortem(incident)


def last_dump() -> Optional[dict]:
    """The most recent postmortem document (None before any dump)."""
    return _last_dump


def last_dump_path() -> Optional[str]:
    return _last_dump_path
