"""Structured incident log for the resilience layer.

Port of ``heat_tpu/resilience/incidents.py`` (stdlib only, copied).
Every guard intervention (a raised abort, a warned-and-continued call, a
degraded-to-exact fallback) and every unrecoverable health failure is
recorded here as an :class:`Incident` — a small frozen record the
operator (or a test) can assert on after the fact.  The log is
process-wide and append-only between explicit :func:`clear_incident_log`
calls; it never touches the device, so recording is free relative to the
collectives it describes.

Every recorded incident also triggers the always-on flight recorder
(:mod:`heat_tpu_torch.telemetry.flight`): the incident lands on the bounded
event ring and a deterministic postmortem JSON is dumped (to
``HEAT_FLIGHT_DIR`` when set, retained in memory otherwise) — so even a
process that never enabled telemetry leaves an incident-adjacent
artifact behind.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import List, Tuple

from ..telemetry import _core as _telemetry
from ..telemetry import flight as _flight

__all__ = ["Incident", "record", "incident_log", "clear_incident_log"]

_SEQ = itertools.count()
_LOG: List["Incident"] = []


@dataclass(frozen=True)
class Incident:
    """One guard intervention.

    ``seq`` is a process-wide monotone counter (stable ordering for
    tests), ``kind`` the detected condition (``"nonfinite"`` /
    ``"overflow"`` / ``"nonfinite-or-overflow"``), ``site`` the
    collective or program that tripped the guard (``"allreduce_q"``,
    ``"allgather_q"``, ``"fuse:<fn>"``), ``policy`` the guard policy in
    force, and ``action`` what the guard actually did (``"raised"`` /
    ``"warned"`` / ``"degraded"`` / ``"unrecoverable"`` — the last when a
    degrade re-run was itself unhealthy or no exact fallback exists).
    """

    seq: int
    kind: str
    site: str
    policy: str
    action: str
    detail: str = ""
    #: host-time seconds from the telemetry clock
    #: (:func:`heat_tpu_torch.telemetry.clock` — monotonic, injectable, and a
    #: plain sequence number in deterministic mode, so chaos-lane runs
    #: are clock-independent); informational only — never part of
    #: equality-sensitive test assertions
    timestamp: float = field(default=0.0, compare=False)

    def render(self) -> str:
        out = f"[{self.seq}] {self.site}: {self.kind} -> {self.action} (policy={self.policy})"
        if self.detail:
            out += f" — {self.detail}"
        return out


def record(kind: str, site: str, policy: str, action: str, detail: str = "") -> Incident:
    """Append one incident to the process-wide log and return it.

    With telemetry enabled the incident is also published on the event
    stream (type ``"incident"``) and counted under
    ``resilience.incidents`` / ``resilience.incidents.<action>`` — the
    resilience log doubles as a telemetry event source.  Regardless of
    the telemetry flag, the flight recorder notes the incident and dumps
    a postmortem (see module docs)."""
    inc = Incident(
        seq=next(_SEQ),
        kind=kind,
        site=site,
        policy=policy,
        action=action,
        detail=detail,
        timestamp=_telemetry.clock(),
    )
    _LOG.append(inc)
    if _telemetry.enabled:
        _telemetry.inc("resilience.incidents")
        _telemetry.inc(f"resilience.incidents.{action}")
        _telemetry.record_event(
            "incident",
            site=site,
            kind=kind,
            policy=policy,
            action=action,
            detail=detail,
            seq=inc.seq,
        )
    # always-on: ring note (skipped when the event above already reached
    # the ring via the _emit mirror) + deterministic postmortem dump
    _flight.on_incident(inc, already_streamed=_telemetry.enabled)
    return inc


def incident_log() -> Tuple[Incident, ...]:
    """Snapshot of all incidents since the last clear (oldest first)."""
    return tuple(_LOG)


def clear_incident_log() -> None:
    """Drop all recorded incidents (the sequence counter keeps running,
    so incident identities never repeat within a process)."""
    _LOG.clear()
