"""Resilience layer: fault injection, health guards, retries, incidents.

Port of ``heat_tpu/resilience``.  Everything operates at host-visible
boundaries, around the kernels and never inside them:

:mod:`~heat_tpu_torch.resilience.faults`
    ``htt.resilience.inject(kind, seed=...)`` — seeded, deterministic
    fault injection against the compressed-collective boundary
    (``allreduce_q``/``allgather_q``), with the host-only seams of the
    IO, resume and serving layers.  Pytest fixtures live in
    ``heat_tpu_torch.resilience.fixtures``.

:mod:`~heat_tpu_torch.resilience.guards`
    ``htt.resilience.guard(policy)`` — a cheap on-device
    finiteness/overflow check on the compressed collectives;
    ``"degrade"`` falls back to the exact f32 path for the affected call
    and records a structured incident.

:mod:`~heat_tpu_torch.resilience.retry`
    ``retry(policy)`` — seeded, jittered exponential backoff with
    deadlines and bounded attempts; every attempt lands in the incident
    log and on the telemetry counters.

:mod:`~heat_tpu_torch.resilience.incidents`
    the structured incident log behind all of them; every incident also
    dumps a flight-recorder postmortem.

The reference's ``resume`` and ``elastic`` modules (``LoopCheckpointer``,
``load_loop_state``/``save_loop_state``, ``MeshMismatchError``,
``DeadlineWatchdog``, ``grow``, ``recover``, ``set_watchdog``) save
through the IO layer and come after it.
"""

from __future__ import annotations

from .faults import DeviceArrival, DeviceLossError, Preempted, inject
from .guards import (
    GuardWarning,
    NumericalHealthError,
    get_guard_policy,
    guard,
    set_guard_policy,
)
from .incidents import Incident, clear_incident_log, incident_log
from .retry import RetryPolicy
# NOTE: bound last on purpose — `retry` must stay the submodule at the
# package level (the engine function is retry.retry / retry.call)
from . import faults, guards, incidents, retry

__all__ = [
    "DeviceArrival",
    "DeviceLossError",
    "GuardWarning",
    "Incident",
    "NumericalHealthError",
    "Preempted",
    "RetryPolicy",
    "clear_incident_log",
    "faults",
    "get_guard_policy",
    "guard",
    "guards",
    "incident_log",
    "incidents",
    "inject",
    "retry",
    "set_guard_policy",
]
