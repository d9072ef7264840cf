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

:mod:`~heat_tpu_torch.resilience.resume`
    ``checkpoint_every=N`` / ``resume=True`` on the iterative solvers:
    segmented fit loops whose carry (the error-feedback residual
    included) snapshots atomically through the IO layer, with a
    bitwise-identical resume.

:mod:`~heat_tpu_torch.resilience.elastic`
    ``resume="elastic"`` / ``elastic.recover(...)``: survive the loss (or
    arrival) of positions by migrating the snapshot's stacked carry onto
    the new mesh; the deadline watchdog classifies over-budget dispatches
    as suspected-lost ranks.

:mod:`~heat_tpu_torch.resilience.incidents`
    the structured incident log behind all of them; every incident also
    dumps a flight-recorder postmortem.
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
from .resume import (
    LoopCheckpointer,
    MeshMismatchError,
    load_loop_state,
    save_loop_state,
)
from .retry import RetryPolicy
from .elastic import DeadlineWatchdog, grow, recover, set_watchdog
# NOTE: bound last on purpose — `retry` must stay the submodule at the
# package level (the engine function is retry.retry / retry.call)
from . import elastic, faults, guards, incidents, resume, retry

__all__ = [
    "DeadlineWatchdog",
    "DeviceArrival",
    "DeviceLossError",
    "GuardWarning",
    "Incident",
    "LoopCheckpointer",
    "MeshMismatchError",
    "NumericalHealthError",
    "Preempted",
    "RetryPolicy",
    "clear_incident_log",
    "elastic",
    "faults",
    "get_guard_policy",
    "grow",
    "guard",
    "guards",
    "incident_log",
    "incidents",
    "inject",
    "load_loop_state",
    "recover",
    "resume",
    "retry",
    "save_loop_state",
    "set_guard_policy",
    "set_watchdog",
]
