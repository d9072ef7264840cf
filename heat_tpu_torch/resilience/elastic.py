"""Elastic recovery: resize the mesh, migrate the carry, resume the fit.

Port of ``heat_tpu/resilience/elastic.py``.  When a position drops out of
the mesh (an injected ``device_loss``, or a dispatch the deadline
watchdog classifies as a suspected-lost rank) the latest loop snapshot
is still durable, and :func:`recover` re-enters the fit on the surviving
positions:

1. the snapshot's replicated carry entries (iterate, residual, counters)
   are mesh-independent and load unchanged;
2. the mesh-stacked entries (the ``(p, payload)`` error-feedback
   residual of the quantized paths) are re-chunked onto the new mesh by
   :func:`migrate_stacked`: old rank ``r``'s untransmitted residual is
   *summed* into new rank ``r * new_p // old_p``, so the total deferred
   mass is conserved;
3. the fit re-enters its segment loop at the recorded iteration via
   ``resume="elastic"``.

Here positions share one device, so "a different mesh" is a different
number of positions on the same card (or CPU); the migrated rows land on
the fit's device when it rebuilds its carry.

Determinism contract: a fit killed at mesh ``P`` and recovered at mesh
``Q`` finishes bitwise-identical to an uninterrupted mesh-``Q`` fit
resumed from the same snapshot: both consume the same migrated carry
through the same loop.  (Migrated residuals re-quantize against the new
block grid at the next ring step, so an ``int8_block`` trajectory at mesh
``Q`` differs from the never-interrupted mesh-``P`` one only within the
documented quantization bound.)  The mini-batch fits compute on the
mesh-independent chunk, so there the recovered fit is bitwise the
uninterrupted one at any mesh.

:func:`grow` is the scale-up mirror (devices arrive): ``r -> r * new_p //
old_p`` folds rows going down and spreads them injectively going up, so
shrink and grow share one migration path and one re-entry driver.

The :class:`DeadlineWatchdog` closes the detection loop: per-site
dispatch budgets are fed from telemetry span aggregates (mean duration ×
``factor``), and a dispatch blowing its budget (simulated ``slow_rank``
latency from :mod:`heat_tpu_torch.resilience.faults` included) records a
``suspected-lost`` incident and raises the same typed
:class:`~heat_tpu_torch.resilience.faults.DeviceLossError` the injection
seam does, so callers have one failure mode to catch.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import numpy as np

from ..telemetry import _core as _tel
from . import faults, incidents
from . import resume as _resume
from . import retry as _retry
from .faults import DeviceLossError

__all__ = [
    "DeadlineWatchdog",
    "dispatch_guard",
    "get_watchdog",
    "grow",
    "migrate_stacked",
    "migrate_state",
    "recover",
    "set_watchdog",
]


# --------------------------------------------------------------------- #
# carry migration                                                        #
# --------------------------------------------------------------------- #
def migrate_stacked(arr: np.ndarray, new_p: int) -> np.ndarray:
    """Re-chunk a mesh-stacked ``(old_p, *payload)`` carry entry onto a
    ``new_p``-rank mesh: old rank ``r``'s row is **summed** into new row
    ``r * new_p // old_p``.

    Summing (not slicing) is what keeps the error-feedback ring honest:
    each row is a rank's *untransmitted* quantization residual, and the
    merge hands the surviving rank the total deferred mass of the ranks
    it absorbs — 8→4 folds pairs, 8→7 folds ``[2, 1, 1, 1, 1, 1, 1]``.
    The merged rows re-quantize against the new block grid at the next
    ring step.
    """
    arr = np.asarray(arr)
    if arr.ndim == 0:
        raise ValueError("stacked carry entries must have a leading mesh axis")
    old_p = int(arr.shape[0])
    new_p = int(new_p)
    if new_p < 1:
        raise ValueError(f"new mesh size must be >= 1, got {new_p}")
    if new_p == old_p:
        return arr
    out = np.zeros((new_p,) + arr.shape[1:], dtype=arr.dtype)
    for r in range(old_p):
        out[r * new_p // old_p] += arr[r]
    return out


def migrate_state(
    state: Dict[str, Any],
    meta: Dict[str, Any],
    new_mesh: int,
    comm=None,
) -> Dict[str, Any]:
    """Migrate a loaded snapshot's carry to a ``new_mesh``-rank mesh.

    ``meta["splits"]`` (written by :class:`~heat_tpu_torch.resilience.
    resume.LoopCheckpointer`) names each entry's partitioning; entries
    marked ``"mesh"`` are re-chunked by :func:`migrate_stacked`, everything
    else (replicated) passes through untouched.  When ``comm`` has more
    than one position, each migrated entry is laid out at split 0 through
    the planned redistribution, as in the reference (one dispatch, counted
    on ``comm.resplit.planned``; the plan is an exact slice).  The entries
    stay host arrays: the resumed fit moves its carry onto its own device.
    """
    new_mesh = int(new_mesh)
    splits = meta.get("splits") or {}
    old_mesh = int(meta.get("mesh", new_mesh))
    out = dict(state)
    for name, spec in splits.items():
        if spec != "mesh" or name not in out:
            continue
        arr = np.asarray(out[name])
        if arr.ndim == 0 or int(arr.shape[0]) != old_mesh:
            continue  # not actually stacked per-rank; leave it alone
        migrated = migrate_stacked(arr, new_mesh)
        if comm is not None and getattr(comm, "size", 1) > 1:
            import torch

            from ..comm import redistribution

            with redistribution("planned"):
                placed = comm.resplit(torch.from_numpy(np.ascontiguousarray(migrated)), 0)
            migrated = comm.unpad(placed, migrated.shape[0]).numpy()
        out[name] = migrated
        growing = new_mesh > old_mesh
        incidents.record(
            kind="mesh-grow" if growing else "mesh-shrink",
            site=f"elastic.{name}",
            policy=f"migrate_stacked({old_mesh}->{new_mesh})",
            action="migrated",
            detail=f"carry entry {name!r}: {old_mesh} rows "
            + ("spread over" if growing else "folded into")
            + f" {new_mesh} (deferred residual mass conserved)",
        )
        if _tel.enabled:
            _tel.inc("resilience.elastic.migrated")
    return out


# --------------------------------------------------------------------- #
# deadline watchdog                                                      #
# --------------------------------------------------------------------- #
class DeadlineWatchdog:
    """Classifies a dispatch exceeding its per-site budget as a
    suspected-lost rank.

    The budget for a site is ``factor ×`` the mean observed duration,
    preferring the process-wide telemetry span aggregates
    (``telemetry.snapshot()["spans"]``) and falling back to the
    watchdog's own observations; no budget exists until ``min_samples``
    observations have accumulated (a cold site can't be judged).  The
    budget is computed *before* the new observation is folded in, so one
    pathological dispatch cannot raise its own bar.  Time comes from the
    telemetry clock — deterministic under
    ``telemetry.enable(deterministic=True)``, injectable via
    ``telemetry.set_clock`` — and simulated ``slow_rank`` latency from
    the fault seams is added on top, which is how the chaos tests drive
    classification without real stalls.
    """

    def __init__(self, factor: float = 3.0, min_samples: int = 3,
                 min_budget: float = 0.0):
        if factor <= 1.0:
            raise ValueError(f"factor must be > 1, got {factor}")
        self.factor = float(factor)
        self.min_samples = int(min_samples)
        self.min_budget = float(min_budget)
        #: site -> [count, total_seconds] (fallback when telemetry is off)
        self._local: Dict[str, list] = {}

    def observations(self, site: str):
        """``(count, total_seconds)`` for a site: telemetry span
        aggregates when available, else this watchdog's own."""
        spans = getattr(_tel, "_spans", None) or {}
        agg = spans.get(site)
        if agg and agg[0] > 0:
            return int(agg[0]), float(agg[1])
        local = self._local.get(site)
        if local and local[0] > 0:
            return int(local[0]), float(local[1])
        return 0, 0.0

    def budget(self, site: str) -> Optional[float]:
        """The deadline (seconds) for one dispatch at ``site``, or
        ``None`` while fewer than ``min_samples`` observations exist."""
        count, total = self.observations(site)
        if count < self.min_samples:
            return None
        return max(self.factor * (total / count), self.min_budget)

    def _observe(self, site: str, elapsed: float) -> None:
        agg = self._local.setdefault(site, [0, 0.0])
        agg[0] += 1
        agg[1] += float(elapsed)

    @contextlib.contextmanager
    def watch(self, site: str, comm=None):
        """Time the block; on budget overrun, record a ``suspected-lost``
        incident and raise :class:`DeviceLossError` naming the suspect
        rank (the armed ``slow_rank``'s rank when one fired, else the
        mesh's last rank)."""
        budget = self.budget(site)  # pre-observation: see class docstring
        t0 = _tel.clock()
        yield
        elapsed = float(_tel.clock() - t0)
        extra, suspect = faults.extra_latency(site)
        elapsed += extra
        self._observe(site, elapsed)
        if budget is None or elapsed <= budget:
            return
        size = int(getattr(comm, "size", 1) or 1)
        lost = suspect if suspect is not None else size - 1
        if _tel.enabled:
            _tel.inc("resilience.watchdog.suspected")
        incidents.record(
            kind="deadline",
            site=site,
            policy=f"watchdog(factor={self.factor}, "
            f"min_samples={self.min_samples})",
            action="suspected-lost",
            detail=f"dispatch took {elapsed:.4f}s against a {budget:.4f}s "
            f"budget; suspecting rank {lost} of {size}",
        )
        raise DeviceLossError(
            f"dispatch at {site} exceeded its deadline ({elapsed:.4f}s > "
            f"{budget:.4f}s budget): suspecting lost rank {lost}; shrink "
            f'the mesh and resume with resume="elastic"',
            lost_rank=lost,
            mesh_size=size,
            site=site,
        )


#: the process-wide watchdog the fit drivers consult (None = disarmed)
_WATCHDOG: Optional[DeadlineWatchdog] = None


def set_watchdog(watchdog: Optional[DeadlineWatchdog]):
    """Arm (or, with ``None``, disarm) the process-wide deadline
    watchdog consulted by :func:`dispatch_guard`."""
    global _WATCHDOG
    _WATCHDOG = watchdog
    return watchdog


def get_watchdog() -> Optional[DeadlineWatchdog]:
    return _WATCHDOG


@contextlib.contextmanager
def dispatch_guard(site: str, comm=None):
    """The seam the fit drivers wrap around their segment dispatches.
    A no-op (beyond one attribute read) while no watchdog is armed and
    no fault plans are active, so the hot path stays hot."""
    wd = _WATCHDOG
    if wd is None:
        if faults.any_active():
            # still advance the slow_rank schedule so fault plans see a
            # deterministic opportunity sequence with or without a watchdog
            faults.extra_latency(site)
        yield
        return
    with wd.watch(site, comm=comm):
        yield


# --------------------------------------------------------------------- #
# re-entry drivers (shrink and grow share one body)                      #
# --------------------------------------------------------------------- #
def _reenter(fit, snapshot: str, data, comm, policy, *, site: str,
             kind: str, start_action: str, done_action: str,
             done_detail: str, counter: str):
    """The shared kill→resize→resume body behind :func:`recover` and
    :func:`grow`: probe the snapshot under the seeded retry policy,
    repoint the fit's checkpoint path, re-enter via ``resume="elastic"``
    (which migrates the carry to the comm the input data lives on), and
    bracket it all with incidents."""
    probe = _retry.retry(policy or _retry.IO_POLICY, site=site)
    state, meta = None, None
    for attempt in probe:
        with attempt:
            state, meta = _resume.load_loop_state(snapshot)
    old_mesh = meta.get("mesh")
    new_mesh = int(getattr(comm, "size", 0) or 0) or None
    if hasattr(fit, "checkpoint_path") and fit.checkpoint_path != snapshot:
        fit.checkpoint_path = snapshot
    incidents.record(
        kind=kind,
        site=site,
        policy="elastic",
        action=start_action,
        detail=f"resuming {meta.get('algo')!r} from it={meta.get('it')} "
        f"on mesh {old_mesh}->{new_mesh if new_mesh else '?'}",
    )
    if _tel.enabled:
        _tel.inc(counter)
    if hasattr(fit, "fit"):
        out = fit.fit(*data, resume="elastic")
    else:
        out = fit(*data, resume="elastic") if data else fit()
    incidents.record(
        kind=kind,
        site=site,
        policy="elastic",
        action=done_action,
        detail=f"{meta.get('algo')!r} {done_detail}",
    )
    return out


def recover(fit, snapshot: str, *data, comm=None,
            policy: Optional[_retry.RetryPolicy] = None):
    """Kill→shrink→recover in one call.

    ``fit`` is an estimator exposing ``.fit(*data, resume=...)`` (Lasso,
    KMeans) or a bare callable (``lambda: lanczos(..., resume="elastic")``);
    ``snapshot`` is the loop-snapshot path the dead fit was ticking;
    ``data`` are the input arrays **already built on the surviving
    mesh**.  The snapshot probe runs under the bounded, seeded retry
    policy — recovery is exactly when storage is most likely to still be
    failing over — and the whole cycle lands in the incident log.
    """
    return _reenter(
        fit, snapshot, data, comm, policy,
        site="elastic.recover",
        kind="device-loss",
        start_action="recovering",
        done_action="recovered",
        done_detail="finished on the shrunk mesh",
        counter="resilience.elastic.recoveries",
    )


def grow(fit, snapshot: str, *data, comm=None,
         policy: Optional[_retry.RetryPolicy] = None):
    """Arrival→grow→resume in one call — the scale-up mirror of
    :func:`recover`.

    ``comm`` spans the ENLARGED device set (survivors + arrivals) and
    ``data`` are the input arrays already built on it; the snapshot is
    the one the smaller-mesh fit was ticking.  The carry migrates up
    through the same :func:`migrate_state` path shrink uses
    (``r -> r * new_p // old_p`` is injective going up, so no residual
    mass merges), and the re-entered fit is **bitwise-identical** to an
    uninterrupted fit on the large mesh resumed from the same snapshot —
    the contract the fleet autoscaler's scale-up events lean on.
    """
    return _reenter(
        fit, snapshot, data, comm, policy,
        site="elastic.grow",
        kind="device-arrival",
        start_action="growing",
        done_action="grown",
        done_detail="finished on the grown mesh",
        counter="resilience.elastic.grows",
    )
