"""Fleet-scale serving: watermark autoscaling, zero-cold-start replicas,
canary rollout.

Port of ``heat_tpu/serve/fleet.py``.  A :class:`FleetEngine` is a set of
:class:`~heat_tpu_torch.serve.engine.ServeEngine` replicas behind one
deterministic round-robin front door, plus three control loops the
single-host engine never needed:

- **watermark autoscaling** — :meth:`FleetEngine.tick` feeds the
  aggregate ``serve.queue_depth`` signal (and the SLO monitor's burn
  state, when one is attached) to a :class:`WatermarkAutoscaler`:
  ``high`` breaches for ``hysteresis`` consecutive ticks add a replica,
  ``low`` breaches remove one, anything between resets the streak — so
  a noisy queue cannot flap the fleet.
- **zero-cold-start spin-up** — a new replica installs the model's
  AOT bundles from the registry sidecar (:meth:`ServeEngine.warm` →
  :func:`heat_tpu_torch.core.aot.install_programs`, which on the card
  captures each program's CUDA graph) before taking traffic, so cold
  start → first reply builds nothing; a bundle whose fingerprint does
  not match is skipped and its program built on first use, so a stale
  sidecar stays sound.
- **canary rollout** — a :class:`CanaryConfig` routes a seeded slice of
  traffic for one ``(tenant, model)`` to the canary version while the
  stable version keeps the rest.  Assignment is a pure function of
  ``(seed, submit order)``, so the non-canary slice of a canary run is
  bitwise-comparable to a stable-only run of the same payload stream —
  the bench's golden-twin discipline extended to deployment.

Chaos rides the same seams as everything else: ``device_arrival`` /
``device_loss`` plans with ``site="fleet.tick"`` force scale events
(an injected loss closes the victim replica WITHOUT draining, so its
in-flight futures resolve with ``ServeClosedError`` — never a hang),
and ``io_error`` plans with ``site="registry_open"`` hit the sidecar
reads under the seeded retry policy.  Every decision is a pure function
of ``HEAT_CHAOS_SEED`` and the submitted traffic.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..resilience import faults as _faults
from ..resilience import incidents as _incidents
from ..telemetry import _core as _tel
from .engine import ServeEngine
from .errors import ServeClosedError
from .loadgen import chaos_seed
from .registry import ModelRegistry

__all__ = ["CanaryConfig", "FleetEngine", "WatermarkAutoscaler"]


class WatermarkAutoscaler:
    """Hysteretic watermark policy over the queue-depth / SLO signals.

    ``decide`` returns ``+1`` (add a replica), ``-1`` (remove one) or
    ``0``.  A scale-up needs ``hysteresis`` CONSECUTIVE high-watermark
    breaches (queue depth > ``high``, or the SLO monitor alerting); a
    scale-down needs the same streak of low breaches (depth < ``low``
    with the SLO quiet).  Any in-band observation resets both streaks,
    and every decision resets them — one event per sustained condition,
    no flapping.  Replica bounds are enforced here so the fleet can hand
    the policy raw signals."""

    def __init__(self, low: float = 2.0, high: float = 16.0, *,
                 hysteresis: int = 2, min_replicas: int = 1,
                 max_replicas: int = 4):
        if not 0 <= low < high:
            raise ValueError(f"need 0 <= low < high, got {low}/{high}")
        if int(hysteresis) < 1:
            raise ValueError(f"hysteresis must be >= 1, got {hysteresis}")
        if not 1 <= int(min_replicas) <= int(max_replicas):
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{min_replicas}/{max_replicas}"
            )
        self.low = float(low)
        self.high = float(high)
        self.hysteresis = int(hysteresis)
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self._high_streak = 0
        self._low_streak = 0

    def decide(self, queue_depth: float, *, slo_alerting: bool = False,
               replicas: int = 1) -> int:
        depth = float(queue_depth)
        if depth > self.high or slo_alerting:
            self._high_streak += 1
            self._low_streak = 0
            if (
                self._high_streak >= self.hysteresis
                and int(replicas) < self.max_replicas
            ):
                self._high_streak = 0
                return 1
        elif depth < self.low:
            self._low_streak += 1
            self._high_streak = 0
            if (
                self._low_streak >= self.hysteresis
                and int(replicas) > self.min_replicas
            ):
                self._low_streak = 0
                return -1
        else:
            self._high_streak = 0
            self._low_streak = 0
        return 0


@dataclass(frozen=True)
class CanaryConfig:
    """A versioned canary rollout for one ``(tenant, model)``.

    ``fraction`` of that model's traffic (seeded, in submit order) goes
    to ``canary_version``; the rest stays on ``stable_version``.
    ``seed=None`` uses ``HEAT_CHAOS_SEED``, so canary membership is part
    of the chaos lane's replayable state."""

    tenant: str
    model: str
    stable_version: int
    canary_version: int
    fraction: float = 0.1
    seed: Optional[int] = None

    def __post_init__(self):
        if not 0.0 < self.fraction < 1.0:
            raise ValueError(
                f"canary fraction must be in (0, 1), got {self.fraction}"
            )


class FleetEngine:
    """A replicated serving fleet (see module docs).

    Parameters
    ----------
    registry : ModelRegistry — shared by every replica.
    autoscaler : WatermarkAutoscaler | None — the scaling policy
        (default watermarks; its min/max bound the fleet size).
    warm_models : sequence of (tenant, model) or (tenant, model, version)
        — models each new replica installs AOT bundles for before taking
        traffic; omitting the version warms the latest
        published one.
    canary : CanaryConfig | None — versioned traffic-slice rollout.
    slo : SloMonitor | None — shared across replicas; its burn state is
        the autoscaler's second signal.
    engine_kwargs — forwarded to every :class:`ServeEngine` replica
        (``max_batch_rows``, ``max_queue_rows``, ``split`` …).
    """

    def __init__(self, registry: ModelRegistry, *,
                 autoscaler: Optional[WatermarkAutoscaler] = None,
                 warm_models: Sequence[Tuple] = (),
                 canary: Optional[CanaryConfig] = None,
                 slo=None, **engine_kwargs):
        self.registry = registry
        self.autoscaler = autoscaler or WatermarkAutoscaler()
        self.canary = canary
        self.slo = slo
        self._engine_kwargs = dict(engine_kwargs)
        self._warm_models = [
            (str(w[0]), str(w[1]), int(w[2]) if len(w) > 2 else None)
            for w in warm_models
        ]
        self.replicas: List[ServeEngine] = []
        self._rr = 0  # round-robin cursor (deterministic routing)
        self._background = False
        self._closed = False
        # canary assignment: one draw per eligible request, submit order
        base = canary.seed if canary is not None and canary.seed is not None \
            else chaos_seed()
        self._canary_rng = np.random.default_rng([int(base), 2])
        self.assignments: List[bool] = []  # True = routed to canary
        self.n_canary = 0
        self.n_stable = 0
        # scale-event ledger (the bench and the chaos lane read these)
        self.cold_start_ms: List[float] = []
        self.scale_events: List[Dict] = []
        self.n_scale_ups = 0
        self.n_scale_downs = 0
        self.n_replica_losses = 0
        for _ in range(self.autoscaler.min_replicas):
            self.scale_up(cause="bootstrap")

    # ------------------------------------------------------------------ #
    # scaling
    # ------------------------------------------------------------------ #
    def _gauge(self) -> None:
        if _tel.enabled:
            _tel.gauge("serve.fleet.replicas", len(self.replicas))

    def scale_up(self, *, cause: str = "watermark") -> Optional[ServeEngine]:
        """Spawn one replica (bounded by the autoscaler's
        ``max_replicas``): construct the engine, install every warm
        model's AOT bundles, then start taking traffic.  The
        spawn→ready time lands in ``cold_start_ms``."""
        if self._closed:
            raise ServeClosedError("FleetEngine is closed")
        if len(self.replicas) >= self.autoscaler.max_replicas:
            return None
        t0 = time.perf_counter()
        eng = ServeEngine(self.registry, slo=self.slo, **self._engine_kwargs)
        installed = 0
        for tenant, model, version in self._warm_models:
            installed += eng.warm(tenant, model, version=version)
        if self._background:
            eng.start()
        self.replicas.append(eng)
        cold_ms = (time.perf_counter() - t0) * 1e3
        self.cold_start_ms.append(cold_ms)
        self.n_scale_ups += 1
        self.scale_events.append({
            "action": "scale-up", "cause": cause,
            "replicas": len(self.replicas), "installed": installed,
            "cold_start_ms": cold_ms,
        })
        _incidents.record(
            kind="scale-up", site="fleet", policy="watermark", action="scaled",
            detail=f"{cause}: replica #{len(self.replicas)} up in "
            f"{cold_ms:.1f}ms ({installed} executables installed)",
        )
        self._gauge()
        return eng

    def scale_down(self, *, cause: str = "watermark") -> bool:
        """Retire the newest replica (bounded by ``min_replicas``),
        draining its queue first so every accepted request still gets
        its reply."""
        if self._closed:
            raise ServeClosedError("FleetEngine is closed")
        if len(self.replicas) <= self.autoscaler.min_replicas:
            return False
        eng = self.replicas.pop()
        eng.close(drain=True)
        self.n_scale_downs += 1
        self.scale_events.append({
            "action": "scale-down", "cause": cause,
            "replicas": len(self.replicas),
        })
        _incidents.record(
            kind="scale-down", site="fleet", policy="watermark",
            action="scaled",
            detail=f"{cause}: drained and retired replica "
            f"#{len(self.replicas) + 1}",
        )
        self._gauge()
        return True

    def lose_replica(self, index: int) -> None:
        """An injected (or real) replica loss: the victim closes WITHOUT
        draining — its in-flight futures resolve with
        :class:`ServeClosedError` — and the fleet keeps serving on the
        survivors (respawn is the autoscaler's call, next tick)."""
        if not self.replicas:
            return
        index = int(index) % len(self.replicas)
        eng = self.replicas.pop(index)
        eng.close(drain=False)
        self.n_replica_losses += 1
        self.scale_events.append({
            "action": "replica-loss", "cause": "device-loss",
            "replicas": len(self.replicas), "index": index,
        })
        _incidents.record(
            kind="replica-loss", site="fleet", policy="chaos", action="lost",
            detail=f"replica #{index} dropped mid-flight; pending futures "
            "resolved with ServeClosedError",
        )
        self._gauge()
        # a fleet must never serve zero replicas: immediate respawn (the
        # same durable-snapshot contract device_point keeps for fits)
        if not self.replicas:
            self.scale_up(cause="replica-loss-respawn")

    def queue_depth(self) -> int:
        """Aggregate queued requests across every replica lane — the
        autoscaler's primary signal."""
        total = 0
        for eng in list(self.replicas):
            with eng._lock:
                lanes = list(eng._lanes.values())
            total += sum(ln.batcher.queue_depth for ln in lanes)
        return total

    def tick(self, queue_depth: Optional[float] = None) -> Dict:
        """One control-loop step: run the chaos seams (forced arrivals /
        losses at ``site="fleet.tick"``), then feed the watermark policy
        and apply its decision.  Returns the tick record (also appended
        to ``scale_events`` when a scale happened) — a pure function of
        the armed plans and the observed signals."""
        if self._closed:
            raise ServeClosedError("FleetEngine is closed")
        if _faults.any_active():
            try:
                _faults.arrival_point("fleet.tick", mesh=len(self.replicas))
            except _faults.DeviceArrival as e:
                for _ in range(e.arrived):
                    self.scale_up(cause="device-arrival")
            try:
                _faults.device_point("fleet.tick", mesh=len(self.replicas))
            except _faults.DeviceLossError as e:
                self.lose_replica(e.lost_rank)
        depth = self.queue_depth() if queue_depth is None else float(queue_depth)
        alerting = bool(self.slo.alerting) if self.slo is not None else False
        decision = self.autoscaler.decide(
            depth, slo_alerting=alerting, replicas=len(self.replicas)
        )
        if decision > 0:
            self.scale_up()
        elif decision < 0:
            self.scale_down()
        if _tel.enabled:
            _tel.gauge("serve.fleet.queue_depth", depth)
        return {
            "decision": decision,
            "queue_depth": depth,
            "slo_alerting": alerting,
            "replicas": len(self.replicas),
        }

    # ------------------------------------------------------------------ #
    # request path (ServeEngine-compatible, loadgen-drivable)
    # ------------------------------------------------------------------ #
    def _route(self) -> ServeEngine:
        if self._closed or not self.replicas:
            raise ServeClosedError("FleetEngine is closed")
        eng = self.replicas[self._rr % len(self.replicas)]
        self._rr += 1
        return eng

    def _version_for(self, tenant: str, model: str,
                     version: Optional[int]) -> Optional[int]:
        """Canary assignment: requests that pin a version bypass the
        rollout; everything else on the canaried model draws once from
        the seeded stream."""
        c = self.canary
        if c is None or version is not None:
            return version
        if tenant != c.tenant or model != c.model:
            return version
        is_canary = bool(float(self._canary_rng.random()) < c.fraction)
        self.assignments.append(is_canary)
        if is_canary:
            self.n_canary += 1
            return c.canary_version
        self.n_stable += 1
        return c.stable_version

    def submit(self, tenant: str, model: str, payload, *,
               version: Optional[int] = None,
               request_id: Optional[str] = None):
        version = self._version_for(tenant, model, version)
        return self._route().submit(
            tenant, model, payload, version=version, request_id=request_id
        )

    def predict(self, tenant: str, model: str, payload, *,
                version: Optional[int] = None,
                request_id: Optional[str] = None):
        fut = self.submit(tenant, model, payload, version=version,
                          request_id=request_id)
        if not self._background:
            self.flush()
        return fut.result()

    def direct_predict(self, tenant: str, model: str, payload, *,
                       version: Optional[int] = None):
        """Unbatched golden twin, deterministically on replica 0 (the
        twin must not advance the round-robin cursor or the canary
        stream)."""
        if self._closed or not self.replicas:
            raise ServeClosedError("FleetEngine is closed")
        return self.replicas[0].direct_predict(
            tenant, model, payload, version=version
        )

    def _lane(self, tenant: str, model: str, version: Optional[int]):
        # loadgen compatibility: geometry introspection, replica 0
        if self._closed or not self.replicas:
            raise ServeClosedError("FleetEngine is closed")
        return self.replicas[0]._lane(tenant, model, version)

    def flush(self) -> int:
        return sum(eng.flush() for eng in list(self.replicas))

    def start(self) -> None:
        self._background = True
        for eng in list(self.replicas):
            eng.start()

    def stats(self) -> Dict[str, float]:
        """Aggregate replica counters (the LoadReport contract) plus the
        fleet's own: replica count, scale/loss totals, shed requests,
        canary split."""
        keys = (
            "requests", "batches", "rows", "padded_rows", "dispatches",
            "degraded", "payload_bytes", "reply_bytes", "shed",
        )
        agg = {k: 0 for k in keys}
        for eng in list(self.replicas):
            s = eng.stats()
            for k in keys:
                agg[k] += s.get(k, 0)
        agg["dispatches_per_batch"] = (
            agg["dispatches"] / agg["batches"] if agg["batches"] else 0.0
        )
        agg["batch_occupancy"] = (
            agg["rows"] / agg["padded_rows"] if agg["padded_rows"] else 0.0
        )
        agg.update(
            replicas=len(self.replicas),
            scale_ups=self.n_scale_ups,
            scale_downs=self.n_scale_downs,
            replica_losses=self.n_replica_losses,
            canary=self.n_canary,
            stable=self.n_stable,
        )
        return agg

    def close(self, *, drain: bool = True) -> None:
        """Idempotent fleet shutdown: every replica closes (draining by
        default), later submits raise :class:`ServeClosedError`."""
        if self._closed:
            return
        self._closed = True
        replicas, self.replicas = list(self.replicas), []
        for eng in replicas:
            eng.close(drain=drain)
        self._gauge()
