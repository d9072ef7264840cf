"""Burn-rate SLO monitoring over streaming latency observations.

Port of ``heat_tpu/telemetry/slo.py`` (stdlib only, copied).  An SLO here is the serving form: "``p`` of requests answer under
``target_ms``" — e.g. *99% of predicts under 20 ms*.  The error budget
is ``1 - objective`` (1% of requests may exceed the target), and the
**burn rate** is how fast the budget is being spent:

    ``burn = error_ratio / (1 - objective)``

``burn == 1`` consumes exactly the budget (the SLO holds with nothing to
spare); ``burn == 14.4`` exhausts a 30-day budget in ~2 days — the
classic SRE-workbook page-worthy threshold this module defaults to.

Multi-window discipline: a single window either pages too slowly (long
window) or flaps on noise (short window), so :class:`SloMonitor` tracks
the error ratio over a SHORT and a LONG window simultaneously and
alerts only when **both** burn above the threshold — the short window
proves the problem is happening *now*, the long window proves it is not
a blip.  Each window is a fixed wheel of ``SLOTS`` time buckets
(good/bad counts), so memory is constant regardless of traffic, and
time comes from :func:`heat_tpu_torch.telemetry.clock` — monotonic in
production, the injectable/deterministic sequence in tests, so burn
alerts are replayable under ``enable(deterministic=True)``.

Outputs ride the existing rails: every observation refreshes
``slo.<name>.*`` gauges (burn rates, error ratio, alert flag) through
the one-predicate telemetry guard, and a burn crossing publishes a
structured **incident** through :mod:`heat_tpu_torch.resilience.incidents` —
which means it lands in the incident log, on the event stream, AND
triggers a flight-recorder postmortem dump, exactly like a guard
intervention or a device loss.  The monitor itself is always-on like
the flight recorder: observing with telemetry disabled still tracks the
windows (a latency SLO that only counts when someone is watching is not
an SLO), it just skips the gauges.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from . import _core

__all__ = ["SloMonitor"]

#: time buckets per window wheel — fixed memory per monitor
SLOTS = 60


class _Wheel:
    """One fixed window: ``SLOTS`` buckets of ``window_s / SLOTS``
    seconds each, good/bad counts, stale buckets invalidated lazily by
    an epoch stamp (no timer thread)."""

    __slots__ = ("window_s", "res", "good", "bad", "stamp")

    def __init__(self, window_s: float):
        self.window_s = float(window_s)
        self.res = self.window_s / SLOTS
        self.good = [0] * SLOTS
        self.bad = [0] * SLOTS
        self.stamp: List[int] = [-1] * SLOTS

    def add(self, t: float, ok: bool) -> None:
        epoch = int(t / self.res)
        i = epoch % SLOTS
        if self.stamp[i] != epoch:
            self.stamp[i] = epoch
            self.good[i] = 0
            self.bad[i] = 0
        if ok:
            self.good[i] += 1
        else:
            self.bad[i] += 1

    def totals(self, t: float) -> tuple:
        """(good, bad) over the live window ending at ``t``."""
        lo = int(t / self.res) - SLOTS + 1
        g = b = 0
        for i in range(SLOTS):
            if self.stamp[i] >= lo:
                g += self.good[i]
                b += self.bad[i]
        return g, b


class SloMonitor:
    """One latency SLO: ``objective`` of observations under ``target_ms``
    (see module docs for the burn-rate model).

    Parameters
    ----------
    name : str — gauge/incident namespace (``slo.<name>.*``).
    target_ms : float — the per-observation latency target.
    objective : float in (0, 1) — fraction that must meet the target.
    short_s / long_s : the two burn windows (seconds of telemetry-clock
        time; the deterministic clock makes these event-count windows).
    burn_threshold : float — alert when BOTH windows burn at or above
        this multiple of budget spend.
    min_events : int — no alert before this many observations sit in the
        long window (cold-start guard).
    """

    def __init__(
        self,
        name: str,
        *,
        target_ms: float,
        objective: float = 0.99,
        short_s: float = 60.0,
        long_s: float = 3600.0,
        burn_threshold: float = 14.4,
        min_events: int = 32,
    ):
        if not 0.0 < objective < 1.0:
            raise ValueError(f"objective must be in (0, 1), got {objective}")
        if not 0.0 < short_s < long_s:
            raise ValueError(
                f"need 0 < short_s < long_s, got {short_s}/{long_s}"
            )
        self.name = str(name)
        self.target_ms = float(target_ms)
        self.objective = float(objective)
        self.budget = 1.0 - self.objective
        self.burn_threshold = float(burn_threshold)
        self.min_events = int(min_events)
        self._short = _Wheel(short_s)
        self._long = _Wheel(long_s)
        self._lock = threading.Lock()
        self._alerting = False
        self.n_alerts = 0

    # ------------------------------------------------------------------ #
    def observe(self, latency_ms: float) -> None:
        """Record one latency observation and refresh the burn state.
        Host-side only: call it where the latency was measured."""
        ok = float(latency_ms) <= self.target_ms
        t = _core.clock()
        with self._lock:
            self._short.add(t, ok)
            self._long.add(t, ok)
            state = self._state_locked(t)
            fired = self._maybe_alert_locked(state)
        if _core.enabled:
            pre = f"slo.{self.name}"
            _core.gauge(f"{pre}.burn_rate_short", state["burn_short"])
            _core.gauge(f"{pre}.burn_rate_long", state["burn_long"])
            _core.gauge(f"{pre}.error_ratio_short", state["error_ratio_short"])
            _core.gauge(f"{pre}.alerting", 1.0 if state["alerting"] else 0.0)
            _core.observe(f"{pre}.latency_ms", latency_ms)
        if fired is not None:
            # outside our lock: incidents -> telemetry event + flight dump
            from ..resilience import incidents as _incidents

            _incidents.record(
                "slo-burn",
                f"slo:{self.name}",
                f"objective={self.objective:g}",
                "alert",
                detail=(
                    f"burn short={fired['burn_short']:.2f}x "
                    f"long={fired['burn_long']:.2f}x >= "
                    f"{self.burn_threshold:g}x of the {self.budget:g} error "
                    f"budget (target {self.target_ms:g} ms)"
                ),
            )

    # ------------------------------------------------------------------ #
    def _burn(self, good: int, bad: int) -> float:
        n = good + bad
        if n == 0:
            return 0.0
        return (bad / n) / self.budget

    def _state_locked(self, t: float) -> Dict[str, float]:
        gs, bs = self._short.totals(t)
        gl, bl = self._long.totals(t)
        return {
            "burn_short": self._burn(gs, bs),
            "burn_long": self._burn(gl, bl),
            "error_ratio_short": (bs / (gs + bs)) if (gs + bs) else 0.0,
            "error_ratio_long": (bl / (gl + bl)) if (gl + bl) else 0.0,
            "events_long": gl + bl,
            "alerting": self._alerting,
        }

    def _maybe_alert_locked(self, state: Dict[str, float]) -> Optional[dict]:
        burning = (
            state["events_long"] >= self.min_events
            and state["burn_short"] >= self.burn_threshold
            and state["burn_long"] >= self.burn_threshold
        )
        if burning and not self._alerting:
            self._alerting = True
            state["alerting"] = True
            self.n_alerts += 1
            return dict(state)
        if not burning and self._alerting and state["burn_short"] < self.burn_threshold:
            # burn cleared: re-arm (gauge flips; clearing is not an incident)
            self._alerting = False
            state["alerting"] = False
        return None

    # ------------------------------------------------------------------ #
    @property
    def alerting(self) -> bool:
        return self._alerting

    def state(self) -> Dict[str, float]:
        """Current burn/ratio snapshot (the ``/varz`` form)."""
        t = _core.clock()
        with self._lock:
            s = self._state_locked(t)
        s.update(
            name=self.name,
            target_ms=self.target_ms,
            objective=self.objective,
            burn_threshold=self.burn_threshold,
            n_alerts=self.n_alerts,
        )
        return s
