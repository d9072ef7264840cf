"""Per-replica health: EWMA latency + a consecutive-failure breaker.

Port of ``heat_tpu/serve/health.py`` (pure Python, copied).  Binary
liveness (a replica is alive until its pipe dies)
misses the gray failures that actually dominate fleet incidents — a
replica that answers, but slowly; one that errors on every third
request; one whose socket is half-open.  :class:`ReplicaBreaker` is the
classic three-state circuit breaker, specialized for the procfleet:

- **closed** — healthy.  Every reply updates an EWMA of observed
  latency (the worker's dispatch gate uses it as the replica's observed
  p50: the EWMA of a unimodal latency stream tracks its center, and one
  smoothed scalar is cheap enough to consult on every dispatch).
- **open** — ``failure_threshold`` *consecutive* failures tripped it.
  The fleet quarantines the replica (kill + warm respawn from the
  ``.aotx`` sidecar); an open breaker never takes traffic, because the
  replica behind it no longer exists.
- **half-open** — the warm replacement spawned for a quarantined
  replica starts here: one success closes it, one failure re-opens it
  immediately (threshold 1 — a replacement that fails its first
  request is flapping, not warming up).

Failures are *replica-health* signals only: a wire error, an injected
stall, a ``code=500`` reply.  A 429 shed is admission policy, not
sickness, and never counts.  Success resets the consecutive count —
the breaker reacts to sustained failure, not error rate.

State edges are the observable: the fleet records a flight-recorder
note and an incident on every transition, and exports per-state gauges
(``serve.breaker.closed`` / ``half_open`` / ``open``), so a quarantine
storm is visible on the same ``/metrics`` surface as the traffic it
eats.  The breaker itself is clock-free and unsynchronized — the one
procfleet worker thread that owns the replica is the only writer, and
transitions are pure functions of the success/failure sequence, which
keeps the chaos lane's breaker edges replayable under a fixed seed.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["ReplicaBreaker"]

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class ReplicaBreaker:
    """One replica's health state machine (see module docs).

    Parameters
    ----------
    failure_threshold : int — consecutive failures that trip a closed
        breaker (a half-open breaker always trips on its first failure).
    ewma_alpha : float — smoothing factor for the observed-latency
        EWMA (higher = faster tracking, noisier p50 estimate).
    half_open : bool — start half-open (the warm replacement of a
        quarantined replica) instead of closed.
    """

    __slots__ = ("state", "failure_threshold", "ewma_alpha",
                 "consecutive_failures", "ewma_ms", "n_successes",
                 "n_failures", "n_opens")

    def __init__(self, *, failure_threshold: int = 3,
                 ewma_alpha: float = 0.2, half_open: bool = False):
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}"
            )
        self.state = HALF_OPEN if half_open else CLOSED
        self.failure_threshold = int(failure_threshold)
        self.ewma_alpha = float(ewma_alpha)
        self.consecutive_failures = 0
        self.ewma_ms: Optional[float] = None
        self.n_successes = 0
        self.n_failures = 0
        self.n_opens = 0

    def p50_ms(self) -> Optional[float]:
        """The replica's observed p50 estimate (EWMA of reply latency),
        ``None`` until the first reply — the dispatch gate treats an
        unknown p50 as "don't second-guess the deadline"."""
        return self.ewma_ms

    def record_success(self, latency_ms: float) -> bool:
        """One healthy reply.  Returns True when this closed a
        half-open breaker (a state edge the fleet logs)."""
        self.n_successes += 1
        self.consecutive_failures = 0
        if self.ewma_ms is None:
            self.ewma_ms = float(latency_ms)
        else:
            a = self.ewma_alpha
            self.ewma_ms = a * float(latency_ms) + (1.0 - a) * self.ewma_ms
        if self.state == HALF_OPEN:
            self.state = CLOSED
            return True
        return False

    def record_failure(self) -> bool:
        """One replica-health failure.  Returns True when this tripped
        the breaker open — the caller's cue to quarantine."""
        self.n_failures += 1
        self.consecutive_failures += 1
        if self.state == OPEN:
            return False
        threshold = 1 if self.state == HALF_OPEN else self.failure_threshold
        if self.consecutive_failures >= threshold:
            self.state = OPEN
            self.n_opens += 1
            return True
        return False
