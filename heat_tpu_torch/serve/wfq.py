"""Per-tenant weighted-fair queueing admission.

Port of ``heat_tpu/serve/wfq.py`` (pure Python, copied).  The engine's
bounded lane queue sheds globally: one hot tenant fills the shared
``max_queue_rows`` and every other tenant's submits bounce.  The fleet
ingress needs *isolation*: each tenant owns a bounded backlog sized by
its weight, and service order interleaves tenants in proportion to their
weights, so a saturating tenant sheds against its own bound while a
quiet tenant's requests keep flowing with bounded delay.

The discipline is classic virtual-time WFQ over row counts:

- every tenant has a ``weight`` (its service share) and a ``priority``
  band (strict: band 0 drains before band 1 sees service — the
  "interactive over batch" knob);
- a request of ``r`` rows arriving for tenant ``t`` gets the finish tag
  ``F = max(V, F_last[t]) + r / weight[t]`` where ``V`` is the band's
  virtual time (the finish tag of the last served request);
- ``pop`` serves, within the lowest occupied band, the head-of-line
  request with the smallest finish tag (ties break on tenant name, so
  the order is a pure function of the push sequence — no clocks).

Over any busy interval tenants therefore receive service proportional
to their weights (the usual WFQ bound: a backlogged tenant's service
lags its weighted share by at most one request), which is exactly the
starvation bound the two-tenant chaos scenario asserts.

Admission is per-tenant: a push that would lift the tenant's queued rows
over its bound sheds with the same typed
:class:`~heat_tpu_torch.serve.errors.ServeOverloadError` + deterministic
retry-after hint contract as the engine's micro-batcher, so the 429
surface is identical whether the shed happens at the lane or at the
fleet door.

Thread-safe; ``pop`` blocks until an item arrives or ``close`` wakes it.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, Optional, Tuple

from .errors import ServeClosedError, ServeOverloadError
from ..telemetry import _core as _tel

__all__ = ["TenantPolicy", "WeightedFairQueue"]


class TenantPolicy:
    """One tenant's admission contract: service ``weight`` (> 0),
    strict ``priority`` band (lower drains first), and ``max_queue_rows``
    backlog bound (None = unbounded)."""

    __slots__ = ("weight", "priority", "max_queue_rows")

    def __init__(self, weight: float = 1.0, priority: int = 0,
                 max_queue_rows: Optional[int] = None):
        if weight <= 0:
            raise ValueError(f"tenant weight must be > 0, got {weight}")
        self.weight = float(weight)
        self.priority = int(priority)
        self.max_queue_rows = None if max_queue_rows is None else int(max_queue_rows)


class WeightedFairQueue:
    """The fleet door's admission queue (see module docs).

    ``policies`` maps tenant -> :class:`TenantPolicy`; unknown tenants
    get ``default_policy`` (weight 1, band 0, ``default_max_queue_rows``
    backlog).  Items are opaque; ``push`` charges ``rows`` against the
    tenant's bound and fair-share tags, ``pop`` returns items in WFQ
    order.
    """

    def __init__(self, policies: Optional[Dict[str, TenantPolicy]] = None, *,
                 default_max_queue_rows: Optional[int] = None,
                 drain_hint_s: float = 2e-3):
        self._policies = dict(policies or {})
        self._default_max = default_max_queue_rows
        self._drain_hint_s = float(drain_hint_s)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._closed = False
        # per-tenant state: FIFO of (finish_tag, rows, item), queued rows,
        # last finish tag; bands hold per-band virtual time
        self._queues: Dict[str, deque] = {}
        self._queued_rows: Dict[str, int] = {}
        self._last_finish: Dict[str, float] = {}
        self._vtime: Dict[int, float] = {}
        self.n_shed = 0
        self.shed_by_tenant: Dict[str, int] = {}

    def policy(self, tenant: str) -> TenantPolicy:
        pol = self._policies.get(tenant)
        if pol is None:
            pol = TenantPolicy(max_queue_rows=self._default_max)
            self._policies[tenant] = pol
        return pol

    def queued_rows(self, tenant: Optional[str] = None) -> int:
        with self._lock:
            if tenant is not None:
                return self._queued_rows.get(tenant, 0)
            return sum(self._queued_rows.values())

    def __len__(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._queues.values())

    # ------------------------------------------------------------------ #
    def push(self, tenant: str, item: Any, *, rows: int = 1) -> None:
        """Admit one request (or shed it — see module docs)."""
        rows = int(rows)
        pol = self.policy(tenant)
        with self._cond:
            if self._closed:
                raise ServeClosedError("WeightedFairQueue is closed")
            pending = self._queued_rows.get(tenant, 0)
            if pol.max_queue_rows is not None and pending + rows > pol.max_queue_rows:
                # same deterministic-hint contract as MicroBatcher.submit:
                # a pure function of queue state, replayable under chaos
                self.n_shed += 1
                self.shed_by_tenant[tenant] = self.shed_by_tenant.get(tenant, 0) + 1
                hint = max(1, pending) * self._drain_hint_s / pol.weight
                if _tel.enabled:
                    _tel.inc("serve.wfq.shed")
                raise ServeOverloadError(
                    f"tenant {tenant!r} WFQ backlog is full "
                    f"({pending}+{rows} > {pol.max_queue_rows} rows); "
                    f"retry after {hint:.4f}s",
                    retry_after_s=hint,
                    queue_rows=pending,
                    max_queue_rows=pol.max_queue_rows,
                )
            band = pol.priority
            vt = self._vtime.get(band, 0.0)
            start = max(vt, self._last_finish.get(tenant, 0.0))
            finish = start + rows / pol.weight
            self._last_finish[tenant] = finish
            self._queues.setdefault(tenant, deque()).append((finish, rows, item))
            self._queued_rows[tenant] = pending + rows
            if _tel.enabled:
                _tel.gauge("serve.wfq.rows", sum(self._queued_rows.values()))
            self._cond.notify()

    def pop(self, *, timeout: Optional[float] = None):
        """The next ``(tenant, item)`` in WFQ order; ``None`` on timeout
        or when the queue closes empty.  The wait is deadline-aware: the
        deadline is computed once up front and each wakeup waits only
        the remainder, so spurious notify storms cannot stretch a 0.25s
        pop into an unbounded one."""
        deadline = (
            None if timeout is None else time.monotonic() + float(timeout)
        )
        with self._cond:
            while True:
                best: Optional[Tuple[int, float, str]] = None
                for tenant, q in self._queues.items():
                    if not q:
                        continue
                    band = self.policy(tenant).priority
                    key = (band, q[0][0], tenant)
                    if best is None or key < best:
                        best = key
                if best is not None:
                    band, finish, tenant = best
                    _, rows, item = self._queues[tenant].popleft()
                    self._queued_rows[tenant] -= rows
                    # virtual time advances to the served finish tag
                    if finish > self._vtime.get(band, 0.0):
                        self._vtime[band] = finish
                    return tenant, item
                if self._closed:
                    return None
                if deadline is None:
                    self._cond.wait()
                    continue
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cond.wait(timeout=remaining):
                    return None

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
