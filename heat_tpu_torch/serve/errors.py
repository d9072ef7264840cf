"""Typed serving errors: the contract between the engine and its callers.

A copy of ``heat_tpu/serve/errors.py`` (standard library only).

All subclass ``RuntimeError`` so pre-existing ``except RuntimeError``
handlers (and tests) keep working; the point of the subtypes is that a
fleet client can *distinguish* "this lane is gone, re-resolve" from
"this lane is busy, back off and retry" from "this request's budget ran
out, don't bother retrying" without parsing messages.
"""

from __future__ import annotations

from typing import Optional

__all__ = [
    "IngressBootError",
    "ServeClosedError",
    "ServeDeadlineError",
    "ServeOverloadError",
]


class ServeClosedError(RuntimeError):
    """The engine (or one of its lanes) has been closed: the submit was
    refused, or an in-flight future was resolved with this error during
    a non-draining shutdown.  Terminal for this engine — re-resolve a
    replica instead of retrying here."""


class ServeOverloadError(RuntimeError):
    """Admission control shed this request: the lane's bounded queue is
    full (``max_queue_rows``).  Transient — ``retry_after_s`` is a
    deterministic backoff hint derived from the queue depth and the
    lane's drain rate, sized so a client that honors it meets a freshly
    drained queue."""

    def __init__(self, message: str, *, retry_after_s: float,
                 queue_rows: int, max_queue_rows: int):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)
        self.queue_rows = int(queue_rows)
        self.max_queue_rows = int(max_queue_rows)


class ServeDeadlineError(RuntimeError):
    """The request's end-to-end deadline expired before an answer could
    have mattered, so the fleet shed it instead of burning a replica
    slot on a reply nobody is waiting for.

    Carries the time breakdown (milliseconds) so the caller can see
    *where* the budget went: ``queue_ms`` (WFQ admission to dispatch
    pop), ``dispatch_ms`` (dispatch pop to the replica send decision),
    ``compute_ms`` (time a replica actually spent, 0.0 when the shed
    happened before any dispatch).  ``stage`` names the shed point
    (``"queue"`` — expired while queued; ``"dispatch"`` — remaining
    budget below the target replica's observed p50, so the dispatch was
    skipped).  NOT transient for this request — the deadline is the
    client's, and retrying an already-late request is exactly the retry
    amplification the retry budget exists to stop."""

    def __init__(self, message: str, *, deadline_ms: float,
                 elapsed_ms: float, stage: str = "queue",
                 queue_ms: float = 0.0, dispatch_ms: float = 0.0,
                 compute_ms: float = 0.0):
        super().__init__(message)
        self.deadline_ms = float(deadline_ms)
        self.elapsed_ms = float(elapsed_ms)
        self.stage = str(stage)
        self.queue_ms = float(queue_ms)
        self.dispatch_ms = float(dispatch_ms)
        self.compute_ms = float(compute_ms)


class IngressBootError(RuntimeError):
    """The ingress event-loop thread failed to come up.  Carries the
    listener thread's captured exception as ``cause`` (also chained via
    ``__cause__``) when there was one — a bind failure, a bad host —
    and ``cause=None`` when the thread simply never signalled within
    the startup timeout (a wedged loop), so the caller gets a diagnosis
    either way instead of a dead server and a bare RuntimeError."""

    def __init__(self, message: str, *,
                 cause: Optional[BaseException] = None):
        super().__init__(message)
        self.cause = cause
