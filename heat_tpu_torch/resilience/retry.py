"""Seeded retry engine: jittered exponential backoff with deadlines.

Port of ``heat_tpu/resilience/retry.py`` (numpy only, copied; the same
policy and seed give the reference's delays, on the same numpy
generator).  Transient faults — an ``EIO`` from a flaky filesystem, a checkpoint
manifest read racing a writer, a recovery path touching storage that is
still failing over — heal on retry far more often than they deserve a
crashed fit.  This module is the one place that policy lives:

- a :class:`RetryPolicy` bounds the attempts (``attempts``), spaces them
  by exponential backoff (``base_delay * multiplier**k``, capped at
  ``max_delay``), spreads herds with multiplicative jitter, and cuts the
  whole sequence off at ``deadline`` seconds of elapsed retry time;
- the jitter stream is **seeded** (default: ``HEAT_CHAOS_SEED``), so a
  retry schedule is a pure function of the policy — the chaos lane
  replays the exact same sleeps, bit for bit
  (:func:`backoff_schedule` exposes the schedule directly);
- every failed attempt lands in the incident log
  (:mod:`heat_tpu_torch.resilience.incidents`, action ``"retried"`` /
  ``"gave-up"``) and on the telemetry counters
  (``resilience.retries`` / ``resilience.retries.<site>`` /
  ``resilience.retry_exhausted``), so no retry is ever invisible.

Three spellings, one engine::

    @retry(policy, site="io.load")             # decorator
    def load(path): ...

    out = call(fn, policy=policy, site="...")  # functional

    for attempt in retry(policy, site="..."):  # loop form (the context-
        with attempt:                          # manager per attempt)
            out = flaky_op()

The reference adopts it at the HDF5/NetCDF opens, the checkpoint
manifest loads and the elastic recovery path; the port's callers come
with those layers.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional, Tuple, Type

import numpy as np

from ..telemetry import _core as _tel
from . import incidents

__all__ = [
    "RetryPolicy",
    "Retrying",
    "backoff_schedule",
    "call",
    "retry",
    "set_sleep",
]

#: injectable sleep (tests replace it to run backoff schedules instantly)
_sleep: Callable[[float], None] = time.sleep


def set_sleep(fn: Optional[Callable[[float], None]]) -> None:
    """Inject a replacement for ``time.sleep`` (``None`` restores it).
    Test-only seam: delays stay part of the deterministic schedule, they
    just stop costing wall time."""
    global _sleep
    _sleep = time.sleep if fn is None else fn


def _default_seed() -> int:
    return int(os.environ.get("HEAT_CHAOS_SEED", "0"))


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded, seeded, jittered exponential backoff.

    ``attempts`` counts TOTAL tries (1 = no retry).  Delay before retry
    ``k`` (0-based) is ``base_delay * multiplier**k``, capped at
    ``max_delay``, then scaled by a uniform jitter factor in
    ``[1 - jitter, 1 + jitter]`` drawn from a generator seeded with
    ``seed`` (``None`` → ``HEAT_CHAOS_SEED``, default 0).  ``deadline``
    (seconds of elapsed time since the first attempt, telemetry clock)
    stops retrying early even with attempts left.  ``retry_on`` is the
    exception tuple that counts as transient; anything else propagates
    immediately.
    """

    attempts: int = 3
    base_delay: float = 0.01
    multiplier: float = 2.0
    max_delay: float = 1.0
    jitter: float = 0.5
    deadline: Optional[float] = None
    retry_on: Tuple[Type[BaseException], ...] = (OSError,)
    seed: Optional[int] = None

    def __post_init__(self):
        if self.attempts < 1:
            raise ValueError(f"attempts must be >= 1, got {self.attempts}")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {self.jitter}")


#: the default policy for transient-OSError file opens (HDF5/NetCDF,
#: checkpoint manifests): three tries, ~10/20 ms backoff — enough to
#: outlive an NFS hiccup, cheap enough for a test suite
IO_POLICY = RetryPolicy(attempts=3, base_delay=0.01, retry_on=(OSError,))


def backoff_schedule(policy: RetryPolicy) -> Tuple[float, ...]:
    """The full delay schedule (seconds before retry 1, 2, …) a policy
    produces — a pure function of the policy, seed included.  Exposed so
    tests (and operators) can pin the chaos lane's exact sleeps.

    A ``deadline`` truncates the schedule: once the cumulative sleep
    reaches the deadline, no further retry can ever run (the engine's
    runtime check gives up first), so those tail delays are dropped and
    the schedule length tells the truth about the retries a policy can
    actually deliver."""
    rng = np.random.default_rng(
        policy.seed if policy.seed is not None else _default_seed()
    )
    out = []
    total = 0.0
    for k in range(policy.attempts - 1):
        if policy.deadline is not None and total >= policy.deadline:
            break
        delay = min(policy.base_delay * policy.multiplier**k, policy.max_delay)
        factor = 1.0 + policy.jitter * float(rng.uniform(-1.0, 1.0))
        out.append(delay * factor)
        total += out[-1]
    return tuple(out)


class _Attempt:
    """One try: a context manager that records the outcome with its
    :class:`Retrying` parent.  A swallowed transient exception means
    "retry"; success or a non-transient exception ends the loop."""

    __slots__ = ("_engine", "number")

    def __init__(self, engine: "Retrying", number: int):
        self._engine = engine
        self.number = number  # 1-based

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return self._engine._finish(self, exc)


class Retrying:
    """The iterable retry loop (``for attempt in retry(policy): ...``).

    Also usable as a decorator via :func:`retry`.  Not reentrant — build
    one per protected operation."""

    def __init__(self, policy: RetryPolicy, site: str = "retry"):
        self.policy = policy
        self.site = site
        self.delays = backoff_schedule(policy)
        self._attempt = 0
        self._done = False
        self._t0: Optional[float] = None

    # ---------------------------------------------------------------- #
    # iteration protocol                                                #
    # ---------------------------------------------------------------- #
    def __iter__(self):
        return self

    def __next__(self) -> _Attempt:
        if self._done:
            raise StopIteration
        if self._attempt >= self.policy.attempts:  # pragma: no cover - guarded by _finish
            raise StopIteration
        self._attempt += 1
        if self._t0 is None:
            self._t0 = _tel.clock()
        return _Attempt(self, self._attempt)

    # ---------------------------------------------------------------- #
    # outcome handling (called by _Attempt.__exit__)                    #
    # ---------------------------------------------------------------- #
    def _finish(self, attempt: _Attempt, exc: Optional[BaseException]) -> bool:
        if exc is None:
            self._done = True
            return False
        if not isinstance(exc, self.policy.retry_on):
            self._done = True
            return False  # not transient: propagate untouched
        elapsed = _tel.clock() - (self._t0 if self._t0 is not None else 0.0)
        out_of_attempts = attempt.number >= self.policy.attempts
        past_deadline = (
            self.policy.deadline is not None and elapsed >= self.policy.deadline
        )
        # a deadline-truncated schedule can be shorter than attempts-1;
        # running past its end is the same give-up as the runtime check
        out_of_schedule = attempt.number > len(self.delays)
        if _tel.enabled:
            _tel.inc("resilience.retries")
            _tel.inc(f"resilience.retries.{self.site}")
        if out_of_attempts or past_deadline or out_of_schedule:
            self._done = True
            if _tel.enabled:
                _tel.inc("resilience.retry_exhausted")
            incidents.record(
                kind=type(exc).__name__,
                site=self.site,
                policy=self._policy_tag(),
                action="gave-up",
                detail=(
                    f"attempt {attempt.number}/{self.policy.attempts}"
                    + (", deadline exceeded" if past_deadline else "")
                    + (
                        ", schedule truncated at deadline"
                        if out_of_schedule and not past_deadline
                        else ""
                    )
                    + f": {exc}"
                ),
            )
            return False  # exhausted: propagate the last exception
        delay = self.delays[attempt.number - 1]
        incidents.record(
            kind=type(exc).__name__,
            site=self.site,
            policy=self._policy_tag(),
            action="retried",
            detail=f"attempt {attempt.number}/{self.policy.attempts}, "
            f"backoff {delay:.4f}s: {exc}",
        )
        if delay > 0:
            _sleep(delay)
        return True  # swallow: the loop hands out the next attempt

    def _policy_tag(self) -> str:
        return (
            f"retry(attempts={self.policy.attempts}, "
            f"base={self.policy.base_delay}, seed="
            f"{self.policy.seed if self.policy.seed is not None else _default_seed()})"
        )

    # ---------------------------------------------------------------- #
    # decorator form                                                    #
    # ---------------------------------------------------------------- #
    def __call__(self, fn: Callable):
        import functools

        policy, site = self.policy, self.site

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            return call(fn, *args, policy=policy, site=site, **kwargs)

        return wrapper


def retry(policy: Optional[RetryPolicy] = None, site: str = "retry") -> Retrying:
    """The engine's front door: decorator or iterable-of-attempts.

    ``retry(policy)(fn)`` wraps ``fn``; ``for attempt in retry(policy):
    with attempt: ...`` drives the loop inline.  ``policy=None`` uses
    :data:`IO_POLICY`."""
    return Retrying(policy or IO_POLICY, site=site)


def call(fn: Callable, *args, policy: Optional[RetryPolicy] = None,
         site: Optional[str] = None, **kwargs):
    """Run ``fn(*args, **kwargs)`` under a retry policy and return its
    result; the last transient exception propagates when the policy is
    exhausted."""
    engine = Retrying(policy or IO_POLICY, site=site or getattr(fn, "__name__", "call"))
    out = None
    for attempt in engine:
        with attempt:
            out = fn(*args, **kwargs)
    return out
