"""Numerical health guards: ``htt.resilience.guard(policy)``.

Port of ``heat_tpu/resilience/guards.py``.  The compressed collectives
(:mod:`heat_tpu_torch.comm.compressed`) are where a single corrupted
value — a NaN in a payload, a saturated quantizer scale, a flipped
exponent bit in a forwarded wire block — silently poisons a result that
then *looks* like data.  A guard adds a cheap on-device health check at
those seams (one reduction on the card, one scalar read by the host per
guarded call, and only under a policy other than ``"off"``):

``all(isfinite(out))  and  max|out| < overflow_limit``

The second clause is what makes *scale inflation* detectable: a flipped
high exponent bit in a block scale multiplies the whole decoded block by
~2^64, which stays finite but lands far above any value the algorithm
could legitimately produce.  (Deflation — a cleared exponent bit driving
a block toward zero — is indistinguishable from small data and is NOT
caught.)

Policies
--------
``"off"``
    The default: no checks, zero overhead, bit-identical to an
    unguarded call.
``"raise"``
    An unhealthy result aborts with :class:`NumericalHealthError` naming
    the offending collective.
``"warn"``
    Exactly one :class:`GuardWarning` per incident, attributed to the
    first caller frame outside the package (the
    ``_user_stacklevel`` convention), and the unhealthy result is
    returned as-is.
``"degrade"``
    The call is re-run on the exact f32 path — bit-identical to what
    ``set_collective_precision("f32")`` would have produced for that
    call — while every *healthy* call stays compressed.  The event lands
    in the structured incident log.

The policy joins every program cache key through
:func:`heat_tpu_torch.core._compile.register_key_context`
(``_guard_token``), so a fused program captured with the health output,
or without it, is never replayed under the other configuration.
"""

from __future__ import annotations

import contextlib
import threading
import warnings
from typing import Callable, Optional, Tuple

import torch

from ..core._compile import register_key_context
from ..core.communication import _user_stacklevel
from . import incidents

__all__ = [
    "GuardWarning",
    "NumericalHealthError",
    "guard",
    "get_guard_policy",
    "get_overflow_limit",
    "set_guard_policy",
]

_POLICIES = ("off", "raise", "warn", "degrade")
_POLICY = "off"
#: Finite-but-absurd threshold: ~1/1000 of f32 max.  A flipped high
#: exponent bit inflates a block by ~2^64, far past this; legitimate f32
#: compute that *approaches* f32 max is already one addition away from
#: Inf and deserves the incident.
_DEFAULT_OVERFLOW_LIMIT = 3.4e35
_OVERFLOW_LIMIT = _DEFAULT_OVERFLOW_LIMIT

_LOCAL = threading.local()


class NumericalHealthError(RuntimeError):
    """An unhealthy collective/program result under ``guard("raise")``."""


class GuardWarning(UserWarning):
    """An unhealthy result under ``guard("warn")`` (one per incident)."""


def set_guard_policy(policy: str, overflow_limit: Optional[float] = None) -> None:
    """Set the process-wide guard policy (see module docs)."""
    global _POLICY, _OVERFLOW_LIMIT
    if policy not in _POLICIES:
        raise ValueError(
            f"unknown guard policy {policy!r}: expected one of {_POLICIES}"
        )
    _POLICY = policy
    if overflow_limit is not None:
        limit = float(overflow_limit)
        if not limit > 0:
            raise ValueError("overflow_limit must be positive")
        _OVERFLOW_LIMIT = limit


def get_guard_policy() -> str:
    """The current process-wide guard policy."""
    return _POLICY


def get_overflow_limit() -> float:
    """The current finite-but-absurd magnitude threshold."""
    return _OVERFLOW_LIMIT


@contextlib.contextmanager
def guard(policy: str, overflow_limit: Optional[float] = None):
    """Context-manager form of :func:`set_guard_policy` — restores the
    previous policy (and overflow limit) on exit."""
    global _POLICY, _OVERFLOW_LIMIT
    prev, prev_limit = _POLICY, _OVERFLOW_LIMIT
    set_guard_policy(policy, overflow_limit)
    try:
        yield
    finally:
        _POLICY = prev
        _OVERFLOW_LIMIT = prev_limit


@register_key_context
def _guard_token() -> Tuple:
    """The guard policy's contribution to every program cache key
    (``jitted`` and the ``htt.fuse`` cache)."""
    return ("guard", _POLICY, _OVERFLOW_LIMIT)


def active() -> bool:
    """True when any guard policy other than ``"off"`` is in force."""
    return _POLICY != "off"


def health_flag(values, limit: Optional[float] = None) -> torch.Tensor:
    """On-device health predicate over floating tensors: a 0-d bool tensor
    that is True iff every value is finite AND below the overflow limit in
    magnitude.  Integer/bool leaves are vacuously healthy (skipped), and
    an empty tensor's magnitude is 0 (the reference's ``max(...,
    initial=0)``; ``torch.amax`` of an empty tensor raises)."""
    lim = _OVERFLOW_LIMIT if limit is None else float(limit)
    ok = None
    for v in values:
        v = torch.as_tensor(v)
        if not (v.is_floating_point() or v.is_complex()):
            continue
        if v.numel() == 0:
            leaf = torch.ones((), dtype=torch.bool, device=v.device)
        else:
            mag = torch.amax(torch.abs(v)).to(torch.float32)
            leaf = torch.all(torch.isfinite(v)) & (mag < torch.tensor(lim, dtype=torch.float32))
        ok = leaf if ok is None else ok & leaf.to(ok.device)
    return torch.ones((), dtype=torch.bool) if ok is None else ok


def is_healthy(*values) -> bool:
    """Host-side form of :func:`health_flag`: one read of the scalar flag
    from the device."""
    return bool(health_flag(values))


def _in_degrade() -> bool:
    return getattr(_LOCAL, "degrading", 0) > 0


@contextlib.contextmanager
def _degrading():
    """Recursion guard around a degrade re-run: if the exact fallback is
    *itself* unhealthy (genuinely non-finite input data), the incident is
    recorded as unrecoverable instead of degrading forever."""
    _LOCAL.degrading = getattr(_LOCAL, "degrading", 0) + 1
    try:
        yield
    finally:
        _LOCAL.degrading -= 1


def handle(site: str, result, degrade_fn: Optional[Callable], kind: str = "nonfinite-or-overflow"):
    """Dispatch an unhealthy ``result`` from ``site`` per the active
    policy.  ``degrade_fn`` (nullary) re-runs the call on the exact f32
    path; pass ``None`` where no exact fallback exists.  Returns what the
    guarded call should return."""
    policy = _POLICY
    if policy == "raise":
        incidents.record(kind, site, policy, "raised")
        raise NumericalHealthError(
            f"numerical health guard: {kind} result in {site} "
            f"(policy='raise'; see ht.resilience.incident_log())"
        )
    if policy == "warn":
        inc = incidents.record(kind, site, policy, "warned")
        warnings.warn(
            f"numerical health guard: {kind} result in {site} "
            f"(incident #{inc.seq}; continuing with the unhealthy value)",
            GuardWarning,
            stacklevel=_user_stacklevel(),
        )
        return result
    # policy == "degrade"
    if degrade_fn is None or _in_degrade():
        incidents.record(
            kind, site, policy, "unrecoverable",
            detail="no exact fallback" if degrade_fn is None
            else "exact path unhealthy too (bad input data)",
        )
        return result
    incidents.record(kind, site, policy, "degraded", detail="re-ran on the exact f32 path")
    with _degrading():
        return degrade_fn()
