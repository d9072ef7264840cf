"""Trace-mode state shared by the compile cache, the communication layer,
DNDarray, and :mod:`heat_tpu_torch.core.fuse`.

Port of ``heat_tpu/core/_tracing.py``.  ``heat_tpu_torch`` normally runs
ops eagerly and any host-side inspection (``float(x)``, ``repr(x)``,
``x.numpy()``) simply reads the tensor back.  Under :func:`heat_tpu_torch.fuse`
the same library code runs inside a *trace*: on the card the pipeline is
captured once into a CUDA graph, where a host read is impossible by
construction (the captured stream may not synchronize, and the values
read at capture time would be baked into every replay).  This module
holds the per-thread flag that tells the rest of the core which of the
two worlds it is in, plus the diagnostic error raised when traced code
demands a concrete value.

It also hosts the *dispatch counter* shim: a dispatch is one
library-level program launch (an eager op counts one whatever number of
CUDA kernels it launches; a fused call counts one).  The two places that
launch programs, the ``jitted()`` wrapper and a layout commit in the
communication layer, count through :func:`record_dispatch`, which
no-ops inside a trace: a call made while tracing is part of the
enclosing program.  The storage lives in :mod:`heat_tpu_torch.telemetry`;
:func:`counting_dispatches` is the leak-free way to scope a reading.

Stdlib only, so every core module can import it.
"""

from __future__ import annotations

import contextlib
import threading

from ..telemetry import _core as _telemetry

__all__ = [
    "FuseTraceError",
    "NO_OVERRIDE",
    "applying_layout_plan",
    "consume_layout_override",
    "trace_mode",
    "in_trace",
    "layout_plan_active",
    "require_concrete",
    "record_dispatch",
    "dispatch_count",
    "reset_dispatch_count",
    "counting_dispatches",
]


class FuseTraceError(RuntimeError):
    """A value-forcing operation ran on a traced DNDarray.

    Raised when code inside an ``htt.fuse`` pipeline (or a
    ``fuse.trace()`` block) tries to materialize a concrete value:
    ``float(x)``, ``x.item()``, ``print(x)``, ``x.numpy()``, file I/O.
    Inside a trace the values are those of a capture, not of a call; the
    fix is to keep the computation on the device (``torch.where`` instead
    of a Python ``if``), or to move the host-side step outside the fused
    function.
    """


class _State(threading.local):
    """The trace depth and the active layout plan, per thread: one
    thread's trace must not turn another thread's eager calls into traced
    ones (a serving process calls the library from several threads)."""

    depth = 0
    plan = None  # {signature: [apply, ...]} FIFO while a plan is active


_state = _State()


def in_trace() -> bool:
    """True while a ``fuse`` trace (or explicit ``fuse.trace()`` block)
    is active on this thread."""
    return _state.depth > 0


@contextlib.contextmanager
def trace_mode():
    """Enter tracing mode on this thread: the communication layer skips
    host inspection of layouts and value-forcing DNDarray operations
    raise :class:`FuseTraceError`.  Re-entrant."""
    _state.depth += 1
    try:
        yield
    finally:
        _state.depth -= 1


def require_concrete(what: str) -> None:
    """Raise the diagnostic :class:`FuseTraceError` if tracing is active.

    Called by every value-forcing DNDarray entry point with a short
    description of the operation (``"float()"``, ``".numpy()"`` ...).
    """
    if _state.depth > 0:
        raise FuseTraceError(
            f"{what} forces a concrete value, but this DNDarray is being "
            "traced inside htt.fuse — no value exists yet. Keep the decision "
            "on-device (torch.where) or move this step outside the "
            "fused function."
        )


# ---------------------------------------------------------------------- #
# layout-plan overrides (the autoshard seam of manipulations.resplit)     #
# ---------------------------------------------------------------------- #
#: sentinel distinguishing "no override recorded" from "override to None"
NO_OVERRIDE = object()


def layout_plan_active() -> bool:
    """True while a solved layout plan is being applied on this call."""
    return _state.plan is not None


@contextlib.contextmanager
def applying_layout_plan(decisions):
    """Expose a solved layout plan to ``resplit`` for the dynamic extent
    of one pipeline call.

    Each decision is keyed by the *signature* of the hand-written resplit
    it replaces, ``(shape, dtype, src split, requested dst)``, not by call
    position, so resplits the plan never saw pass through untouched.
    Same-signature calls consume their overrides in FIFO order.  The table
    is rebuilt per call, and nesting restores the outer plan.
    """
    table = {}
    for d in decisions:
        key = (tuple(d["shape"]), d["dtype"], d["src"], d["requested"])
        table.setdefault(key, []).append(d["apply"])
    prev = _state.plan
    _state.plan = table
    try:
        yield
    finally:
        _state.plan = prev


def consume_layout_override(shape, dtype_name, src, requested):
    """Pop the next planned placement for a resplit with this signature,
    or :data:`NO_OVERRIDE` when the active plan has nothing for it."""
    if _state.plan is None:
        return NO_OVERRIDE
    queue = _state.plan.get((tuple(shape), dtype_name, src, requested))
    if not queue:
        return NO_OVERRIDE
    return queue.pop(0)


# ---------------------------------------------------------------------- #
# dispatch counting (shim over the telemetry registry)                    #
# ---------------------------------------------------------------------- #
def record_dispatch() -> None:
    """Count one library-level program launch.

    No-ops inside trace mode: a call made while tracing is part of the
    enclosing program, not a launch of its own.
    """
    if _state.depth == 0:
        _telemetry.record_dispatch()


def dispatch_count() -> int:
    """Program launches recorded since the last reset."""
    return _telemetry.dispatch_count()


def reset_dispatch_count() -> None:
    _telemetry.reset_dispatch_count()


def counting_dispatches():
    """Scoped dispatch counting: ``with counting_dispatches() as d: ...``
    then read ``d.count``, a baseline diff over the process counter."""
    return _telemetry.counting_dispatches()
