"""Latency-hiding policy for the ring collectives, and the ring-dispatch
telemetry.

Port of ``heat_tpu/comm/overlap.py``.  The policy knob is the
reference's: ``set_overlap("on" | "off" | "auto")`` (and the
:func:`overlap` context manager) sets a process-wide mode whose token
joins every compiled-program key
(:func:`heat_tpu_torch.core._compile.register_key_context`), so flipping
it keys fresh ``jitted`` and ``htt.fuse`` entries.  :func:`overlap_enabled`
answers whether a ring over ``size`` positions runs its double-buffered
body: ``"on"`` says yes for ``size > 1``, ``"off"`` no, and ``"auto"``,
which in the reference means "on a TPU", resolves to serial, because
every position of the port shares one card and a hop is a roll on it.
(The rule for positions on several cards comes with them.)  The port's
ring bodies are the reference's serial ones, which its double-buffered
bodies equal bit for bit, so the policy changes the telemetry's
``overlapped`` flag of a planned resplit and nothing in the values.

Telemetry (all behind the single ``_tel.enabled`` predicate — zero
overhead while disabled):

- ``comm.ring.dispatch.overlapped`` / ``comm.ring.dispatch.serial``
  counters and the ``comm.overlap_ratio`` gauge (overlapped fraction of
  eager ring dispatches so far);
- per-ring ``comm:<ring>:step:issue`` / ``comm:<ring>:step:consume``
  span pairs around each eager ring dispatch: the *issue* span covers
  the (asynchronous) kernel enqueue, the *consume* span covers the wait
  for the result on its stream.  Spans are host-side by construction.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import torch

from ..core._compile import register_key_context
from ..telemetry import _core as _tel

__all__ = [
    "get_overlap",
    "overlap",
    "overlap_enabled",
    "set_overlap",
    "timed_dispatch",
]

_MODES = ("on", "off", "auto")
_OVERLAP = "auto"


def set_overlap(mode: str) -> None:
    """Set the process-wide ring-overlap policy: ``"on"``, ``"off"`` or
    ``"auto"`` (the default; serial on the port's one card)."""
    global _OVERLAP
    if mode not in _MODES:
        raise ValueError(
            f"unknown overlap mode {mode!r}: expected one of {_MODES}"
        )
    _OVERLAP = mode


def get_overlap() -> str:
    """The current process-wide ring-overlap policy."""
    return _OVERLAP


@contextlib.contextmanager
def overlap(mode: str):
    """Context-manager form of :func:`set_overlap`."""
    prev = _OVERLAP
    set_overlap(mode)
    try:
        yield
    finally:
        set_overlap(prev)


@register_key_context
def _overlap_token() -> Tuple:
    """The overlap policy's contribution to every compiled-program key:
    flipping the policy keys fresh entries."""
    return ("overlap", _OVERLAP)


def overlap_enabled(size: int) -> bool:
    """Whether a ring over ``size`` positions runs its double-buffered
    body under the current policy: never at one position or under
    ``"off"``, always under ``"on"``, and under ``"auto"`` not while
    every position shares one card."""
    if _OVERLAP == "off" or size <= 1:
        return False
    return _OVERLAP == "on"


def _note_ring(overlapped: bool) -> None:
    """Count one eager ring dispatch and refresh the
    ``comm.overlap_ratio`` gauge.  Caller holds the ``_tel.enabled``
    predicate."""
    _tel.inc(
        "comm.ring.dispatch.overlapped" if overlapped
        else "comm.ring.dispatch.serial"
    )
    with _tel._lock:
        ov = _tel._counters.get("comm.ring.dispatch.overlapped", 0)
        se = _tel._counters.get("comm.ring.dispatch.serial", 0)
    _tel.gauge("comm.overlap_ratio", ov / (ov + se))


def _leaves(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from _leaves(o)


def _wait(out) -> None:
    """Block the host until every CUDA tensor of ``out`` is computed: one
    synchronize of the current stream of each device it lies on (the
    ring's kernels run on that stream).  Nothing to wait for on the CPU,
    or while a CUDA graph is being captured (nothing runs then)."""
    devs = {t.device for t in _leaves(out) if t.device.type == "cuda"}
    for d in devs:
        if not torch.cuda.is_current_stream_capturing():
            torch.cuda.current_stream(d).synchronize()


def timed_dispatch(ring: str, overlapped: bool, launch):
    """Run one eager ring dispatch under a ``comm:<ring>:step`` span
    pair: the *issue* span times the kernel enqueue, the *consume* span
    times the wait for the result (the reference's
    ``jax.block_until_ready``).  With telemetry disabled this is exactly
    ``launch()`` — one predicate read, no spans, no sync (the
    zero-overhead contract)."""
    if not _tel.enabled:
        return launch()
    _note_ring(overlapped)
    with _tel.span(f"comm:{ring}:step:issue", overlapped=overlapped):
        out = launch()
    with _tel.span(f"comm:{ring}:step:consume", overlapped=overlapped):
        _wait(out)
    return out
