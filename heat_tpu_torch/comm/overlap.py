"""Ring-dispatch telemetry: the issue/consume span pair around an eager
ring and the overlapped/serial dispatch counters.

Port of the telemetry half of ``heat_tpu/comm/overlap.py`` (``_note_ring``
and ``timed_dispatch``).  The reference's latency-hiding policy
(``set_overlap``/``overlap``) and its double-buffered ring bodies are not
ported: on one card every ring runs its serial body, so every dispatch
counts as ``overlapped=False``.

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

import torch

from ..telemetry import _core as _tel

__all__ = ["timed_dispatch"]


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
