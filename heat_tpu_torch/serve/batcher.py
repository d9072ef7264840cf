"""Async micro-batching: coalesce concurrent submits into fixed shapes.

Port of ``heat_tpu/serve/batcher.py``: buckets, padding and the queue
are the reference's, host-side numpy; the one difference is where a
:class:`StagingPool` keeps its buffers (below).

The fuse cache (:mod:`heat_tpu_torch.core.fuse`) keys fused predict
programs on operand shapes — every distinct batch shape is a fresh
trace, and on the card a fresh CUDA-graph capture.  A naive
server therefore recompiles per request size; this module makes the
shape space finite instead:

- **bucketing** — batch rows round up to the next power of two
  (:func:`bucket_rows`), so a lane serves at most ``log2(max_rows)``
  distinct programs, all compiled within the first few requests;
- **canonical zero-padding + validity mask** (:func:`pad_batch`) — the
  tail rows beyond the real payload are zeros, the same pad discipline
  ``comm/compressed.py`` uses for ragged per-shard counts (and
  ``pad_to_shards`` for ragged split axes): a deterministic fill, so a
  padded batch is a pure function of its requests and replays are
  byte-stable.  The mask marks which rows are real; every predict
  program in the library is row-independent (distance/likelihood/matmul
  rows never mix), which is what makes the batched result BITWISE equal
  to each request's unbatched predict — the pad rows compute garbage
  that is sliced away, never mixed in.

The :class:`MicroBatcher` owns the queue and the coalescing policy only;
shapes, devices, and replies belong to the engine callback, so the same
batcher fronts any lane.  Two drive modes: synchronous :meth:`flush`
(deterministic — tests, replay, loadgen) and a background worker thread
(:meth:`start`) that flushes when ``max_batch_rows`` are waiting or the
oldest request has waited ``max_delay_s``.

Buffer donation: with a :class:`StagingPool` the per-bucket host staging
buffer is allocated once and rewritten in place per batch (tail
re-zeroed), so steady-state serving allocates nothing per micro-batch —
the zero-copy-replay knob the engine's ``donate`` flag controls.  Where
CUDA is available the pool's buffers are page-locked host memory, so
the engine's one host-to-device copy of a batch is a direct DMA.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..telemetry import _core as _tel
from .errors import ServeClosedError, ServeOverloadError

__all__ = ["MicroBatcher", "Request", "StagingPool", "bucket_rows", "pad_batch"]


def bucket_rows(n: int, *, min_bucket: int = 1) -> int:
    """The smallest power of two >= ``max(n, min_bucket)`` — the fixed
    row count the micro-batch is padded to.  ``min_bucket`` floors tiny
    batches into one shared bucket (fewer compiled programs, and a
    mesh-divisible shape for row-split serving)."""
    n = int(n)
    if n < 1:
        raise ValueError(f"bucket_rows needs at least one row, got {n}")
    lo = max(n, int(min_bucket))
    return 1 << (lo - 1).bit_length()


def pad_batch(
    payloads: Sequence[np.ndarray], bucket: int, out: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Pack ``payloads`` (2-D host arrays sharing dtype and feature
    count) into one ``(bucket, f)`` buffer with canonical zero padding,
    returning ``(buffer, mask)`` where ``mask[i]`` is True iff row ``i``
    is a real payload row.

    With ``out=`` the rows are written into the caller's staging buffer
    in place and only the tail is re-zeroed — the donation path: no
    allocation per batch, and because the fill is deterministic the
    buffer contents are identical to a fresh :func:`numpy.zeros` pack.
    """
    if not payloads:
        raise ValueError("pad_batch needs at least one payload")
    first = payloads[0]
    f, dtype = first.shape[1], first.dtype
    n = sum(int(p.shape[0]) for p in payloads)
    bucket = int(bucket)
    if n > bucket:
        raise ValueError(f"{n} rows do not fit the bucket of {bucket}")
    if out is None:
        buf = np.zeros((bucket, f), dtype=dtype)
    else:
        if out.shape != (bucket, f) or out.dtype != dtype:
            raise ValueError(
                f"staging buffer is {out.shape}/{out.dtype}, batch needs "
                f"({bucket}, {f})/{dtype}"
            )
        buf = out
        buf[n:] = 0  # canonical tail; real rows are overwritten below
    off = 0
    for p in payloads:
        if p.shape[1] != f or p.dtype != dtype:
            raise ValueError(
                f"mixed payloads in one batch: ({p.shape[1]}, {p.dtype}) vs ({f}, {dtype})"
            )
        rows = int(p.shape[0])
        buf[off : off + rows] = p
        off += rows
    mask = np.zeros((bucket,), dtype=bool)
    mask[:n] = True
    return buf, mask


class StagingPool:
    """One reusable host staging buffer per ``(bucket, features, dtype)``
    — the engine's ``donate=True`` allocator (see module docs); in
    page-locked memory where CUDA is available."""

    def __init__(self):
        self._buffers: Dict[Tuple[int, int, str], np.ndarray] = {}

    def get(self, bucket: int, features: int, dtype) -> np.ndarray:
        key = (int(bucket), int(features), np.dtype(dtype).str)
        buf = self._buffers.get(key)
        if buf is None:
            shape, dt = (int(bucket), int(features)), np.dtype(dtype)
            if torch.cuda.is_available():
                buf = torch.zeros(shape, dtype=torch.from_numpy(np.zeros(0, dt)).dtype,
                                  pin_memory=True).numpy()
            else:
                buf = np.zeros(shape, dtype=dt)
            self._buffers[key] = buf
        return buf

    def __len__(self) -> int:
        return len(self._buffers)


@dataclass
class Request:
    """One queued predict request (engine-internal bookkeeping).

    ``trace_id`` is the request-scoped observability handle: it rides
    the queue with the payload (contextvars do not cross the worker
    thread, so the id must travel on the request itself), and the engine
    re-establishes ``telemetry.trace_ctx`` from the batch's ids around
    execution — that is how the ``serve:batch`` span, the Perfetto
    events, and the flight ring all get tagged with the requests of the
    micro-batch they belong to."""

    seq: int
    payload: np.ndarray
    future: Future = field(default_factory=Future)
    t_submit: float = field(default_factory=time.monotonic)
    healthy: bool = True
    trace_id: str = ""

    @property
    def rows(self) -> int:
        return int(self.payload.shape[0])


class MicroBatcher:
    """Coalesces concurrent :meth:`submit` calls into micro-batches and
    hands each batch to ``process`` (see module docs).

    ``process(requests)`` owns shapes/devices/replies and MUST resolve
    every request's future (the engine does, including the degrade
    path); the batcher never touches payloads.
    """

    def __init__(
        self,
        process: Callable[[List[Request]], None],
        *,
        max_batch_rows: int = 64,
        max_delay_s: float = 0.002,
        name: str = "serve",
        max_queue_rows: Optional[int] = None,
    ):
        if int(max_batch_rows) < 1:
            raise ValueError(f"max_batch_rows must be >= 1, got {max_batch_rows}")
        if float(max_delay_s) < 0:
            raise ValueError(f"max_delay_s must be >= 0, got {max_delay_s}")
        if max_queue_rows is not None and int(max_queue_rows) < 1:
            raise ValueError(
                f"max_queue_rows must be >= 1 (or None), got {max_queue_rows}"
            )
        self._process = process
        self.max_batch_rows = int(max_batch_rows)
        self.max_delay_s = float(max_delay_s)
        self.max_queue_rows = None if max_queue_rows is None else int(max_queue_rows)
        self.name = name
        self._queue: "deque[Request]" = deque()
        self._cond = threading.Condition()
        self._seq = 0
        self._worker: Optional[threading.Thread] = None
        self._closed = False
        self.n_shed = 0

    # ------------------------------------------------------------------ #
    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    def submit(
        self,
        payload: np.ndarray,
        *,
        healthy: bool = True,
        trace_id: Optional[str] = None,
    ) -> Future:
        """Enqueue one request; the future resolves to the engine's Reply
        when a flush processes the batch it lands in.

        ``trace_id`` names the request for end-to-end tracing; when the
        caller supplies none (or an ambient :func:`telemetry.trace_ctx`
        carries none), the batcher mints ``"<lane>#<seq>"`` so every
        request is traceable even from uninstrumented clients."""
        if payload.ndim != 2:
            raise ValueError(
                f"payload must be 2-D (rows, features), got {payload.ndim}-D"
            )
        if payload.shape[0] < 1:
            raise ValueError("payload needs at least one row")
        if trace_id is None:
            ambient = _tel.current_trace()
            trace_id = ambient[-1] if ambient else None
        with self._cond:
            if self._closed:
                raise ServeClosedError(f"MicroBatcher {self.name!r} is closed")
            rows = int(payload.shape[0])
            if self.max_queue_rows is not None:
                pending = self._rows_pending()
                if pending + rows > self.max_queue_rows:
                    # shed, with a deterministic retry hint: micro-batches
                    # needed to drain the backlog × the per-batch delay
                    # budget (a pure function of queue state, so the chaos
                    # lane replays identical hints)
                    self.n_shed += 1
                    batches = max(1, -(-pending // self.max_batch_rows))
                    hint = batches * max(self.max_delay_s, 1e-4)
                    if _tel.enabled:
                        _tel.inc("serve.shed")
                        _tel.record_event(
                            "serve.shed", site=self.name, rows=rows,
                            queue_rows=pending,
                        )
                    raise ServeOverloadError(
                        f"MicroBatcher {self.name!r} queue is full "
                        f"({pending}+{rows} > {self.max_queue_rows} rows); "
                        f"retry after {hint:.4f}s",
                        retry_after_s=hint,
                        queue_rows=pending,
                        max_queue_rows=self.max_queue_rows,
                    )
            self._seq += 1
            rid = trace_id if trace_id is not None else f"{self.name}#{self._seq}"
            req = Request(
                seq=self._seq, payload=payload, healthy=healthy, trace_id=rid
            )
            if _tel.is_deterministic():
                # deterministic mode: latency math must be replayable, so
                # submit times come from the sequence clock too
                req.t_submit = _tel.clock()
            self._queue.append(req)
            if _tel.enabled:
                _tel.gauge(f"{self.name}.queue_depth", len(self._queue))
                _tel.record_event(
                    "serve.enqueue", site=self.name, rid=[rid],
                    rows=req.rows, healthy=healthy,
                )
            self._cond.notify_all()
        return req.future

    def _pop_batch(self) -> List[Request]:
        """FIFO-coalesce up to ``max_batch_rows`` rows (always at least
        one request, even an oversized one — it becomes its own batch)."""
        batch: List[Request] = []
        rows = 0
        with self._cond:
            while self._queue:
                nxt = self._queue[0]
                if batch and rows + nxt.rows > self.max_batch_rows:
                    break
                batch.append(self._queue.popleft())
                rows += nxt.rows
            if _tel.enabled:
                _tel.gauge(f"{self.name}.queue_depth", len(self._queue))
        return batch

    def flush(self) -> int:
        """Process ONE micro-batch synchronously; returns the number of
        requests it contained (0 when the queue is empty)."""
        batch = self._pop_batch()
        if batch:
            self._process(batch)
        return len(batch)

    def drain(self) -> int:
        """Flush until the queue is empty; returns requests processed."""
        total = 0
        while True:
            n = self.flush()
            if n == 0:
                return total
            total += n

    # ------------------------------------------------------------------ #
    def start(self) -> None:
        """Spawn the background coalescing worker (idempotent)."""
        with self._cond:
            if self._closed:
                raise ServeClosedError(f"MicroBatcher {self.name!r} is closed")
            if self._worker is not None:
                return
            self._worker = threading.Thread(
                target=self._run, name=f"micro-batcher:{self.name}", daemon=True
            )
            self._worker.start()

    def _rows_pending(self) -> int:
        return sum(r.rows for r in self._queue)

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if self._closed and not self._queue:
                    return
                # coalescing window: wait for a full batch, but never past
                # the oldest request's delay budget
                deadline = self._queue[0].t_submit + self.max_delay_s
                while (
                    not self._closed
                    and self._rows_pending() < self.max_batch_rows
                    and self._queue
                ):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(timeout=remaining)
            self.flush()

    def close(self, *, drain: bool = True) -> None:
        """Stop the worker and refuse new submits (idempotent; further
        submits raise :class:`ServeClosedError`).

        ``drain=True`` (default) processes everything still queued, so
        every accepted request gets its real reply.  ``drain=False``
        abandons the queue instead: every still-pending future resolves
        with :class:`ServeClosedError` — resolved, never left hanging —
        the fast-shutdown half of the close contract."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        if drain:
            self.drain()
        else:
            with self._cond:
                abandoned, self._queue = list(self._queue), deque()
            for req in abandoned:
                if not req.future.done():
                    req.future.set_exception(
                        ServeClosedError(
                            f"MicroBatcher {self.name!r} closed without "
                            f"draining; request #{req.seq} abandoned"
                        )
                    )
