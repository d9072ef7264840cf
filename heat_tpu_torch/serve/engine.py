"""The serving engine: persistent compiled predict programs per lane.

Port of ``heat_tpu/serve/engine.py``.  The fused predicts are the port's
``htt.fuse`` programs: on the card a CUDA-graph replay each, on the CPU
one traced call each; either way one dispatch.

One **lane** per ``(tenant, model, version)``: the registry hands the
lane its (cached) estimator, and the estimator's own module-level
``htt.fuse`` predict program — ``_fused_knn_predict``,
``_fused_nb_predict``, ``_fused_assign``, ``_fused_lasso_predict`` — IS
the persistent compiled program.  The lane's micro-batcher makes its
operand shape space finite (power-of-two row buckets), so after one
warmup trace per bucket every micro-batch is a fuse-cache replay:
**exactly one compiled dispatch per micro-batch**, verifiable with
``counting_dispatches()`` and the ``fuse.cache.hits``/``misses``
telemetry counters.

Why one dispatch and not two: the engine commits the padded host batch
to the device itself (one host-to-device copy onto the lane
communicator's device, wrapped as a DNDarray at the bucket's layout)
instead of routing it through ``factories.array`` — the factory's
layout commit records a dispatch of its own, which would double-count
the host→device staging transfer as a program launch.  The staging copy
is a transfer, not a launch; the stats account it under wire bytes
instead.  With ``donate=True`` the copy reads a page-locked staging
buffer of the lane (:class:`~heat_tpu_torch.serve.batcher.StagingPool`)
without blocking the host; the buffer is written again only after the
batch's reply was read back, which waits for the copy.  A lane runs one
batch at a time, so no two batches share a staging buffer.

Degrade wiring (``resilience.guard("degrade")`` per request): every
payload is health-screened at submit — the same
finite-and-below-overflow-limit predicate as
:func:`heat_tpu_torch.resilience.guards.health_flag`, evaluated on the host
copy — and a poisoned request NEVER enters the shared micro-batch.  It
is quarantined to its own isolated dispatch under ``guard("degrade")``,
its reply is flagged ``degraded=True``, and a ``poisoned-payload``
incident lands in the structured log.  Batch-mates are untouched:
their replies remain bitwise-equal to unbatched predicts.

Telemetry: ``serve:*`` spans around batch execution and registry
traffic, ``serve.queue_depth`` / ``serve.batch_occupancy`` gauges, and
``serve.requests`` / ``serve.batches`` / ``serve.rows`` /
``serve.degraded`` counters.

Request-scoped observability: every request gets a
``trace_id`` (caller-supplied ``request_id`` or a minted
``<lane>#<seq>``), the engine re-establishes ``telemetry.trace_ctx``
with the batch's ids around execution — so the ``serve:batch`` span,
its Perfetto record, and the flight-recorder ring all say *which*
requests the micro-batch served — and the id comes back on the
:class:`Reply`.  Per-request latencies stream into the
``serve.latency_ms`` histogram (``telemetry.observe``), feed the
optional :class:`~heat_tpu_torch.telemetry.slo.SloMonitor`, and
:meth:`ServeEngine.start_metrics_server` exposes it all on a
loopback-only ``/metrics``/``/healthz``/``/varz`` endpoint.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import types
from ..core._tracing import counting_dispatches
from ..core.dndarray import DNDarray
from ..resilience import faults as _faults
from ..resilience import guards as _guards
from ..resilience import incidents as _incidents
from ..telemetry import _core as _tel
from ..telemetry import flight as _flight
from ..telemetry.httpz import MetricsServer
from .batcher import MicroBatcher, Request, StagingPool, bucket_rows, pad_batch
from .errors import ServeClosedError
from .registry import ModelRegistry, RegistryError

__all__ = ["Reply", "ServeEngine"]


@dataclass
class Reply:
    """One request's outcome: the per-row prediction values (host numpy,
    exactly the request's rows), the degrade flag, and bookkeeping.
    ``trace_id`` is the request's observability handle — grep it in the
    event stream / Perfetto export / flight postmortem to walk this
    request's path through the engine."""

    value: np.ndarray
    degraded: bool
    seq: int
    latency_s: float
    trace_id: str = ""


def _payload_healthy(payload: np.ndarray) -> bool:
    """Host twin of :func:`heat_tpu_torch.resilience.guards.health_flag`: every
    value finite AND below the overflow limit (integer payloads are
    vacuously healthy)."""
    if payload.size == 0 or not np.issubdtype(payload.dtype, np.floating):
        return True
    if not bool(np.all(np.isfinite(payload))):
        return False
    return float(np.max(np.abs(payload))) < _guards.get_overflow_limit()


def _model_geometry(est) -> Tuple[Optional[int], Optional[object], Optional[object]]:
    """``(n_features, comm, device)`` introspected from a fitted
    estimator (duck-typed over the registry's estimator families)."""
    theta_ = getattr(est, "theta_", None)  # GaussianNB (host arrays)
    if theta_ is not None:
        return int(np.asarray(theta_).shape[1]), None, None
    centers = getattr(est, "cluster_centers_", None)  # k-clusterers
    if centers is not None:
        return int(centers.shape[1]), centers.comm, centers.device
    theta = getattr(est, "theta", None)  # Lasso ([intercept, coefs])
    if theta is not None:
        return int(theta.shape[0]) - 1, theta.comm, theta.device
    x = getattr(est, "x", None)  # KNN (training set)
    if isinstance(x, DNDarray):
        return int(x.shape[1]), x.comm, x.device
    return None, None, None


class _Lane:
    """One (tenant, model, version): estimator + batcher + geometry."""

    def __init__(self, engine: "ServeEngine", tenant: str, model: str,
                 version: int, est):
        self.tenant = tenant
        self.model = model
        self.version = version
        self.est = est
        self.predict = getattr(est, engine.method)
        self.site = f"serve:{tenant}/{model}"
        n_features, comm, device = _model_geometry(est)
        if comm is None or device is None:
            # no array operand (GaussianNB's host parameters): the default
            # communicator and its device, as the factories take them
            from ..core.communication import get_comm
            from ..core.devices import sanitize_device

            comm = get_comm()
            device = sanitize_device(comm.device)
        self.n_features = n_features
        self.comm = comm
        self.device = device
        self.dtype: Optional[np.dtype] = None  # fixed by the first payload
        self.staging = StagingPool()
        self.lock = threading.Lock()  # one batch of the lane at a time
        self.batcher = MicroBatcher(
            lambda requests: engine._process(self, requests),
            max_batch_rows=engine.max_batch_rows,
            max_delay_s=engine.max_delay_s,
            name=f"serve:{tenant}/{model}/v{version}",
            max_queue_rows=engine.max_queue_rows,
        )

    def check(self, payload: np.ndarray) -> None:
        if self.n_features is not None and int(payload.shape[1]) != self.n_features:
            raise ValueError(
                f"{self.site}: model expects {self.n_features} features, "
                f"request has {int(payload.shape[1])}"
            )
        if self.dtype is None:
            self.dtype = payload.dtype
        elif payload.dtype != self.dtype:
            raise ValueError(
                f"{self.site}: lane serves {self.dtype} payloads, request "
                f"is {payload.dtype} (mixed dtypes would fork the compiled-"
                "program cache — convert at the client)"
            )


class ServeEngine:
    """Multi-tenant micro-batched predict serving (see module docs).

    Parameters
    ----------
    registry : ModelRegistry — where models come from.
    max_batch_rows : int — coalescing cap per micro-batch.
    max_delay_s : float — background-mode queue-delay budget for the
        oldest waiting request.
    min_bucket : int — bucket floor (power of two); 8 keeps even tiny
        batches mesh-divisible on a full 8-device mesh.
    split : None | 0 | "auto" — micro-batch layout: replicated, row-split,
        or row-split exactly when the bucket divides the mesh ("auto").
    donate : bool — reuse one persistent host staging buffer per bucket
        and lane (zero allocations per batch in steady state; page-locked
        where CUDA is available).
    method : str — the estimator method lanes serve (default "predict").
    slo : SloMonitor | None — when given, every reply's latency feeds
        the monitor (burn-rate gauges + ``slo-burn`` incident on burn).
    max_queue_rows : int | None — admission-control bound per lane queue;
        a submit that would exceed it is shed with
        :class:`~heat_tpu_torch.serve.errors.ServeOverloadError` (carrying a
        deterministic ``retry_after_s`` hint) instead of growing the
        queue without bound.  ``None`` (default): unbounded.
    """

    def __init__(
        self,
        registry: ModelRegistry,
        *,
        max_batch_rows: int = 64,
        max_delay_s: float = 0.002,
        min_bucket: int = 8,
        split="auto",
        donate: bool = True,
        method: str = "predict",
        slo=None,
        max_queue_rows: Optional[int] = None,
    ):
        if split not in (None, 0, "auto"):
            raise ValueError(f'split must be None, 0 or "auto", got {split!r}')
        self.registry = registry
        self.max_batch_rows = int(max_batch_rows)
        self.max_delay_s = float(max_delay_s)
        self.max_queue_rows = None if max_queue_rows is None else int(max_queue_rows)
        self.min_bucket = int(min_bucket)
        self.split = split
        self.donate = bool(donate)
        self.method = method
        self.slo = slo
        self._metrics: Optional[MetricsServer] = None
        self._lanes: Dict[Tuple[str, str, int], _Lane] = {}
        self._lock = threading.Lock()
        self._background = False
        self._closed = False
        # dispatch/wire accounting (the bench models read these)
        self.n_requests = 0
        self.n_batches = 0
        self.n_rows = 0
        self.n_padded_rows = 0
        self.n_dispatches = 0
        self.n_degraded = 0
        self.payload_bytes = 0
        self.reply_bytes = 0

    # ------------------------------------------------------------------ #
    # lanes
    # ------------------------------------------------------------------ #
    def _lane(self, tenant: str, model: str, version: Optional[int]) -> _Lane:
        est, resolved = self.registry.load(tenant, model, version)
        key = (tenant, model, resolved)
        with self._lock:
            if self._closed:
                raise ServeClosedError("ServeEngine is closed")
            lane = self._lanes.get(key)
            if lane is None:
                lane = _Lane(self, tenant, model, resolved, est)
                self._lanes[key] = lane
                if self._background:
                    lane.batcher.start()
        return lane

    def _pick_split(self, lane: _Lane, rows: int) -> Optional[int]:
        if self.split is None:
            return None
        # split=0 and "auto" both require a mesh-divisible bucket; an
        # indivisible one (sub-min_bucket mesh) serves replicated
        size = lane.comm.size
        return 0 if (size > 1 and rows % size == 0) else None

    def _commit(self, lane: _Lane, buf: np.ndarray, split: Optional[int]) -> DNDarray:
        """Stage one host batch onto the lane's device: a single
        host-to-device copy (NOT a program dispatch — see module docs),
        wrapped with the metadata the fused programs key on.  A
        page-locked buffer is copied without blocking the host; the
        result never shares memory with ``buf``."""
        host = torch.from_numpy(buf)
        garr = host.to(lane.comm.device, non_blocking=host.is_pinned(), copy=True)
        return DNDarray(
            garr,
            tuple(buf.shape),
            types.canonical_heat_type(buf.dtype),
            split,
            lane.device,
            lane.comm,
        )

    # ------------------------------------------------------------------ #
    # request path
    # ------------------------------------------------------------------ #
    def submit(self, tenant: str, model: str, payload, *,
               version: Optional[int] = None,
               request_id: Optional[str] = None):
        """Enqueue one predict request; returns a Future resolving to a
        :class:`Reply`.  The payload is screened here: the fault seam
        applies any armed plan, then the health predicate routes the
        request to the shared batch or the per-request degrade path.

        ``request_id`` names the request for end-to-end tracing (an
        ambient :func:`telemetry.trace_ctx` id is picked up when none is
        given; otherwise the lane mints ``<lane>#<seq>``); the id comes
        back on ``Reply.trace_id``."""
        payload = np.asarray(payload)
        if payload.ndim != 2:
            raise ValueError(
                f"payload must be 2-D (rows, features), got {payload.ndim}-D"
            )
        lane = self._lane(tenant, model, version)
        lane.check(payload)
        if _faults.any_active():
            payload = np.asarray(_faults.payload_input(lane.site, payload))
        healthy = _payload_healthy(payload)
        if _tel.enabled:
            _tel.inc("serve.requests")
        self.n_requests += 1
        self.payload_bytes += int(payload.nbytes)
        return lane.batcher.submit(payload, healthy=healthy, trace_id=request_id)

    def predict(self, tenant: str, model: str, payload, *,
                version: Optional[int] = None,
                request_id: Optional[str] = None) -> Reply:
        """Synchronous convenience: submit, flush the lane, return the
        Reply (background mode: just waits on the future)."""
        fut = self.submit(tenant, model, payload, version=version,
                          request_id=request_id)
        if not self._background:
            self.flush()
        return fut.result()

    def direct_predict(self, tenant: str, model: str, payload, *,
                       version: Optional[int] = None) -> np.ndarray:
        """The unbatched twin: one request, exact shape, no padding, no
        queue — the golden the batched path must match bitwise."""
        payload = np.asarray(payload)
        lane = self._lane(tenant, model, version)
        lane.check(payload)
        x = self._commit(lane, np.ascontiguousarray(payload), None)
        return np.asarray(lane.predict(x).numpy())

    # ------------------------------------------------------------------ #
    # zero-cold-start: AOT executable export / install
    # ------------------------------------------------------------------ #
    def _buckets(self) -> List[int]:
        """The finite bucket set a lane serves: powers of two from
        ``min_bucket`` up to the coalescing cap's bucket."""
        out, b = [], self.min_bucket
        top = bucket_rows(self.max_batch_rows, min_bucket=self.min_bucket)
        while b <= top:
            out.append(b)
            b *= 2
        return out

    def export_warm(self, tenant: str, model: str, *,
                    version: Optional[int] = None, dtype="float32") -> List[dict]:
        """Capture and AOT-serialize this engine's predict programs for
        ``(tenant, model)``: one zero-payload warmup per bucket per
        serving layout (the batched split and the replicated direct
        path), recorded via :func:`heat_tpu_torch.core.aot.capture_programs`.
        Returns the bundles — hand them to
        :meth:`ModelRegistry.publish_executables` so replicas can
        :meth:`warm` without paying the compile tax."""
        from ..core import aot as _aot

        lane = self._lane(tenant, model, version)
        if lane.n_features is None:
            raise ValueError(
                f"{lane.site}: estimator exposes no feature count — cannot "
                "synthesize warmup payloads for executable export"
            )
        dt = np.dtype(lane.dtype if lane.dtype is not None else dtype)
        with _aot.capture_programs() as cap:
            for bucket in self._buckets():
                payload = np.zeros((bucket, lane.n_features), dtype=dt)
                for split in dict.fromkeys(
                    (self._pick_split(lane, bucket), None)
                ):
                    x = self._commit(lane, payload, split)
                    lane.predict(x).numpy()
        return _aot.export_programs(cap)

    def warm(self, tenant: str, model: str, *,
             version: Optional[int] = None, policy=None) -> int:
        """Install a version's serialized executables from the registry
        sidecar into the fuse cache (on the card each is captured here, so
        the first request of its shape is a replay); returns how many
        programs were installed.  0 — no sidecar, a fingerprint/topology
        mismatch, or a partial install — is the sound-fallback signal:
        serving still works, the missing programs just build on first use
        (and the shortfall lands in the incident log)."""
        from ..core import aot as _aot

        bundles, resolved = self.registry.load_executables(
            tenant, model, version, policy=policy
        )
        if not bundles:
            return 0
        lane = self._lane(tenant, model, resolved)
        installed = _aot.install_programs(bundles, comm=lane.comm)
        if installed < len(bundles):
            _incidents.record(
                "aot-fallback", lane.site, "executable-install", "fell-back",
                detail=f"installed {installed}/{len(bundles)} serialized "
                "executables; the rest take the fresh-compile rung",
            )
        if _tel.enabled:
            _tel.inc("serve.warm_installs", installed)
        return installed

    def flush(self) -> int:
        """Drain every lane synchronously; returns requests processed."""
        total = 0
        with self._lock:
            lanes = list(self._lanes.values())
        for lane in lanes:
            total += lane.batcher.drain()
        return total

    # ------------------------------------------------------------------ #
    # batch execution (the batcher's process callback)
    # ------------------------------------------------------------------ #
    def _process(self, lane: _Lane, requests: List[Request]) -> None:
        try:
            healthy = [r for r in requests if r.healthy]
            poisoned = [r for r in requests if not r.healthy]
            if healthy:
                self._run_batch(lane, healthy)
            for req in poisoned:
                self._degrade_one(lane, req)
        except BaseException as e:  # futures must never dangle
            for req in requests:
                if not req.future.done():
                    req.future.set_exception(e)
            if isinstance(e, (KeyboardInterrupt, SystemExit)):
                raise

    @staticmethod
    def _now() -> float:
        """Reply-latency timestamp source: wall clock normally, the
        telemetry sequence clock in deterministic mode — so latencies
        (and the histograms/postmortems they stream into) are replayable
        under ``enable(deterministic=True)``."""
        return _tel.clock() if _tel.is_deterministic() else time.monotonic()

    def _reply(self, req: Request, value: np.ndarray, degraded: bool,
               t_done: float) -> None:
        """Resolve one request: stream its latency into the
        ``serve.latency_ms`` histogram and the SLO monitor, then set the
        future's Reply (carrying the request's trace id back out)."""
        lat_s = t_done - req.t_submit
        lat_ms = lat_s * 1e3
        if _tel.enabled:
            _tel.observe("serve.latency_ms", lat_ms)
        if self.slo is not None:
            self.slo.observe(lat_ms)
        req.future.set_result(Reply(value, degraded, req.seq, lat_s, req.trace_id))

    def _run_batch(self, lane: _Lane, batch: List[Request]) -> None:
        with lane.lock:
            self._run_batch_locked(lane, batch)

    def _run_batch_locked(self, lane: _Lane, batch: List[Request]) -> None:
        rows = sum(r.rows for r in batch)
        bucket = bucket_rows(rows, min_bucket=self.min_bucket)
        staging = (
            lane.staging.get(bucket, int(batch[0].payload.shape[1]),
                             batch[0].payload.dtype)
            if self.donate
            else None
        )
        buf, mask = pad_batch([r.payload for r in batch], bucket, out=staging)
        split = self._pick_split(lane, bucket)
        ctx = (
            _tel.span(
                "serve:batch",
                tenant=lane.tenant,
                model=lane.model,
                version=lane.version,
                requests=len(batch),
                rows=rows,
                bucket=bucket,
                split=str(split),
            )
            if _tel.enabled
            else contextlib.nullcontext()
        )
        # the micro-batch trace context: every span/event below (the
        # serve:batch span, nested comm:* spans, Perfetto records, flight
        # notes) is tagged with ALL coalesced request ids; ids already in
        # the ambient context (sync flush inside the caller's trace_ctx)
        # are not repeated
        ambient = set(_tel.current_trace())
        with _tel.trace_ctx([r.trace_id for r in batch
                             if r.trace_id not in ambient]):
            with counting_dispatches() as window:
                x = self._commit(lane, buf, split)
                with ctx:
                    out = lane.predict(x)
                    host = out.numpy()
                count = int(window.count)
        self.n_batches += 1
        self.n_rows += rows
        self.n_padded_rows += bucket
        self.n_dispatches += count
        self.reply_bytes += int(host[:rows].nbytes)
        if _tel.enabled:
            _tel.inc("serve.batches")
            _tel.inc("serve.rows", rows)
            _tel.gauge("serve.batch_occupancy", rows / bucket)
        t_done = self._now()
        off = 0
        for req in batch:
            value = np.array(host[off : off + req.rows], copy=True)
            off += req.rows
            self._reply(req, value, False, t_done)

    def _degrade_one(self, lane: _Lane, req: Request) -> None:
        """The per-request degrade path: the poisoned payload runs as its
        own isolated dispatch under ``guard("degrade")`` — whatever its
        values poison, they poison only this reply."""
        with _tel.trace_ctx(
            () if req.trace_id in _tel.current_trace() else (req.trace_id,)
        ):
            with _guards.guard("degrade"):
                x = self._commit(lane, np.ascontiguousarray(req.payload), None)
                value = np.asarray(lane.predict(x).numpy())
            _incidents.record(
                "poisoned-payload", lane.site, "degrade", "degraded",
                detail="request quarantined to an isolated dispatch; "
                "batch-mates unaffected",
            )
            self.n_degraded += 1
            if _tel.enabled:
                _tel.inc("serve.degraded")
                _tel.record_event(
                    "serve.degrade", site=lane.site, seq=req.seq, rows=req.rows
                )
            else:
                # telemetry off: the degrade still leaves flight-ring
                # context next to the incident (always-on contract)
                _flight.note(
                    "serve.degrade", site=lane.site, seq=req.seq, rows=req.rows
                )
        self._reply(req, value, True, self._now())

    # ------------------------------------------------------------------ #
    # lifecycle / introspection
    # ------------------------------------------------------------------ #
    def start(self) -> None:
        """Switch to background mode: every lane coalesces on its own
        worker thread under the queue-delay budget."""
        with self._lock:
            self._background = True
            lanes = list(self._lanes.values())
        for lane in lanes:
            lane.batcher.start()

    def close(self, *, drain: bool = True) -> None:
        """Close the engine (idempotent).  New submits raise
        :class:`~heat_tpu_torch.serve.errors.ServeClosedError`; every request
        already accepted either gets its real reply (``drain=True``,
        default) or a future resolved with ``ServeClosedError``
        (``drain=False``) — never a hang, even when a submit races the
        close."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            lanes = list(self._lanes.values())
        for lane in lanes:
            lane.batcher.close(drain=drain)
        if self._metrics is not None:
            self._metrics.close()
            self._metrics = None

    # ------------------------------------------------------------------ #
    # live endpoint
    # ------------------------------------------------------------------ #
    def start_metrics_server(self, *, port: int = 0, host: str = "127.0.0.1"):
        """Bind the loopback-only introspection endpoint for this engine:
        ``/metrics`` (Prometheus text off the telemetry registry),
        ``/healthz``, and ``/varz`` (JSON: :meth:`varz`).  Runs on its
        own daemon thread, entirely off the request path; ``port=0``
        picks a free port (read it from the returned server's ``.port``).
        Closed with the engine."""
        if self._metrics is None:
            self._metrics = MetricsServer(port=port, host=host, varz=self.varz)
        return self._metrics

    def varz(self) -> Dict:
        """The engine's ``/varz`` contribution: aggregate stats, the live
        lanes, and the SLO burn state when a monitor is attached."""
        with self._lock:
            lanes = list(self._lanes.values())
        doc: Dict = {
            "serve": self.stats(),
            "lanes": [
                {
                    "tenant": ln.tenant,
                    "model": ln.model,
                    "version": ln.version,
                    "queue_depth": ln.batcher.queue_depth,
                }
                for ln in lanes
            ],
        }
        if self.slo is not None:
            doc["slo"] = self.slo.state()
        return doc

    def stats(self) -> Dict[str, float]:
        """Aggregate serving counters, plus the derived dispatch model:
        dispatches per micro-batch (the ==1.0 steady-state invariant) and
        mean batch occupancy (real rows / padded rows)."""
        with self._lock:
            lanes = list(self._lanes.values())
        return {
            "shed": sum(ln.batcher.n_shed for ln in lanes),
            "requests": self.n_requests,
            "batches": self.n_batches,
            "rows": self.n_rows,
            "padded_rows": self.n_padded_rows,
            "dispatches": self.n_dispatches,
            "degraded": self.n_degraded,
            "payload_bytes": self.payload_bytes,
            "reply_bytes": self.reply_bytes,
            "dispatches_per_batch": (
                self.n_dispatches / self.n_batches if self.n_batches else 0.0
            ),
            "batch_occupancy": (
                self.n_rows / self.n_padded_rows if self.n_padded_rows else 0.0
            ),
        }
