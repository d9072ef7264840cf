"""Loopback asyncio ingress + aggregated fleet metrics.

Port of ``heat_tpu/serve/ingress.py`` (host code over
:mod:`heat_tpu_torch.net.wire`, whose frames are byte-identical to the
reference's, so either package's client talks to either package's
door).  The fleet door for out-of-process clients: an asyncio TCP server
speaking the same framing as the replica RPC, fronting any backend with
the fleet ``submit()`` contract (a
:class:`~heat_tpu_torch.serve.procfleet.ProcFleet`, or its
single-process ``FleetEngine`` golden twin wrapped the same way).  Per
the :mod:`heat_tpu_torch.net` policy the listener binds loopback ONLY — a
non-loopback host is refused at construction.

Request flow: one ``predict`` frame in (tenant/model/version/rid/session
+ the ``x`` payload blob), one ``reply`` frame out (``y`` blob + the
replica index, engine seq, measured latency, trace id, and the replica's
flight-recorder sequence).  Admission failures surface exactly like
HTTP: a :class:`~heat_tpu_torch.serve.errors.ServeOverloadError` — whether
shed at the WFQ door or inside a replica's micro-batcher — becomes an
``error`` frame with ``code=429`` and ``retry_after_s`` (the
Retry-After), which :class:`IngressClient` re-raises as the same typed
exception, so a client cannot tell (and need not care) where in the
pipeline the shed happened.

Connections pipeline: the server answers each request as its own task,
serializing frame *writes* per connection, so one slow batch does not
head-of-line-block an entire connection.

Fault-domain hardening rides the same wire:

- **deadlines** — ``predict(..., deadline_ms=...)`` puts the budget in
  the frame header; the fleet sheds expired work (queue- or
  dispatch-stage) and the resulting ``error`` frame carries ``code=504``
  plus the queue/dispatch/compute breakdown, which the client re-raises
  as the same typed :class:`~heat_tpu_torch.serve.errors.ServeDeadlineError`
  the in-process path sees.  No deadline, no overhead: the field is
  absent from the frame and the fleet takes its deadline-free fast path.
- **hedged retries under a budget** — :class:`HedgePolicy` arms the
  client: a request still unanswered after the observed
  slow-quantile latency is *hedged* to a second connection under a
  derived rid (``<rid>~h``); the first good answer wins and the loser
  is cancelled over the wire (a ``cancel`` frame the fleet maps to
  ``Future.cancel``).  429 retries honor the server's Retry-After plus
  seeded jitter.  Every hedge and retry spends from one token budget,
  refilled by successes — the classic anti-retry-storm governor: when
  the fleet is sick the budget runs dry and the client fails fast
  instead of amplifying.
- **cancellation** — a cancelled future surfaces as ``code=499``; the
  ingress catches ``asyncio.CancelledError`` explicitly (it is a
  ``BaseException``) so the loser's connection always gets a frame back
  instead of hanging.

:class:`FleetMetricsServer` is the observability half: one Prometheus
endpoint aggregating every replica's counters/gauges (scraped over the
replica RPC) with a ``replica="<index>"`` label per sample, plus the
fleet's own admission/chaos counters — byte-parseable exposition format,
scrape-time consistent with the fleet reply ledger.
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import os
import socket
import threading
import time
from concurrent import futures as _cf
from typing import Deque, Dict, Optional, Tuple

import numpy as np

from ..net import wire
from ..net._base import LoopbackHTTPServer, check_loopback
from ..resilience import retry as _retry
from ..telemetry import _core as _tel
from ..telemetry.httpz import _Handler as _MetricsHandler
from ..telemetry.httpz import _fmt, sanitize_metric_name
from .errors import (
    IngressBootError,
    ServeClosedError,
    ServeDeadlineError,
    ServeOverloadError,
)

__all__ = ["FleetMetricsServer", "HedgePolicy", "Ingress", "IngressClient"]


@dataclasses.dataclass(frozen=True)
class HedgePolicy:
    """Client-side hedging/retry contract for :class:`IngressClient`.

    ``hedge_after_quantile`` picks the observed-latency quantile after
    which a still-unanswered request is hedged (0.9 = hedge the slowest
    decile), floored at ``min_hedge_delay_s`` until enough samples
    accumulate.  ``retry_attempts`` bounds 429 retries (each honoring
    the server's Retry-After plus seeded jitter).  Hedges and retries
    both spend 1.0 from a shared token budget of ``budget_tokens``,
    refilled ``budget_refill`` per success and capped at the initial
    size — the governor that turns a fleet-wide brownout into fast
    failures instead of a retry storm.  ``seed`` feeds the jitter
    schedule (``None`` = ``HEAT_CHAOS_SEED``, default 0), so a chaos
    replay reproduces the client's sleeps exactly.
    """

    enabled: bool = True
    hedge_after_quantile: float = 0.9
    min_hedge_delay_s: float = 0.005
    retry_attempts: int = 2
    budget_tokens: float = 8.0
    budget_refill: float = 0.1
    seed: Optional[int] = None


class Ingress:
    """The loopback asyncio fleet door (see module docs).

    ``backend`` needs ``submit(tenant, model, payload, *, version,
    request_id, session) -> concurrent.futures.Future`` resolving to the
    ProcFleet reply dict, and optionally ``stats()``.  The event loop
    runs on a dedicated daemon thread; construction returns with the
    server listening (read the ephemeral port off ``.port``).
    """

    def __init__(self, backend, *, host: str = "127.0.0.1", port: int = 0):
        check_loopback(host, what="Ingress")
        self.backend = backend
        self.host = host
        self._loop = asyncio.new_event_loop()
        self._started = threading.Event()
        self._boot_error: Optional[BaseException] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._thread = threading.Thread(
            target=self._run, args=(host, int(port)),
            name="heat-ingress", daemon=True,
        )
        self._thread.start()
        if not self._started.wait(timeout=30):
            raise IngressBootError(
                "ingress event loop failed to start within 30s: the "
                "listener thread never signalled (wedged loop?)"
            )
        if self._boot_error is not None:
            cause = self._boot_error
            raise IngressBootError(
                f"ingress failed to listen on {host}:{port}: "
                f"{type(cause).__name__}: {cause}",
                cause=cause,
            ) from cause
        self.port = self._port

    # ------------------------------------------------------------------ #
    # event-loop thread
    # ------------------------------------------------------------------ #
    def _run(self, host: str, port: int) -> None:
        asyncio.set_event_loop(self._loop)
        try:
            self._server = self._loop.run_until_complete(
                asyncio.start_server(self._serve_conn, host, port)
            )
            self._port = self._server.sockets[0].getsockname()[1]
        except BaseException as e:
            self._boot_error = e
            self._started.set()
            return
        self._started.set()
        try:
            self._loop.run_forever()
        finally:
            self._server.close()
            self._loop.run_until_complete(self._server.wait_closed())
            pending = asyncio.all_tasks(self._loop)
            for t in pending:
                t.cancel()
            if pending:
                self._loop.run_until_complete(
                    asyncio.gather(*pending, return_exceptions=True)
                )
            self._loop.close()

    async def _serve_conn(self, reader, writer) -> None:
        wlock = asyncio.Lock()  # frame writes must not interleave
        tasks = set()
        try:
            while True:
                try:
                    got = await wire.read_frame(reader)
                except wire.WireError:
                    break
                if got is None:
                    break
                t = asyncio.ensure_future(self._handle(got, writer, wlock))
                tasks.add(t)
                t.add_done_callback(tasks.discard)
        finally:
            for t in tasks:
                t.cancel()
            writer.close()
            try:
                await writer.wait_closed()
            except (OSError, ConnectionError):
                pass

    async def _handle(self, got, writer, wlock) -> None:
        msg, blobs = got
        kind = msg.get("kind")
        rid = msg.get("rid")
        try:
            if kind == "predict":
                kw = dict(
                    version=msg.get("version"),
                    request_id=rid,
                    session=msg.get("session"),
                )
                # only forward a deadline when the client set one, so
                # backends without deadline support (the FleetEngine
                # golden twin) keep working for deadline-free traffic
                if msg.get("deadline_ms") is not None:
                    kw["deadline_ms"] = float(msg["deadline_ms"])
                fut = self.backend.submit(
                    msg["tenant"], msg["model"], blobs["x"], **kw
                )
                reply = await asyncio.wrap_future(fut)
                out_msg = {
                    "kind": "reply", "rid": rid,
                    "replica": int(reply.get("replica", -1)),
                    "seq": int(reply.get("seq", 0)),
                    "degraded": bool(reply.get("degraded", False)),
                    "latency_s": float(reply.get("latency_s", 0.0)),
                    "trace_id": reply.get("trace_id"),
                    "flight_seq": int(reply.get("flight_seq", 0)),
                }
                out_blobs = {"y": np.asarray(reply["value"])}
            elif kind == "stats":
                stats = await asyncio.get_running_loop().run_in_executor(
                    None, self.backend.stats
                )
                out_msg = {"kind": "stats", "stats": stats}
                out_blobs = None
            elif kind == "cancel":
                cancelled = False
                cancel_fn = getattr(self.backend, "cancel", None)
                if cancel_fn is not None and rid is not None:
                    cancelled = bool(
                        await asyncio.get_running_loop().run_in_executor(
                            None, cancel_fn, rid
                        )
                    )
                out_msg = {"kind": "cancel_ack", "rid": rid,
                           "cancelled": cancelled}
                out_blobs = None
            else:
                out_msg = {
                    "kind": "error", "code": 400, "rid": rid,
                    "error": f"unknown frame kind {kind!r}",
                }
                out_blobs = None
        except asyncio.CancelledError:
            # CancelledError is a BaseException: without this clause a
            # cancelled backend future (the hedge loser) would kill the
            # handler task with NO reply frame, wedging the client's
            # lockstep socket forever
            out_msg = {"kind": "error", "code": 499, "rid": rid,
                       "error": "cancelled"}
            out_blobs = None
        except ServeOverloadError as e:
            out_msg = {
                "kind": "error", "code": 429, "rid": rid,
                "error": str(e),
                "retry_after_s": e.retry_after_s,
                "queue_rows": e.queue_rows,
                "max_queue_rows": e.max_queue_rows,
            }
            out_blobs = None
        except ServeDeadlineError as e:
            out_msg = {
                "kind": "error", "code": 504, "rid": rid,
                "error": str(e),
                "deadline_ms": e.deadline_ms,
                "elapsed_ms": e.elapsed_ms,
                "stage": e.stage,
                "queue_ms": e.queue_ms,
                "dispatch_ms": e.dispatch_ms,
                "compute_ms": e.compute_ms,
            }
            out_blobs = None
        except ServeClosedError as e:
            out_msg = {"kind": "error", "code": 503, "rid": rid,
                       "error": str(e)}
            out_blobs = None
        except Exception as e:
            out_msg = {"kind": "error", "code": 500, "rid": rid,
                       "error": f"{type(e).__name__}: {e}"}
            out_blobs = None
        async with wlock:
            try:
                await wire.write_frame(writer, out_msg, out_blobs)
            except (OSError, ConnectionError):
                pass  # client hung up before its reply; nothing to do

    # ------------------------------------------------------------------ #
    @property
    def url(self) -> str:
        return f"{self.host}:{self.port}"

    def close(self) -> None:
        if self._loop.is_closed():
            return
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=10)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class IngressClient:
    """Blocking wire-protocol client for :class:`Ingress` (tests, the
    loadgen hop, and the tutorial).  One lockstep request per call;
    thread-safe via an internal lock.  A 429 ``error`` frame re-raises
    as :class:`ServeOverloadError` with the server's Retry-After; a 504
    re-raises as :class:`ServeDeadlineError` with the fleet's time
    breakdown.

    Pass ``hedge=HedgePolicy(...)`` to arm hedged retries: the client
    opens a second connection, hedges slow requests onto it, cancels
    the loser over the wire, and retries 429s under the policy's token
    budget (module docs).  Without ``hedge`` the client is the plain
    lockstep client — no second socket, no executor, no budget math.
    """

    def __init__(self, host: str, port: int, *, timeout_s: float = 120.0,
                 hedge: Optional[HedgePolicy] = None):
        self._addr = (host, int(port))
        self._timeout_s = float(timeout_s)
        self._sock = socket.create_connection(self._addr, timeout=timeout_s)
        self._lock = threading.Lock()
        self._seq = 0
        self._stats_lock = threading.Lock()
        self._latencies: Deque[float] = collections.deque(maxlen=128)
        self.n_hedges = 0
        self.n_hedge_wins = 0
        self.n_retries = 0
        self.n_budget_exhausted = 0
        self._hedge = hedge if (hedge is not None and hedge.enabled) else None
        if self._hedge is not None:
            self._hedge_sock = socket.create_connection(
                self._addr, timeout=timeout_s
            )
            self._hedge_lock = threading.Lock()
            self._pool = _cf.ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="heat-hedge"
            )
            self._budget = float(self._hedge.budget_tokens)
            seed = self._hedge.seed
            if seed is None:
                seed = int(os.environ.get("HEAT_CHAOS_SEED", "0"))
            self._jitter = _retry.backoff_schedule(_retry.RetryPolicy(
                attempts=max(2, self._hedge.retry_attempts + 1),
                base_delay=1e-3, multiplier=2.0, max_delay=0.05,
                jitter=0.5, seed=seed,
            ))
            self._jitter_i = 0

    # ------------------------------------------------------------------ #
    def _call(self, msg: dict, blobs: Optional[dict] = None, *,
              sock=None, lock=None) -> Tuple[dict, dict]:
        sock = self._sock if sock is None else sock
        lock = self._lock if lock is None else lock
        with lock:
            wire.send_frame(sock, msg, blobs)
            got = wire.recv_frame(sock)
        if got is None:
            raise wire.WireError("ingress hung up")
        reply, rblobs = got
        if reply.get("kind") == "error":
            code = reply.get("code")
            if code == 429:
                raise ServeOverloadError(
                    str(reply.get("error", "overloaded")),
                    retry_after_s=float(reply.get("retry_after_s", 0.0)),
                    queue_rows=int(reply.get("queue_rows", 0)),
                    max_queue_rows=int(reply.get("max_queue_rows", 0)),
                )
            if code == 504:
                raise ServeDeadlineError(
                    str(reply.get("error", "deadline exceeded")),
                    deadline_ms=float(reply.get("deadline_ms", 0.0)),
                    elapsed_ms=float(reply.get("elapsed_ms", 0.0)),
                    stage=str(reply.get("stage", "queue")),
                    queue_ms=float(reply.get("queue_ms", 0.0)),
                    dispatch_ms=float(reply.get("dispatch_ms", 0.0)),
                    compute_ms=float(reply.get("compute_ms", 0.0)),
                )
            raise RuntimeError(
                f"ingress error {code}: {reply.get('error')}"
            )
        return reply, rblobs

    # ------------------------------------------------------------------ #
    # hedging internals
    # ------------------------------------------------------------------ #
    def _note_success(self, latency_s: float) -> None:
        with self._stats_lock:
            self._latencies.append(float(latency_s))
            if self._hedge is not None:
                self._budget = min(
                    self._hedge.budget_tokens,
                    self._budget + self._hedge.budget_refill,
                )

    def _spend_token(self) -> bool:
        """Take one token from the retry/hedge budget; False (and the
        exhaustion counter) when the bucket is dry."""
        with self._stats_lock:
            if self._budget >= 1.0:
                self._budget -= 1.0
                return True
            self.n_budget_exhausted += 1
        if _tel.enabled:
            _tel.inc("serve.retry_budget_exhausted")
        return False

    def _hedge_delay_s(self) -> float:
        """How long to give the primary before hedging: the policy's
        latency quantile over recent observations, floored at
        ``min_hedge_delay_s`` (and used alone until 8 samples exist)."""
        assert self._hedge is not None
        with self._stats_lock:
            lat = sorted(self._latencies)
        q = 0.0
        if len(lat) >= 8:
            q = lat[min(len(lat) - 1,
                        int(self._hedge.hedge_after_quantile * len(lat)))]
        return max(self._hedge.min_hedge_delay_s, q)

    def _next_jitter_s(self) -> float:
        with self._stats_lock:
            i = self._jitter_i
            self._jitter_i += 1
        return self._jitter[min(i, len(self._jitter) - 1)]

    def _wrap(self, reply: dict, rblobs: dict) -> dict:
        out = dict(reply)
        out["value"] = rblobs["y"]
        return out

    def _predict_hedged(self, msg: dict, x) -> dict:
        """429-retry loop around single hedged attempts.  Only overload
        sheds retry — a deadline shed is terminal for the request (its
        budget is the client's, and it already ran out)."""
        assert self._hedge is not None
        attempt = 0
        while True:
            try:
                return self._hedged_once(msg, x)
            except ServeOverloadError as e:
                attempt += 1
                if attempt > self._hedge.retry_attempts:
                    raise
                if not self._spend_token():
                    raise
                with self._stats_lock:
                    self.n_retries += 1
                if _tel.enabled:
                    _tel.inc("serve.client.retries")
                # honor the server's Retry-After; seeded jitter on top
                # de-synchronizes a thundering herd of honorers
                _retry._sleep(max(0.0, e.retry_after_s)
                              + self._next_jitter_s())

    def _hedged_once(self, msg: dict, x) -> dict:
        assert self._hedge is not None
        rid = msg.get("rid")
        t0 = time.perf_counter()
        primary = self._pool.submit(self._call, msg, {"x": x})
        try:
            reply, rblobs = primary.result(timeout=self._hedge_delay_s())
            self._note_success(time.perf_counter() - t0)
            return self._wrap(reply, rblobs)
        except _cf.TimeoutError:
            pass
        # primary is slow: hedge to the second connection if the rid is
        # hedgeable (cancel needs one) and the budget allows
        if rid is None or not self._spend_token():
            reply, rblobs = primary.result()
            self._note_success(time.perf_counter() - t0)
            return self._wrap(reply, rblobs)
        hmsg = dict(msg)
        hmsg["rid"] = f"{rid}~h"
        with self._stats_lock:
            self.n_hedges += 1
        if _tel.enabled:
            _tel.inc("serve.hedges")
        hedged = self._pool.submit(
            self._call, hmsg, {"x": x},
            sock=self._hedge_sock, lock=self._hedge_lock,
        )
        winner = None
        pending = {primary, hedged}
        while pending:
            done, pending = _cf.wait(
                pending, return_when=_cf.FIRST_COMPLETED
            )
            for f in done:
                if f.exception() is None:
                    winner = f
                    break
            if winner is not None:
                break
        if winner is None:
            primary.result()  # both legs failed: re-raise the primary's
        if winner is hedged:
            with self._stats_lock:
                self.n_hedge_wins += 1
            if _tel.enabled:
                _tel.inc("serve.hedge_wins")
        loser = hedged if winner is primary else primary
        loser_rid = hmsg["rid"] if winner is primary else rid
        wsock, wlock = (
            (self._sock, self._lock) if winner is primary
            else (self._hedge_sock, self._hedge_lock)
        )
        if not loser.done():
            # best-effort cancel over the winner's (now idle) socket,
            # then reap the loser so its socket is lockstep-clean for
            # the next request
            try:
                self._call({"kind": "cancel", "rid": loser_rid},
                           sock=wsock, lock=wlock)
            except (RuntimeError, wire.WireError, OSError):
                pass
        try:
            loser.result(timeout=self._timeout_s)
        except Exception:
            pass  # a cancelled loser answers 499; any answer is fine
        reply, rblobs = winner.result()
        self._note_success(time.perf_counter() - t0)
        return self._wrap(reply, rblobs)

    # ------------------------------------------------------------------ #
    def predict(self, tenant: str, model: str, payload, *,
                version: Optional[int] = None,
                request_id: Optional[str] = None,
                session: Optional[str] = None,
                deadline_ms: Optional[float] = None) -> dict:
        """One request over the wire; returns the reply dict (``value``
        plus the routing/tracing fields — see module docs).
        ``deadline_ms`` rides the frame header end to end; when the
        fleet sheds on it the call raises :class:`ServeDeadlineError`
        with the stage breakdown."""
        self._seq += 1
        msg = {
            "kind": "predict", "tenant": tenant, "model": model,
            "version": version, "rid": request_id, "session": session,
        }
        if deadline_ms is not None:
            msg["deadline_ms"] = float(deadline_ms)
        x = np.asarray(payload)
        if self._hedge is not None:
            return self._predict_hedged(msg, x)
        t0 = time.perf_counter()
        reply, rblobs = self._call(msg, {"x": x})
        self._note_success(time.perf_counter() - t0)
        return self._wrap(reply, rblobs)

    def hedge_stats(self) -> dict:
        """Client-side resilience counters (all zero when unhedged)."""
        with self._stats_lock:
            return {
                "hedges": self.n_hedges,
                "hedge_wins": self.n_hedge_wins,
                "retries": self.n_retries,
                "budget_exhausted": self.n_budget_exhausted,
                "budget_tokens": (
                    self._budget if self._hedge is not None else 0.0
                ),
            }

    def stats(self) -> dict:
        reply, _ = self._call({"kind": "stats"})
        return reply["stats"]

    def close(self) -> None:
        if self._hedge is not None:
            self._pool.shutdown(wait=False)
            try:
                self._hedge_sock.close()
            except OSError:
                pass
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# --------------------------------------------------------------------- #
# aggregated fleet /metrics
# --------------------------------------------------------------------- #
def fleet_prometheus_text(fleet) -> str:
    """The aggregated exposition document: every replica's counters and
    gauges (scraped over the replica RPC) as one metric family per name
    with a ``replica="<index>"`` label per sample, then the fleet's own
    counters.  Values render via the same formatter as the single-process
    ``/metrics``, so they parse back exactly."""
    scrapes = fleet.scrape_metrics()
    lines = []
    for family, suffix, ptype in (("counters", "_total", "counter"),
                                  ("gauges", "", "gauge")):
        names = sorted({n for s in scrapes for n in s.get(family, {})})
        for name in names:
            m = sanitize_metric_name(name) + suffix
            lines.append(f"# HELP {m} heat_tpu fleet {ptype} {name}")
            lines.append(f"# TYPE {m} {ptype}")
            for s in scrapes:
                if name in s.get(family, {}):
                    lines.append(
                        f'{m}{{replica="{s["replica"]}"}} '
                        f'{_fmt(s[family][name])}'
                    )
    stats = fleet.stats()
    lines.append("# HELP heat_fleet_replicas live replica processes")
    lines.append("# TYPE heat_fleet_replicas gauge")
    lines.append(f"heat_fleet_replicas {int(stats['replicas'])}")
    for key in ("accepted", "resolved", "wfq_shed", "requeued",
                "replica_losses", "respawns", "drains", "deadline_shed",
                "cancelled", "breaker_opens"):
        m = f"heat_fleet_{key}_total"
        lines.append(f"# HELP {m} heat_tpu fleet counter fleet.{key}")
        lines.append(f"# TYPE {m} counter")
        lines.append(f"{m} {int(stats.get(key, 0))}")
    return "\n".join(lines) + "\n"


class FleetMetricsServer(LoopbackHTTPServer):
    """Loopback HTTP endpoint serving the aggregated fleet ``/metrics``
    (plus ``/healthz``); same lifecycle contract as ``MetricsServer``."""

    def __init__(self, fleet, *, port: int = 0, host: str = "127.0.0.1"):
        def _text() -> str:
            return fleet_prometheus_text(fleet)

        handler = type(
            "_FleetHandler", (_FleetMetricsHandler,),
            {"metrics_fn": staticmethod(_text)},
        )
        super().__init__(handler, port=port, host=host, name="heat-fleet-metrics")


class _FleetMetricsHandler(_MetricsHandler):
    metrics_fn = None

    def do_GET(self):  # noqa: N802 - http.server API
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            try:
                body = type(self).metrics_fn()
            except Exception as e:  # scrape failures must not 500 opaquely
                self._send(503, f"scrape failed: {type(e).__name__}: {e}\n",
                           "text/plain; charset=utf-8")
                return
            self._send(200, body, "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/healthz":
            self._send(200, "ok\n", "text/plain; charset=utf-8")
        else:
            self._send(404, "not found\n", "text/plain; charset=utf-8")
