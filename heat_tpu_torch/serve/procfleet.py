"""Multi-process serving fleet: warm replica processes behind one door.

Port of ``heat_tpu/serve/procfleet.py``.
:class:`~heat_tpu_torch.serve.fleet.FleetEngine` gives elasticity,
canary, and zero-cold-start *in one process* — every replica sharing one
GIL, so "aggregate predictions/sec vs replica count" is not a real
number there.  :class:`ProcFleet` is the other half: each replica is an
OS **process** (:mod:`heat_tpu_torch.serve._replica_main`) hosting a
sidecar-warmed :class:`ServeEngine`, joined to the parent by one
loopback TCP connection speaking the :mod:`heat_tpu_torch.net.wire`
framing.  Processes do not share a GIL, so the aggregate-throughput
scaling curve over 1→2→4 replicas is real.  Each child is a fresh
interpreter (``subprocess.Popen``, never a fork of a process that may
hold a CUDA context) placed where the parent is: the spawn config
carries the parent's default device and its communicator's positions,
so on the card every replica opens its own CUDA context on the same
device, and a child that finds no CUDA device fails its boot.

Architecture::

    submit() ──canary──▶ WeightedFairQueue ──dispatcher──▶ outbox[i]
                (WFQ admission: per-tenant          │ sticky/RR pick
                 bounds shed 429 here)              ▼
                                        worker[i]: send ▸ recv ▸ resolve
                                           │  (lockstep: ≤1 in flight)
                                           ▼
                                   replica process i (warm ServeEngine)

- **Admission** is the :class:`~heat_tpu_torch.serve.wfq.WeightedFairQueue`:
  per-tenant weighted-fair service with strict priority bands, bounded
  per-tenant backlogs shedding typed
  :class:`~heat_tpu_torch.serve.errors.ServeOverloadError` — one hot tenant
  saturates its own share while a cold tenant's p99 stays bounded.
- **Routing** is sticky by session: ``submit(..., session=...)`` pins a
  session to a replica for its lifetime (canary assignment and ``rid=``
  trace ids are decided *before* the hop and ride the frame, so they
  survive re-routing; the reply carries the replica's flight-recorder
  sequence for postmortem stitching).  Sessionless traffic round-robins.
- **Canary** mirrors ``FleetEngine`` exactly: one draw per eligible
  request from ``default_rng([seed, 2])`` in submit order, so a
  ``ProcFleet`` and its single-process golden twin assign identical
  versions to identical request streams.
- **Un-acked re-queue** (the kill -9 contract): each worker keeps at
  most one request in flight, so when a replica dies (EOF / reset on
  its socket ⇒ :class:`~heat_tpu_torch.net.wire.WireError`) the un-acked set
  is exactly {the in-flight request} ∪ {its outbox}; those — and only
  those — are re-queued to survivors.  Predict is stateless and
  versions are pinned pre-hop, so a request the dead replica answered
  into the void re-executes byte-identically on a survivor; the future
  resolves once, hence "no accepted request lost or double-answered".
- **Ledger**: every resolved request lands as ``(rid, crc32(reply))``;
  :meth:`ledger` returns them in submit order.  Reply bytes are a pure
  function of (model version, payload) — independent of which replica
  answered or when — so the ledger is a pure function of
  ``HEAT_CHAOS_SEED`` even across kill -9 chaos, replayable twice to
  byte equality.

Everything binds loopback only; the spawn handshake is parent-listens /
child-connects with a one-shot token, so there is no port race and no
foreign process can impersonate a replica.
"""

from __future__ import annotations

import os
import queue
import secrets
import socket
import subprocess
import sys
import threading
import time
import zlib
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..net import wire
from ..net._base import check_loopback
from ..resilience import faults as _faults
from ..resilience import incidents as _incidents
from ..resilience import retry as _retry
from ..telemetry import _core as _tel
from ..telemetry import flight as _flight
from .errors import ServeClosedError, ServeDeadlineError, ServeOverloadError
from .fleet import CanaryConfig
from .health import ReplicaBreaker
from .loadgen import chaos_seed
from .wfq import TenantPolicy, WeightedFairQueue

__all__ = ["ProcFleet", "ReplicaProc"]

_SPAWN_TIMEOUT_S = 120.0  # torch import + warm install on a loaded CI box


def _policy_snapshot() -> dict:
    """Process-wide policy knobs that feed the compile-cache key context.

    ``aot.fingerprint()`` embeds :func:`~heat_tpu_torch.core._compile.
    context_token`, so a replica process left on policy *defaults* would
    soundly refuse every sidecar bundle a non-default parent exported
    (installed=0, fresh compiles — the zero-compile hello would catch
    it, but warm spin-ups are the whole point).  The spawn config ships
    this snapshot and :mod:`_replica_main` re-applies it before engine
    construction, so the child's fingerprint matches the exporter's."""
    from ..comm.compressed import (
        get_collective_precision,
        get_collective_threshold,
    )
    from ..comm.overlap import get_overlap
    from ..comm.redistribute import (
        get_redistribution,
        get_redistribution_threshold,
    )
    from ..io.stream import get_prefetch
    from ..resilience.guards import get_guard_policy, get_overflow_limit

    return {
        "overlap": get_overlap(),
        "collective_precision": get_collective_precision(),
        "collective_threshold": int(get_collective_threshold()),
        "redistribution": get_redistribution(),
        "redistribution_threshold": int(get_redistribution_threshold()),
        "guard_policy": get_guard_policy(),
        "guard_overflow_limit": float(get_overflow_limit()),
        "prefetch": get_prefetch(),
    }


def _placement_snapshot() -> dict:
    """Where this process runs: its default device (``None`` when it was
    never set) and its default communicator's positions and mesh.  The
    spawn config ships it beside the policy snapshot and
    :mod:`_replica_main` applies it before the registry loads a model, so
    the child's estimators live on the parent's positions and the AOT
    bundles the parent exported install there.  Raises where the parent
    itself has no device (no CUDA and no CPU asked for)."""
    from ..core import communication, devices

    comm = communication.get_comm()
    default = devices._default
    return {
        "device": None if default is None else default.device_type,
        "positions": [str(p) for p in comm._positions],
        "mesh_shape": [int(s) for s in comm.mesh_shape],
    }


@dataclass
class _Pending:
    """One admitted request riding the dispatcher."""

    rid: str
    tenant: str
    model: str
    version: Optional[int]
    session: Optional[str]
    payload: np.ndarray
    future: Future
    submit_index: int
    # --- gray-failure fields (all inert when no deadline is set) ---
    deadline_ms: Optional[float] = None
    t_submit: float = 0.0    # perf_counter at admission (deadline only)
    t_dispatch: float = 0.0  # perf_counter at dispatcher pop (deadline only)
    requeues: int = 0        # crash re-queues this request survived


class ReplicaProc:
    """One replica process + its RPC socket (see module docs).

    Use :meth:`spawn`: it owns the listen-then-spawn handshake, validates
    the hello token, and returns only once the replica is warm and
    serving; a child that exits before it connects (a failed boot) is
    reported at once with its exit code.  ``call`` is the serialized
    request/reply primitive the fleet's scrape paths use; the hot path talks to ``sock`` directly
    from the owning worker thread (lockstep, no lock needed).
    """

    #: the child's command after the interpreter: the replica entry point
    _child_argv: Tuple[str, ...] = ("-m", "heat_tpu_torch.serve._replica_main")

    def __init__(self, index: int, proc: subprocess.Popen,
                 sock: socket.socket, hello: dict):
        self.index = index
        self.proc = proc
        self.sock = sock
        self.hello = hello
        self.pid = int(hello.get("pid", proc.pid))
        self.dead = False
        self.drained = False  # dead via goodbye + clean EOF, not a crash
        self.breaker = ReplicaBreaker()  # replaced by the fleet at spawn
        self._lock = threading.Lock()

    @classmethod
    def spawn(cls, index: int, *, registry_root: str,
              warm_models: Sequence[Tuple] = (),
              engine_kwargs: Optional[dict] = None,
              host: str = "127.0.0.1",
              spawn_timeout_s: float = _SPAWN_TIMEOUT_S) -> "ReplicaProc":
        check_loopback(host, what="ReplicaProc")
        token = secrets.token_hex(16)
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            listener.bind((host, 0))
            listener.listen(1)
            listener.settimeout(0.25)
            cfg = {
                "port": listener.getsockname()[1],
                "token": token,
                "replica": int(index),
                "registry_root": str(registry_root),
                "warm_models": [list(w) for w in warm_models],
                "engine_kwargs": dict(engine_kwargs or {}),
                "policy": _policy_snapshot(),
                "placement": _placement_snapshot(),
            }
            import json as _json

            # the child must import heat_tpu_torch no matter what the caller's
            # cwd is (the repo may not be pip-installed): front-load the
            # package's parent directory onto its PYTHONPATH
            env = dict(os.environ)
            pkg_parent = os.path.dirname(
                os.path.dirname(os.path.abspath(__file__))
            )
            pkg_parent = os.path.dirname(pkg_parent)
            prior = env.get("PYTHONPATH")
            env["PYTHONPATH"] = (
                pkg_parent if not prior
                else pkg_parent + os.pathsep + prior
            )
            proc = subprocess.Popen(
                [sys.executable, *cls._child_argv, _json.dumps(cfg)],
                env=env,
            )
            deadline = time.monotonic() + spawn_timeout_s
            while True:
                try:
                    conn, _ = listener.accept()
                    break
                except socket.timeout:
                    if proc.poll() is not None:
                        raise ConnectionError(
                            f"replica {index} exited with code "
                            f"{proc.returncode} before connecting (pid "
                            f"{proc.pid}): its boot failed"
                        )
                    if time.monotonic() >= deadline:
                        proc.kill()
                        proc.wait()
                        raise TimeoutError(
                            f"replica {index} did not connect within "
                            f"{spawn_timeout_s}s (pid {proc.pid})"
                        )
        finally:
            listener.close()
        conn.settimeout(spawn_timeout_s)
        got = wire.recv_frame(conn)
        if got is None or got[0].get("kind") != "hello" \
                or got[0].get("token") != token:
            proc.kill()
            proc.wait()
            conn.close()
            raise ConnectionError(
                f"replica {index} handshake failed: "
                f"{'EOF' if got is None else got[0].get('kind')}"
            )
        conn.settimeout(None)
        hello = dict(got[0])
        hello.pop("token", None)  # one-shot; never store or log it
        return cls(index, proc, conn, hello)

    def call(self, msg: dict, blobs: Optional[dict] = None) -> Tuple[dict, dict]:
        """Serialized request/reply (scrape paths; not the hot path)."""
        with self._lock:
            wire.send_frame(self.sock, msg, blobs)
            got = wire.recv_frame(self.sock)
        if got is None:
            raise wire.WireError(f"replica {self.index} hung up")
        return got

    def kill(self) -> None:
        """SIGKILL — the chaos lane's replica-loss injection."""
        self.proc.kill()

    def terminate(self) -> None:
        """SIGTERM — ask the replica to drain: finish in-flight work,
        send its goodbye frame, exit 0 (the graceful half of the
        drain-vs-crash distinction)."""
        self.proc.terminate()

    def close(self, *, timeout_s: float = 30.0) -> None:
        if not self.dead:
            try:
                self.call({"kind": "close"})
            except (OSError, wire.WireError):
                pass
        try:
            self.sock.close()
        except OSError:
            pass
        try:
            self.proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=timeout_s)


class ProcFleet:
    """The multi-process serving fleet (see module docs).

    Parameters
    ----------
    registry_root : str — filesystem root the replicas' registries open
        (the parent never loads estimators itself).
    n_replicas : int — initial fleet size.
    warm_models : sequence of (tenant, model[, version]) — models each
        replica warms from the ``.aotx`` sidecar before taking traffic.
    tenants : dict tenant -> :class:`TenantPolicy` | None — the WFQ
        admission policies (weights, priority bands, per-tenant bounds).
    default_max_queue_rows : int | None — backlog bound for tenants
        without an explicit policy.
    canary : CanaryConfig | None — seeded versioned rollout, identical
        draws to ``FleetEngine`` (the golden-twin contract).
    seed : int | None — canary stream seed (default ``HEAT_CHAOS_SEED``).
    auto_respawn : bool — respawn a warm replacement when a replica dies
        (the chaos lane's recovery leg); the un-acked re-queue happens
        either way.
    breaker_failure_threshold : int — consecutive replica-health
        failures (wire errors, stalls, 500s) that trip a replica's
        circuit breaker open and quarantine it (kill + warm respawn,
        the replacement starting half-open).
    flap_backoff : RetryPolicy | None — the seeded backoff schedule
        consecutive breaker-triggered respawns walk (flap detection:
        a replacement that keeps tripping earns exponentially longer
        respawn delays instead of a hot quarantine loop).  Default: 6
        attempts, 50 ms base, seeded from the fleet seed.
    engine_kwargs — forwarded to every replica's ``ServeEngine``.
    """

    def __init__(self, registry_root: str, *,
                 n_replicas: int = 1,
                 warm_models: Sequence[Tuple] = (),
                 tenants: Optional[Dict[str, TenantPolicy]] = None,
                 default_max_queue_rows: Optional[int] = None,
                 canary: Optional[CanaryConfig] = None,
                 seed: Optional[int] = None,
                 auto_respawn: bool = True,
                 breaker_failure_threshold: int = 3,
                 flap_backoff: Optional[_retry.RetryPolicy] = None,
                 spawn_timeout_s: float = _SPAWN_TIMEOUT_S,
                 **engine_kwargs):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        self.registry_root = str(registry_root)
        self._warm_models = [tuple(w) for w in warm_models]
        self._engine_kwargs = dict(engine_kwargs)
        self._spawn_timeout_s = float(spawn_timeout_s)
        self.canary = canary
        self.auto_respawn = bool(auto_respawn)
        base = canary.seed if canary is not None and canary.seed is not None \
            else (chaos_seed() if seed is None else int(seed))
        self._canary_rng = np.random.default_rng([int(base), 2])
        self.assignments: List[bool] = []
        self.n_canary = 0
        self.n_stable = 0

        self.wfq = WeightedFairQueue(
            tenants, default_max_queue_rows=default_max_queue_rows
        )
        self._lock = threading.Lock()
        self._closed = False
        self._seq = 0
        self._next_index = 0
        self.replicas: List[ReplicaProc] = []
        self._outboxes: Dict[int, "queue.Queue[_Pending]"] = {}
        self._workers: Dict[int, threading.Thread] = {}
        self._in_flight: Dict[int, Optional[_Pending]] = {}
        self._sessions: Dict[str, int] = {}
        self._rr = 0
        self._accepted = 0
        self._resolved = 0
        self._resolved_cv = threading.Condition(self._lock)
        # the fleet reply ledger: submit_index -> (rid, crc32); read back
        # in submit order by ledger()
        self._ledger: Dict[int, Tuple[str, int]] = {}
        # the disposition ledger: submit_index -> (rid, disposition) for
        # EVERY admitted fate — ok / requeued-ok / shed-429 /
        # shed-deadline-* / cancelled / error-<code> — read back in
        # submit order by disposition_ledger()
        self._dispositions: Dict[int, Tuple[str, str]] = {}
        # accepted-but-unresolved bookkeeping, so a flush timeout can
        # name the rids it was still waiting on
        self._pending_rids: Dict[int, str] = {}
        self._rid_map: Dict[str, _Pending] = {}
        self.n_requeued = 0
        self.n_replica_losses = 0
        self.n_respawns = 0
        self.n_drains = 0
        self.n_deadline_shed = 0
        self.n_cancelled = 0
        self.n_breaker_opens = 0
        self.drain_exit_codes: List[Optional[int]] = []
        self.cold_start_ms: List[float] = []
        self._breaker_threshold = int(breaker_failure_threshold)
        self._flap_streak = 0  # consecutive breaker-triggered respawns
        self._flap_delays = _retry.backoff_schedule(
            flap_backoff if flap_backoff is not None
            else _retry.RetryPolicy(
                attempts=6, base_delay=0.05, multiplier=2.0,
                max_delay=2.0, jitter=0.5, seed=int(base),
            )
        )

        for _ in range(int(n_replicas)):
            self._spawn_one()
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="procfleet-dispatch", daemon=True
        )
        self._dispatcher.start()

    # ------------------------------------------------------------------ #
    # spawn / death / respawn
    # ------------------------------------------------------------------ #
    def _spawn_one(self, *, half_open: bool = False) -> ReplicaProc:
        t0 = time.perf_counter()
        index = self._next_index
        self._next_index += 1
        rep = ReplicaProc.spawn(
            index,
            registry_root=self.registry_root,
            warm_models=self._warm_models,
            engine_kwargs=self._engine_kwargs,
            spawn_timeout_s=self._spawn_timeout_s,
        )
        rep.breaker = ReplicaBreaker(
            failure_threshold=self._breaker_threshold, half_open=half_open,
        )
        cold_ms = (time.perf_counter() - t0) * 1e3
        self.cold_start_ms.append(cold_ms)
        with self._lock:
            self.replicas.append(rep)
            self._outboxes[index] = queue.Queue()
            self._in_flight[index] = None
            w = threading.Thread(
                target=self._worker_loop, args=(rep,),
                name=f"procfleet-replica{index}", daemon=True,
            )
            self._workers[index] = w
        if _tel.enabled:
            _tel.gauge("serve.procfleet.replicas", len(self.replicas))
            self._breaker_gauges()
        w.start()
        return rep

    def _breaker_gauges(self) -> None:
        """Per-state breaker gauges over live replicas (open breakers
        belong to quarantined — dead — replicas, so the open gauge spikes
        on the quarantine edge and settles once the replacement is up)."""
        counts = {"closed": 0, "half_open": 0, "open": 0}
        for r in self.replicas:
            key = r.breaker.state if not r.dead else (
                "open" if r.breaker.state == "open" else None
            )
            if key is not None:
                counts[key] = counts.get(key, 0) + 1
        for state, n in counts.items():
            _tel.gauge(f"serve.breaker.{state}", n)

    def _breaker_edge(self, rep: ReplicaProc, state: str,
                      reason: str) -> None:
        """One breaker transition: flight note + incident + gauges —
        every edge is observable."""
        if state == "open":
            self.n_breaker_opens += 1
        if _tel.enabled:
            self._breaker_gauges()
        if _flight.is_enabled():
            _flight.note(
                "serve.breaker", site=f"replica{rep.index}",
                state=state, reason=reason,
            )
        _incidents.record(
            kind=f"breaker-{state}",
            site=f"procfleet.replica{rep.index}",
            policy=f"breaker(threshold={rep.breaker.failure_threshold})",
            action="quarantined" if state == "open" else "recovered",
            detail=f"replica {rep.index} breaker -> {state}: {reason}",
        )

    def _record_failure(self, rep: ReplicaProc, reason: str) -> bool:
        """Breaker accounting for one replica-health failure; returns
        True when the breaker just opened (caller quarantines)."""
        opened = rep.breaker.record_failure()
        if opened:
            self._breaker_edge(rep, "open", reason)
        return opened

    def scale_to(self, n: int) -> None:
        """Grow the fleet to ``n`` live replicas (warm spawns).  Shrink
        is not implemented — the scaling bench only grows."""
        while len(self.alive()) < int(n):
            self._spawn_one()

    def alive(self) -> List[ReplicaProc]:
        with self._lock:
            return [r for r in self.replicas if not r.dead]

    def kill_replica(self, index: int) -> None:
        """Chaos injection: SIGKILL replica ``index``.  Detection,
        re-queue, and (optionally) respawn happen on the worker path."""
        with self._lock:
            rep = next(r for r in self.replicas if r.index == index)
        rep.kill()

    def drain_replica(self, index: int) -> ReplicaProc:
        """SIGTERM replica ``index``: it finishes in-flight work, sends
        its goodbye frame, and exits 0.  The worker path distinguishes
        the drain (goodbye + clean EOF — nothing re-queues) from a crash
        (mid-frame ``WireError`` — the un-acked set re-queues).  Returns
        the :class:`ReplicaProc` so callers can await its exit code."""
        with self._lock:
            rep = next(r for r in self.replicas if r.index == index)
        rep.terminate()
        return rep

    def _on_replica_death(self, rep: ReplicaProc, *,
                          quarantined: bool = False,
                          extra: Optional[_Pending] = None) -> None:
        """Worker-thread path: mark dead, re-queue exactly the un-acked
        set to survivors, rebind its sticky sessions, maybe respawn.
        ``quarantined`` marks a breaker-triggered death: the respawn
        walks the seeded flap-backoff schedule and the replacement
        starts half-open.  ``extra`` is a popped-but-unsent request the
        caller owns (stall injection) — part of the un-acked set."""
        with self._lock:
            if rep.dead:
                if extra is not None:
                    self._route(extra)
                return
            rep.dead = True
            self.n_replica_losses += 1
            unacked: List[_Pending] = []
            if extra is not None:
                unacked.append(extra)
            inflight = self._in_flight.pop(rep.index, None)
            if inflight is not None:
                unacked.append(inflight)
            outbox = self._outboxes.pop(rep.index, None)
            while outbox is not None and not outbox.empty():
                try:
                    unacked.append(outbox.get_nowait())
                except queue.Empty:
                    break
            for sess, idx in list(self._sessions.items()):
                if idx == rep.index:
                    del self._sessions[sess]  # rebind on next submit
            closed = self._closed
        try:
            rep.sock.close()
        except OSError:
            pass
        if _tel.enabled:
            _tel.inc("serve.procfleet.replica_losses")
        _incidents.record(
            kind="replica-loss", site="procfleet", policy="requeue",
            action="requeued",
            detail=f"replica {rep.index} (pid {rep.pid}) died"
            + (" (breaker quarantine)" if quarantined else "")
            + f"; {len(unacked)} un-acked request(s) re-queued to survivors",
        )
        self.n_requeued += len(unacked)
        for p in unacked:
            p.requeues += 1
        if not closed and self.auto_respawn:
            if quarantined:
                self._flap_backoff()
            try:
                self._spawn_one(half_open=quarantined)
                self.n_respawns += 1
            except (OSError, TimeoutError, ConnectionError) as e:
                _incidents.record(
                    kind="respawn-failed", site="procfleet", policy="requeue",
                    action="degraded", detail=str(e),
                )
        # re-dispatch AFTER the replacement is up, so a fleet reduced to
        # zero survivors still answers every accepted request
        for p in unacked:
            self._route(p)

    def _flap_backoff(self) -> None:
        """Flap detection: the first breaker quarantine respawns
        immediately; each consecutive one (no intervening recovery —
        the streak resets when a half-open replacement closes its
        breaker) sleeps the next step of the seeded backoff schedule,
        so a persistently sick fleet backs off instead of burning CPU
        in a spawn loop.  Sleeps via the retry engine's injectable
        sleep, so tests replay the schedule without the wall time."""
        self._flap_streak += 1
        k = self._flap_streak - 2
        if k < 0 or not self._flap_delays:
            return
        delay = self._flap_delays[min(k, len(self._flap_delays) - 1)]
        _incidents.record(
            kind="flap-backoff", site="procfleet",
            policy=f"flap(streak={self._flap_streak})",
            action="backed-off",
            detail=f"{self._flap_streak} consecutive breaker quarantines; "
            f"respawn delayed {delay:.4f}s",
        )
        if delay > 0:
            _retry._sleep(delay)

    def _check_drained(self, rep: ReplicaProc) -> bool:
        """An exited replica pid: was it a drain?  Drain means the
        goodbye frame (``bye`` with ``drain=True``) followed by clean
        EOF and exit code 0; anything else is a crash.  Consumes the
        goodbye from the socket when present."""
        if rep.proc.poll() != 0:
            return False
        try:
            with rep._lock:
                rep.sock.settimeout(2.0)
                try:
                    got = wire.recv_frame(rep.sock)
                finally:
                    try:
                        rep.sock.settimeout(None)
                    except OSError:
                        pass
        except (OSError, wire.WireError):
            return False
        if got is None or got[0].get("kind") != "bye" \
                or not got[0].get("drain"):
            return False
        self._on_replica_drain(rep)
        return True

    def _on_replica_drain(self, rep: ReplicaProc, *,
                          pending: Optional[_Pending] = None) -> None:
        """Worker-thread path for a graceful drain: the replica finished
        its in-flight work, said goodbye, and exited 0.  Nothing was
        lost mid-answer, so nothing counts as re-queued — requests still
        waiting in its outbox (plus ``pending``, a request whose predict
        frame the drained replica never read) are simply re-routed."""
        with self._lock:
            if rep.dead:
                if pending is not None:
                    self._route(pending)
                return
            rep.dead = True
            rep.drained = True
            self.n_drains += 1
            remnants: List[_Pending] = []
            if pending is not None:
                remnants.append(pending)
            inflight = self._in_flight.pop(rep.index, None)
            if inflight is not None:  # defensive: drain implies acked
                remnants.append(inflight)
            outbox = self._outboxes.pop(rep.index, None)
            while outbox is not None and not outbox.empty():
                try:
                    remnants.append(outbox.get_nowait())
                except queue.Empty:
                    break
            for sess, idx in list(self._sessions.items()):
                if idx == rep.index:
                    del self._sessions[sess]
            closed = self._closed
        try:
            rep.sock.close()
        except OSError:
            pass
        try:
            code: Optional[int] = rep.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:  # pragma: no cover - exited pid
            code = None
        self.drain_exit_codes.append(code)
        if _tel.enabled:
            _tel.inc("serve.procfleet.drains")
        if _flight.is_enabled():
            _flight.note(
                "serve.drain", site=f"replica{rep.index}",
                exit_code=code, rerouted=len(remnants),
            )
        _incidents.record(
            kind="replica-drain", site="procfleet", policy="drain",
            action="drained",
            detail=f"replica {rep.index} (pid {rep.pid}) drained cleanly "
            f"(exit {code}); {len(remnants)} queued request(s) re-routed, "
            f"0 re-queued",
        )
        if not closed and self.auto_respawn:
            try:
                self._spawn_one()
                self.n_respawns += 1
            except (OSError, TimeoutError, ConnectionError) as e:
                _incidents.record(
                    kind="respawn-failed", site="procfleet", policy="drain",
                    action="degraded", detail=str(e),
                )
        for p in remnants:
            self._route(p)

    # ------------------------------------------------------------------ #
    # canary + admission + dispatch
    # ------------------------------------------------------------------ #
    def _version_for(self, tenant: str, model: str,
                     version: Optional[int]) -> Optional[int]:
        """Identical math to ``FleetEngine._version_for`` — one seeded
        draw per eligible request, submit order (the golden-twin
        contract requires draw-for-draw agreement)."""
        c = self.canary
        if c is None or version is not None:
            return version
        if tenant != c.tenant or model != c.model:
            return version
        is_canary = bool(float(self._canary_rng.random()) < c.fraction)
        self.assignments.append(is_canary)
        if is_canary:
            self.n_canary += 1
            return c.canary_version
        self.n_stable += 1
        return c.stable_version

    def submit(self, tenant: str, model: str, payload, *,
               version: Optional[int] = None,
               request_id: Optional[str] = None,
               session: Optional[str] = None,
               deadline_ms: Optional[float] = None) -> Future:
        """Admit one request; returns a Future resolving to a dict reply
        (keys ``value``/``degraded``/``seq``/``latency_s``/``trace_id``/
        ``replica``/``flight_seq``).  Sheds synchronously with
        :class:`ServeOverloadError` when the tenant's WFQ backlog is
        full; canary version and trace id are fixed HERE, before the
        hop, so routing and re-routing cannot change them.

        ``deadline_ms`` is the request's END-TO-END budget from this
        admission: a request still queued past it sheds with a typed
        :class:`ServeDeadlineError` (time breakdown included) instead of
        burning a replica slot, and the worker skips dispatch when the
        remaining budget is below the target replica's observed p50.
        ``None`` (default) keeps the deadline machinery entirely off the
        hot path — one ``is None`` test per stage."""
        if self._closed:
            raise ServeClosedError("ProcFleet is closed")
        payload = np.asarray(payload)
        if payload.ndim != 2:
            raise ValueError(
                f"payload must be 2-D (rows, features), got {payload.ndim}-D"
            )
        if deadline_ms is not None and float(deadline_ms) < 0:
            raise ValueError(f"deadline_ms must be >= 0, got {deadline_ms}")
        version = self._version_for(tenant, model, version)
        with self._lock:
            self._seq += 1
            rid = request_id if request_id is not None else f"pf#{self._seq}"
            submit_index = self._seq
        p = _Pending(
            rid=rid, tenant=tenant, model=model, version=version,
            session=session, payload=payload, future=Future(),
            submit_index=submit_index,
            deadline_ms=None if deadline_ms is None else float(deadline_ms),
            t_submit=time.perf_counter() if deadline_ms is not None else 0.0,
        )
        # count the acceptance BEFORE the push: a racing worker may
        # resolve the request instantly, and flush() must never observe
        # resolved > accepted
        with self._lock:
            self._accepted += 1
            self._pending_rids[submit_index] = rid
            self._rid_map[rid] = p
        try:
            # WFQ admission: raises ServeOverloadError (the 429 surface)
            self.wfq.push(tenant, p, rows=int(payload.shape[0]))
        except BaseException as e:
            with self._lock:
                self._accepted -= 1
                self._pending_rids.pop(submit_index, None)
                self._rid_map.pop(rid, None)
                if isinstance(e, ServeOverloadError):
                    self._dispositions[submit_index] = (rid, "shed-429")
            raise
        if _tel.enabled:
            _tel.inc("serve.procfleet.requests")
        return p.future

    def cancel(self, rid: str) -> bool:
        """Best-effort cancel by trace id — the hedging client's loser
        kill.  Succeeds (True) only while the request is still pending
        (queued or un-sent): its future flips to cancelled and the
        dispatcher/worker skip it on sight.  Once a reply is in (or the
        send won the race) the cancel is a no-op (False) — a request is
        never un-answered."""
        with self._lock:
            p = self._rid_map.get(rid)
            if p is None or not p.future.cancel():
                return False
            self._dispositions[p.submit_index] = (p.rid, "cancelled")
            self._pending_rids.pop(p.submit_index, None)
            self._rid_map.pop(rid, None)
            self.n_cancelled += 1
            self._bump_resolved()
        if _tel.enabled:
            _tel.inc("serve.cancelled")
        return True

    def _shed_deadline(self, p: _Pending, *, stage: str,
                       elapsed_ms: float, queue_ms: float,
                       dispatch_ms: float = 0.0) -> None:
        """Resolve one expired request with the typed breakdown error —
        the request never reaches (or never re-reaches) a replica."""
        err = ServeDeadlineError(
            f"rid {p.rid}: deadline {p.deadline_ms:.1f}ms exceeded at "
            f"{stage} ({elapsed_ms:.1f}ms elapsed: queue {queue_ms:.1f}ms"
            f" + dispatch {dispatch_ms:.1f}ms); shed without dispatch",
            deadline_ms=p.deadline_ms, elapsed_ms=elapsed_ms, stage=stage,
            queue_ms=queue_ms, dispatch_ms=dispatch_ms, compute_ms=0.0,
        )
        with self._lock:
            if p.future.done():
                return
            self._dispositions[p.submit_index] = (
                p.rid, f"shed-deadline-{stage}"
            )
            self._pending_rids.pop(p.submit_index, None)
            self._rid_map.pop(p.rid, None)
            self.n_deadline_shed += 1
            self._bump_resolved()
        if _tel.enabled:
            _tel.inc("serve.deadline_exceeded")
        p.future.set_exception(err)

    def _pick_replica(self, p: _Pending) -> Optional[int]:
        """Sticky-session or round-robin over live replicas (holding the
        fleet lock)."""
        live = [r.index for r in self.replicas if not r.dead]
        if not live:
            return None
        if p.session is not None:
            idx = self._sessions.get(p.session)
            if idx is not None and idx in live:
                return idx
            idx = live[self._rr % len(live)]
            self._rr += 1
            self._sessions[p.session] = idx
            return idx
        idx = live[self._rr % len(live)]
        self._rr += 1
        return idx

    def _route(self, p: _Pending) -> None:
        """Place one admitted request on a live replica's outbox (or
        fail its future when the fleet is gone)."""
        with self._lock:
            idx = self._pick_replica(p)
            if idx is None:
                if not p.future.done():
                    p.future.set_exception(
                        ServeClosedError("no live replicas to serve request")
                    )
                    self._dispositions[p.submit_index] = (p.rid, "error-closed")
                    self._pending_rids.pop(p.submit_index, None)
                    self._rid_map.pop(p.rid, None)
                    self._bump_resolved()
                return
            self._outboxes[idx].put(p)

    def _dispatch_loop(self) -> None:
        while True:
            got = self.wfq.pop(timeout=0.25)
            if got is None:
                if self._closed and len(self.wfq) == 0:
                    return
                continue
            _tenant, p = got
            if p.future.done():  # cancelled while queued
                continue
            if p.deadline_ms is not None:
                # expired-in-queue: shed HERE, before any replica slot
                # is spent on a reply nobody is waiting for
                now = time.perf_counter()
                elapsed_ms = (now - p.t_submit) * 1e3
                if elapsed_ms >= p.deadline_ms:
                    self._shed_deadline(
                        p, stage="queue", elapsed_ms=elapsed_ms,
                        queue_ms=elapsed_ms,
                    )
                    continue
                p.t_dispatch = now
            self._route(p)

    # ------------------------------------------------------------------ #
    # per-replica worker: lockstep send ▸ recv ▸ resolve
    # ------------------------------------------------------------------ #
    def _bump_resolved(self) -> None:
        # caller holds self._lock
        self._resolved += 1
        self._resolved_cv.notify_all()

    def _worker_loop(self, rep: ReplicaProc) -> None:
        outbox = self._outboxes[rep.index]
        site = f"replica{rep.index}"
        while not rep.dead:
            try:
                p = outbox.get(timeout=0.25)
            except queue.Empty:
                if self._closed:
                    return
                # idle liveness probe: a dead pipe with nothing in flight
                # would otherwise go unnoticed until the next request
                if rep.proc.poll() is not None:
                    if self._check_drained(rep):
                        return  # goodbye + clean EOF + exit 0: a drain
                    self._record_failure(rep, "process exited")
                    self._on_replica_death(rep)
                    return
                continue
            if p.future.done():  # cancelled while in the outbox
                continue
            if p.deadline_ms is not None:
                # dispatch gate: when the remaining budget is below this
                # replica's observed p50, the reply would arrive dead —
                # shed now and keep the slot for a request that can win
                now = time.perf_counter()
                elapsed_ms = (now - p.t_submit) * 1e3
                queue_ms = (
                    (p.t_dispatch - p.t_submit) * 1e3
                    if p.t_dispatch else elapsed_ms
                )
                p50 = rep.breaker.p50_ms()
                remaining = p.deadline_ms - elapsed_ms
                if remaining <= 0.0 or (p50 is not None and remaining < p50):
                    self._shed_deadline(
                        p, stage="dispatch", elapsed_ms=elapsed_ms,
                        queue_ms=queue_ms,
                        dispatch_ms=max(0.0, elapsed_ms - queue_ms),
                    )
                    continue
            if _faults.any_active():
                delay = _faults.serve_delay(site)
                if delay > 0.0:
                    # the injected straggler: real wall latency, spent in
                    # the one thread that owns this replica
                    time.sleep(delay)
                if _faults.socket_stalled(site):
                    # half-open pipe: the next recv would never return.
                    # Fail over instead of hanging: breaker failure, kill
                    # the pid (its framing state is untrustworthy), and
                    # count p with the un-acked set.
                    opened = self._record_failure(rep, "stalled socket")
                    rep.kill()
                    self._on_replica_death(
                        rep, quarantined=opened, extra=p,
                    )
                    return
            with self._lock:
                if rep.index not in self._in_flight:
                    # replica was reaped between get() and here
                    self._route(p)
                    return
                self._in_flight[rep.index] = p
            t_send = time.perf_counter()
            try:
                # rep._lock keeps scrape calls (stats/metrics) from
                # interleaving their frames with this request/reply pair
                with rep._lock:
                    wire.send_frame(rep.sock, {
                        "kind": "predict", "rid": p.rid,
                        "tenant": p.tenant, "model": p.model,
                        "version": p.version,
                    }, {"x": p.payload})
                    got = wire.recv_frame(rep.sock)
                if got is None:
                    raise wire.WireError(f"replica {rep.index} hung up")
            except (OSError, wire.WireError) as e:
                opened = self._record_failure(rep, f"{type(e).__name__}: {e}")
                self._on_replica_death(rep, quarantined=opened)
                return
            msg, blobs = got
            with self._lock:
                if self._in_flight.get(rep.index) is p:
                    self._in_flight[rep.index] = None
            if msg.get("kind") == "bye":
                # the replica drained between our pop and send: the
                # predict frame we just wrote was never read.  Re-route
                # it — a drain re-queues nothing.
                self._on_replica_drain(rep, pending=p)
                return
            self._resolve(p, msg, blobs)
            if msg.get("kind") == "error" \
                    and int(msg.get("code", 0)) >= 500:
                # a 500 is replica sickness (a 429 is admission policy,
                # never a health signal)
                if self._record_failure(rep, f"error {msg.get('code')}"):
                    rep.kill()
                    self._on_replica_death(rep, quarantined=True)
                    return
            else:
                rtt_ms = (time.perf_counter() - t_send) * 1e3
                if rep.breaker.record_success(rtt_ms):
                    # a half-open replacement proved itself: recovery
                    # edge, and the flap streak is over
                    self._flap_streak = 0
                    self._breaker_edge(
                        rep, "closed", "half-open probe succeeded",
                    )

    def _resolve(self, p: _Pending, msg: dict, blobs: dict) -> None:
        if p.future.done():  # defensive: never double-answer
            return
        if msg.get("kind") == "reply":
            value = blobs["y"]
            with self._lock:
                self._ledger[p.submit_index] = (
                    p.rid, zlib.crc32(value.tobytes())
                )
                self._dispositions[p.submit_index] = (
                    p.rid, "requeued-ok" if p.requeues else "ok"
                )
                self._pending_rids.pop(p.submit_index, None)
                self._rid_map.pop(p.rid, None)
                self._bump_resolved()
            p.future.set_result({
                "value": value,
                "degraded": bool(msg.get("degraded", False)),
                "seq": int(msg.get("seq", 0)),
                "latency_s": float(msg.get("latency_s", 0.0)),
                "trace_id": msg.get("trace_id"),
                "replica": int(msg.get("replica", -1)),
                "flight_seq": int(msg.get("flight_seq", 0)),
            })
        else:
            err: Exception
            if msg.get("code") == 429:
                err = ServeOverloadError(
                    str(msg.get("error", "overloaded")),
                    retry_after_s=float(msg.get("retry_after_s", 0.0)),
                    queue_rows=int(msg.get("queue_rows", 0)),
                    max_queue_rows=int(msg.get("max_queue_rows", 0)),
                )
            else:
                err = RuntimeError(
                    f"replica error {msg.get('code')}: {msg.get('error')}"
                )
            with self._lock:
                self._dispositions[p.submit_index] = (
                    p.rid, f"error-{msg.get('code')}"
                )
                self._pending_rids.pop(p.submit_index, None)
                self._rid_map.pop(p.rid, None)
                self._bump_resolved()
            p.future.set_exception(err)

    # ------------------------------------------------------------------ #
    # observability / ledger
    # ------------------------------------------------------------------ #
    def flush(self, *, timeout_s: float = 300.0) -> int:
        """Block until every accepted request has resolved; returns how
        many resolved during the wait.  The wait is deadline-aware (one
        deadline computed up front, each wakeup waits only the
        remainder), and a timeout names *which* rids were still
        unresolved — the first diagnostic anyone needs when a flush
        hangs, instead of a bare count."""
        deadline = time.monotonic() + timeout_s
        with self._resolved_cv:
            start = self._resolved
            while self._resolved < self._accepted:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    n = self._accepted - self._resolved
                    stuck = [
                        rid for _, rid in sorted(self._pending_rids.items())
                    ]
                    shown = ", ".join(stuck[:8])
                    if len(stuck) > 8:
                        shown += f", … ({len(stuck) - 8} more)"
                    raise TimeoutError(
                        f"flush timed out after {timeout_s}s with {n} "
                        f"request(s) unresolved; unresolved rids: "
                        f"[{shown}]"
                    )
                self._resolved_cv.wait(timeout=min(remaining, 0.5))
            return self._resolved - start

    def ledger(self) -> Tuple[Tuple[str, int], ...]:
        """The fleet reply ledger: ``(rid, crc32(reply bytes))`` for
        every successfully answered request, in submit order — a pure
        function of the seeded request stream (module docs)."""
        with self._lock:
            return tuple(self._ledger[k] for k in sorted(self._ledger))

    def disposition_ledger(self) -> Tuple[Tuple[str, str, int], ...]:
        """The gray-failure ledger: ``(rid, disposition, crc32)`` for
        every admitted request in submit order, crc 0 when no reply
        bytes exist.  Dispositions: ``ok``, ``requeued-ok`` (answered
        after surviving a crash re-queue), ``shed-429``,
        ``shed-deadline-queue`` / ``shed-deadline-dispatch``,
        ``cancelled`` (hedge loser), ``error-<code>``.  Like
        :meth:`ledger` it is a pure function of the seeded request
        stream — the chaos lane replays it bit for bit."""
        with self._lock:
            out = []
            for k in sorted(self._dispositions):
                rid, disp = self._dispositions[k]
                crc = self._ledger.get(k, (rid, 0))[1]
                out.append((rid, disp, crc))
            return tuple(out)

    def checksum(self) -> int:
        """One crc32 over the ledger (order-sensitive) — the scalar the
        chaos lane compares across replays and against the single-process
        golden twin's per-reply checksums."""
        acc = 0
        for rid, crc in self.ledger():
            acc = zlib.crc32(f"{rid}:{crc:08x};".encode("ascii"), acc)
        return acc

    def replica_stats(self) -> List[dict]:
        """Per-replica ``stats`` frames (engine counters + telemetry
        counters + histogram states), live replicas only."""
        out = []
        for rep in self.alive():
            msg, _ = rep.call({"kind": "stats"})
            out.append(msg)
        return out

    def scrape_metrics(self) -> List[dict]:
        """Per-replica ``metrics`` frames for the fleet-level Prometheus
        aggregation (:class:`heat_tpu_torch.serve.ingress.FleetMetricsServer`)."""
        out = []
        for rep in self.alive():
            msg, _ = rep.call({"kind": "metrics"})
            out.append(msg)
        return out

    def latency_percentiles_ms(self) -> Tuple[float, float]:
        """Fleet (p50, p99) latency by merging each replica's
        ``serve.latency_ms`` histogram STATE — states merge
        byte-exactly; raw latency lists never cross the
        process boundary."""
        from .loadgen import merge_percentiles_ms

        states = [
            s["hists"]["serve.latency_ms"]
            for s in self.replica_stats()
            if "serve.latency_ms" in s.get("hists", {})
        ]
        return merge_percentiles_ms(states)

    def stats(self) -> Dict[str, float]:
        """Aggregate replica engine counters (the ``FleetEngine.stats``
        key contract) plus the fleet's own admission/chaos counters."""
        keys = (
            "requests", "batches", "rows", "padded_rows", "dispatches",
            "degraded", "payload_bytes", "reply_bytes", "shed",
        )
        agg = {k: 0 for k in keys}
        for s in self.replica_stats():
            for k in keys:
                agg[k] += s["stats"].get(k, 0)
        agg["dispatches_per_batch"] = (
            agg["dispatches"] / agg["batches"] if agg["batches"] else 0.0
        )
        agg["batch_occupancy"] = (
            agg["rows"] / agg["padded_rows"] if agg["padded_rows"] else 0.0
        )
        with self._lock:
            agg.update(
                replicas=len([r for r in self.replicas if not r.dead]),
                accepted=self._accepted,
                resolved=self._resolved,
                wfq_shed=self.wfq.n_shed,
                requeued=self.n_requeued,
                replica_losses=self.n_replica_losses,
                respawns=self.n_respawns,
                canary=self.n_canary,
                stable=self.n_stable,
                drains=self.n_drains,
                deadline_shed=self.n_deadline_shed,
                cancelled=self.n_cancelled,
                breaker_opens=self.n_breaker_opens,
            )
        return agg

    def close(self) -> None:
        """Drain-and-stop: wait for accepted work, stop the dispatcher,
        close every replica (graceful ``close`` frame, then reap)."""
        if self._closed:
            return
        try:
            self.flush(timeout_s=60.0)
        except TimeoutError:
            pass
        self._closed = True
        self.wfq.close()
        self._dispatcher.join(timeout=10)
        with self._lock:
            reps = list(self.replicas)
            workers = list(self._workers.values())
        for w in workers:
            w.join(timeout=10)
        for rep in reps:
            rep.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
