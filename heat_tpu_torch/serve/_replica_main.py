"""Replica process entrypoint: ``python -m heat_tpu_torch.serve._replica_main``.

Port of ``heat_tpu/serve/_replica_main.py``.  One replica = one OS
process hosting one warm-started
:class:`~heat_tpu_torch.serve.engine.ServeEngine`, speaking the
:mod:`heat_tpu_torch.net.wire` length-prefixed RPC back to the procfleet
parent over a single loopback TCP connection.  The parent listens; the
child connects (no port race: the parent owns the ephemeral port before
the child exists) and authenticates with the one-shot token from its
spawn config.

Boot sequence (the zero-compile contract):

1. take the parent's placement from the spawn config — its default
   device and its communicator's positions (``placement``, captured by
   ``procfleet._placement_snapshot``) — and its policy knobs, then
   build the engine over the registry.  The child sees the same
   positions as the parent, so the AOT bundles' topology and
   fingerprint match; a child told to run on a CUDA device that finds
   none fails its boot (exit 3), it never falls back to the CPU;
2. ``warm()`` every configured model from the ``.aotx`` registry
   sidecar (on the card each bundle's CUDA graph is captured here);
3. run one warmup predict per warm model and measure the
   ``fuse.cache.misses`` / ``compile.cache.misses`` deltas across it —
   a sidecar-warmed replica serves its first request with BOTH deltas
   zero, and the **hello frame ships the deltas**, so the parent
   asserts the contract across the process boundary instead of
   trusting it;
4. serve the RPC loop: strictly sequential recv → handle → reply, so
   within one replica the reply order is the request order (the parent
   keeps at most one request in flight per replica, which is what makes
   its un-acked set exact when this process is kill -9'd).

:func:`main` reads the spawn config and opens the registry root as a
:class:`~heat_tpu_torch.serve.registry.ModelRegistry`; :func:`serve` is
the rest (steps 1-4) and takes any object with the registry's
interface.

Frames the loop answers:

- ``predict`` (+ ``x`` blob) → ``reply`` (+ ``y`` blob) carrying the
  engine seq, the request's trace id, measured latency, and this
  replica's flight-recorder sequence (``flight_seq``) for cross-process
  postmortem stitching; a shed surfaces as ``error`` with ``code=429``
  and the deterministic ``retry_after_s`` hint (the wire form of
  :class:`~heat_tpu_torch.serve.errors.ServeOverloadError`), any other
  failure as ``code=500``;
- ``stats`` → engine counters + telemetry counters + histogram states
  (the mergeable ``Histogram.state()`` form — raw latency lists never
  cross the wire);
- ``metrics`` → the full telemetry snapshot for the fleet-level
  Prometheus aggregation;
- ``close`` → drain, ``bye``, exit 0.  EOF on the socket (parent died)
  also exits: a replica never outlives its fleet.

**Graceful drain**: SIGTERM means "finish what you hold, then leave".
The handler does two things and returns: sets the draining flag and
half-closes the socket's read side (``shutdown(SHUT_RD)``).  Per PEP 475
the blocking ``recv`` the loop sits in retries after the signal and then
sees EOF, so the loop falls out of its recv *at a frame boundary* — any
request already received is answered first, because the loop is
strictly sequential.  The drain branch then closes the engine with
``drain=True``, sends a goodbye frame with ``drain: True``, and exits 0.
The parent distinguishes this (goodbye + clean EOF + exit 0 ⇒ zero
re-queues) from a crash (mid-frame ``WireError`` / nonzero exit ⇒
exactly the un-acked set re-queues).
"""

from __future__ import annotations

import json
import os
import signal
import socket
import sys


def _fail(msg: str) -> "NoReturn":  # noqa: F821 - py38-safe annotation
    print(f"replica boot failed: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(3)


def _apply_policy(policy: dict) -> None:
    """Re-apply the parent's process-wide policy knobs (spawn config
    ``policy``, captured by ``procfleet._policy_snapshot``) BEFORE the
    engine exists: ``aot.fingerprint()`` embeds the policy key context,
    so matching the exporter's policy state is what lets ``warm()``
    install the sidecar bundles instead of soundly refusing them."""
    if not policy:
        return
    from ..comm.compressed import (
        set_collective_precision,
        set_collective_threshold,
    )
    from ..comm.overlap import set_overlap
    from ..comm.redistribute import (
        set_redistribution,
        set_redistribution_threshold,
    )
    from ..io.stream import set_prefetch
    from ..resilience.guards import set_guard_policy

    set_overlap(str(policy["overlap"]))
    set_collective_precision(str(policy["collective_precision"]))
    set_collective_threshold(int(policy["collective_threshold"]))
    set_redistribution(str(policy["redistribution"]))
    set_redistribution_threshold(int(policy["redistribution_threshold"]))
    set_guard_policy(str(policy["guard_policy"]),
                     float(policy["guard_overflow_limit"]))
    set_prefetch(str(policy["prefetch"]))


def _apply_placement(placement: dict) -> None:
    """Put this process where the parent is (spawn config ``placement``,
    captured by ``procfleet._placement_snapshot``): the parent's default
    device and a communicator over the parent's positions, set BEFORE the
    registry loads an estimator (its arrays land on the default
    communicator) and before ``warm()`` installs bundles (they are bound
    to the positions' count and mesh).  Positions on a CUDA device that
    this process cannot see fail the boot."""
    import torch

    from ..core import communication, devices

    positions = [str(p) for p in placement["positions"]]
    if any(p.startswith("cuda") for p in positions) and not torch.cuda.is_available():
        _fail(
            f"the parent runs on {positions[0]} but this process sees no "
            "CUDA device (it does not fall back to the CPU)"
        )
    device = placement.get("device")
    devices.use_device(None if device is None else str(device))
    communication.use_comm(communication.TorchCommunication(
        positions, mesh_shape=[int(s) for s in placement["mesh_shape"]],
    ))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        _fail("usage: python -m heat_tpu_torch.serve._replica_main '<json config>'")
    cfg = json.loads(argv[0])
    from .registry import ModelRegistry

    return serve(cfg, ModelRegistry(str(cfg["registry_root"])))


def serve(cfg: dict, registry) -> int:
    """Boot steps 1-4 (module docs) over ``registry``, then serve the
    parent until it closes, drains or goes away; returns the exit code."""
    port = int(cfg["port"])
    token = str(cfg["token"])
    replica = int(cfg.get("replica", 0))
    warm_models = [
        (str(w[0]), str(w[1]), None if len(w) < 3 or w[2] is None else int(w[2]))
        for w in cfg.get("warm_models", ())
    ]

    import numpy as np

    from .. import telemetry
    from ..net import wire
    from ..telemetry import flight as _flight
    from .engine import ServeEngine
    from .errors import ServeOverloadError

    _apply_policy(cfg.get("policy"))
    _apply_placement(cfg["placement"])
    telemetry.enable()
    engine = ServeEngine(registry, **cfg.get("engine_kwargs", {}))

    installed = 0
    for tenant, model, version in warm_models:
        installed += engine.warm(tenant, model, version=version)

    # warmup predicts under the compile-miss microscope (boot step 3)
    before = dict(telemetry.snapshot()["counters"])
    warmups = 0
    for tenant, model, version in warm_models:
        lane = engine._lane(tenant, model, version)
        if lane.n_features is None:
            continue
        dt = np.dtype(lane.dtype if lane.dtype is not None else "float32")
        engine.predict(
            tenant, model,
            np.zeros((engine.min_bucket, lane.n_features), dtype=dt),
            version=version,
        )
        warmups += 1
    after = dict(telemetry.snapshot()["counters"])

    def _delta(name: str) -> int:
        return int(after.get(name, 0)) - int(before.get(name, 0))

    hello = {
        "kind": "hello",
        "token": token,
        "replica": replica,
        "pid": os.getpid(),
        "installed": installed,
        "warmups": warmups,
        "fuse_misses": _delta("fuse.cache.misses"),
        "compile_misses": _delta("compile.cache.misses"),
    }

    sock = socket.create_connection(("127.0.0.1", port), timeout=30)
    sock.settimeout(None)

    draining = {"flag": False}

    def _on_sigterm(signum, frame):  # noqa: ARG001 - signal API
        # Flag + half-close the read side.  The blocked recv retries
        # after the signal (PEP 475) and then reads EOF, so the serve
        # loop exits at the next frame *boundary* — in-flight work is
        # answered before the goodbye.  Everything here is
        # async-signal-safe enough for CPython: two attribute writes
        # and a shutdown(2) syscall.
        draining["flag"] = True
        try:
            sock.shutdown(socket.SHUT_RD)
        except OSError:
            pass

    signal.signal(signal.SIGTERM, _on_sigterm)

    try:
        wire.send_frame(sock, hello)
        n_replies = 0
        while True:
            try:
                got = wire.recv_frame(sock)
            except wire.WireError:
                # SHUT_RD can land mid-frame when the loop was already
                # reading; while draining that is the expected EOF, not
                # corruption
                if draining["flag"]:
                    got = None
                else:
                    raise
            if got is None:
                if draining["flag"]:
                    # graceful drain: everything received was answered
                    # (the loop is sequential), so say goodbye and
                    # leave cleanly
                    engine.close(drain=True)
                    wire.send_frame(sock, {
                        "kind": "bye", "replica": replica, "drain": True,
                    })
                break  # parent is gone; do not outlive the fleet
            msg, blobs = got
            kind = msg.get("kind")
            if kind == "predict":
                rid = msg.get("rid")
                try:
                    reply = engine.predict(
                        msg["tenant"], msg["model"], blobs["x"],
                        version=msg.get("version"), request_id=rid,
                    )
                    n_replies += 1
                    if _flight.is_enabled():
                        _flight.note(
                            "serve.rpc", site=f"replica{replica}",
                            rid=str(rid), seq=n_replies,
                        )
                    wire.send_frame(sock, {
                        "kind": "reply",
                        "rid": rid,
                        "replica": replica,
                        "seq": int(reply.seq),
                        "degraded": bool(reply.degraded),
                        "latency_s": float(reply.latency_s),
                        "trace_id": reply.trace_id,
                        "flight_seq": n_replies,
                    }, {"y": np.asarray(reply.value)})
                except ServeOverloadError as e:
                    wire.send_frame(sock, {
                        "kind": "error", "code": 429, "rid": rid,
                        "replica": replica, "error": str(e),
                        "retry_after_s": e.retry_after_s,
                        "queue_rows": e.queue_rows,
                        "max_queue_rows": e.max_queue_rows,
                    })
                except Exception as e:  # the loop must answer every frame
                    wire.send_frame(sock, {
                        "kind": "error", "code": 500, "rid": rid,
                        "replica": replica,
                        "error": f"{type(e).__name__}: {e}",
                    })
            elif kind == "stats":
                snap = telemetry.snapshot()
                wire.send_frame(sock, {
                    "kind": "stats",
                    "replica": replica,
                    "pid": os.getpid(),
                    "stats": engine.stats(),
                    "counters": snap["counters"],
                    "hists": snap["hists"],
                })
            elif kind == "metrics":
                snap = telemetry.snapshot()
                wire.send_frame(sock, {
                    "kind": "metrics",
                    "replica": replica,
                    "counters": snap["counters"],
                    "gauges": snap["gauges"],
                    "hists": snap["hists"],
                    "dispatches": telemetry.dispatch_count(),
                })
            elif kind == "close":
                engine.close(drain=True)
                wire.send_frame(sock, {"kind": "bye", "replica": replica})
                break
            else:
                wire.send_frame(sock, {
                    "kind": "error", "code": 400, "replica": replica,
                    "error": f"unknown frame kind {kind!r}",
                })
    finally:
        sock.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
