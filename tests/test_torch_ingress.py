"""``heat_tpu_torch.serve``'s ingress (``Ingress``, ``IngressClient``,
``HedgePolicy``) and aggregated fleet metrics (``fleet_prometheus_text``,
``FleetMetricsServer``) held against ``heat_tpu.serve``'s, over stub
backends (no replica processes, no JAX process).

Every case runs the same script in the four pairings of a client and a
door: port-port, reference-reference, and across the packages (the
port's ``IngressClient`` against the reference's ``Ingress``, the
reference's ``IngressClient`` against the port's ``Ingress``).  The
backend stub belongs to the door's package (its typed errors and fault
seams).  Replies, error codes, typed error fields, the raw reply frames'
bytes, the CRC trailer's detection, the hedge decisions under a pinned
``slow_replica`` plan, the retry budget and the seeded 429 retry sleeps
must equal the reference-reference run exactly.
"""

import http.client
import socket
import threading
import types
from concurrent.futures import Future

import numpy as np
import pytest

from heat_tpu.net import wire as rwire
from heat_tpu.resilience import faults as rfaults
from heat_tpu.resilience import retry as rretry
from heat_tpu.serve import errors as rerrors
from heat_tpu.serve import ingress as ringress
from test_torch_reference_state import reference_state  # noqa: F401  (restores the JAX package's state)

from heat_tpu_torch.net import wire
from heat_tpu_torch.resilience import faults
from heat_tpu_torch.resilience import retry
from heat_tpu_torch.serve import (
    FleetMetricsServer,
    HedgePolicy,
    Ingress,
    IngressBootError,
    IngressClient,
    errors,
    ingress,
)

PKGS = {
    "port": types.SimpleNamespace(
        Ingress=Ingress, IngressClient=IngressClient, HedgePolicy=HedgePolicy, errors=errors,
        faults=faults, retry=retry, wire=wire, ingress=ingress,
        FleetMetricsServer=FleetMetricsServer),
    "ref": types.SimpleNamespace(
        Ingress=ringress.Ingress, IngressClient=ringress.IngressClient,
        HedgePolicy=ringress.HedgePolicy, errors=rerrors, faults=rfaults, retry=rretry,
        wire=rwire, ingress=ringress, FleetMetricsServer=ringress.FleetMetricsServer),
}
PAIRS = [("port", "port"), ("port", "ref"), ("ref", "port")]


@pytest.fixture(autouse=True)
def _clean():
    def scrub():
        for pkg in PKGS.values():
            pkg.faults.clear()
            pkg.retry.set_sleep(None)

    scrub()
    yield
    scrub()


def payload(rows, seed=0, cols=5):
    return np.random.default_rng(seed).normal(size=(rows, cols)).astype(np.float32)


class Stub:
    """The fleet ``submit()`` contract (the reference's
    ``tests/test_procfleet.py`` stub) with the serving plane's failure
    modes: tenant ``hot`` sheds (429), ``flaky`` sheds its first two
    attempts, a deadline under 1 ms sheds (504), ``gone`` is closed (503),
    ``bad`` fails (500).  A primary request (a rid without ``~h``) passes
    the package's ``slow_replica`` seam at site ``replica0`` and is
    answered after its delay; a hedge leg answers at once as replica 1."""

    def __init__(self, pkg):
        self.pkg = pkg
        self.flaky = 0
        self.pending = {}
        self.timers = []
        self.cancelled = []

    def submit(self, tenant, model, payload, *, version=None, request_id=None,
               session=None, deadline_ms=None):
        e = self.pkg.errors
        if tenant == "hot":
            raise e.ServeOverloadError("stub backlog full", retry_after_s=0.125,
                                       queue_rows=6, max_queue_rows=8)
        if tenant == "flaky" and self.flaky < 2:
            self.flaky += 1
            raise e.ServeOverloadError("stub flaky", retry_after_s=0.01, queue_rows=1,
                                       max_queue_rows=2)
        if deadline_ms is not None and deadline_ms < 1.0:
            raise e.ServeDeadlineError(
                f"rid {request_id}: deadline {deadline_ms:.1f}ms exceeded at queue",
                deadline_ms=deadline_ms, elapsed_ms=2.5, stage="queue", queue_ms=2.5)
        if tenant == "gone":
            raise e.ServeClosedError("no live replicas to serve request")
        if tenant == "bad":
            raise ValueError(f"payload must be 2-D, model {model!r}")
        hedge = str(request_id).endswith("~h")
        delay = 0.0 if hedge else self.pkg.faults.serve_delay("replica0")
        x = np.asarray(payload)
        reply = {"value": x.sum(axis=1), "degraded": False, "seq": int(x.shape[0]),
                 "latency_s": 0.001, "trace_id": request_id, "replica": int(hedge),
                 "flight_seq": 3 if version is None else int(version)}
        fut = Future()
        self.pending[request_id] = fut

        def resolve():
            if fut.set_running_or_notify_cancel():
                fut.set_result(reply)

        if delay:
            t = threading.Timer(delay, resolve)
            self.timers.append(t)
            t.start()
        else:
            resolve()
        return fut

    def cancel(self, rid):
        fut = self.pending.get(rid)
        ok = fut is not None and fut.cancel()
        if ok:
            self.cancelled.append(rid)
        return ok

    def stats(self):
        return {"accepted": 3, "resolved": 2, "replicas": 1, "ratio": 0.5}

    def close(self):
        for t in self.timers:
            t.cancel()  # a straggle whose request was hedged away is never answered
            t.join(timeout=30)


def _outcome(fn):
    """A call's reply, or its typed error's class name and fields."""
    try:
        r = fn()
    except Exception as e:  # noqa: BLE001 - the error is the outcome
        fields = {k: v for k, v in vars(e).items() if not k.startswith("_")}
        return ("raise", type(e).__name__, str(e), fields)
    if isinstance(r, dict) and "value" in r:
        v = np.asarray(r["value"])
        r = dict(r, value=(v.dtype.str, v.shape, v.tobytes()))
    return ("ok", r)


def _raw(pkg, sock, msg, blobs=None):
    """Send one frame with ``pkg``'s codec; return the reply frame's raw
    bytes (length prefix through CRC trailer)."""
    pkg.wire.send_frame(sock, msg, blobs)
    head = b""
    while len(head) < 4:
        head += sock.recv(4 - len(head))
    (total,) = pkg.wire._U32.unpack(head)
    body = b""
    while len(body) < total:
        body += sock.recv(total - len(body))
    return head + body


def _script(client, door):
    """Every request kind through one door (the table the four pairings
    must agree on)."""
    c, d = PKGS[client], PKGS[door]
    stub = Stub(d)
    out = []
    with d.Ingress(stub) as ing, c.IngressClient("127.0.0.1", ing.port) as cli:
        out.append(_outcome(lambda: cli.predict("acme", "km", payload(2), request_id="rid-1",
                                                session="s0")))
        out.append(_outcome(lambda: cli.predict("acme", "km", np.ones((3, 4)), version=3)))
        out.append(_outcome(lambda: cli.predict("acme", "km", payload(1, 2), deadline_ms=100.0)))
        out.append(_outcome(lambda: cli.predict("hot", "km", payload(2))))
        out.append(_outcome(lambda: cli.predict("acme", "km", payload(2), request_id="late",
                                                deadline_ms=0.5)))
        out.append(_outcome(lambda: cli.predict("gone", "km", payload(2))))
        out.append(_outcome(lambda: cli.predict("bad", "km", payload(2))))
        out.append(_outcome(cli.stats))
        out.append(_outcome(lambda: cli._call({"kind": "cancel", "rid": "nope"})[0]))
        out.append(_outcome(lambda: cli._call({"kind": "nope", "rid": "r9"})[0]))
        out.append(cli.hedge_stats())
        with socket.create_connection(("127.0.0.1", ing.port), timeout=30) as s:
            out.append(_raw(c, s, {"kind": "predict", "tenant": "acme", "model": "km",
                                   "version": None, "rid": "raw", "session": None},
                            {"x": payload(4, 9)}))
            out.append(_raw(c, s, {"kind": "predict", "tenant": "hot", "model": "km",
                                   "version": None, "rid": "raw2", "session": None},
                            {"x": payload(1)}))
    stub.close()
    return out


@pytest.fixture(scope="module")
def reference_script():
    return _script("ref", "ref")


@pytest.mark.parametrize("client,door", PAIRS)
def test_replies_and_errors_equal_the_reference_pair(client, door, reference_script):
    got = _script(client, door)
    assert len(got) == len(reference_script)
    for i, (a, b) in enumerate(zip(got, reference_script)):
        assert a == b, i
    assert [o[0] for o in got[:10]] == ["ok"] * 3 + ["raise"] * 4 + ["ok"] * 2 + ["raise"]
    assert [o[1] for o in got[3:7]] == ["ServeOverloadError", "ServeDeadlineError",
                                        "RuntimeError", "RuntimeError"]
    assert got[3][3]["retry_after_s"] == 0.125 and got[4][3]["stage"] == "queue"
    assert "ingress error 503" in got[5][2] and "ingress error 500: ValueError" in got[6][2]
    assert got[8][1] == {"kind": "cancel_ack", "rid": "nope", "cancelled": False}
    assert got[9][2] == "ingress error 400: unknown frame kind 'nope'"


@pytest.mark.parametrize("door", ["port", "ref"])
def test_corrupt_request_frame_closes_the_connection(door):
    """The door checks each request's CRC trailer: a flipped byte (the
    seeded ``corrupt_frame`` plan at the door's receive seam) ends the
    connection, and the client sees the hang-up."""
    d = PKGS[door]
    stub = Stub(d)
    outs = []
    for client in ("port", "ref"):
        c = PKGS[client]
        with d.Ingress(stub) as ing, c.IngressClient("127.0.0.1", ing.port) as cli:
            with d.faults.inject("corrupt_frame", site="wire.read", nth=1, seed=3):
                outs.append(_outcome(lambda: cli.predict("acme", "km", payload(2))))
    assert outs[0] == outs[1] == ("raise", "WireError", "ingress hung up", {})


def _corrupt_reply(client, door):
    c, d = PKGS[client], PKGS[door]
    stub = Stub(d)
    with d.Ingress(stub) as ing, c.IngressClient("127.0.0.1", ing.port) as cli:
        with c.faults.inject("corrupt_frame", site="wire.recv", nth=1, seed=5):
            return _outcome(lambda: cli.predict("acme", "km", payload(2), request_id="c"))


@pytest.mark.parametrize("client,door", PAIRS)
def test_corrupt_reply_frame_is_detected_by_the_client(client, door):
    """The client checks each reply's CRC trailer: the seeded flip at its
    receive seam raises the codec's own error, as in the reference pair."""
    got = _corrupt_reply(client, door)
    assert got == _corrupt_reply("ref", "ref")
    assert got[:2] == ("raise", "WireError") and got[2].startswith("corrupt-frame: crc32 mismatch")


#: the hedge delay's floor: far above a loopback round trip on a loaded
#: machine, far below the pinned straggles
HEDGE_FLOOR_S = 0.5


def _hedged(client, door, *, seed, nth, delay, budget, refill=0.1):
    c, d = PKGS[client], PKGS[door]
    stub = Stub(d)
    policy = c.HedgePolicy(hedge_after_quantile=0.9, min_hedge_delay_s=HEDGE_FLOOR_S,
                           budget_tokens=budget, budget_refill=refill, seed=seed)
    rec = []
    with d.Ingress(stub) as ing, c.IngressClient("127.0.0.1", ing.port, hedge=policy) as cli:
        for i in range(2):  # the client's executor threads start here
            cli.predict("acme", "km", payload(1), request_id=f"w-{i}")
        with d.faults.inject("slow_replica", site="replica0", nth=nth, delay=delay, seed=seed):
            for i in range(10):
                r = cli.predict("acme", "km", payload(2, seed=i), request_id=f"h-{i}")
                st = cli.hedge_stats()
                rec.append((r["rid"], r["trace_id"], r["replica"], r["value"].tobytes(),
                            st["hedges"], st["hedge_wins"], st["budget_exhausted"]))
        stats = cli.hedge_stats()
    stub.close()
    return rec, stats, stub.cancelled


@pytest.mark.parametrize("client,door", PAIRS)
def test_hedge_decisions_equal_the_reference_pair(client, door):
    """Straggles pinned to the 3rd and 7th primaries: each is hedged onto
    the second connection, the hedge wins, the primary is cancelled over
    the wire; the same decisions as the reference pair."""
    kw = dict(seed=11, nth=(3, 7), delay=30.0, budget=8.0)
    got, ref = _hedged(client, door, **kw), _hedged("ref", "ref", **kw)
    assert got == ref
    rec, stats, cancelled = got
    assert [r[0] for r in rec if r[2] == 1] == ["h-2~h", "h-6~h"]
    assert (stats["hedges"], stats["hedge_wins"], stats["budget_exhausted"]) == (2, 2, 0)
    assert cancelled == ["h-2", "h-6"]


def test_hedge_budget_runs_dry_as_the_references():
    """One token and no refill: the first straggle is hedged, the next two
    wait on their primaries and count as budget exhaustion.  All three
    fall among the client's first 8 samples, where the hedge delay is the
    floor."""
    client, door = "port", "port"
    kw = dict(seed=4, nth=(1, 3, 5), delay=HEDGE_FLOOR_S + 0.4, budget=1.0, refill=0.0)
    got, ref = _hedged(client, door, **kw), _hedged("ref", "ref", **kw)
    assert got == ref
    stats = got[1]
    assert (stats["hedges"], stats["hedge_wins"], stats["budget_exhausted"]) == (1, 1, 2)
    assert stats["budget_tokens"] == 0.0


@pytest.mark.parametrize("client,door", PAIRS + [("ref", "ref")])
def test_overload_retries_sleep_the_seeded_schedule(client, door):
    """A 429 is retried after the server's Retry-After plus the client's
    seeded jitter: the same sleeps, counters and reply in every pairing."""
    c, d = PKGS[client], PKGS[door]
    sleeps = []
    c.retry.set_sleep(sleeps.append)
    stub = Stub(d)
    policy = c.HedgePolicy(retry_attempts=2, min_hedge_delay_s=HEDGE_FLOOR_S, seed=9)
    with d.Ingress(stub) as ing, c.IngressClient("127.0.0.1", ing.port, hedge=policy) as cli:
        got = _outcome(lambda: cli.predict("flaky", "km", payload(3), request_id="f"))
        stats = cli.hedge_stats()
    stub.close()
    want = [0.01 + j for j in rretry.backoff_schedule(rretry.RetryPolicy(
        attempts=3, base_delay=1e-3, multiplier=2.0, max_delay=0.05, jitter=0.5, seed=9))[:2]]
    assert sleeps == want
    assert got[0] == "ok" and got[1]["rid"] == "f"
    assert (stats["retries"], stats["hedges"]) == (2, 0)
    assert stats["budget_tokens"] == 8.0 - 2 + 0.1  # two retries spent, one success refilled


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_door_refuses_non_loopback_and_reports_a_failed_bind(pkg):
    p = PKGS[pkg]
    with pytest.raises(ValueError, match="Ingress binds loopback only"):
        p.Ingress(Stub(p), host="0.0.0.0")
    with socket.socket() as busy:
        busy.bind(("127.0.0.1", 0))
        busy.listen(1)
        port = busy.getsockname()[1]
        with pytest.raises(p.errors.IngressBootError,
                           match=f"ingress failed to listen on 127.0.0.1:{port}: OSError"):
            p.Ingress(Stub(p), port=port)


def test_hedge_policy_defaults_equal_the_references():
    assert vars(HedgePolicy()) == vars(ringress.HedgePolicy())
    assert issubclass(IngressBootError, RuntimeError)


# --------------------------------------------------------------------- #
# aggregated fleet metrics                                                #
# --------------------------------------------------------------------- #
class FakeFleet:
    """``scrape_metrics()`` and ``stats()``, as a ProcFleet gives them."""

    def __init__(self, scrapes, stats, fail=False):
        self.scrapes, self._stats, self.fail = scrapes, stats, fail

    def scrape_metrics(self):
        if self.fail:
            raise RuntimeError("replica 1 hung up")
        return self.scrapes

    def stats(self):
        return self._stats


def _fake(seed):
    rng = np.random.default_rng(seed)
    names = ["serve.requests", "serve.rows", "fuse.cache.hits", "weird-name/x", "9lead"]
    gnames = ["serve.queue_depth", "serve.breaker.open", "serve.batch_occupancy"]
    scrapes = []
    for rep in rng.permutation(4)[: int(rng.integers(1, 5))]:
        scrapes.append({
            "replica": int(rep),
            "counters": {n: int(rng.integers(0, 1000)) for n in names if rng.random() < 0.7},
            "gauges": {n: rng.choice([float(rng.random()), 0, float("nan"), float("inf"),
                                      True]) for n in gnames if rng.random() < 0.7},
        })
    keys = ("replicas", "accepted", "resolved", "wfq_shed", "requeued", "replica_losses",
            "respawns", "drains", "deadline_shed", "cancelled", "breaker_opens")
    stats = {k: int(rng.integers(0, 50)) for k in keys if k == "replicas" or rng.random() < 0.8}
    return FakeFleet(scrapes, stats)


@pytest.mark.parametrize("seed", range(8))
def test_fleet_prometheus_text_equals_the_references(seed):
    fleet = _fake(seed)
    text = ingress.fleet_prometheus_text(fleet)
    assert text == ringress.fleet_prometheus_text(fleet)
    assert text.endswith("\n") and "\n\n" not in text
    assert f"heat_fleet_replicas {fleet.stats()['replicas']}\n" in text


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_fleet_metrics_server_serves_the_text(pkg):
    p = PKGS[pkg]
    fleet = _fake(3)
    with p.FleetMetricsServer(fleet) as srv:
        status, ctype, body = _get(srv.port, "/metrics")
        assert (status, ctype) == (200, "text/plain; version=0.0.4; charset=utf-8")
        assert body.decode() == ringress.fleet_prometheus_text(fleet)
        assert _get(srv.port, "/healthz")[::2] == (200, b"ok\n")
        assert _get(srv.port, "/nope")[0] == 404
        fleet.fail = True
        assert _get(srv.port, "/metrics")[::2] == (
            503, b"scrape failed: RuntimeError: replica 1 hung up\n")


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()
