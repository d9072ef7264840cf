"""``heat_tpu_torch.serve.ProcFleet``: real port replica processes on the
CPU, one or two at a time (eight spawns in the file), held against the
reference's in-process ``FleetEngine`` on the same seeded streams.

* Every hello (first spawns, respawns after kill -9 and after a drain)
  reports ``fuse_misses == compile_misses == 0`` and installs every
  bundle of the port's sidecar: the child runs on the parent's eight CPU
  positions, where the bundles were exported.
* The reply ledger ``(rid, crc32(value))`` of a seeded
  ``loadgen.schedule`` stream (32 requests of 1-32 rows, the shape of the
  reference benchmark's ``procfleet_rates``) equals the CRCs of the
  reference ``FleetEngine``'s replies, in submit order; trace ids survive
  the hop, sessions are sticky, the aggregated ``/metrics`` reconciles
  with the ledger.
* kill -9 of a replica while its worker holds one request (a pinned
  ``slow_replica`` straggle) re-queues exactly its un-acked set to the
  warm replacement, the ledger still equals the reference twin's, its
  sessions rebind.
* WFQ admission sheds only the hot tenant; the canary over the ingress
  draws what the reference's ``FleetEngine`` draws; a drain (SIGTERM)
  exits 0 with zero re-queues.
* A child given the parent's policy context installs every bundle; a
  child placed on a CUDA device where there is none fails its boot, and
  the spawn says so at once.

A module-scoped fixture checks that no replica process outlives the file.
"""

import os
import time
import urllib.request
import zlib

import numpy as np
import pytest

from heat_tpu import telemetry as rtelemetry
from heat_tpu.resilience import faults as rfaults
from heat_tpu.resilience import incidents as rincidents
from heat_tpu.resilience import retry as rretry
from heat_tpu.serve import (
    CanaryConfig as RCanaryConfig,
    FleetEngine as RFleetEngine,
    ModelRegistry as RRegistry,
)
from test_torch_reference_state import reference_state  # noqa: F401  (restores the JAX package's state)
from test_torch_serve import P, Xn, payload

import heat_tpu as ht
import heat_tpu_torch as htt
from heat_tpu_torch import telemetry
from heat_tpu_torch.comm import compressed as tcq
from heat_tpu_torch.core import communication as tcomm
from heat_tpu_torch.core import devices as tdevices
from heat_tpu_torch.resilience import faults, incidents
from heat_tpu_torch.serve import (
    CanaryConfig,
    FleetMetricsServer,
    Ingress,
    IngressClient,
    ModelRegistry,
    ProcFleet,
    ReplicaProc,
    ServeEngine,
    loadgen,
)
from heat_tpu_torch.serve import _replica_main, procfleet

KW = dict(max_batch_rows=64, min_bucket=8)


def _live_replicas():
    """Replica processes this process started that are still running
    (zombies excluded)."""
    me, out = str(os.getpid()), []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as fh:
                fields = fh.read().rsplit(")", 1)[1].split()
            with open(f"/proc/{pid}/cmdline", "rb") as fh:
                cmd = fh.read()
        except OSError:
            continue
        if fields[1] == me and fields[0] != "Z" and b"heat_tpu_torch.serve._replica_main" in cmd:
            out.append(int(pid))
    return out


@pytest.fixture(scope="module", autouse=True)
def no_replica_outlives_the_file():
    assert _live_replicas() == []
    yield
    deadline = time.monotonic() + 30
    while _live_replicas() and time.monotonic() < deadline:
        time.sleep(0.1)
    assert _live_replicas() == []


@pytest.fixture(autouse=True)
def _clean():
    def scrub():
        for f, inc, tel in ((faults, incidents, telemetry), (rfaults, rincidents, rtelemetry)):
            f.clear()
            inc.clear_incident_log()
            tel.disable()
            tel.reset()

    scrub()
    yield
    scrub()


@pytest.fixture(scope="module")
def port_positions():
    """The parent at the reference's eight positions, as the replicas
    will be."""
    prev = tcomm._default_comm
    htt.use_comm(htt.TorchCommunication(["cpu"] * P))
    yield P
    htt.use_comm(prev)


def _publish(root, *, tenants=("acme",)):
    """A tree the reference published (KMeans v1 and, for ``acme``, the
    canary v2) with the port's sidecar on ``acme``'s v1; returns the
    bundles."""
    x = ht.array(Xn, split=0)
    km = ht.cluster.KMeans(n_clusters=3, max_iter=5, random_state=0).fit(x)
    km2 = ht.cluster.KMeans(n_clusters=3, max_iter=7, random_state=1).fit(x)
    rreg = RRegistry(root)
    for tenant in tenants:
        rreg.publish(tenant, "km", km)
    rreg.publish("acme", "km", km2)
    reg = ModelRegistry(root)
    src = ServeEngine(reg, **KW)
    bundles = src.export_warm("acme", "km", version=1)
    src.close()
    assert bundles
    reg.publish_executables("acme", "km", 1, bundles)
    return bundles


@pytest.fixture(scope="module")
def fleet_root(tmp_path_factory, port_positions):
    root = str(tmp_path_factory.mktemp("procfleet") / "models")
    return root, _publish(root, tenants=("acme", "hot", "cold"))


def _check_hellos(fleet, n_bundles):
    for rep in fleet.alive():
        h = rep.hello
        assert (h["fuse_misses"], h["compile_misses"]) == (0, 0), h
        assert h["installed"] == n_bundles and h["warmups"] == 1, h
        assert h["pid"] == rep.proc.pid and "token" not in h
        assert sorted(h) == ["compile_misses", "fuse_misses", "installed", "kind", "pid",
                             "replica", "warmups"]


def _twin_crcs(root, pays, *, canary=None):
    """The reference's in-process FleetEngine over the same tree: its
    replies' crc32s and canary draws."""
    twin = RFleetEngine(RRegistry(root), canary=canary, **KW)
    try:
        crcs = [zlib.crc32(np.asarray(twin.predict("acme", "km", p,
                                                   version=None if canary else 1).value).tobytes())
                for p in pays]
        return crcs, list(twin.assignments)
    finally:
        twin.close()


def _checksum(ledger):
    acc = 0
    for rid, crc in ledger:
        acc = zlib.crc32(f"{rid}:{crc:08x};".encode("ascii"), acc)
    return acc


# --------------------------------------------------------------------- #
# placement                                                               #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("mesh", [(3,), (2, 2)])
def test_placement_snapshot_and_apply_round_trip(mesh):
    """The spawn config carries the parent's positions and mesh; the
    child's ``_apply_placement`` rebuilds the same communicator."""
    prev, prev_device = tcomm._default_comm, tdevices._default
    try:
        comm = htt.TorchCommunication(["cpu"] * int(np.prod(mesh)), mesh_shape=mesh)
        htt.use_comm(comm)
        snap = procfleet._placement_snapshot()
        assert snap == {"device": None, "positions": ["cpu"] * comm.size,
                        "mesh_shape": list(mesh)}
        htt.use_comm(htt.TorchCommunication(["cpu"]))
        _replica_main._apply_placement(snap)
        assert tcomm.get_comm() == comm and tdevices._default is None
        _replica_main._apply_placement(dict(snap, device="cpu"))
        assert tdevices.get_device() is tdevices.cpu
    finally:
        htt.use_comm(prev)
        tdevices.use_device(prev_device)


def test_child_placed_on_a_missing_card_fails_its_boot(fleet_root, monkeypatch, capfd):
    """A replica told to run where the parent ran on a card, on a machine
    without one, exits 3 before it connects; the spawn reports that at
    once, and nothing runs on the CPU instead."""
    root, _ = fleet_root
    monkeypatch.setattr(procfleet, "_placement_snapshot", lambda: {
        "device": None, "positions": ["cuda:0"], "mesh_shape": [1]})
    t0 = time.monotonic()
    with pytest.raises(ConnectionError, match="exited with code 3 before connecting"):
        ReplicaProc.spawn(0, registry_root=root, warm_models=[("acme", "km", 1)],
                          engine_kwargs=KW)
    assert time.monotonic() - t0 < procfleet._SPAWN_TIMEOUT_S / 2
    err = capfd.readouterr().err
    assert ("replica boot failed: the parent runs on cuda:0 but this process sees no CUDA "
            "device (it does not fall back to the CPU)") in err


# --------------------------------------------------------------------- #
# the fleet                                                               #
# --------------------------------------------------------------------- #
def test_fleet_ledger_equals_the_reference_twin(fleet_root):
    """Two replicas: zero-compile hellos, the ledger of a seeded stream
    equal to the reference FleetEngine's CRCs, trace ids, sticky sessions,
    and the aggregated /metrics reconciled with the ledger."""
    root, bundles = fleet_root
    arrivals = loadgen.schedule(seed=11, n_requests=32, min_rows=1, max_rows=32)
    pays = loadgen.payloads(arrivals, 5, seed=11)
    twin, _ = _twin_crcs(root, pays)
    with ProcFleet(root, n_replicas=2, warm_models=[("acme", "km", 1)], **KW) as fleet:
        _check_hellos(fleet, len(bundles))
        # the flap back-off the reference's fleet would walk for this seed
        assert fleet._flap_delays == rretry.backoff_schedule(rretry.RetryPolicy(
            attempts=6, base_delay=0.05, multiplier=2.0, max_delay=2.0, jitter=0.5,
            seed=loadgen.chaos_seed()))
        futs = [fleet.submit("acme", "km", p, version=1, request_id=f"rid-{i}",
                             session=f"s{i % 3}") for i, p in enumerate(pays)]
        fleet.flush()
        replies = [f.result() for f in futs]
        assert [r["trace_id"] for r in replies] == [f"rid-{i}" for i in range(32)]
        assert all(r["flight_seq"] >= 1 and not r["degraded"] for r in replies)
        by_session = {}
        for i, r in enumerate(replies):
            by_session.setdefault(f"s{i % 3}", set()).add(r["replica"])
        assert all(len(v) == 1 for v in by_session.values())
        assert {next(iter(v)) for v in by_session.values()} == {0, 1}
        led = fleet.ledger()
        assert led == tuple((f"rid-{i}", crc) for i, crc in enumerate(twin))
        assert [zlib.crc32(r["value"].tobytes()) for r in replies] == twin
        assert fleet.checksum() == _checksum(led)
        assert fleet.disposition_ledger() == tuple(
            (f"rid-{i}", "ok", crc) for i, crc in enumerate(twin))

        with FleetMetricsServer(fleet) as srv:
            with urllib.request.urlopen(srv.url + "/metrics") as resp:
                assert resp.status == 200
                body = resp.read().decode()
        samples = {}
        for line in body.splitlines():
            if not line.startswith("#"):
                name, value = line.rsplit(" ", 1)
                samples[name] = float(value)
        per_replica = [samples[f'heat_serve_requests_total{{replica="{r.index}"}}']
                       for r in fleet.alive()]
        assert sum(per_replica) == len(led) + 2  # and one warm-up each
        assert samples["heat_fleet_resolved_total"] == len(led)
        assert samples["heat_fleet_replicas"] == 2
        p50, p99 = fleet.latency_percentiles_ms()
        assert 0 < p50 <= p99
        stats = fleet.stats()
        assert (stats["accepted"], stats["resolved"], stats["requeued"]) == (32, 32, 0)
        assert stats["requests"] == 34 and stats["dispatches_per_batch"] == 1.0


def test_kill9_requeues_exactly_the_unacked_set(fleet_root):
    """The replica's worker holds its first request (a pinned 2 s
    straggle) while its outbox fills; kill -9 of the replica then
    re-queues exactly what it held, all twelve requests, to its warm
    replacement: the ledger equals the reference twin's, the dead
    replica's sessions rebind to the replacement and stay there."""
    root, bundles = fleet_root
    pays = [payload(3, seed=50 + i) for i in range(12)]
    twin, _ = _twin_crcs(root, pays)
    with ProcFleet(root, n_replicas=1, warm_models=[("acme", "km", 1)], **KW) as fleet:
        (victim,) = fleet.alive()
        with faults.inject("slow_replica", site="replica0", nth=1, delay=2.0):
            futs = [fleet.submit("acme", "km", p, version=1, request_id=f"k-{i}",
                                 session=f"s{i % 4}") for i, p in enumerate(pays)]
            deadline = time.monotonic() + 30
            while len(fleet._sessions) < 4 and time.monotonic() < deadline:
                time.sleep(0.01)  # every request routed: held or in the outbox
            assert fleet._sessions == {f"s{k}": 0 for k in range(4)}
            fleet.kill_replica(0)
            victim.proc.wait(timeout=30)
            fleet.flush(timeout_s=120)
        replies = [f.result() for f in futs]
        assert fleet.ledger() == tuple((f"k-{i}", crc) for i, crc in enumerate(twin))
        assert fleet.disposition_ledger() == tuple(
            (f"k-{i}", "requeued-ok", crc) for i, crc in enumerate(twin))
        stats = fleet.stats()
        assert (stats["requeued"], stats["replica_losses"], stats["respawns"]) == (12, 1, 1)
        assert victim.pid == victim.hello["pid"] and victim.proc.returncode == -9
        assert [r.index for r in fleet.alive()] == [1]
        _check_hellos(fleet, len(bundles))
        assert {r["replica"] for r in replies} == {1}
        losses = [i for i in incidents.incident_log() if i.kind == "replica-loss"]
        assert len(losses) == 1 and "12 un-acked request(s) re-queued" in losses[0].detail
        assert fleet._sessions == {f"s{k}": 1 for k in range(4)}
        more = [fleet.submit("acme", "km", payload(2, seed=i), version=1, session=f"s{i % 4}")
                for i in range(4)]
        fleet.flush()
        assert [f.result()["replica"] for f in more] == [1] * 4


def test_admission_canary_drain_and_close(fleet_root):
    """One replica behind WFQ admission and the ingress, under a canary:
    the hot tenant sheds against its own bound while the cold one is
    admitted in full; the versions drawn and every reply over the ingress
    equal the reference FleetEngine's; SIGTERM drains the replica (exit
    0, nothing re-queued) and its warm replacement serves; a closed fleet
    refuses submits and has reaped its replicas (exit 0)."""
    from heat_tpu_torch.serve import ServeClosedError, ServeOverloadError, TenantPolicy

    root, bundles = fleet_root
    canary = CanaryConfig("acme", "km", stable_version=1, canary_version=2, fraction=0.4, seed=123)
    pays = [payload(2, seed=i) for i in range(12)]
    twin, twin_draws = _twin_crcs(root, pays, canary=RCanaryConfig(**vars(canary)))
    fleet = ProcFleet(root, n_replicas=1, warm_models=[("acme", "km", 1)], canary=canary,
                      tenants={"hot": TenantPolicy(weight=1.0, max_queue_rows=16),
                               "cold": TenantPolicy(weight=4.0)}, **KW)
    try:
        _check_hellos(fleet, len(bundles))
        hot_shed, cold = 0, []
        for i in range(20):
            for _ in range(10):
                try:
                    fleet.submit("hot", "km", payload(8, seed=i))
                except ServeOverloadError as e:
                    hot_shed += 1
                    assert e.retry_after_s > 0 and e.max_queue_rows == 16
            cold.append(fleet.submit("cold", "km", payload(2, seed=100 + i)))
        fleet.flush(timeout_s=120)
        assert hot_shed > 0 and fleet.wfq.shed_by_tenant.get("cold", 0) == 0
        assert all(f.result()["value"].shape == (2,) for f in cold)
        shed = [d for d in fleet.disposition_ledger() if d[1] == "shed-429"]
        assert len(shed) == hot_shed == fleet.stats()["wfq_shed"]

        with Ingress(fleet) as ing, IngressClient("127.0.0.1", ing.port) as cli:
            replies = [cli.predict("acme", "km", p, request_id=f"c-{i}") for i, p in enumerate(pays)]
        assert [r["trace_id"] for r in replies] == [f"c-{i}" for i in range(12)]
        assert [zlib.crc32(r["value"].tobytes()) for r in replies] == twin
        assert fleet.assignments == twin_draws and fleet.n_canary == sum(twin_draws) > 0

        rep = fleet.drain_replica(0)
        assert rep.proc.wait(timeout=60) == 0
        deadline = time.monotonic() + 90
        while fleet.n_respawns < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        stats = fleet.stats()
        assert (stats["drains"], stats["requeued"], stats["respawns"]) == (1, 0, 1)
        assert fleet.drain_exit_codes == [0] and rep.drained
        assert [r.index for r in fleet.alive()] == [1]
        _check_hellos(fleet, len(bundles))
        got = fleet.submit("acme", "km", pays[0], version=1).result(timeout=60)
        assert got["replica"] == 1 and zlib.crc32(got["value"].tobytes()) == _twin_crcs(root, pays[:1])[0][0]
        drains = [i for i in incidents.incident_log() if i.kind == "replica-drain"]
        assert len(drains) == 1 and "0 re-queued" in drains[0].detail
        procs = [r.proc for r in fleet.alive()]
    finally:
        fleet.close()
    fleet.close()  # idempotent
    assert all(p.poll() == 0 for p in procs)
    with pytest.raises(ServeClosedError, match="ProcFleet is closed"):
        fleet.submit("acme", "km", payload(2))
    with pytest.raises(ValueError, match="n_replicas must be >= 1, got 0"):
        ProcFleet(root, n_replicas=0)
    with pytest.raises(ValueError, match="loopback only"):
        ReplicaProc.spawn(0, registry_root=root, host="0.0.0.0")


def test_replica_inherits_the_parents_policy_context(tmp_path, port_positions):
    """A non-default collective threshold changes the fingerprint's
    context token: the child, given the parent's policy, installs every
    bundle the parent exported under it, and builds nothing."""
    prev = tcq.get_collective_threshold()
    tcq.set_collective_threshold(1 << 20)
    try:
        root = str(tmp_path / "policy")
        bundles = _publish(root)
        with ProcFleet(root, n_replicas=1, warm_models=[("acme", "km", 1)], **KW) as fleet:
            _check_hellos(fleet, len(bundles))
    finally:
        tcq.set_collective_threshold(prev)
