"""``heat_tpu_torch.serve``'s fleet control plane held against
``heat_tpu.serve``'s, in one process (no replica processes here:
``tests/test_torch_procfleet.py`` spawns them).

* ``WatermarkAutoscaler.decide`` over seeded traces of queue depths and
  SLO states: the same decisions, streaks and validation messages.
* ``WeightedFairQueue``: the same pop order under weights, priority bands
  and per-tenant bounds, and the same typed sheds with the same
  ``retry_after_s``, ``queue_rows`` and messages.
* ``ReplicaBreaker``: the same transitions, EWMA and counters over seeded
  success/failure sequences.
* ``FleetEngine`` at 1 and 8 positions over one registry tree the
  reference published: every reply of the four fused predicts bitwise the
  reference ``FleetEngine``'s and the port's direct predict; the same
  canary assignments for one seed; the same scale events under
  ``device_arrival`` and ``device_loss`` plans; a lost replica's futures
  resolve with ``ServeClosedError``, never a hang; warm scale-ups build
  nothing.

Tolerance: bitwise for replies, exact for every decision and counter.
"""

import shutil

import numpy as np
import pytest

import jax

from heat_tpu import telemetry as rtelemetry
from heat_tpu.core import communication as rcomm
from heat_tpu.resilience import faults as rfaults
from heat_tpu.resilience import incidents as rincidents
from heat_tpu.serve import (
    CanaryConfig as RCanaryConfig,
    FleetEngine as RFleetEngine,
    ModelRegistry as RRegistry,
    ServeClosedError as RServeClosedError,
    ServeOverloadError as RServeOverloadError,
    TenantPolicy as RTenantPolicy,
    WatermarkAutoscaler as RWatermarkAutoscaler,
    WeightedFairQueue as RWeightedFairQueue,
    loadgen as rloadgen,
)
from heat_tpu.resilience import retry as rretry
from heat_tpu.serve import procfleet as rprocfleet
from heat_tpu.serve.health import ReplicaBreaker as RReplicaBreaker
from test_torch_reference_state import reference_state  # noqa: F401  (restores the JAX package's state)
from test_torch_serve import P, Xn, fit_reference, payload

import heat_tpu as ht
import heat_tpu_torch as htt
from heat_tpu_torch import telemetry
from heat_tpu_torch.core import communication as tcomm
from heat_tpu_torch.resilience import faults, incidents
from heat_tpu_torch.serve import (
    CanaryConfig,
    FleetEngine,
    ModelRegistry,
    ServeClosedError,
    ServeEngine,
    ServeOverloadError,
    TenantPolicy,
    WatermarkAutoscaler,
    WeightedFairQueue,
    loadgen,
)
from heat_tpu_torch.resilience import retry
from heat_tpu_torch.serve import procfleet
from heat_tpu_torch.serve.health import ReplicaBreaker

NAMES = ["km", "nb", "knn", "lasso"]


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
def published(tmp_path_factory):
    """The reference's tree: the four estimators under ``acme``, and a
    second KMeans version (the canary)."""
    root = str(tmp_path_factory.mktemp("fleet") / "models")
    reg = RRegistry(root)
    for name, est in fit_reference().items():
        reg.publish("acme", name, est)
    km2 = ht.cluster.KMeans(n_clusters=3, max_iter=7, random_state=1).fit(ht.array(Xn, split=0))
    reg.publish("acme", "km", km2)
    return root


@pytest.fixture
def positions(request):
    p = getattr(request, "param", P)
    prev, rprev = tcomm._default_comm, rcomm._default_comm
    htt.use_comm(htt.TorchCommunication(["cpu"] * p))
    rcomm._default_comm = rcomm.XlaCommunication(jax.devices()[:p])
    yield p
    htt.use_comm(prev)
    rcomm._default_comm = rprev


@pytest.fixture
def fleets(published, positions):
    """A port and a reference fleet over the same tree, closed after."""
    made = []

    def make(**kw):
        rkw = dict(kw)
        for key, rcls in (("autoscaler", RWatermarkAutoscaler), ("canary", RCanaryConfig)):
            if key in kw:
                rkw[key] = rcls(**vars(kw[key])) if key == "canary" else _twin_autoscaler(kw[key])
        pair = (FleetEngine(ModelRegistry(published), **kw), RFleetEngine(RRegistry(published), **rkw))
        made.extend(pair)
        return pair

    yield make
    for f in made:
        f.close()


def _twin_autoscaler(a):
    return RWatermarkAutoscaler(a.low, a.high, hysteresis=a.hysteresis,
                                min_replicas=a.min_replicas, max_replicas=a.max_replicas)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


# --------------------------------------------------------------------- #
# the watermark autoscaler                                                #
# --------------------------------------------------------------------- #
AUTOSCALERS = [
    dict(low=1.0, high=4.0, hysteresis=1, max_replicas=2),
    dict(low=2.0, high=16.0),
    dict(low=0.0, high=8.0, hysteresis=3, min_replicas=2, max_replicas=5),
    dict(low=4.0, high=6.0, hysteresis=2, min_replicas=1, max_replicas=8),
]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("cfg", range(len(AUTOSCALERS)))
def test_autoscaler_decisions_equal_the_references(cfg, seed):
    kw = AUTOSCALERS[cfg]
    mine, ref = WatermarkAutoscaler(**kw), RWatermarkAutoscaler(**kw)
    rng = np.random.default_rng(seed)
    # runs of 1-6 ticks at one level, so that streaks build and break
    levels = rng.choice([0.0, 0.5, 1.0, 3.0, 5.0, 7.0, 12.0, 20.0, 50.0], size=120)
    depths = np.repeat(levels, rng.integers(1, 7, size=120))
    slo = rng.random(depths.size) < 0.05
    replicas = mine.min_replicas
    decisions = []
    for depth, alerting in zip(depths, slo):
        d = mine.decide(depth, slo_alerting=bool(alerting), replicas=replicas)
        assert d == ref.decide(depth, slo_alerting=bool(alerting), replicas=replicas)
        assert (mine._high_streak, mine._low_streak) == (ref._high_streak, ref._low_streak)
        replicas += d
        decisions.append(d)
    assert mine.min_replicas <= replicas <= mine.max_replicas
    assert 1 in decisions and (-1 in decisions) == (mine.low > 0)  # depth < 0 never happens


@pytest.mark.parametrize("kw", [
    dict(low=4.0, high=4.0), dict(low=-1.0, high=2.0), dict(hysteresis=0),
    dict(min_replicas=0), dict(min_replicas=3, max_replicas=2),
])
def test_autoscaler_validation_messages_equal_the_references(kw):
    with pytest.raises(ValueError) as mine:
        WatermarkAutoscaler(**kw)
    with pytest.raises(ValueError) as ref:
        RWatermarkAutoscaler(**kw)
    assert str(mine.value) == str(ref.value)


# --------------------------------------------------------------------- #
# weighted-fair admission                                                  #
# --------------------------------------------------------------------- #
def _wfq_trace(cls_queue, cls_policy, overload, seed):
    """A seeded interleaving of pushes and pops; every outcome recorded."""
    rng = np.random.default_rng(seed)
    tenants = ["a", "b", "c", "d"]
    policies = {
        "a": cls_policy(weight=1.0, priority=0, max_queue_rows=12),
        "b": cls_policy(weight=3.0, priority=0),
        "c": cls_policy(weight=0.5, priority=1, max_queue_rows=20),
    }
    q = cls_queue(policies, default_max_queue_rows=16, drain_hint_s=1.5e-3)
    out = []
    for i in range(160):
        if rng.random() < 0.6:
            t = tenants[int(rng.integers(0, 4))]
            rows = int(rng.integers(1, 9))
            try:
                q.push(t, (t, i), rows=rows)
                out.append(("push", t, rows))
            except overload as e:
                out.append(("shed", t, rows, e.retry_after_s, e.queue_rows, e.max_queue_rows, str(e)))
        else:
            out.append(("pop", q.pop(timeout=0)))
        out.append((len(q), q.queued_rows(), q.queued_rows("a")))
    q.close()
    while True:
        got = q.pop(timeout=0)
        out.append(("drain", got))
        if got is None:
            break
    out.append((q.n_shed, dict(q.shed_by_tenant)))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_wfq_order_and_sheds_equal_the_references(seed):
    mine = _wfq_trace(WeightedFairQueue, TenantPolicy, ServeOverloadError, seed)
    ref = _wfq_trace(RWeightedFairQueue, RTenantPolicy, RServeOverloadError, seed)
    assert mine == ref
    assert any(e[0] == "shed" for e in mine if isinstance(e[0], str))


def test_wfq_weighted_interleave_and_priority_band():
    """The reference's tests/test_procfleet.py cases, both packages."""
    orders = []
    for cls_q, cls_p in ((WeightedFairQueue, TenantPolicy), (RWeightedFairQueue, RTenantPolicy)):
        q = cls_q({"heavy": cls_p(weight=3.0), "light": cls_p(weight=1.0),
                   "batch": cls_p(priority=1)})
        for i in range(6):
            q.push("heavy", f"h{i}", rows=2)
            q.push("light", f"l{i}", rows=2)
            q.push("batch", f"b{i}", rows=2)
        orders.append([q.pop(timeout=0)[1] for _ in range(18)])
    assert orders[0] == orders[1]
    assert orders[0][-6:] == [f"b{i}" for i in range(6)]


def test_wfq_closed_and_policy_errors_equal_the_references():
    for cls_q, cls_p, closed in ((WeightedFairQueue, TenantPolicy, ServeClosedError),
                                 (RWeightedFairQueue, RTenantPolicy, RServeClosedError)):
        with pytest.raises(ValueError, match="tenant weight must be > 0, got 0"):
            cls_p(weight=0)
        q = cls_q()
        assert q.pop(timeout=0.01) is None
        q.close()
        with pytest.raises(closed, match="WeightedFairQueue is closed"):
            q.push("t", 1)
        assert q.pop() is None


def test_wfq_pop_wakes_on_push_from_another_thread():
    import threading

    q = WeightedFairQueue()
    got = []
    t = threading.Thread(target=lambda: got.append(q.pop(timeout=30)))
    t.start()
    q.push("t", "x", rows=3)
    t.join(timeout=30)
    assert not t.is_alive() and got == [("t", "x")]


# --------------------------------------------------------------------- #
# the replica breaker                                                     #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("half_open", [False, True])
@pytest.mark.parametrize("threshold", [1, 2, 3, 5])
@pytest.mark.parametrize("seed", [0, 1])
def test_breaker_transitions_equal_the_references(threshold, half_open, seed):
    rng = np.random.default_rng(seed)
    mine = ReplicaBreaker(failure_threshold=threshold, ewma_alpha=0.3, half_open=half_open)
    ref = RReplicaBreaker(failure_threshold=threshold, ewma_alpha=0.3, half_open=half_open)
    states = []
    # alternating runs of 1-6 successes and 1-6 failures
    fails = np.repeat(np.arange(40) % 2 == 1, rng.integers(1, 7, size=40))
    for fail in fails:
        if fail:
            got = (mine.record_failure(), ref.record_failure())
        else:
            lat = float(rng.exponential(4.0))
            got = (mine.record_success(lat), ref.record_success(lat))
        assert got[0] == got[1]
        fields = [(b.state, b.consecutive_failures, b.ewma_ms, b.p50_ms(), b.n_successes,
                   b.n_failures, b.n_opens) for b in (mine, ref)]
        assert fields[0] == fields[1]
        states.append(mine.state)
    assert "open" in states


def test_breaker_validation_equal_the_references():
    for cls in (ReplicaBreaker, RReplicaBreaker):
        with pytest.raises(ValueError, match="failure_threshold must be >= 1, got 0"):
            cls(failure_threshold=0)


# --------------------------------------------------------------------- #
# the procfleet's flap back-off                                           #
# --------------------------------------------------------------------- #
class _Flapper:
    """The two fields ``ProcFleet._flap_backoff`` reads and writes, with
    the schedule ``ProcFleet.__init__`` builds for a fleet seed."""

    def __init__(self, retry_mod, seed):
        self._flap_streak = 0
        self._flap_delays = retry_mod.backoff_schedule(retry_mod.RetryPolicy(
            attempts=6, base_delay=0.05, multiplier=2.0, max_delay=2.0, jitter=0.5, seed=seed))


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_flap_backoff_schedule_and_sleeps_equal_the_references(seed):
    """Consecutive breaker quarantines walk the seeded schedule: the first
    respawns at once, the next sleep its steps (the last one repeating),
    with the same incidents; the schedule is numpy's, bitwise."""
    runs = []
    for cls, retry_mod, inc in ((procfleet.ProcFleet, retry, incidents),
                                (rprocfleet.ProcFleet, rretry, rincidents)):
        sleeps = []
        retry_mod.set_sleep(sleeps.append)
        try:
            fake = _Flapper(retry_mod, seed)
            for _ in range(9):
                cls._flap_backoff(fake)
        finally:
            retry_mod.set_sleep(None)
        log = [(i.kind, i.site, i.policy, i.action, i.detail) for i in inc.incident_log()]
        runs.append((fake._flap_delays, sleeps, log))
    assert runs[0] == runs[1]
    delays, sleeps, log = runs[0]
    assert len(delays) == 5 and sleeps == list(delays) + [delays[-1]] * 3
    assert [e[2] for e in log] == [f"flap(streak={k})" for k in range(2, 10)]


# --------------------------------------------------------------------- #
# FleetEngine                                                             #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("positions", [1, P], indirect=True)
@pytest.mark.parametrize("name", NAMES)
def test_fleet_replies_bitwise_reference_and_direct(fleets, name, positions):
    auto = WatermarkAutoscaler(low=0, high=100, min_replicas=2, max_replicas=2)
    fleet, rfleet = fleets(autoscaler=auto, max_batch_rows=32, min_bucket=8)
    assert len(fleet.replicas) == len(rfleet.replicas) == 2
    for mix in ([1, 2, 3], [5, 4, 8], [16, 7], [9, 9, 3, 1]):
        pays = [payload(r, seed=300 + r + i) for i, r in enumerate(mix)]
        futs = [fleet.submit("acme", name, p) for p in pays]
        rfuts = [rfleet.submit("acme", name, p) for p in pays]
        assert fleet.flush() == rfleet.flush() == len(mix)
        for p, f, rf in zip(pays, futs, rfuts):
            got, ref = f.result(), rf.result()
            assert (got.seq, got.trace_id, got.degraded) == (ref.seq, ref.trace_id, ref.degraded)
            assert _same(got.value, ref.value), (name, mix)
            assert _same(got.value, fleet.direct_predict("acme", name, p)), (name, mix)
    stats, rstats = fleet.stats(), rfleet.stats()
    assert stats == rstats
    assert stats["dispatches_per_batch"] == 1.0 and stats["replicas"] == 2


@pytest.mark.parametrize("fraction", [0.1, 0.4])
@pytest.mark.parametrize("seed", [7, 123])
def test_fleet_canary_assignments_and_replies_equal_the_references(fleets, seed, fraction):
    canary = CanaryConfig(tenant="acme", model="km", stable_version=1, canary_version=2,
                          fraction=fraction, seed=seed)
    fleet, rfleet = fleets(canary=canary, max_batch_rows=32, min_bucket=8)
    for s in range(16):
        got = fleet.predict("acme", "km", payload(4, s))
        ref = rfleet.predict("acme", "km", payload(4, s))
        assert _same(got.value, ref.value)
    assert fleet.assignments == rfleet.assignments and len(fleet.assignments) == 16
    assert (fleet.n_canary, fleet.n_stable) == (rfleet.n_canary, rfleet.n_stable)
    # the stream is numpy's: default_rng([seed, 2]), one draw a request
    want = list(np.random.default_rng([seed, 2]).random(16) < fraction)
    assert fleet.assignments == want
    # a pinned version bypasses the rollout
    fleet.predict("acme", "km", payload(4, 99), version=1)
    assert len(fleet.assignments) == 16


def test_fleet_canary_seed_defaults_to_the_chaos_seed(fleets, monkeypatch):
    monkeypatch.setenv("HEAT_CHAOS_SEED", "31")
    canary = CanaryConfig(tenant="acme", model="km", stable_version=1, canary_version=2,
                          fraction=0.5)
    fleet, rfleet = fleets(canary=canary, min_bucket=8)
    for s in range(8):
        fleet.submit("acme", "km", payload(2, s))
        rfleet.submit("acme", "km", payload(2, s))
    assert fleet.assignments == rfleet.assignments
    assert fleet.assignments == list(np.random.default_rng([31, 2]).random(8) < 0.5)
    with pytest.raises(ValueError) as mine:
        CanaryConfig("acme", "km", 1, 2, fraction=1.0)
    with pytest.raises(ValueError) as ref:
        RCanaryConfig("acme", "km", 1, 2, fraction=1.0)
    assert str(mine.value) == str(ref.value)


def _chaos_scenario(fleets, seed, pkg_faults):
    """The reference's tests/test_fleet.py scenario: serve under a canary
    while devices arrive and die on seeded schedules."""
    ledgers = []
    canary = CanaryConfig(tenant="acme", model="km", stable_version=1, canary_version=2,
                          fraction=0.3, seed=seed)
    auto = WatermarkAutoscaler(low=1, high=8, hysteresis=2, min_replicas=1, max_replicas=3)
    pair = fleets(canary=canary, autoscaler=auto, max_batch_rows=32, min_bucket=8)
    for fleet, f in zip(pair, pkg_faults):
        ledger, values = [], []
        with f.inject("device_arrival", site="fleet.tick", nth=2, rank=1, seed=seed):
            with f.inject("device_loss", site="fleet.tick", nth=4, rank=0, seed=seed):
                for step in range(6):
                    for s in range(3):
                        values.append(fleet.predict("acme", "km", payload(4, step * 3 + s)).value)
                    rec = fleet.tick(queue_depth=10 if step < 3 else 0)
                    ledger.append((rec["decision"], rec["replicas"], rec["queue_depth"],
                                   rec["slo_alerting"]))
        events = [(e["action"], e["cause"], e["replicas"], e.get("installed"), e.get("index"))
                  for e in fleet.scale_events]
        ledgers.append((ledger, events, tuple(fleet.assignments),
                        [np.asarray(v).tobytes() for v in values],
                        (fleet.n_scale_ups, fleet.n_scale_downs, fleet.n_replica_losses)))
    return ledgers


@pytest.mark.parametrize("seed", [123, 124])
def test_fleet_scale_events_under_arrival_and_loss_equal_the_references(fleets, seed):
    mine, ref = _chaos_scenario(fleets, seed, (faults, rfaults))
    assert mine == ref
    actions = [e[0] for e in mine[1]]
    assert "scale-up" in actions and "replica-loss" in actions
    log = [(i.kind, i.site, i.policy, i.action) for i in incidents.incident_log()]
    rlog = [(i.kind, i.site, i.policy, i.action) for i in rincidents.incident_log()]
    assert log == rlog and ("replica-loss", "fleet", "chaos", "lost") in log


def test_fleet_lost_replica_futures_resolve_closed(fleets):
    """Device loss mid-flight: the victim's pending futures resolve with
    the typed close error (never a hang), the survivors keep serving."""
    auto = WatermarkAutoscaler(low=0, high=100, hysteresis=2, min_replicas=2, max_replicas=3)
    outcomes = []
    for fleet, f, closed in zip(fleets(autoscaler=auto, max_batch_rows=32, min_bucket=8),
                                (faults, rfaults), (ServeClosedError, RServeClosedError)):
        futs = [fleet.submit("acme", "km", payload(4, s)) for s in range(4)]
        with f.inject("device_loss", site="fleet.tick", nth=1, rank=0):
            fleet.tick(queue_depth=50)
        fleet.flush()
        got = []
        for fut in futs:
            try:
                got.append(fut.result(timeout=10).value.tobytes())
            except closed as e:
                got.append(("closed", str(e)))
        outcomes.append((got, fleet.n_replica_losses, len(fleet.replicas)))
        assert fleet.predict("acme", "km", payload(4, 9)).value.shape == (4,)
    assert outcomes[0] == outcomes[1]
    assert sum(isinstance(g, tuple) for g in outcomes[0][0]) == 2


def test_fleet_loses_its_last_replica_and_respawns(fleets):
    events = []
    for fleet in fleets(min_bucket=8):
        fleet.lose_replica(0)
        events.append([(e["action"], e["cause"], e["replicas"]) for e in fleet.scale_events])
        assert len(fleet.replicas) == 1
    assert events[0] == events[1]
    assert events[0][-1] == ("scale-up", "replica-loss-respawn", 1)


def test_fleet_scale_down_drains_and_close_contract(fleets):
    auto = WatermarkAutoscaler(low=1, high=4, hysteresis=1, max_replicas=3)
    for fleet, closed in zip(fleets(autoscaler=auto, min_bucket=8),
                             (ServeClosedError, RServeClosedError)):
        fleet.tick(queue_depth=10)
        fleet.tick(queue_depth=10)
        assert len(fleet.replicas) == 3
        futs = [fleet.submit("acme", "km", payload(3, s)) for s in range(6)]
        # scale-down retires the newest replica after draining it
        assert fleet.tick(queue_depth=0)["decision"] == -1
        assert all(f.done() for f in futs[2::3])
        fleet.flush()
        assert [f.result().value.shape for f in futs] == [(3,)] * 6
        fleet.close()
        fleet.close()  # idempotent
        for call in (lambda: fleet.submit("acme", "km", payload(4)),
                     lambda: fleet.direct_predict("acme", "km", payload(4)),
                     lambda: fleet.tick(), lambda: fleet.scale_up(), lambda: fleet.scale_down()):
            with pytest.raises(closed, match="FleetEngine is closed"):
                call()


def test_fleet_warm_scale_ups_build_nothing(published, positions, tmp_path):
    """A replica warmed from the port's sidecar serves its first request
    with zero fuse and compile misses; a scale-up installs every bundle."""
    root = str(tmp_path / "models")
    shutil.copytree(published, root)
    reg = ModelRegistry(root)
    src = ServeEngine(reg, max_batch_rows=32, min_bucket=8)
    bundles = src.export_warm("acme", "km", version=1)
    src.close()
    reg.publish_executables("acme", "km", 1, bundles)
    htt.fuse.clear_cache()
    auto = WatermarkAutoscaler(low=1, high=4, hysteresis=1, max_replicas=2)
    fleet = FleetEngine(ModelRegistry(root), autoscaler=auto, warm_models=[("acme", "km", 1)],
                        max_batch_rows=32, min_bucket=8)
    telemetry.enable()
    try:
        for _ in range(3):
            before = dict(telemetry.snapshot()["counters"])
            fleet.tick(queue_depth=50.0)
            for _r in range(len(fleet.replicas)):
                fleet.predict("acme", "km", payload(8, 1), version=1)
            after = telemetry.snapshot()["counters"]
            for key in ("fuse.cache.misses", "compile.cache.misses"):
                assert after.get(key, 0) == before.get(key, 0), key
            fleet.tick(queue_depth=0.0)
    finally:
        fleet.close()
    installed = [e["installed"] for e in fleet.scale_events if e["action"] == "scale-up"]
    assert installed == [len(bundles)] * 4
    assert fleet.stats()["scale_ups"] == 4 and fleet.stats()["scale_downs"] == 3
    assert len(fleet.cold_start_ms) == 4


def test_fleet_drives_loadgen_with_golden_twin(fleets):
    """loadgen drives the fleet as it drives an engine: the same seeded
    report (checksum, degraded, batching) as the reference fleet's."""
    reports = [
        gen.run(fleet, "acme", "km", version=1, seed=5, n_requests=24, rate_hz=500.0,
                min_rows=1, max_rows=16, n_features=5, realtime=False, twin=True)
        for fleet, gen in zip(fleets(max_batch_rows=32, min_bucket=8), (loadgen, rloadgen))
    ]
    mine, ref = reports
    assert mine.twin["bitwise_equal"] and ref.twin["bitwise_equal"]
    for key in ("n_requests", "rows", "degraded", "checksum", "batches", "dispatches",
                "batch_occupancy", "payload_bytes", "reply_bytes", "trace_ids"):
        assert getattr(mine, key) == getattr(ref, key), key
