"""``heat_tpu_torch.serve.ServeEngine`` held against ``heat_tpu.serve``'s
engine on the same registry tree and payloads.

Tolerance: **bitwise**, the reference's serving contract
(``heat_tpu/serve/__init__.py``): every reply of the four fused predicts
(KMeans' ``_fused_assign``, GaussianNB's ``_fused_nb_predict``, KNN's
``_fused_knn_predict``, Lasso's ``_fused_lasso_predict``) equals the
reference engine's reply and the port's own unbatched ``direct_predict``,
at 1 and at 8 positions, replicated and row-split.  Besides: one dispatch
a micro-batch, the degrade quarantine, the validation messages, the
background worker, versions side by side, trace ids, the ``serve:*``
telemetry, the SLO hook, the loopback ``/metrics`` server and the close
contract.  Every engine is closed and its worker threads joined.
"""

import http.client
import json

import numpy as np
import pytest

import jax

from heat_tpu import telemetry as rtelemetry
from heat_tpu.core import communication as rcomm
from heat_tpu.resilience import incidents as rincidents
from heat_tpu.serve import ModelRegistry as RRegistry, ServeEngine as REngine
from test_torch_reference_state import reference_state  # noqa: F401  (restores the JAX package's state)
from test_torch_serve import P, fit_reference, payload

import heat_tpu_torch as htt
from heat_tpu_torch import telemetry
from heat_tpu_torch.core import communication as tcomm
from heat_tpu_torch.resilience import incidents
from heat_tpu_torch.serve import ModelRegistry, ServeClosedError, ServeEngine

NAMES = ["km", "nb", "knn", "lasso"]


@pytest.fixture(scope="module")
def published(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("serve_engine") / "models")
    reg = RRegistry(root)
    for name, est in fit_reference().items():
        reg.publish("acme", name, est)
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
def engines(published, positions):
    """A port and a reference engine over the same tree, closed after."""
    made = []

    def make(**kw):
        pair = (ServeEngine(ModelRegistry(published), **kw), REngine(RRegistry(published), **kw))
        made.extend(pair)
        return pair

    yield make
    for eng in made:
        eng.close()
    # every lane's worker thread joined
    assert all(ln.batcher._worker is None for eng in made for ln in eng._lanes.values())


def _same(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


# --------------------------------------------------------------------- #
# bitwise replies                                                         #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("split", [None, "auto"])
@pytest.mark.parametrize("positions", [1, P], indirect=True)
@pytest.mark.parametrize("name", NAMES)
def test_served_replies_bitwise_the_reference_and_direct(engines, name, positions, split):
    eng, reng = engines(max_batch_rows=32, min_bucket=8, split=split)
    # row mixes crossing the 8-row bucket and the 8 -> 16 -> 32 steps
    for mix in ([1, 2, 3], [5, 4], [8], [7, 6], [16], [9, 9], [20, 12]):
        pays = [payload(r, seed=100 + r + i) for i, r in enumerate(mix)]
        futs = [eng.submit("acme", name, p) for p in pays]
        rfuts = [reng.submit("acme", name, p) for p in pays]
        assert eng.flush() == reng.flush() == len(mix)
        for p, f, rf in zip(pays, futs, rfuts):
            got, ref = f.result(), rf.result()
            assert not got.degraded and (got.seq, got.trace_id) == (ref.seq, ref.trace_id)
            assert _same(got.value, ref.value), (name, mix)
            assert _same(got.value, eng.direct_predict("acme", name, p)), (name, mix)
    stats, rstats = eng.stats(), reng.stats()
    for key in ("requests", "batches", "rows", "padded_rows", "dispatches", "payload_bytes",
                "reply_bytes", "dispatches_per_batch", "batch_occupancy"):
        assert stats[key] == rstats[key], key
    assert stats["dispatches_per_batch"] == 1.0


def test_one_dispatch_a_batch_and_no_builds_once_warm(engines):
    eng, _ = engines(max_batch_rows=32, min_bucket=8)
    eng.predict("acme", "km", payload(5, seed=0))
    warm = eng.stats()
    assert warm["batches"] == warm["dispatches"] == 1
    telemetry.enable()
    telemetry.reset()
    try:
        for seed in range(1, 6):
            futs = [eng.submit("acme", "km", payload(3, seed=seed)),
                    eng.submit("acme", "km", payload(4, seed=seed + 50))]
            eng.flush()
            [f.result() for f in futs]
        counters = telemetry.snapshot()["counters"]
    finally:
        telemetry.disable()
        telemetry.reset()
    assert counters.get("fuse.cache.misses", 0) == 0
    assert counters["fuse.cache.hits"] >= 5 and counters["serve.batches"] == 5
    stats = eng.stats()
    assert stats["batches"] == stats["dispatches"] == 6
    assert stats["dispatches_per_batch"] == 1.0


def test_poisoned_payload_is_quarantined_and_batch_mates_untouched(engines):
    eng, reng = engines(max_batch_rows=32, min_bucket=8)
    incidents.clear_incident_log()
    rincidents.clear_incident_log()
    good1, good2, bad = payload(3, seed=7), payload(4, seed=8), payload(2, seed=9)
    bad[1, 3] = np.nan
    replies = []
    for e in (eng, reng):
        futs = [e.submit("acme", "km", p) for p in (good1, bad, good2)]
        e.flush()
        replies.append([f.result() for f in futs])
    (r1, rbad, r2), (q1, qbad, q2) = replies
    assert not r1.degraded and not r2.degraded and rbad.degraded and qbad.degraded
    assert rbad.value.shape == (2,)
    for got, ref, p in ((r1, q1, good1), (r2, q2, good2)):
        assert _same(got.value, ref.value)
        assert _same(got.value, eng.direct_predict("acme", "km", p))
    log = [(i.kind, i.site, i.policy, i.action) for i in incidents.incident_log()
           if i.kind == "poisoned-payload"]
    rlog = [(i.kind, i.site, i.policy, i.action) for i in rincidents.incident_log()
            if i.kind == "poisoned-payload"]
    assert log == rlog == [("poisoned-payload", "serve:acme/km", "degrade", "degraded")]
    assert eng.stats()["degraded"] == reng.stats()["degraded"] == 1
    incidents.clear_incident_log()
    rincidents.clear_incident_log()


def test_validation_messages_equal_the_references(engines):
    eng, reng = engines(min_bucket=8)
    for e in (eng, reng):
        e.predict("acme", "km", payload(2))
    for bad in (payload(2)[:, :3], np.zeros(5, np.float32), payload(2).astype(np.float64)):
        with pytest.raises(ValueError) as mine:
            eng.submit("acme", "km", bad)
        with pytest.raises(ValueError) as ref:
            reng.submit("acme", "km", bad)
        assert str(mine.value) == str(ref.value)
    with pytest.raises(ValueError, match='split must be None, 0 or "auto"'):
        ServeEngine(ModelRegistry("unused"), split=1)


def test_background_worker_replies_bitwise_the_direct_twin(engines):
    """With ``start()`` the batches run on the lane's worker thread; each
    reply still equals the caller-thread direct predict, bitwise."""
    eng, _ = engines(max_batch_rows=32, min_bucket=8, max_delay_s=0.01)
    eng.start()
    for name in NAMES:
        futs = [eng.submit("acme", name, payload(2 + s % 3, seed=s)) for s in range(9)]
        replies = [f.result(timeout=60) for f in futs]
        for s, r in enumerate(replies):
            assert not r.degraded
            assert _same(r.value, eng.direct_predict("acme", name, payload(2 + s % 3, seed=s)))
    assert eng.stats()["dispatches_per_batch"] == 1.0
    eng.close()
    with pytest.raises(ServeClosedError, match="closed"):
        eng.predict("acme", "km", payload(2))


def test_close_without_drain_resolves_every_future(engines):
    eng, _ = engines(min_bucket=8)
    futs = [eng.submit("acme", "nb", payload(2, seed=s)) for s in range(3)]
    eng.close(drain=False)
    for f in futs:
        with pytest.raises(ServeClosedError, match="abandoned"):
            f.result(timeout=5)
    eng.close()  # idempotent


def test_versions_side_by_side(tmp_path, positions):
    root = str(tmp_path / "v")
    reg = RRegistry(root)
    import heat_tpu as ht
    from test_torch_serve import Xn

    reg.publish("acme", "km", fit_reference()["km"])
    reg.publish("acme", "km", ht.cluster.KMeans(n_clusters=2, max_iter=5, random_state=1).fit(
        ht.array(Xn, split=0)))
    eng = ServeEngine(ModelRegistry(root), min_bucket=8)
    reng = REngine(RRegistry(root), min_bucket=8)
    try:
        p = payload(4, seed=3)
        for v in (1, 2):
            got = eng.predict("acme", "km", p, version=v)
            assert _same(got.value, reng.predict("acme", "km", p, version=v).value)
            assert _same(got.value, eng.direct_predict("acme", "km", p, version=v))
        assert int(got.value.max()) < 2
        assert sorted(ln["version"] for ln in eng.varz()["lanes"]) == [1, 2]
    finally:
        eng.close()
        reng.close()


def test_request_ids_and_ambient_trace_context(engines):
    eng, reng = engines(min_bucket=8)
    for e, tel in ((eng, telemetry), (reng, rtelemetry)):
        assert e.predict("acme", "nb", payload(2), request_id="req-7").trace_id == "req-7"
        with tel.trace_ctx("ambient-1"):
            fut = e.submit("acme", "nb", payload(3))
        e.flush()
        assert fut.result().trace_id == "ambient-1"
        assert e.predict("acme", "nb", payload(1)).trace_id == "serve:acme/nb/v1#3"


def test_serve_telemetry_names_equal_the_references(engines):
    """With telemetry on in both packages, the same traffic leaves the same
    ``serve.*`` counters and gauges, the same ``serve:batch`` span count and
    one latency observation a reply; each reply feeds the SLO monitor."""
    eng, reng = engines(max_batch_rows=16, min_bucket=8)
    for e in (eng, reng):  # warm both buckets with telemetry off (the reference's cdist)
        e.predict("acme", "km", payload(3))
        e.predict("acme", "km", payload(9))
    eng.slo = telemetry.SloMonitor("test.serve", target_ms=1e9)
    reng.slo = rtelemetry.SloMonitor("test.serve", target_ms=1e9)
    snaps = []
    for e, tel in ((eng, telemetry), (reng, rtelemetry)):
        tel.enable()
        tel.reset()
        try:
            futs = [e.submit("acme", "km", payload(r, seed=r)) for r in (3, 5, 9, 2)]
            e.flush()
            [f.result() for f in futs]
            snaps.append(tel.snapshot())
        finally:
            tel.disable()
            tel.reset()
    mine, ref = snaps
    serve_counters = {k: v for k, v in mine["counters"].items() if k.startswith("serve.")}
    assert serve_counters == {k: v for k, v in ref["counters"].items() if k.startswith("serve.")}
    assert serve_counters["serve.requests"] == 4 and serve_counters["serve.batches"] == 2
    gauges = {k: v for k, v in mine["gauges"].items() if k.startswith("serve")}
    assert gauges == {k: v for k, v in ref["gauges"].items() if k.startswith("serve")}
    assert mine["spans"]["serve:batch"]["count"] == ref["spans"]["serve:batch"]["count"] == 2
    assert eng.slo.state()["events_long"] == reng.slo.state()["events_long"] == 4


def test_metrics_server_on_loopback(engines):
    eng, _ = engines(min_bucket=8)
    eng.predict("acme", "lasso", payload(3))
    srv = eng.start_metrics_server(port=0)
    assert eng.start_metrics_server() is srv
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=10)
    try:
        conn.request("GET", "/varz")
        varz = json.loads(conn.getresponse().read())
        conn.request("GET", "/healthz")
        assert conn.getresponse().status == 200
        conn.request("GET", "/metrics")
        assert conn.getresponse().status == 200
    finally:
        conn.close()
    assert varz["serve"]["requests"] == 1
    assert varz["lanes"] == [{"tenant": "acme", "model": "lasso", "version": 1, "queue_depth": 0}]
    eng.close()
    assert eng._metrics is None
