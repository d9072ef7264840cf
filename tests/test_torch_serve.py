"""``heat_tpu_torch.serve``'s registry, batcher and load generator held
against ``heat_tpu.serve`` on the same inputs.

* The registry: the port publishes into the reference's tree layout
  (``<root>/<tenant>/<model>/v<N>.h5``) and each package lists, resolves
  and loads what the other published; typed errors carry the reference's
  messages; executable sidecars (``v<N>.aotx``) hold the port's AOT
  bundles and install them (HDF5 needs ``h5py``, present here).
* The batcher: buckets, padded buffers, masks and FIFO coalescing
  bitwise the reference's; the staging pool's donation path
  byte-identical to a fresh pack.
* The load generator: schedules and payloads bitwise, and a run's reply
  checksum, degraded tuple and batch accounting equal to the reference's
  on the same seed (KMeans, fitted by the reference and loaded by both).

Engines are closed and their threads joined in every test
(``tests/test_torch_serve_engine.py`` holds the engine's replies).
"""

import os
import shutil

import numpy as np
import pytest

import jax

import heat_tpu as ht
from heat_tpu import resilience as rresilience
from heat_tpu.core import communication as rcomm
from heat_tpu.resilience import incidents as rincidents
from heat_tpu.serve import registry as rreg
from heat_tpu.serve import (
    MicroBatcher as RMicroBatcher,
    ModelRegistry as RRegistry,
    ServeEngine as REngine,
    StagingPool as RStagingPool,
    bucket_rows as rbucket_rows,
    loadgen as rloadgen,
    pad_batch as rpad_batch,
)
from test_torch_reference_state import reference_state  # noqa: F401  (restores the JAX package's state)

import heat_tpu_torch as htt
from heat_tpu_torch import resilience, serve, telemetry
from heat_tpu_torch.core import communication as tcomm
from heat_tpu_torch.resilience import incidents
from heat_tpu_torch.serve import (
    ManifestError,
    MicroBatcher,
    ModelNotFoundError,
    ModelRegistry,
    RegistryError,
    ServeEngine,
    StagingPool,
    VersionNotFoundError,
    bucket_rows,
    loadgen,
    pad_batch,
)

P = len(jax.devices())
RNG = np.random.default_rng(42)
Xn = RNG.normal(size=(64, 5)).astype(np.float32)
yn = RNG.integers(0, 3, 64).astype(np.int32)


def payload(rows, seed=0):
    return np.random.default_rng(seed).normal(size=(rows, 5)).astype(np.float32)


def fit_reference():
    """The reference's four served estimators, fitted as its
    ``tests/test_serve.py`` fits them."""
    X, y = ht.array(Xn, split=0), ht.array(yn, split=0)
    return {
        "km": ht.cluster.KMeans(n_clusters=3, max_iter=5, random_state=0).fit(X),
        "nb": ht.naive_bayes.GaussianNB().fit(X, y),
        "knn": ht.classification.KNN(X, y, 3),
        "lasso": ht.regression.lasso.Lasso(max_iter=15).fit(X, ht.array(Xn[:, :1].copy(), split=0)),
    }


@pytest.fixture(scope="module")
def published(tmp_path_factory):
    """A registry tree the reference published: tenant ``acme``, one
    version of each estimator."""
    root = str(tmp_path_factory.mktemp("serve") / "models")
    reg = RRegistry(root)
    for name, est in fit_reference().items():
        reg.publish("acme", name, est)
    return root


@pytest.fixture
def positions(request):
    """Both packages' default communicators at ``p`` positions (the
    parameter, default 8), restored after the test."""
    p = getattr(request, "param", P)
    prev, rprev = tcomm._default_comm, rcomm._default_comm
    htt.use_comm(htt.TorchCommunication(["cpu"] * p))
    rcomm._default_comm = rcomm.XlaCommunication(jax.devices()[:p])
    yield p
    htt.use_comm(prev)
    rcomm._default_comm = rprev


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


# --------------------------------------------------------------------- #
# registry                                                                #
# --------------------------------------------------------------------- #
def test_publish_lays_out_the_references_tree_both_ways(tmp_path, published, positions):
    """The port re-publishes the reference's estimators into a tree of its
    own: the same files, and each registry reads the other's."""
    shutil.copytree(published, str(tmp_path / "ref"))
    ref = RRegistry(str(tmp_path / "ref"))
    mine = ModelRegistry(str(tmp_path / "port"))
    for name in ("km", "nb", "knn", "lasso"):
        est, version = ModelRegistry(published).load("acme", name)
        assert version == 1
        assert mine.publish("acme", name, est) == 1
    assert mine.publish("acme", "km", ModelRegistry(published).load("acme", "km")[0]) == 2
    ref.publish("acme", "km", ref.load("acme", "km")[0])
    assert _tree(mine.root) == _tree(ref.root)
    assert mine.tenants() == ref.tenants() == ["acme"]
    assert mine.models("acme") == ref.models("acme") == ["km", "knn", "lasso", "nb"]
    assert mine.versions("acme", "km") == ref.versions("acme", "km") == [1, 2]
    assert mine.resolve("acme", "km") == (2, os.path.join(mine.root, "acme", "km", "v2.h5"))
    # each reads the other's files and predicts alike
    x = payload(9, seed=1)
    for name in ("km", "nb", "knn", "lasso"):
        theirs = RRegistry(mine.root, max_cached=0).load("acme", name)[0]
        ours = ModelRegistry(published, max_cached=0).load("acme", name)[0]
        np.testing.assert_array_equal(
            np.asarray(theirs.predict(ht.array(x, split=0)).numpy()),
            ours.predict(htt.array(x, split=0)).numpy(), err_msg=name)


def _messages(fn_mine, fn_ref, cls_mine, cls_ref):
    with pytest.raises(cls_mine) as mine:
        fn_mine()
    with pytest.raises(cls_ref) as ref:
        fn_ref()
    assert str(mine.value) == str(ref.value)


def test_typed_errors_carry_the_references_messages(tmp_path, published, positions):
    mine, ref = ModelRegistry(published), RRegistry(published)

    cases = [
        (lambda r: r.resolve("acme", "nope"), ModelNotFoundError, rreg.ModelNotFoundError),
        (lambda r: r.resolve("acme", "km", 9), VersionNotFoundError, rreg.VersionNotFoundError),
        (lambda r: r.resolve("../x", "km"), RegistryError, rreg.RegistryError),
        (lambda r: r.resolve("acme", ""), RegistryError, rreg.RegistryError),
        (lambda r: r.publish("acme", "km", None, version=1), RegistryError, rreg.RegistryError),
        (lambda r: r.publish("acme", "new", None, version=0), RegistryError, rreg.RegistryError),
        (lambda r: r.publish_executables("acme", "km", 7, []), VersionNotFoundError,
         rreg.VersionNotFoundError),
    ]
    for call, cls, rcls in cases:
        _messages(lambda: call(mine), lambda: call(ref), cls, rcls)
    with pytest.raises(RegistryError):
        ModelRegistry("")
    # a corrupt version file names tenant, model and version in both
    root = str(tmp_path / "corrupt")
    for r in (ModelRegistry(root), RRegistry(root)):
        os.makedirs(os.path.join(root, "acme", "km"), exist_ok=True)
    with open(os.path.join(root, "acme", "km", "v1.h5"), "wb") as fh:
        fh.write(b"not hdf5 at all")
    with pytest.raises(ManifestError, match="tenant='acme' model='km'"):
        ModelRegistry(root).load("acme", "km")
    with pytest.raises(rreg.ManifestError, match="tenant='acme' model='km'"):
        RRegistry(root).load("acme", "km")


def test_load_caches_one_estimator_per_version(published, positions):
    reg = ModelRegistry(published, max_cached=2)
    a, _ = reg.load("acme", "km")
    b, _ = reg.load("acme", "km")
    assert a is b
    reg.load("acme", "nb")
    reg.load("acme", "knn")  # evicts km, the least recently used
    c, _ = reg.load("acme", "km")
    assert c is not a and isinstance(c, htt.cluster.KMeans)
    fresh = ModelRegistry(published, max_cached=0)
    assert fresh.load("acme", "nb")[0] is not fresh.load("acme", "nb")[0]


def test_executable_sidecars_publish_load_and_warm(tmp_path, published, positions):
    """``export_warm`` captures the lane's programs (one per bucket and
    layout), the sidecar sits beside the version as ``v<N>.aotx``, and a
    fresh engine installs every bundle: its requests then build nothing."""
    root = str(tmp_path / "aot")
    reg = ModelRegistry(root)
    reg.publish("acme", "km", ModelRegistry(published).load("acme", "km")[0])
    eng = ServeEngine(reg, max_batch_rows=16, min_bucket=8)
    try:
        bundles = eng.export_warm("acme", "km")
    finally:
        eng.close()
    # buckets 8 and 16, each row-split and replicated at 8 positions
    assert len(bundles) == (4 if positions > 1 else 2)
    path = reg.publish_executables("acme", "km", 1, bundles)
    assert path == os.path.join(root, "acme", "km", "v1.aotx")
    assert reg.versions("acme", "km") == [1]  # the sidecar is not a version
    with pytest.raises(RegistryError, match="immutable"):
        reg.publish_executables("acme", "km", 1, bundles)
    got, version = reg.load_executables("acme", "km")
    assert version == 1 and len(got) == len(bundles)
    assert reg.load_executables("acme", "km", None)[0][0]["fn"] == bundles[0]["fn"]
    htt.fuse.clear_cache()
    eng = ServeEngine(reg, max_batch_rows=16, min_bucket=8)
    telemetry.enable()
    telemetry.reset()
    try:
        assert eng.warm("acme", "km") == len(bundles)
        futs = [eng.submit("acme", "km", payload(r, seed=r)) for r in (3, 4, 6)]
        eng.flush()
        [f.result() for f in futs]
        eng.direct_predict("acme", "km", payload(8, seed=9))
        counters = telemetry.snapshot()["counters"]
        assert counters.get("fuse.cache.misses", 0) == 0
        assert counters["aot.installed"] == len(bundles)
    finally:
        telemetry.disable()
        telemetry.reset()
        eng.close()
    # no sidecar: the cold rung, not an error
    assert ModelRegistry(published).load_executables("acme", "nb") == ([], 1)


# --------------------------------------------------------------------- #
# batcher                                                                 #
# --------------------------------------------------------------------- #
def test_buckets_equal_the_references():
    for n in range(1, 130):
        for lo in (1, 2, 8, 64):
            assert bucket_rows(n, min_bucket=lo) == rbucket_rows(n, min_bucket=lo)
    for fn in (bucket_rows, rbucket_rows):
        with pytest.raises(ValueError, match="at least one row"):
            fn(0)


@pytest.mark.parametrize("rows", [[1], [3, 2], [5, 4, 7], [8], [16], [1, 1, 1, 1, 1]])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32])
def test_padding_and_masks_bitwise_the_references(rows, dtype):
    pays = [payload(r, seed=10 + i).astype(dtype) for i, r in enumerate(rows)]
    bucket = bucket_rows(sum(rows), min_bucket=8)
    buf, mask = pad_batch(pays, bucket)
    rbuf, rmask = rpad_batch(pays, bucket)
    assert buf.dtype == rbuf.dtype and buf.tobytes() == rbuf.tobytes()
    assert mask.tobytes() == rmask.tobytes()
    pool, rpool = StagingPool(), RStagingPool()
    out, rout = pool.get(bucket, 5, dtype), rpool.get(bucket, 5, dtype)
    out[:] = 7  # dirty, as after a previous batch
    rout[:] = 7
    assert pad_batch(pays, bucket, out=out)[0] is out
    rpad_batch(pays, bucket, out=rout)
    assert out.tobytes() == rout.tobytes() == buf.tobytes()
    assert len(pool) == 1 and pool.get(bucket, 5, dtype) is out


def test_padding_errors_equal_the_references():
    cases = [([payload(9)], 8, None), ([payload(2), payload(2).astype(np.float64)], 8, None),
             ([], 8, None), ([payload(3)], 8, np.zeros((4, 5), np.float32))]
    for pays, bucket, out in cases:
        with pytest.raises(ValueError) as mine:
            pad_batch(pays, bucket, out=out)
        with pytest.raises(ValueError) as ref:
            rpad_batch(pays, bucket, out=out)
        assert str(mine.value) == str(ref.value)


def test_micro_batcher_coalesces_as_the_references():
    rows = (3, 3, 3, 7, 9, 1, 8, 2, 2, 2, 2)
    seen, rseen = [], []
    mb = MicroBatcher(lambda reqs: seen.append([(r.seq, r.rows, r.trace_id) for r in reqs]),
                      max_batch_rows=8, name="lane")
    rmb = RMicroBatcher(lambda reqs: rseen.append([(r.seq, r.rows, r.trace_id) for r in reqs]),
                        max_batch_rows=8, name="lane")
    for r in rows:
        mb.submit(payload(r))
        rmb.submit(payload(r))
    assert mb.queue_depth == rmb.queue_depth == len(rows)
    assert mb.flush() == rmb.flush()
    assert mb.drain() == rmb.drain()
    assert seen == rseen and seen[0] == [(1, 3, "lane#1"), (2, 3, "lane#2")]
    for b in (mb, rmb):
        b.close()
    with pytest.raises(serve.ServeClosedError, match="is closed"):
        mb.submit(payload(1))


def test_micro_batcher_sheds_with_the_references_hint():
    mb = MicroBatcher(lambda reqs: None, max_batch_rows=4, max_queue_rows=6)
    rmb = RMicroBatcher(lambda reqs: None, max_batch_rows=4, max_queue_rows=6)
    for b in (mb, rmb):
        b.submit(payload(5))
    with pytest.raises(serve.ServeOverloadError) as mine:
        mb.submit(payload(2))
    with pytest.raises(Exception) as ref:
        rmb.submit(payload(2))
    assert str(mine.value) == str(ref.value)
    assert (mine.value.retry_after_s, mine.value.queue_rows, mine.value.max_queue_rows) == (
        ref.value.retry_after_s, ref.value.queue_rows, ref.value.max_queue_rows)
    assert mb.n_shed == rmb.n_shed == 1
    for b in (mb, rmb):
        b.close(drain=False)


def test_micro_batcher_background_worker_and_close_without_drain():
    done = []
    mb = MicroBatcher(lambda reqs: [done.append(r.seq) or r.future.set_result(r.rows) for r in reqs],
                      max_batch_rows=4, max_delay_s=0.005)
    mb.start()
    futs = [mb.submit(payload(1, seed=s)) for s in range(6)]
    assert [f.result(timeout=30) for f in futs] == [1] * 6
    mb.close()
    assert mb._worker is None and sorted(done) == list(range(1, 7))
    idle = MicroBatcher(lambda reqs: None, max_batch_rows=4)
    fut = idle.submit(payload(1))
    idle.close(drain=False)
    with pytest.raises(serve.ServeClosedError, match="abandoned"):
        fut.result(timeout=5)


# --------------------------------------------------------------------- #
# loadgen                                                                 #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_schedule_and_payloads_bitwise_the_references(seed):
    kw = dict(n_requests=40, rate_hz=900.0, min_rows=1, max_rows=8)
    sched, rsched = loadgen.schedule(seed, **kw), rloadgen.schedule(seed, **kw)
    assert [(a.t, a.rows) for a in sched] == [(a.t, a.rows) for a in rsched]
    for a, b in zip(loadgen.payloads(sched, 5, seed=seed), rloadgen.payloads(rsched, 5, seed=seed)):
        assert a.tobytes() == b.tobytes()
    lat = [a.t / 100 for a in sched]
    assert loadgen.latency_hist_ms(lat).state() == rloadgen.latency_hist_ms(lat).state()
    st = [loadgen.latency_hist_ms(lat[:20]).state(), loadgen.latency_hist_ms(lat[20:]).state()]
    assert loadgen.merge_percentiles_ms(st) == rloadgen.merge_percentiles_ms(st)
    assert loadgen._percentiles_ms([]) == rloadgen._percentiles_ms([]) == (0.0, 0.0)


def test_chaos_seed_env(monkeypatch):
    monkeypatch.setenv("HEAT_CHAOS_SEED", "123")
    assert loadgen.chaos_seed() == rloadgen.chaos_seed() == 123
    assert loadgen.schedule(n_requests=4) == loadgen.schedule(123, n_requests=4)


def _report_fields(rep):
    return (rep.n_requests, rep.rows, rep.degraded, rep.checksum, rep.batches, rep.dispatches,
            rep.dispatches_per_batch, rep.batch_occupancy, rep.payload_bytes, rep.reply_bytes,
            rep.trace_ids)


@pytest.mark.parametrize("positions", [1, P], indirect=True)
def test_loadgen_report_equals_the_references(published, positions):
    """The same seed through both engines: the reply checksum, the batch
    accounting and the trace ids agree, and each twin is bitwise."""
    eng = ServeEngine(ModelRegistry(published), max_batch_rows=32, min_bucket=8)
    reng = REngine(RRegistry(published), max_batch_rows=32, min_bucket=8)
    try:
        for seed in (11, 12):
            rep = loadgen.run(eng, "acme", "km", seed=seed, n_requests=24, twin=True)
            rrep = rloadgen.run(reng, "acme", "km", seed=seed, n_requests=24, twin=True)
            assert _report_fields(rep) == _report_fields(rrep)
            assert rep.twin["bitwise_equal"] and rep.twin["compared"] == 24
            assert rep.dispatches_per_batch == 1.0
            assert rep.predictions_per_sec > 0 and rep.p99_ms > 0
            again = loadgen.run(eng, "acme", "km", seed=seed, n_requests=24, twin=False)
            ragain = rloadgen.run(reng, "acme", "km", seed=seed, n_requests=24, twin=False)
            assert again.checksum == rep.checksum
            assert _report_fields(again) == _report_fields(ragain)
    finally:
        eng.close()
        reng.close()


def test_loadgen_chaos_poisons_what_the_references_poisons(published, positions):
    eng = ServeEngine(ModelRegistry(published), max_batch_rows=64, min_bucket=8)
    reng = REngine(RRegistry(published), max_batch_rows=64, min_bucket=8)
    incidents.clear_incident_log()
    rincidents.clear_incident_log()
    try:
        with resilience.inject("nonfinite", nth=(3, 7)):
            rep = loadgen.run(eng, "acme", "km", seed=11, n_requests=12, twin=True)
        with rresilience.inject("nonfinite", nth=(3, 7)):
            rrep = rloadgen.run(reng, "acme", "km", seed=11, n_requests=12, twin=True)
        assert rep.degraded == rrep.degraded == (2, 6)
        assert rep.checksum == rrep.checksum
        assert rep.twin["bitwise_equal"] and rep.twin["compared"] == 10
        kinds = [(i.kind, i.site, i.policy, i.action) for i in incidents.incident_log()
                 if i.kind == "poisoned-payload"]
        rkinds = [(i.kind, i.site, i.policy, i.action) for i in rincidents.incident_log()
                  if i.kind == "poisoned-payload"]
        assert kinds == rkinds and len(kinds) == 2
    finally:
        eng.close()
        reng.close()
        incidents.clear_incident_log()
        rincidents.clear_incident_log()
