"""Elastic resume and recovery, and the deadline watchdog, held against
the JAX package.

Here positions share one device, so another mesh is another number of
positions on it (the reference's: another number of its 8 CPU devices).

* ``migrate_stacked`` / ``migrate_state`` equal the reference's, with
  the same incidents;
* the mini-batch KMeans and Lasso killed at 8 (4) positions and resumed
  with ``resume="elastic"`` at 4, 2 (8, 4) are bitwise the uninterrupted
  fit at the new count (they compute on the mesh-independent chunk);
* Lasso gd exact and ``int8_block``, KMeans and ``lanczos`` recovered by
  ``elastic.recover`` (shrink) or ``elastic.grow`` are bitwise a twin
  resumed elastically from a copy of the same snapshot, with the
  reference's incident sequence; an ``int8_block`` KMeans snapshot
  resumed at one position lands on the exact path (the quantized extras
  dropped), as the reference's;
* the snapshot probe of a recovery heals a transient ``OSError``;
* the deadline watchdog's budgets, its ``suspected-lost`` classification
  and ``dispatch_guard`` behave as the reference's under the
  deterministic clock, raising the same errors.
"""

import itertools
import shutil

import numpy as np
import pytest

import jax

import heat_tpu as ht
from heat_tpu import telemetry as rtel
from heat_tpu.core.communication import XlaCommunication
from heat_tpu.resilience import elastic as relastic
from heat_tpu.resilience import faults as rfaults
from heat_tpu.resilience import incidents as rincidents
from heat_tpu.resilience import retry as rretry
from test_torch_reference_state import reference_state  # noqa: F401,E402  (restores the JAX package's state)

import heat_tpu_torch as htt
from heat_tpu_torch import telemetry as tel
from heat_tpu_torch.core.linalg import solver
from heat_tpu_torch.io import stream
from heat_tpu_torch.resilience import elastic, faults, incidents, retry

RNG = np.random.default_rng(41)
XK = np.concatenate([RNG.normal(size=(40, 4)) + 4, RNG.normal(size=(40, 4)) - 4]).astype(np.float32)
XL = RNG.normal(size=(64, 6)).astype(np.float32)
YL = (XL @ np.array([1.5, 0, -2, 0, 0.7, 0], np.float32) + 0.01 * RNG.normal(size=64)).astype(np.float32)
PKGS = {"port": (htt, faults, elastic, incidents), "ref": (ht, rfaults, relastic, rincidents)}


@pytest.fixture(autouse=True)
def _clean():
    def scrub():
        for f, i, e, r, t in ((faults, incidents, elastic, retry, tel), (rfaults, rincidents, relastic, rretry, rtel)):
            f.clear()
            i.clear_incident_log()
            e.set_watchdog(None)
            r.set_sleep(None)
            t.set_clock(None)
            t.disable()
            t.reset()
        start = max(next(incidents._SEQ), next(rincidents._SEQ))
        incidents._SEQ = itertools.count(start)
        rincidents._SEQ = itertools.count(start)

    scrub()
    yield
    scrub()


def _comm(pkg, p):
    if len(jax.devices()) < p:
        pytest.skip(f"needs {p} devices")
    return htt.TorchCommunication(["cpu"] * p) if pkg is htt else XlaCommunication(jax.devices()[:p])


def _bits(a):
    a = a.numpy() if isinstance(a, htt.DNDarray) else np.asarray(a.larray)
    return np.ascontiguousarray(a).view(np.uint8).tobytes()


def _incidents(i):
    return [(e.kind, e.site, e.policy, e.action, e.detail) for e in i.incident_log()]


# --------------------------------------------------------------------- #
# carry migration                                                         #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("old,new", [(8, 4), (8, 7), (4, 8), (3, 1), (5, 5)])
def test_migration_equals_the_reference(old, new):
    arr = RNG.normal(size=(old, 9)).astype(np.float32)
    np.testing.assert_array_equal(elastic.migrate_stacked(arr, new), relastic.migrate_stacked(arr, new))
    state = {"e": arr, "t": np.arange(3.0), "it": np.int32(4)}
    meta = {"mesh": old, "splits": {"e": "mesh", "t": None, "it": None}}
    mine, ref = elastic.migrate_state(state, meta, new), relastic.migrate_state(state, meta, new)
    assert mine.keys() == ref.keys()
    for k in mine:
        np.testing.assert_array_equal(np.asarray(mine[k]), np.asarray(ref[k]))
    assert _incidents(incidents) == _incidents(rincidents)
    for mod in (elastic, relastic):
        with pytest.raises(ValueError, match="leading mesh axis"):
            mod.migrate_stacked(np.float32(1.0), 2)
        with pytest.raises(ValueError, match="must be >= 1"):
            mod.migrate_stacked(arr, 0)


# --------------------------------------------------------------------- #
# elastic resume of the mini-batch fits: bitwise at any count             #
# --------------------------------------------------------------------- #
def _mb(kind, comm, **kw):
    if kind == "kmeans":
        est = htt.cluster.KMeans(n_clusters=2, mini_batch=16, max_iter=3, random_state=3, **kw)
        return est, (stream.ArraySource(XK),), lambda e: e.cluster_centers_
    est = htt.regression.Lasso(lam=0.01, solver="gd", mini_batch=16, max_iter=3, **kw)
    return est, (stream.ArraySource(XL), stream.ArraySource(YL)), lambda e: e.theta


@pytest.mark.parametrize("kind", ["kmeans", "lasso"])
@pytest.mark.parametrize("old,new", [(8, 4), (4, 2), (2, 4), (4, 8)])
def test_minibatch_elastic_resume_is_bitwise_the_fit_at_the_new_count(tmp_path, kind, old, new):
    path = str(tmp_path / "mb.h5")
    small, big = _comm(htt, new), _comm(htt, old)
    clean, data, out = _mb(kind, small)
    clean.fit(*data, comm=small)
    est, data, _ = _mb(kind, big, checkpoint_every=4, checkpoint_path=path)
    with pytest.raises(faults.DeviceLossError):
        with faults.inject("device_loss", site="iteration", nth=1):
            est.fit(*data, comm=big)
    est2, data, _ = _mb(kind, small, checkpoint_every=4, checkpoint_path=path)
    est2.fit(*data, resume="elastic", comm=small)
    assert _bits(out(est2)) == _bits(out(clean))


# --------------------------------------------------------------------- #
# recover and grow                                                        #
# --------------------------------------------------------------------- #
def _lasso(pkg, **kw):
    return pkg.regression.Lasso(lam=0.01, max_iter=30, tol=0.0, solver="gd", **kw)


def _lasso_data(pkg, comm):
    return pkg.array(XL, split=0, comm=comm), pkg.array(YL.reshape(-1, 1), split=0, comm=comm)


@pytest.mark.parametrize("old,new,policy", [(8, 4, None), (8, 4, "int8_block"), (4, 2, "int8_block"),
                                            (2, 4, "int8_block"), (4, 8, None)])
def test_lasso_recover_and_grow_are_bitwise_the_twin(tmp_path, old, new, policy):
    logs = []
    for name in ("port", "ref"):
        pkg, f, e, i = PKGS[name]
        p, twin = str(tmp_path / f"{name}.h5"), str(tmp_path / f"{name}_twin.h5")
        with pkg.comm.collective_precision(policy or "f32"):
            est = _lasso(pkg, checkpoint_every=7, checkpoint_path=p)
            with pytest.raises(f.DeviceLossError):
                with f.inject("device_loss", site="iteration", nth=2):
                    est.fit(*_lasso_data(pkg, _comm(pkg, old)))
            shutil.copyfile(p, twin)
            data = _lasso_data(pkg, _comm(pkg, new))
            out = (e.recover if new < old else e.grow)(est, p, *data, comm=_comm(pkg, new))
            other = _lasso(pkg, checkpoint_every=7, checkpoint_path=twin).fit(*data, resume="elastic")
        assert _bits(out.theta) == _bits(other.theta) and out.n_iter == other.n_iter == 30
        logs.append([x[:4] for x in _incidents(i)])
    assert logs[0] == logs[1]


def test_kmeans_and_lanczos_recover_bitwise_the_twin(tmp_path):
    p, twin = str(tmp_path / "km.h5"), str(tmp_path / "km_twin.h5")
    kw = dict(n_clusters=2, max_iter=20, tol=0.0, random_state=5)
    est = htt.cluster.KMeans(**kw, checkpoint_every=2, checkpoint_path=p)
    with pytest.raises(faults.DeviceLossError):
        with faults.inject("device_loss", site="iteration", nth=1):
            est.fit(htt.array(XK, split=0, comm=_comm(htt, 8)))
    shutil.copyfile(p, twin)
    xs = htt.array(XK, split=0, comm=_comm(htt, 4))
    out = elastic.recover(est, p, xs, comm=xs.comm)
    other = htt.cluster.KMeans(**kw, checkpoint_every=2, checkpoint_path=twin).fit(xs, resume="elastic")
    assert _bits(out.cluster_centers_) == _bits(other.cluster_centers_) and out.n_iter_ == other.n_iter_
    assert _bits(out.labels_) == _bits(other.labels_)

    m = RNG.normal(size=(20, 20)).astype(np.float32)
    m = m @ m.T
    lz, lz_twin = str(tmp_path / "lz.h5"), str(tmp_path / "lz_twin.h5")
    htt.random.seed(99)
    with pytest.raises(faults.DeviceLossError):
        with faults.inject("device_loss", site="iteration", nth=1):
            solver.lanczos(htt.array(m, split=0, comm=_comm(htt, 8)), 9, checkpoint_every=3, checkpoint_path=lz)
    shutil.copyfile(lz, lz_twin)
    a2 = htt.array(m, split=0, comm=_comm(htt, 2))
    V1, T1 = elastic.recover(
        lambda: solver.lanczos(a2, 9, checkpoint_every=3, checkpoint_path=lz, resume="elastic"), lz, comm=a2.comm)
    V2, T2 = solver.lanczos(a2, 9, checkpoint_every=3, checkpoint_path=lz_twin, resume="elastic")
    assert _bits(V1) == _bits(V2) and _bits(T1) == _bits(T2)


def test_quantized_kmeans_snapshot_resumes_on_the_exact_path_at_one_position(tmp_path):
    """An ``int8_block`` snapshot resumed elastically at one position
    continues on the exact loop with the reference's step count, and the
    port reads the reference's quantized snapshot the same way."""
    results = {}
    for name in ("port", "ref"):
        pkg, f, e, i = PKGS[name]
        p = str(tmp_path / f"{name}.h5")
        kw = dict(n_clusters=2, init=pkg.array(np.array([[3.0] * 4, [-3.0] * 4], np.float32), comm=_comm(pkg, 1)),
                  max_iter=9, tol=-1.0, checkpoint_every=3, checkpoint_path=p)
        with pkg.comm.collective_precision("int8_block"):
            with pytest.raises(f.DeviceLossError):
                with f.inject("device_loss", site="iteration", nth=1):
                    pkg.cluster.KMeans(**kw).fit(pkg.array(XK, split=0, comm=_comm(pkg, 4)))
            with pytest.raises(ValueError, match="written by 'kmeans-q', not 'kmeans'"):
                pkg.cluster.KMeans(**kw).fit(pkg.array(XK, split=0, comm=_comm(pkg, 1)), resume=True)
            est = pkg.cluster.KMeans(**kw).fit(pkg.array(XK, split=0, comm=_comm(pkg, 1)), resume="elastic")
        results[name] = (est.n_iter_, _bits(est.labels_))
    assert results["port"] == results["ref"]


def test_recovery_probe_heals_a_transient_io_error(tmp_path):
    logs = []
    for name in ("port", "ref"):
        pkg, f, e, i = PKGS[name]
        (retry if pkg is htt else rretry).set_sleep(lambda s: None)
        p = str(tmp_path / f"{name}.h5")
        est = _lasso(pkg, checkpoint_every=7, checkpoint_path=p)
        with pytest.raises(f.DeviceLossError):
            with f.inject("device_loss", site="iteration", nth=1):
                est.fit(*_lasso_data(pkg, _comm(pkg, 2)))
        with f.inject("io_error", nth=1, max_faults=1):
            out = e.recover(est, p, *_lasso_data(pkg, _comm(pkg, 1)), comm=_comm(pkg, 1))
        assert out.n_iter == 30
        logs.append([x[:4] for x in _incidents(i)])
    assert logs[0] == logs[1] and logs[0][0][:2] == ("OSError", "resume.load")


# --------------------------------------------------------------------- #
# the deadline watchdog                                                   #
# --------------------------------------------------------------------- #
def test_watchdog_budgets_and_classification_equal_the_reference():
    outs = []
    for name, t in (("port", tel), ("ref", rtel)):
        pkg, f, e, i = PKGS[name]
        t.enable(deterministic=True)
        wd = e.DeadlineWatchdog(factor=3.0, min_samples=3)
        budgets = [wd.budget("seg")]
        for _ in range(3):
            with wd.watch("seg"):
                pass
            budgets.append(wd.budget("seg"))
        with f.inject("slow_rank", site="seg", delay=10.0, rank=2):
            with pytest.raises(f.DeviceLossError) as err:
                with wd.watch("seg", comm=_comm(pkg, 4)):
                    pass
        assert (err.value.lost_rank, err.value.mesh_size, err.value.site) == (2, 4, "seg")
        outs.append((budgets, str(err.value), wd.observations("seg"), _incidents(i),
                     t.snapshot()["counters"]["resilience.watchdog.suspected"]))
        t.disable()
    assert outs[0] == outs[1]
    with pytest.raises(ValueError, match="factor must be > 1"):
        elastic.DeadlineWatchdog(factor=1.0)


def test_dispatch_guard_routes_through_the_armed_watchdog():
    tel.enable(deterministic=True)
    with elastic.dispatch_guard("seg"):
        pass
    wd = elastic.set_watchdog(elastic.DeadlineWatchdog(factor=3.0, min_samples=3))
    assert elastic.get_watchdog() is wd
    for _ in range(3):
        with elastic.dispatch_guard("seg"):
            pass
    with faults.inject("slow_rank", site="seg", delay=10.0):
        with pytest.raises(faults.DeviceLossError):
            with elastic.dispatch_guard("seg"):
                pass
    elastic.set_watchdog(None)
    with faults.inject("slow_rank", site="seg", delay=10.0) as plan:
        with elastic.dispatch_guard("seg"):
            pass
        assert plan.calls == 1


def test_watchdog_stops_a_slow_fit_segment(tmp_path):
    """An armed watchdog and a ``slow_rank`` plan on the fit's segment
    site stop a checkpointed fit as a lost rank, in both packages at the
    same segment."""
    its = []
    for name, t in (("port", tel), ("ref", rtel)):
        pkg, f, e, i = PKGS[name]
        t.enable(deterministic=True)
        e.set_watchdog(e.DeadlineWatchdog(factor=3.0, min_samples=2))
        p = str(tmp_path / f"{name}.h5")
        with pytest.raises(f.DeviceLossError, match="lasso.gd"):
            with f.inject("slow_rank", site="lasso.gd", delay=100.0, nth=3):
                _lasso(pkg, checkpoint_every=5, checkpoint_path=p).fit(*_lasso_data(pkg, _comm(pkg, 2)))
        its.append((pkg.resilience.load_loop_state(p)[1]["it"]))
        e.set_watchdog(None)
        t.disable()
    assert its[0] == its[1] == 10
