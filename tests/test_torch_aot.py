"""AOT recipe bundles of fused programs (``heat_tpu_torch.core.aot``):
export, install, and the fingerprint and topology gates, against the
reference's ``heat_tpu/core/aot.py`` contract.

A bundle holds a program's recipe (function, keyparts, out_meta, operand
specs), not an executable: a CUDA graph cannot be serialized.  Install
rebuilds the program into the fuse cache (on the card it also captures it
on zero-filled inputs), so the next call of the captured pipeline is a
replay: ``fuse.cache.misses`` stays 0, and the results are bitwise the
pre-export ones.  A bundle whose fingerprint or topology does not match,
whose function does not resolve, or that the JAX package exported, is
skipped.
"""

import pickle

import numpy as np
import pytest
import torch

import jax

import heat_tpu as ht
from test_torch_reference_state import reference_state  # noqa: F401,E402  (restores the JAX package's state)

import heat_tpu_torch as htt
from heat_tpu_torch.core import _compile, aot
from heat_tpu_torch.core import communication as tcomm
from heat_tpu_torch.core.fuse import fuse
from heat_tpu_torch.resilience import guards
from heat_tpu_torch.telemetry import _core as ptel

P = len(jax.devices())


@pytest.fixture
def port():
    comm = htt.TorchCommunication(["cpu"] * P)
    prev = tcomm._default_comm
    htt.use_comm(comm)
    was = ptel.enabled
    policy = guards.get_guard_policy()
    yield comm
    htt.use_comm(prev)
    guards.set_guard_policy(policy)
    ptel.reset()
    if not was:
        ptel.disable()


def _served(mod, comm=None):
    """The library's fused programs as a server would call them: fitted
    estimators, an input and the calls (``mod`` is ``ht`` or ``htt``)."""
    rng = np.random.default_rng(31)
    data = rng.standard_normal((40, 4)).astype(np.float32)
    kw = {} if comm is None else {"comm": comm}
    x = mod.array(data, split=0, **kw)
    km = mod.cluster.KMeans(n_clusters=3, init=mod.array(data[:3], **kw), max_iter=3).fit(x)
    nb = mod.naive_bayes.GaussianNB().fit(x, mod.array(rng.integers(0, 3, 40), split=0, **kw))
    la = mod.regression.Lasso(max_iter=5).fit(x, mod.array(rng.standard_normal(40).astype(np.float32),
                                                           split=0, **kw))
    calls = [km.predict, nb.predict, nb.predict_log_proba, nb.predict_proba, la.predict,
             lambda v: mod.kurtosis(v, axis=0), lambda v: mod.skew(v, axis=0)]
    return x, calls


def _export(calls, x):
    with aot.capture_programs() as cap:
        before = [c(x).numpy() for c in calls]
    return aot.export_programs(cap), before


def test_fingerprint_pins_versions_device_and_policy(port):
    fp = aot.fingerprint()
    assert fp[:5] == ("heat_tpu_torch/1", torch.__version__, torch.version.cuda, "cpu", 0)
    assert fp[5] == _compile.context_token()
    with guards.guard("warn"):
        assert aot.fingerprint() != fp


def test_export_install_replays_bitwise_with_no_miss(port):
    fuse.clear_cache()
    x, calls = _served(htt)
    bundles, before = _export(calls, x)
    assert len(bundles) == len(calls)
    bundles = pickle.loads(pickle.dumps(bundles))
    fuse.clear_cache()
    assert aot.install_programs(bundles, comm=port) == len(calls)
    assert fuse.cache_size() == len(calls)
    ptel.reset()
    ptel.enable()
    after = [c(x).numpy() for c in calls]
    counters = ptel.snapshot()["counters"]
    assert counters.get("fuse.cache.misses", 0) == 0
    assert counters["fuse.cache.hits"] == len(calls)
    for a, b in zip(before, after):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_install_counts_installed_bundles(port):
    fuse.clear_cache()
    x, calls = _served(htt)
    bundles, _ = _export(calls[:2], x)
    ptel.reset()
    ptel.enable()
    assert aot.install_programs(bundles, comm=port) == 2
    snap = ptel.snapshot()
    assert snap["counters"]["aot.installed"] == 2
    assert snap["gauges"]["fuse.cache.size"] == fuse.cache_size()


def test_mismatched_fingerprint_topology_or_function_is_skipped(port):
    fuse.clear_cache()
    x, calls = _served(htt)
    bundles, _ = _export(calls[:1], x)
    (b,) = bundles
    fuse.clear_cache()
    wrong = [dict(b, fingerprint=b["fingerprint"][:-1] + (("other",),)),
             dict(b, comm_size=b["comm_size"] + 1),
             dict(b, mesh_shape=(2, P // 2)),
             dict(b, fn=("heat_tpu_torch.core.statistics", "no_such_program"))]
    assert aot.install_programs(wrong, comm=port) == 0
    assert aot.install_programs(bundles, comm=htt.TorchCommunication(["cpu"] * (P // 2))) == 0
    assert aot.install_programs(bundles, comm=htt.grid_comm((2, P // 2), ["cpu"] * P)) == 0
    with guards.guard("warn"):  # another policy: another fingerprint
        assert aot.install_programs(bundles, comm=port) == 0
    assert fuse.cache_size() == 0
    assert aot.install_programs(bundles, comm=port) == 1


def test_programs_without_a_sound_recipe_are_dropped(port):
    fuse.clear_cache()
    a = htt.array(np.ones((8, 2), np.float32), split=0)
    b = htt.array(np.ones((8, 2), np.float32), split=0, comm=htt.TorchCommunication(["cpu"] * 2))
    with aot.capture_programs() as cap:
        fuse(_no_dndarray)(torch.ones(3))
        fuse(_mixed)(a, b)
        fuse(lambda v: v + 1.0)(a)  # transient: no cache key, nothing captured
    assert len(cap) == 2
    assert aot.export_programs(cap) == []


def _no_dndarray(t):
    return t * 2.0


def _mixed(a, b):
    return a + 1.0, b + 1.0


def test_guarded_program_keeps_its_flag(port):
    fuse.clear_cache()
    x, calls = _served(htt)
    with guards.guard("degrade"):
        bundles, before = _export(calls[-2:], x)
        assert all(b["guarded"] for b in bundles)
        fuse.clear_cache()
        assert aot.install_programs(bundles, comm=port) == 2
        after = [c(x).numpy() for c in calls[-2:]]
    assert all(a.tobytes() == b.tobytes() for a, b in zip(before, after))


def test_reference_bundles_are_skipped(port):
    """Bundles the JAX package exported carry its own fingerprint (its
    executables, another format): the port installs none of them."""
    from heat_tpu.core import aot as raot

    rx, rcalls = _served(ht)
    with raot.capture_programs() as cap:
        for c in rcalls:
            c(rx)
    ref_bundles = raot.export_programs(cap)
    assert ref_bundles  # the reference serializes its CPU executables
    fuse.clear_cache()
    assert aot.install_programs(ref_bundles, comm=port) == 0
    assert fuse.cache_size() == 0
    assert all(b["fingerprint"] != aot.fingerprint() for b in ref_bundles)
