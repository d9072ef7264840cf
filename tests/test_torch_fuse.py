"""``htt.fuse`` held to the contract of the reference's ``tests/test_fuse.py``
and against the JAX package.

On the CPU a fused program is its plain traced call (the card captures it
as a CUDA graph: ``tests/test_torch_card.py``, ``chip_smoke.py`` phase 14),
so the port's fused result is bitwise its eager result: it runs the same
code.  Against the reference the tolerance is ``test_fuse.py``'s own
(``rtol=3e-7, atol=1e-7``: the reference's fused programs may
strength-reduce a constant divide); the fused ``kurtosis``/``skew`` are held
bitwise to the port's eager programs and to numpy's float64 moments within
``rtol=1e-5`` (float32 moments of 48 values).

The host-sync test runs every fused library pipeline and every
``test_fuse.py`` family with the tensor methods that synchronize the host
(``item``, ``tolist``, ``cpu``, ``numpy``, ``bool``/``float``/``int``,
``nonzero``, ``torch.unique``, boolean-mask indexing) and host-data tensor
constructors (``torch.tensor``, ``torch.as_tensor`` of host data: on the
card a pageable copy) made to raise while a trace is active: what would
break a capture on the card fails here.

The tests never clear the reference's caches or reset its dispatch
counter; ``reference_state`` puts its caches back at the file's end.
"""

import types as _pytypes

import numpy as np
import pytest
import torch

import jax

import heat_tpu as ht
from test_torch_reference_state import reference_state  # noqa: F401,E402  (restores the JAX package's state)

import heat_tpu_torch as htt
from heat_tpu_torch.comm import compressed as cq
from heat_tpu_torch.core import _tracing
from heat_tpu_torch.core import communication as tcomm
from heat_tpu_torch.core import statistics as pstats
from heat_tpu_torch.core.fuse import fuse
from heat_tpu_torch.resilience import guards, incidents
from heat_tpu_torch.telemetry import _core as ptel
from heat_tpu_torch.telemetry import counting_dispatches

import test_fuse as rfuse

P = len(jax.devices())
TOL = dict(rtol=3e-7, atol=1e-7)


@pytest.fixture(autouse=True)
def port():
    comm = htt.TorchCommunication(["cpu"] * P)
    prev = tcomm._default_comm
    htt.use_comm(comm)
    states = (cq.get_collective_precision(), guards.get_guard_policy())
    yield comm
    htt.use_comm(prev)
    cq.set_collective_precision(states[0])
    guards.set_guard_policy(states[1])


def _pair(shape, split, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape).astype(np.float32)
    b = (rng.standard_normal(shape) ** 2 + 0.5).astype(np.float32)
    return htt.array(a, split=split), htt.array(b, split=split)


def _ported(fn):
    glb = dict(fn.__globals__)
    glb["ht"] = htt
    return _pytypes.FunctionType(fn.__code__, glb, fn.__name__)


def _dispatches(fn, *args):
    fn(*args)
    with counting_dispatches() as d:
        out = fn(*args)
    return d.count, out


def _bitwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


_pipeline = _ported(rfuse._pipeline)
_fused_pipeline = fuse(_pipeline)


# --------------------------------------------------------------------- #
# the acceptance pipeline                                                 #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("shape", rfuse.SHAPES)
@pytest.mark.parametrize("split", rfuse.SPLITS)
def test_acceptance_pipeline_bitwise_and_single_dispatch(shape, split):
    a, b = _pair(shape, split)
    eager = _pipeline(a, b)
    n, fused = _dispatches(_fused_pipeline, a, b)
    assert n == 1
    assert fused.split == eager.split == split
    assert fused.gshape == eager.gshape and fused.dtype == eager.dtype
    assert _bitwise(eager.numpy(), fused.numpy())
    ra, rb = rfuse._pair(shape, split)
    np.testing.assert_allclose(fused.numpy(), rfuse._fused_pipeline(ra, rb).numpy(), **TOL)


@pytest.mark.parametrize("family", [rfuse._arith, rfuse._relational, rfuse._stats, rfuse._manip],
                         ids=["arith", "relational", "stats", "manip"])
@pytest.mark.parametrize("shape", rfuse.SHAPES)
@pytest.mark.parametrize("split", rfuse.SPLITS)
def test_fused_matches_eager_and_reference_across_families(family, shape, split):
    a, b = _pair(shape, split, seed=3)
    mine = _ported(family)
    eager, fused = mine(a, b), fuse(mine)(a, b)
    ref = rfuse.fuse(family)(*rfuse._pair(shape, split, seed=3))
    eager = eager if isinstance(eager, tuple) else (eager,)
    fused = fused if isinstance(fused, tuple) else (fused,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for e, f, r in zip(eager, fused, ref):
        assert f.gshape == e.gshape == r.gshape
        assert f.split == e.split == r.split
        assert f.dtype == e.dtype
        assert _bitwise(e.numpy(), f.numpy())
        np.testing.assert_allclose(f.numpy(), r.numpy(), **TOL)


def test_fused_scalar_and_static_outputs():
    @fuse
    def prog(a, k):
        return a * k, k, "tag"

    a, _ = _pair((4, 6), 0)
    out, k, tag = prog(a, 3)
    assert k == 3 and tag == "tag"
    assert _bitwise(out.numpy(), (a * 3).numpy())


def test_fused_containers_and_namedtuples_round_trip():
    """The port's own flattener: tuples, lists, dicts and namedtuples in and
    out, numpy and tensor leaves as operands."""

    @fuse
    def prog(d, pair, arr, t):
        return {"s": d["x"] + pair[1], "l": [t * 2.0]}, htt.linalg.svd.__module__, arr + 1.0

    a, b = _pair((4, 6), 0)
    host = np.ones(3, np.float32)
    out, name, arr = prog({"x": a}, [b, b], host, torch.ones(2))
    assert _bitwise(out["s"].numpy(), (a + b).numpy())
    assert torch.equal(out["l"][0], torch.full((2,), 2.0))
    assert isinstance(arr, torch.Tensor) and torch.equal(arr, torch.full((3,), 2.0))
    assert name == htt.linalg.svd.__module__
    x = htt.array(np.random.default_rng(2).standard_normal((24, 4)).astype(np.float32), split=0)
    res = fuse(htt.linalg.svd)(x)
    assert type(res).__name__ == "SVD" and res.U.shape == (24, 4)


# --------------------------------------------------------------------- #
# cache behaviour                                                         #
# --------------------------------------------------------------------- #
def _cached_prog(a, b):
    return htt.sqrt(htt.abs(a - b)) + a


def test_cache_one_entry_per_signature():
    fuse.clear_cache()
    fused = fuse(_cached_prog)
    a, b = _pair((4, 6), 0)
    fused(a, b)
    assert fuse.cache_size() == 1
    fused(a, b)
    fused(a, b)
    assert fuse.cache_size() == 1
    fused(*_pair((4, 6), 1))
    assert fuse.cache_size() == 2
    fused(*_pair((7, 5), 0))
    assert fuse.cache_size() == 3
    fused(*_pair((7, 5), 0))
    assert fuse.cache_size() == 3


def test_cache_keeps_the_most_recently_used_programs(monkeypatch):
    """Past ``_MAX_PROGRAMS`` the least recently used program goes; a
    program called again is the most recent, and an evicted one is built
    anew, bitwise the first build."""
    import importlib

    fuse_mod = importlib.import_module("heat_tpu_torch.core.fuse")
    fuse.clear_cache()
    monkeypatch.setattr(fuse_mod, "_MAX_PROGRAMS", 2)
    fused = fuse(_cached_prog)
    first = _pair((4, 6), 0)
    second, third = _pair((4, 6), 1), _pair((7, 5), 0)
    fused(*first)
    r2 = fused(*second)
    fused(*first)  # now the most recent
    with counting_dispatches() as d:
        fused(*third)  # evicts the (4, 6) split 1 program
    assert d.count == 1 and fuse.cache_size() == 2
    keys = list(fuse_mod._FUSE_CACHE)
    assert [(k[4][0][3], k[4][0][5]) for k in keys] == [((4, 6), first[0]._layout),
                                                         ((7, 5), third[0]._layout)]
    ptel.reset()
    ptel.enable()
    try:
        fused(*first)  # kept: a hit
        again = fused(*second)  # evicted before: built anew, evicting (7, 5)
        counters = ptel.snapshot()["counters"]
    finally:
        ptel.disable()
        ptel.reset()
    assert counters["fuse.cache.misses"] == 1 and counters["fuse.cache.hits"] == 1
    assert _bitwise(again.numpy(), r2.numpy()) and fuse.cache_size() == 2
    assert fuse.cache_bytes("cpu") == 0
    fuse.clear_cache()


def test_program_keyed_on_shape_and_split_is_not_replayed_for_another():
    fuse.clear_cache()
    fused = fuse(_cached_prog)
    for shape, split in [((4, 6), 0), ((7, 5), 0), ((4, 6), 1)]:
        a, b = _pair(shape, split, seed=5)
        out = fused(a, b)
        assert out.gshape == shape and out.split == split
        assert _bitwise(out.numpy(), _cached_prog(a, b).numpy())
    assert fuse.cache_size() == 3


def test_unstable_fn_compiles_transiently():
    fuse.clear_cache()
    a, b = _pair((4, 6), 0)
    out = fuse(lambda x, y: x + y)(a, b)
    assert _bitwise(out.numpy(), a.numpy() + b.numpy())
    assert fuse.cache_size() == 0


def test_unstable_static_argument_compiles_transiently():
    fuse.clear_cache()

    def prog(x, f):
        return f(x)

    a, _ = _pair((4, 6), 0)
    out = fuse(prog)(a, lambda x: x * 2.0)
    assert _bitwise(out.numpy(), (a * 2.0).numpy())
    assert fuse.cache_size() == 0

    def scaled(x, s):
        return x * float(len(s))

    out = fuse(scaled)(a, {1, 2})  # an unhashable static leaf
    assert _bitwise(out.numpy(), (a * 2.0).numpy())
    assert fuse.cache_size() == 0


def test_policy_flip_traces_a_new_program():
    fuse.clear_cache()
    fused = fuse(_cached_prog)
    a, b = _pair((4, 6), 0)
    fused(a, b)
    with cq.collective_precision("int8_block"):
        fused(a, b)
    with guards.guard("warn"):
        fused(a, b)
    assert fuse.cache_size() == 3


def test_outputs_are_fresh_tensors():
    """``r1 = f(a); r2 = f(b)`` leaves ``r1`` unchanged (on the card the
    graph's output buffers are never handed out)."""
    fused = fuse(_cached_prog)
    a, b = _pair((4, 6), 0, seed=1)
    c, d = _pair((4, 6), 0, seed=2)
    r1 = fused(a, b)
    keep = r1.numpy().copy()
    r2 = fused(c, d)
    assert _bitwise(r1.numpy(), keep)
    assert not _bitwise(r2.numpy(), keep)


def test_cache_telemetry():
    was = ptel.enabled
    ptel.reset()
    ptel.enable()
    try:
        fuse.clear_cache()
        fused = fuse(_cached_prog)
        a, b = _pair((4, 6), 0)
        fused(a, b)
        fused(a, b)
        snap = ptel.snapshot()
        assert snap["counters"]["fuse.cache.misses"] == 1
        assert snap["counters"]["fuse.cache.hits"] == 1
        assert snap["gauges"]["fuse.cache.size"] == 1
        assert snap["spans"]["fuse:build"]["count"] == 1
        assert snap["spans"]["fuse:replay"]["count"] == 1
    finally:
        ptel.reset()
        if not was:
            ptel.disable()


# --------------------------------------------------------------------- #
# the tracing-mode error contract                                         #
# --------------------------------------------------------------------- #
def test_value_forcing_raises_fuse_trace_error():
    a, _ = _pair((4, 6), 0)

    @fuse
    def syncs_scalar(x):
        return x * float(x.sum())

    @fuse
    def syncs_item(x):
        return x * x.sum().item()

    @fuse
    def syncs_print(x):
        print(x)
        return x

    for bad, what in [(syncs_scalar, "float()"), (syncs_item, ".item()"), (syncs_print, "print()")]:
        with pytest.raises(htt.FuseTraceError) as err:
            bad(a)
        assert what in str(err.value)
        assert "on-device" in str(err.value)
        assert "htt.fuse" in str(err.value)
    assert not _tracing.in_trace()


def test_trace_context_manager_enforces_same_contract():
    a, _ = _pair((4, 6), 0)
    with fuse.trace():
        b = a + 1.0
        with pytest.raises(htt.FuseTraceError):
            float(b.sum())
        with pytest.raises(htt.FuseTraceError):
            np.asarray(b)
    assert float((a + 1.0).sum()) == pytest.approx(float(b.sum()))


def test_error_names_public_entry_point():
    assert htt.FuseTraceError is _tracing.FuseTraceError
    assert htt.fuse is fuse
    assert ht.FuseTraceError.__name__ == htt.FuseTraceError.__name__


# --------------------------------------------------------------------- #
# library pipelines                                                       #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("split", [None, 0, 1])
def test_library_statistics_single_dispatch(split):
    a, _ = _pair((6, 8), split, seed=11)
    for stat in (htt.kurtosis, htt.skew):
        n, _ = _dispatches(stat, a)
        assert n == 1, stat.__name__


@pytest.mark.parametrize("split", [None, 0, 1])
def test_library_statistics_bitwise_eager_and_numpy(split):
    """Fused kurtosis/skew bitwise the port's eager programs, and within
    1e-5 of numpy's float64 moments (the reference's own value test,
    ``test_library_statistics_match_eager_values``, fails on this tree)."""
    a, _ = _pair((6, 8), split, seed=13)
    x64 = a.numpy().astype(np.float64)
    for axis in (None, 0, 1):
        k = htt.kurtosis(a, axis=axis)
        s = htt.skew(a, axis=axis)
        assert _bitwise(k.numpy(), pstats._kurtosis_program(a, axis, True, True).numpy())
        assert _bitwise(s.numpy(), pstats._skew_program(a, axis, True).numpy())
        d = x64 - x64.mean(axis=axis, keepdims=True)
        n = x64.size if axis is None else x64.shape[axis]
        m2, m3, m4 = ((d ** p).mean(axis=axis) for p in (2, 3, 4))
        g2 = ((n - 1) / ((n - 2) * (n - 3))) * ((n + 1) * m4 / m2 ** 2 - 3 * (n - 1)) + 3 - 3
        g1 = m3 / m2 ** 1.5 * np.sqrt(n * (n - 1.0)) / (n - 2.0)
        np.testing.assert_allclose(k.numpy(), g2, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(s.numpy(), g1, rtol=1e-5, atol=1e-5)


def _estimators(mod, data, labels, target):
    x = mod.array(data, split=0)
    km = mod.cluster.KMeans(n_clusters=3, init=mod.array(data[:3]), max_iter=3).fit(x)
    nb = mod.naive_bayes.GaussianNB().fit(x, mod.array(labels, split=0))
    la = mod.regression.Lasso(max_iter=5).fit(x, mod.array(target, split=0))
    return x, km, nb, la


def test_library_predicts_fused_equal_eager_and_reference():
    """Each fused predict is one dispatch, bitwise its program run eagerly,
    and equal to the reference's (labels exactly; probabilities at the
    estimator tests' tolerances)."""
    from heat_tpu_torch.classification import knn as pknn
    from heat_tpu_torch.cluster import _kcluster
    from heat_tpu_torch.naive_bayes import gaussianNB as pnb
    from heat_tpu_torch.regression import lasso as plasso

    rng = np.random.default_rng(21)
    data = rng.standard_normal((40, 4)).astype(np.float32)
    labels = rng.integers(0, 3, 40).astype(np.int64)
    target = rng.standard_normal(40).astype(np.float32)
    x, km, nb, la = _estimators(htt, data, labels, target)
    rx, rkm, rnb, rla = _estimators(ht, data, labels, target)
    theta, sigma, prior = (torch.as_tensor(t) for t in nb._fit_params())
    classes = torch.as_tensor(np.asarray(nb.classes_))
    kn = htt.classification.KNN(x, htt.array(labels, split=0), 5)
    rkn = ht.classification.KNN(rx, ht.array(labels, split=0), 5)
    cases = [
        (km.predict, lambda: _kcluster._assign_program(x, km.cluster_centers_, km._metric),
         rkm.predict, 0),
        (nb.predict, lambda: pnb._nb_predict_program(x, theta, sigma, prior, classes), rnb.predict, 0),
        (nb.predict_log_proba, lambda: pnb._nb_log_proba_program(x, theta, sigma, prior),
         rnb.predict_log_proba, 1e-5),
        (nb.predict_proba, lambda: pnb._nb_proba_program(x, theta, sigma, prior),
         rnb.predict_proba, 1e-6),
        (la.predict, lambda: plasso._lasso_predict_program(x, la._Lasso__theta), rla.predict, 1e-5),
        (kn.predict, lambda: pknn._knn_predict_program(x, kn.x, kn.y, 5, htt.float32), rkn.predict, 0),
    ]
    for fused, eager, ref, tol in cases:
        n, got = _dispatches(fused, x)
        assert n == 1
        assert _bitwise(got.numpy(), eager().numpy())
        want = ref(rx).numpy()
        if tol == 0:
            assert np.array_equal(got.numpy().reshape(want.shape), want)
        else:
            np.testing.assert_allclose(got.numpy().reshape(want.shape), want, rtol=tol, atol=tol)


# --------------------------------------------------------------------- #
# nesting, donation, guards                                               #
# --------------------------------------------------------------------- #
def test_fused_functions_compose():
    inner = fuse(_cached_prog)

    @fuse
    def outer(a, b):
        return inner(a, b) * 0.5

    a, b = _pair((4, 6), 0)
    n, out = _dispatches(outer, a, b)
    assert n == 1
    assert _bitwise(out.numpy(), (_cached_prog(a, b) * 0.5).numpy())


def test_donate_is_correct():
    @fuse(donate=True)
    def prog(a, b):
        return a + b

    for seed in (0, 1):
        a, b = _pair((4, 6), 0, seed=seed)
        want = a.numpy() + b.numpy()
        assert _bitwise(prog(a, b).numpy(), want)


def _guarded_sum(a):
    return htt.sum(a, axis=0) * 1.0


def _degrading_case(rows):
    """Data whose ``int8_block`` sum lies further from zero than the exact
    one, and an overflow limit between the two: only the quantized
    program is unhealthy."""
    for seed in range(64):
        data = np.random.default_rng(seed).standard_normal((rows, 4)).astype(np.float32)
        x = htt.array(data, split=0)
        exact = np.abs(_guarded_sum(x).numpy()).max()
        with cq.collective_precision("int8_block"):
            quant = np.abs(_guarded_sum(x).numpy()).max()
        if quant > exact:
            return x, float((exact + quant) / 2)
    raise AssertionError("no seed separates the quantized sum from the exact one")


@pytest.mark.parametrize("rows", [16, 13])
def test_guarded_program_degrades_to_the_exact_result(rows):
    """Under ``"degrade"`` an unhealthy fused result reads one flag, re-runs
    under the exact policy (a program of its own) and logs one incident;
    a healthy call re-runs nothing."""
    incidents.clear_incident_log()
    fuse.clear_cache()
    fused = fuse(_guarded_sum)
    x, limit = _degrading_case(rows)
    want = _guarded_sum(x).numpy()
    try:
        with cq.collective_precision("int8_block"), guards.guard("degrade"):
            healthy = fused(x)
            assert not incidents.incident_log() and fuse.cache_size() == 1
        with cq.collective_precision("int8_block"), guards.guard("degrade", overflow_limit=limit):
            out = fused(x)
        log = incidents.incident_log()
        assert [(e.site, e.action) for e in log] == [("fuse:_guarded_sum", "degraded")]
        assert _bitwise(out.numpy(), want)
        assert not _bitwise(healthy.numpy(), want)  # the healthy call stayed quantized
        assert fuse.cache_size() == 3  # unguarded-limit, guarded int8 and its exact re-run
    finally:
        incidents.clear_incident_log()


def test_guarded_nan_input_logs_what_the_reference_logs():
    """A NaN in the data is unhealthy on the exact path too: the port logs
    the reference's incidents (degraded, then unrecoverable) and returns
    the exact re-run's result."""
    from heat_tpu.comm import compressed as rcq
    from heat_tpu.resilience import guards as rguards
    from heat_tpu.resilience import incidents as rincidents

    def rsum(a):
        return ht.sum(a, axis=0) * 1.0

    data = np.random.default_rng(4).standard_normal((16, 4)).astype(np.float32)
    data[3, 1] = np.nan
    incidents.clear_incident_log()
    rincidents.clear_incident_log()
    try:
        with cq.collective_precision("int8_block"), guards.guard("degrade"):
            out = fuse(_guarded_sum)(htt.array(data, split=0))
        with rcq.collective_precision("int8_block"), rguards.guard("degrade"):
            rfuse.fuse(rsum)(ht.array(data, split=0))
        mine = [(e.kind, e.policy, e.action, e.detail) for e in incidents.incident_log()]
        ref = [(e.kind, e.policy, e.action, e.detail) for e in rincidents.incident_log()]
        assert mine == ref and [m[2] for m in mine] == ["degraded", "unrecoverable"]
        want = _guarded_sum(htt.array(data, split=0)).numpy()
        assert np.array_equal(np.isnan(out.numpy()), np.isnan(want))
        assert _bitwise(np.nan_to_num(out.numpy()), np.nan_to_num(want))
    finally:
        incidents.clear_incident_log()
        rincidents.clear_incident_log()


# --------------------------------------------------------------------- #
# host syncs inside a trace                                               #
# --------------------------------------------------------------------- #
@pytest.fixture
def no_host_sync(monkeypatch):
    """Tensor methods that synchronize the host, and host-data tensor
    constructors, raise while a trace is active."""

    def guarded(name, fn):
        def wrapper(*args, **kwargs):
            if _tracing.in_trace():
                raise AssertionError(f"host sync {name} inside a trace")
            return fn(*args, **kwargs)

        return wrapper

    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__float__", "__int__", "nonzero"):
        monkeypatch.setattr(torch.Tensor, name, guarded(f"Tensor.{name}", getattr(torch.Tensor, name)))
    for name in ("nonzero", "unique"):
        monkeypatch.setattr(torch, name, guarded(f"torch.{name}", getattr(torch, name)))
    tensor, as_tensor = torch.tensor, torch.as_tensor

    def host_data(name, fn):
        def wrapper(data, *args, **kwargs):
            if _tracing.in_trace() and not isinstance(data, torch.Tensor):
                raise AssertionError(f"{name} of host data inside a trace")
            return fn(data, *args, **kwargs)

        return wrapper

    monkeypatch.setattr(torch, "tensor", host_data("torch.tensor", tensor))
    monkeypatch.setattr(torch, "as_tensor", host_data("torch.as_tensor", as_tensor))
    getitem = torch.Tensor.__getitem__

    def masked(self, key):
        keys = key if isinstance(key, tuple) else (key,)
        if _tracing.in_trace() and any(isinstance(k, torch.Tensor) and k.dtype == torch.bool
                                       for k in keys):
            raise AssertionError("boolean-mask indexing inside a trace")
        return getitem(self, key)

    monkeypatch.setattr(torch.Tensor, "__getitem__", masked)


def test_host_sync_guard_catches_what_it_should(no_host_sync):
    t = torch.ones(3)
    with _tracing.trace_mode():
        for bad in (lambda: t.sum().item(), lambda: t[t > 0], lambda: torch.tensor([1.0]),
                    lambda: bool(t.sum()), lambda: torch.unique(t)):
            with pytest.raises(AssertionError):
                bad()
    assert t.sum().item() == 3.0


@pytest.mark.parametrize("family", [rfuse._pipeline, rfuse._arith, rfuse._relational, rfuse._stats,
                                    rfuse._manip],
                         ids=["pipeline", "arith", "relational", "stats", "manip"])
@pytest.mark.parametrize("split", rfuse.SPLITS)
def test_families_trace_without_host_syncs(no_host_sync, family, split):
    a, b = _pair((7, 5), split, seed=3)
    fuse(_ported(family))(a, b)


def test_library_pipelines_trace_without_host_syncs(no_host_sync):
    rng = np.random.default_rng(21)
    data = rng.standard_normal((40, 4)).astype(np.float32)
    labels = rng.integers(0, 3, 40).astype(np.int64)
    target = rng.standard_normal(40).astype(np.float32)
    x, km, nb, la = _estimators(htt, data, labels, target)
    for split in (None, 0, 1):
        a, _ = _pair((6, 8), split, seed=11)
        for axis in (None, 0, 1):
            htt.kurtosis(a, axis=axis)
            htt.skew(a, axis=axis)
    km.predict(x)
    nb.predict(x)
    nb.predict_log_proba(x)
    nb.predict_proba(x)
    la.predict(x)
    htt.classification.KNN(x, htt.array(labels, split=0), 5).predict(x)


def test_int8_moments_trace_without_host_syncs(no_host_sync):
    """The pipeline ``chip_smoke.py`` phase 14 captures with B1, the hop and
    B2 inside: mean and std along the split under ``int8_block``."""

    def moments(a):
        return htt.mean(a, axis=0), htt.std(a, axis=0)

    data = np.random.default_rng(6).standard_normal((64, 256)).astype(np.float32)
    x = htt.array(data, split=0, comm=htt.TorchCommunication(["cpu"] * 4))
    with cq.collective_precision("int8_block"):
        eager = moments(x)
        fused = fuse(moments)(x)
    for e, f in zip(eager, fused):
        assert _bitwise(e.numpy(), f.numpy())


def test_svd_pipeline_is_left_unfused():
    """``svd`` calls its pipeline unfused on every device (cuSOLVER's
    ``gesvdj`` syncs the host inside, and a capture of it fails on the
    card): no fused program is built for it."""
    fuse.clear_cache()
    x = htt.array(np.random.default_rng(9).standard_normal((24, 4)).astype(np.float32), split=0)
    htt.linalg.svd(x)
    assert fuse.cache_size() == 0


def test_threads_share_one_program_and_lose_no_dispatch():
    """Many threads calling one fused pipeline (and eager ops beside it)
    get their own results, one cached program, and every dispatch
    counted; one thread's trace does not make another's calls traced."""
    import sys
    import threading

    fuse.clear_cache()
    fused = fuse(_cached_prog)
    pairs = [_pair((7, 5), 0, seed=s) for s in range(4)]
    wants = [_cached_prog(a, b).numpy() for a, b in pairs]
    errors, calls, n_threads = [], 25, 12
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(t):
            try:
                a, b = pairs[t % 4]
                for _ in range(calls):
                    out = fused(a, b)
                    float((a + b).sum())  # eager, value-forcing: not traced here
                    if not _bitwise(out.numpy(), wants[t % 4]):
                        errors.append(t)
            except Exception as exc:  # noqa: BLE001 - reported below
                errors.append(repr(exc))

        with counting_dispatches() as d:
            threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors[:3]
    assert fuse.cache_size() == 1
    # a fused call, the eager add and the eager sum: 3 a round
    assert d.count == 3 * calls * n_threads
