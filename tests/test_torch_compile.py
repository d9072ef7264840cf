"""The port's compiled-program accounting held against the JAX package:
trace mode and the value-forcing contract, ``jitted`` with its cache,
telemetry and key contexts, and the dispatch-count table.

Cases come from the reference's ``tests/test_compile_cache.py`` and
``tests/test_fuse.py``.  The dispatch table runs ``test_fuse.py``'s five
pipelines (``_pipeline``, ``_arith``, ``_relational``, ``_stats``,
``_manip``), eager and fused, at splits None/0/1 and shapes (4, 6) and
(7, 5) on 8 positions, and the library calls the reference fuses.  Where
the port's count equals the reference's the test says so; where it cannot
(ROADMAP, "Dispatch accounting"), the case still runs and
asserts the port's own count, with the reason beside it in ``DIFFERS``.

The reference's state is only read: its compile caches, dispatch counter
and telemetry switch are never cleared or reset (dispatches are read
through ``counting_dispatches()`` windows), and every policy a test sets
is restored.  The port's caches are cleared freely.  At the file's end
``reference_state`` puts the reference's caches back as it found them.
"""

import types as _pytypes

import numpy as np
import pytest

import jax

import heat_tpu as ht
from heat_tpu.comm import compressed as rcq
from heat_tpu.core import _compile as rcompile
from heat_tpu.core import _tracing as rtracing
from heat_tpu.io import stream as rstream
from heat_tpu.resilience import guards as rguards
from heat_tpu.telemetry import counting_dispatches as ref_window
from test_torch_reference_state import reference_state  # noqa: F401,E402  (restores the JAX package's state)

import heat_tpu_torch as htt
from heat_tpu_torch.comm import compressed as cq
from heat_tpu_torch.core import _compile, _tracing
from heat_tpu_torch.core import communication as tcomm
from heat_tpu_torch.io import stream as pstream
from heat_tpu_torch.resilience import guards
from heat_tpu_torch.telemetry import _core as ptel
from heat_tpu_torch.telemetry import counting_dispatches as port_window

import test_fuse as rfuse

P = len(jax.devices())


@pytest.fixture
def port():
    """8 CPU positions as the default communicator, the port's policies
    restored afterwards."""
    comm = htt.TorchCommunication(["cpu"] * P)
    prev = tcomm._default_comm
    htt.use_comm(comm)
    states = (cq.get_collective_precision(), guards.get_guard_policy(), pstream.get_prefetch())
    yield comm
    htt.use_comm(prev)
    cq.set_collective_precision(states[0])
    guards.set_guard_policy(states[1])
    pstream.set_prefetch(states[2])


def _pair(shape, split, seed=0):
    """``test_fuse._pair``'s inputs in the port."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape).astype(np.float32)
    b = (rng.standard_normal(shape) ** 2 + 0.5).astype(np.float32)
    return htt.array(a, split=split), htt.array(b, split=split)


def _ported(fn):
    """One of ``test_fuse.py``'s pipelines with ``ht`` bound to the port."""
    glb = dict(fn.__globals__)
    glb["ht"] = htt
    return _pytypes.FunctionType(fn.__code__, glb, fn.__name__)


def _count(window, fn, *args):
    """Dispatches of one ``fn(*args)`` after a warm-up call."""
    fn(*args)
    with window() as d:
        out = fn(*args)
    return d.count, out


# --------------------------------------------------------------------- #
# trace mode and the value-forcing contract                               #
# --------------------------------------------------------------------- #
def test_trace_mode_nests_and_unwinds():
    assert not _tracing.in_trace()
    with _tracing.trace_mode():
        assert _tracing.in_trace()
        with _tracing.trace_mode():
            assert _tracing.in_trace()
        assert _tracing.in_trace()
    assert not _tracing.in_trace()
    with pytest.raises(KeyError):
        with _tracing.trace_mode():
            raise KeyError("x")
    assert not _tracing.in_trace()


def _save_hdf5(x, tmp):
    x.save_hdf5(str(tmp / "x.h5"), "x")


def _save_netcdf(x, tmp):
    x.save_netcdf(str(tmp / "x.nc"), "x")


#: every value-forcing entry point the reference guards
#: (``heat_tpu/core/dndarray.py:504-578,1135,1141``), with its description
FORCING = [
    (".numpy()", lambda x, tmp: x.numpy()),
    (".save()", lambda x, tmp: x.save(str(tmp / "x.csv"))),
    (".save_hdf5()", _save_hdf5),
    (".save_netcdf()", _save_netcdf),
    ("np.asarray()", lambda x, tmp: np.asarray(x)),
    (".tolist()", lambda x, tmp: x.tolist()),
    (".item()", lambda x, tmp: x.sum().item()),
    ("bool()", lambda x, tmp: bool(x.sum())),
    ("int()", lambda x, tmp: int(x.sum())),
    ("float()", lambda x, tmp: float(x.sum())),
    ("complex()", lambda x, tmp: complex(x.sum())),
    ("repr()", lambda x, tmp: repr(x)),
    ("print()/str()", lambda x, tmp: str(x)),
]


@pytest.mark.parametrize("what,force", FORCING, ids=[w for w, _ in FORCING])
def test_value_forcing_raises_in_both_packages(port, tmp_path, what, force):
    """Each entry point raises :class:`FuseTraceError` under trace mode with
    the reference's message less its jax idiom, and works outside it."""
    data = np.arange(8, dtype=np.float32).reshape(4, 2)
    x, rx = htt.array(data, split=0), ht.array(data, split=0)
    with _tracing.trace_mode(), pytest.raises(htt.FuseTraceError) as mine:
        force(x, tmp_path)
    with rtracing.trace_mode(), pytest.raises(ht.FuseTraceError) as ref:
        force(rx, tmp_path)
    assert what in str(mine.value) and what in str(ref.value)
    want = str(ref.value).replace("jnp.where / lax.cond", "torch.where").replace("ht.fuse", "htt.fuse")
    assert str(mine.value) == want
    assert "on-device" in str(mine.value)
    if what not in (".save_hdf5()",) or htt.supports_hdf5():
        force(x, tmp_path)  # outside the trace it runs


def test_fuse_trace_error_is_a_runtime_error_exported_flat():
    assert issubclass(htt.FuseTraceError, RuntimeError)
    assert htt.FuseTraceError is _tracing.FuseTraceError
    assert htt.fuse.trace is _tracing.trace_mode


def test_layout_plan_seam_matches_reference():
    """The autoshard seam: FIFO overrides per resplit signature, nothing
    outside a plan, the outer plan restored on exit."""
    decisions = [
        {"shape": (4, 6), "dtype": "float32", "src": 0, "requested": 1, "apply": None},
        {"shape": (4, 6), "dtype": "float32", "src": 0, "requested": 1, "apply": 0},
    ]
    for mod in (_tracing, rtracing):
        assert not mod.layout_plan_active()
        assert mod.consume_layout_override((4, 6), "float32", 0, 1) is mod.NO_OVERRIDE
        with mod.applying_layout_plan(decisions):
            assert mod.layout_plan_active()
            with mod.applying_layout_plan([]):
                assert mod.consume_layout_override((4, 6), "float32", 0, 1) is mod.NO_OVERRIDE
            got = [mod.consume_layout_override((4, 6), "float32", 0, 1) for _ in range(3)]
            assert got[:2] == [None, 0] and got[2] is mod.NO_OVERRIDE
        assert not mod.layout_plan_active()


def test_record_dispatch_no_ops_under_trace():
    with port_window() as d:
        _tracing.record_dispatch()
        with _tracing.trace_mode():
            _tracing.record_dispatch()
    assert d.count == 1


# --------------------------------------------------------------------- #
# jitted: the cache (reference tests/test_compile_cache.py)               #
# --------------------------------------------------------------------- #
def _module_level_fn(x):
    return x + 1


class _Obj:
    def method(self):  # pragma: no cover - identity only
        return None


def test_jitted_reentry_hits_cache(tels_port):
    import torch

    _compile.clear_cache()
    calls = []

    def make():
        calls.append(1)
        return lambda a: a * 2.0

    key = ("test.reentry", 0)
    x = torch.arange(3.0)
    assert torch.equal(_compile.jitted(key, make)(x), _compile.jitted(key, make)(x))
    counters = ptel.snapshot()["counters"]
    assert counters["compile.cache.misses"] == 1 and counters["compile.cache.hits"] == 1
    assert _compile.cache_size() == 1
    assert len([e for e in ptel.events() if e["type"] == "compile"]) == 1


def test_jitted_keeps_no_key_with_telemetry_off():
    """With telemetry off ``jitted`` builds no key: the call counts its
    dispatch and nothing is kept (no tensor or communicator is pinned)."""
    import torch

    assert not ptel.enabled
    _compile.clear_cache()
    fn = _compile.jitted(("test.off", torch.ones(2)), lambda: torch.neg)
    with port_window() as d:
        out = fn(torch.ones(2))
    assert d.count == 1 and torch.equal(out, -torch.ones(2))
    assert _compile.cache_size() == 0


def test_seen_keys_are_bounded(tels_port, monkeypatch):
    import torch

    _compile.clear_cache()
    monkeypatch.setattr(_compile, "_MAX_KEYS", 3)
    for i in range(5):
        _compile.jitted(("test.bound", i), lambda: torch.neg)
    assert _compile.cache_size() == 3
    _compile.jitted(("test.bound", 4), lambda: torch.neg)  # kept: a hit
    _compile.jitted(("test.bound", 0), lambda: torch.neg)  # evicted: a miss
    counters = ptel.snapshot()["counters"]
    assert counters["compile.cache.misses"] == 6 and counters["compile.cache.hits"] == 1
    _compile.clear_cache()


def test_tensor_kwargs_take_the_keyless_path(tels_port):
    """An op whose static kwargs hold a tensor (hashed by identity) keys
    nothing, so repeated calls add no entries; it still counts one
    dispatch a call."""
    import torch

    from heat_tpu_torch.core import _operations

    _compile.clear_cache()
    x = htt.array(np.arange(6, dtype=np.float32), device="cpu")
    bound = torch.tensor(2.0)
    with port_window() as d:
        for _ in range(3):
            _operations.__local_op(torch.clamp, x, max=bound)
    assert d.count == 3 and _compile.cache_size() == 0
    assert _operations._freeze(({"max": bound},)) is None


def test_cache_repopulates_identically_after_clear(tels_port):
    import torch

    _compile.clear_cache()
    key = ("test.clear", 3)
    make = lambda: lambda a: a + 3.0  # noqa: E731
    x = torch.arange(5.0)
    before = _compile.jitted(key, make)(x)
    _compile.clear_cache()
    assert _compile.cache_size() == 0
    after = _compile.jitted(key, make)(x)
    assert _compile.cache_size() == 1 and torch.equal(after, before)
    _compile.jitted(key, make)
    counters = ptel.snapshot()["counters"]
    assert counters["compile.cache.misses"] == 2 and counters["compile.cache.hits"] == 1


def test_distinct_keys_distinct_entries(tels_port):
    _compile.clear_cache()
    make = lambda: lambda a: a  # noqa: E731
    _compile.jitted(("test.k", 1), make)
    _compile.jitted(("test.k", 2), make)
    assert _compile.cache_size() == 2


def test_cache_stable_agrees_with_reference_and_admits_torch_builtins():
    import functools

    import torch

    def outer():
        y = 2.0

        def closure(x):
            return x * y

        return closure

    cases = [(_module_level_fn, True), (np.add, True), (lambda x: x, False),
             (outer(), False), (_Obj().method, False), (functools.partial(_module_level_fn, 1), False),
             (np.sum, True)]
    for fn, want in cases:
        assert _compile.cache_stable(fn) is want
        assert rcompile.cache_stable(fn) is want
    for fn in (torch.add, torch.sqrt, torch.where, torch.nn.functional.softplus, torch.special.erf):
        assert _compile.cache_stable(fn)
    assert not _compile.cache_stable(torch.zeros(2).add)  # a bound builtin method


def test_jitted_counts_one_dispatch_a_call_and_none_in_a_trace():
    import torch

    fn = _compile.jitted(("test.count",), lambda: torch.neg)
    x = torch.ones(3)
    with port_window() as d:
        fn(x)
        fn(x)
        with _tracing.trace_mode():
            fn(x)
    assert d.count == 2


def test_jitted_telemetry_matches_the_reference_contract(tels_port):
    import torch

    _compile.clear_cache()
    key = ("test.tel", 1)
    make = lambda: torch.neg  # noqa: E731
    fn = _compile.jitted(key, make)
    fn(torch.ones(2))
    fn(torch.ones(2))
    _compile.jitted(key, make)(torch.ones(2))
    snap = ptel.snapshot()
    assert snap["counters"]["compile.cache.misses"] == 1
    assert snap["counters"]["compile.cache.hits"] == 1
    assert snap["gauges"]["compile.cache.size"] == 1
    assert snap["spans"]["jitted:test.tel"]["count"] == 3
    compiles = [e for e in ptel.events() if e["type"] == "compile"]
    assert len(compiles) == 1
    ev = compiles[0]
    assert ev["site"] == "test.tel" and ev["compile_s"] == 0.0 and ev["trace_lower_s"] >= 0.0


@pytest.fixture
def tels_port():
    """The port's registry on and empty; the reference's is not touched."""
    was = ptel.enabled
    ptel.reset()
    ptel.enable()
    yield
    ptel.reset()
    if not was:
        ptel.disable()


# --------------------------------------------------------------------- #
# key contexts                                                            #
# --------------------------------------------------------------------- #
def test_key_context_tokens_equal_the_references(port):
    """The five providers (collective precision, guard, prefetch,
    redistribution, overlap) give the reference's tokens under the same
    settings."""
    import importlib

    from heat_tpu.comm import redistribute as rrd
    from heat_tpu_torch.comm import redistribute as trd

    rov = importlib.import_module("heat_tpu.comm.overlap")
    tov = importlib.import_module("heat_tpu_torch.comm.overlap")
    pairs = [(cq._policy_token, rcq._policy_token), (guards._guard_token, rguards._guard_token),
             (pstream._prefetch_token, rstream._prefetch_token), (trd._redist_token, rrd._redist_token),
             (tov._overlap_token, rov._overlap_token)]
    rprec, rpol, rpre = rcq.get_collective_precision(), rguards.get_guard_policy(), rstream.get_prefetch()
    saved = [(trd, trd.get_redistribution()), (rrd, rrd.get_redistribution())]
    saved_ov = [(tov, tov.get_overlap()), (rov, rov.get_overlap())]
    try:
        for prec, pol, pre, red, ov in [("f32", "off", "auto", "auto", "auto"),
                                        ("int8_block", "degrade", "on", "planned", "on"),
                                        ("bf16", "raise", "off", "monolithic", "off")]:
            for mod in (cq, rcq):
                mod.set_collective_precision(prec)
            for mod in (guards, rguards):
                mod.set_guard_policy(pol)
            for mod in (pstream, rstream):
                mod.set_prefetch(pre)
            for mod in (trd, rrd):
                mod.set_redistribution(red)
            for mod in (tov, rov):
                mod.set_overlap(ov)
            for mine, ref in pairs:
                assert mine() == ref()
            for mine, _ in pairs:
                assert mine in _compile._KEY_CONTEXT
    finally:
        rcq.set_collective_precision(rprec)
        rguards.set_guard_policy(rpol)
        rstream.set_prefetch(rpre)
        for mod, red in saved:
            mod.set_redistribution(red)
        for mod, ov in saved_ov:
            mod.set_overlap(ov)


def test_policy_flip_keys_a_fresh_entry(port, tels_port):
    import torch

    _compile.clear_cache()
    make = lambda: torch.neg  # noqa: E731
    _compile.jitted(("test.policy",), make)
    with cq.collective_precision("int8_block"):
        _compile.jitted(("test.policy",), make)
        with guards.guard("warn"):
            _compile.jitted(("test.policy",), make)
    _compile.jitted(("test.policy",), make)
    counters = ptel.snapshot()["counters"]
    assert counters["compile.cache.misses"] == 3 and counters["compile.cache.hits"] == 1
    assert _compile.cache_size() == 3


# --------------------------------------------------------------------- #
# the dispatch-count table                                               #
# --------------------------------------------------------------------- #
FAMILIES = [rfuse._pipeline, rfuse._arith, rfuse._relational, rfuse._stats, rfuse._manip]

#: cases whose port count differs from the reference's, by (family,
#: split): the port's count and the reason (ROADMAP, "Dispatch
#: accounting").  Every other case is held equal to the reference.
DIFFERS = {
    # ht.div's _truediv is a closure (heat_tpu/core/arithmetics.py:77), so
    # the reference runs it uncounted (_operations.py:197); every port op
    # counts one
    ("_arith", None): (7, "div"), ("_arith", 0): (7, "div"), ("_arith", 1): (7, "div"),
    # where's result is committed at its ragged true shape: the reference
    # counts a constrained copy (communication.py:1078), a pad (:495) and a
    # reshard (:1105) for it; the port pads inside the op, uncounted
    ("_relational", 0): (4, "where"), ("_relational", 1): (4, "where"),
    # ht.max's _nanprop_max is a closure (statistics.py:333): uncounted in
    # the reference; the reference's mean/std along the unsplit axis commit
    # their ragged results (3 dispatches, statistics.py:122-123)
    ("_stats", None): (6, "max"), ("_stats", 0): (6, "max, std"), ("_stats", 1): (6, "max, mean"),
    # transpose/concatenate/getitem/reshape commit their results through
    # apply_sharding (basics.py:710, manipulations.py:69, dndarray.py:1097);
    # the port's layout is canonical and these ops launch no program of
    # their own: only a resplit commits a layout (communication.py:1105)
    ("_manip", 0): (0, "layout commits"), ("_manip", 1): (0, "layout commits"),
}


@pytest.mark.parametrize("shape", rfuse.SHAPES)
@pytest.mark.parametrize("split", rfuse.SPLITS)
@pytest.mark.parametrize("family", FAMILIES, ids=[f.__name__ for f in FAMILIES])
def test_dispatch_table_against_reference(port, family, split, shape):
    a, b = _pair(shape, split, seed=3)
    ra, rb = rfuse._pair(shape, split, seed=3)
    mine = _ported(family)
    ref_eager, _ = _count(ref_window, family, ra, rb)
    ref_fused, _ = _count(ref_window, rfuse.fuse(family), ra, rb)
    eager, _ = _count(port_window, mine, a, b)
    fused, _ = _count(port_window, htt.fuse(mine), a, b)
    assert fused == ref_fused == 1
    want = DIFFERS.get((family.__name__, split))
    if want is None:
        assert eager == ref_eager
    else:
        assert eager == want[0] and eager != ref_eager


def test_eager_pipeline_issues_many_dispatches(port):
    a, b = _pair((4, 6), 0)
    n, _ = _count(port_window, _ported(rfuse._pipeline), a, b)
    assert n >= 5


def _library(mod, shape=(40, 4), seed=21):
    """Fitted estimators and an input in either package (``mod`` is ``ht``
    or ``htt``), from the same numpy data; KNN (k = 5) rides on ``nb``."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal(shape).astype(np.float32)
    labels = rng.integers(0, 3, shape[0]).astype(np.int64)
    target = rng.standard_normal(shape[0]).astype(np.float32)
    x = mod.array(data, split=0)
    km = mod.cluster.KMeans(n_clusters=3, init=mod.array(data[:3]), max_iter=3).fit(x)
    nb = mod.naive_bayes.GaussianNB().fit(x, mod.array(labels, split=0))
    nb.knn = mod.classification.KNN(x, mod.array(labels, split=0), 5)
    la = mod.regression.Lasso(max_iter=5).fit(x, mod.array(target, split=0))
    return x, km, nb, la


#: library calls: name -> (call, port count where it differs from the
#: reference's one fused dispatch, reason)
LIBRARY = {
    "kurtosis": (lambda m, x, km, nb, la: m.kurtosis(x), None),
    "kurtosis_axis0": (lambda m, x, km, nb, la: m.kurtosis(x, axis=0), None),
    "skew": (lambda m, x, km, nb, la: m.skew(x), None),
    "skew_axis1": (lambda m, x, km, nb, la: m.skew(x, axis=1), None),
    "KMeans.predict": (lambda m, x, km, nb, la: km.predict(x), None),
    "GaussianNB.predict": (lambda m, x, km, nb, la: nb.predict(x), None),
    "GaussianNB.predict_log_proba": (lambda m, x, km, nb, la: nb.predict_log_proba(x), None),
    "GaussianNB.predict_proba": (lambda m, x, km, nb, la: nb.predict_proba(x), None),
    "Lasso.predict": (lambda m, x, km, nb, la: la.predict(x), None),
    # C10: the port's KNN predict is the fused _fused_knn_predict
    "KNN.predict": (lambda m, x, km, nb, la: nb.knn.predict(x), None),
    # the port's svd is not fused: cuSOLVER's gesvdj syncs the host inside
    # and fails under a CUDA-graph capture (ROADMAP, "Dispatch accounting");
    # it counts its TSQR program (qr.tsqr)
    "svd": (lambda m, x, km, nb, la: m.linalg.svd(x), 1),
}


@pytest.mark.parametrize("name", list(LIBRARY))
def test_library_dispatch_counts_against_reference(port, name):
    call, differs = LIBRARY[name]
    rx, rkm, rnb, rla = _library(ht)
    x, km, nb, la = _library(htt)
    ref, _ = _count(ref_window, lambda: call(ht, rx, rkm, rnb, rla))
    mine, _ = _count(port_window, lambda: call(htt, x, km, nb, la))
    assert ref == 1
    if differs is None:
        assert mine == ref
    else:
        assert mine == differs


def test_layout_commit_counts_only_a_real_change(port):
    """A resplit to another split counts one dispatch, the same split and
    every op inside a trace none."""
    x = htt.array(np.ones((16, 8), np.float32), split=0)
    for dst, want in [(0, 0), (1, 1), (None, 0)]:
        with port_window() as d:
            x.resplit(dst)
        assert d.count == want, dst
        with port_window() as d:
            htt.resplit(x, dst)
        assert d.count == want, dst
    with port_window() as d, _tracing.trace_mode():
        x.resplit(1)
        x + 1.0
    assert d.count == 0
