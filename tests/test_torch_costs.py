"""The port's cost models, plans and redistribution policy held against
the JAX package's.

Covered: every function of ``comm/_costs.py`` on a grid of inputs, each
rate passed explicitly (the port's default rates are the card's, the
reference's a TPU link's and nominal host figures); ``LayoutSolver``'s
``price`` and ``solve`` on ``tests/test_cost_properties.py``'s shapes and
layouts; ``plan(...)`` field for field (steps, mode, wire, exact and
peak bytes, ``out_shape``, ``key``, ``explain()``, ``wire_model()``),
``monolithic_model``, ``max_live_bytes`` raising, the plan cache; the
redistribution and overlap policy knobs and their key tokens; the
telemetry a planned resplit leaves; one dispatch a planned resplit; and a
resplit inside an ``htt.fuse`` trace exact under ``int8_block``.
Everything is exact.
"""

import contextlib
import importlib
import itertools

import numpy as np
import pytest
import torch

import jax

import heat_tpu as ht
from heat_tpu.comm import _costs as rcosts
from heat_tpu.comm import compressed as rcq
from heat_tpu.comm import redistribute as rrd
from heat_tpu.core import _compile as rcompile
from heat_tpu.core.communication import XlaCommunication
from heat_tpu.telemetry import _core as rcore
from test_torch_reference_state import reference_state  # noqa: F401,E402  (restores the JAX package's state)

import heat_tpu_torch as htt
from heat_tpu_torch.comm import _costs as tcosts
from heat_tpu_torch.comm import compressed as tcq
from heat_tpu_torch.comm import redistribute as trd
from heat_tpu_torch.core import _compile as tcompile
from heat_tpu_torch.core import _tracing as ttracing
from heat_tpu_torch.telemetry import _core as tcore

# the modules: ``comm.overlap`` is also the name of the policy's context manager
rov = importlib.import_module("heat_tpu.comm.overlap")
tov = importlib.import_module("heat_tpu_torch.comm.overlap")

GBPS = 123.25
SIZES = [1, 2, 4, 7, 8]
LAYOUTS_1D = [None, 0, 1]
MESHES = [(2, 2), (2, 4), (4, 2)]
LAYOUTS_GRID = [
    s for s in itertools.product((None, 0, 1), repeat=2)
    if len([g for g in s if g is not None]) == len({g for g in s if g is not None})
]
SHAPES = [(32, 16), (64, 32), (128, 64), (48, 40)]
MODE_FORS = {
    "exact": lambda nbytes: None,
    "int8": lambda nbytes: "int8_block",
    "bf16": lambda nbytes: "bf16",
    "auto": lambda nbytes: "int8_block" if nbytes >= 1024 else None,
}


# --------------------------------------------------------------------- #
# _costs, function by function                                            #
# --------------------------------------------------------------------- #
def test_all_and_block_equal_the_references():
    assert tcosts.__all__ == rcosts.__all__
    assert tcosts.BLOCK == rcosts.BLOCK and tcosts._ITEMSIZES == rcosts._ITEMSIZES
    assert tcosts._COMPRESSIBLE == rcosts._COMPRESSIBLE
    assert tcosts.DEFAULT_ICI_GBPS > 0


def test_small_functions_equal_the_references():
    for name in rcosts._ITEMSIZES:
        assert tcosts.itemsize(name) == rcosts.itemsize(name)
    with pytest.raises(ValueError, match="unknown dtype"):
        tcosts.itemsize("float128")
    for n, mode, item in itertools.product([0, 1, 127, 128, 129, 5000], [None, "bf16", "int8_block"], [2, 4, 8]):
        assert tcosts.encoded_bytes(n, mode, item) == rcosts.encoded_bytes(n, mode, item)
    for dt, nb, prec, thr in itertools.product(["float32", "bfloat16", "float64", "int32"], [0, 100, 1 << 16],
                                               ["f32", "bf16", "int8_block", "auto", None], [0, 1 << 16]):
        assert tcosts.resolve_mode(dt, nb, prec, thr) == rcosts.resolve_mode(dt, nb, prec, thr)
    for wb, hops, comp, ov in itertools.product([0, 1000, 1 << 24], [0, 1, 7], [0.0, 0.5], [False, True]):
        assert tcosts.critical_path_ms(wb, hops, comp, gbps=GBPS, overlap=ov) == \
            rcosts.critical_path_ms(wb, hops, comp, gbps=GBPS, overlap=ov)
    for layout in [None, 0, 1, 2, (None, None), (0, None), (None, 0), (1, 0)]:
        assert tcosts.layout_rank(layout) == rcosts.layout_rank(layout)
    for n, c, t in itertools.product([1, 7, 64, 100], [1, 2, 4], [1, 2, 3]):
        assert tcosts.grid_panel_bounds(n, c, t) == rcosts.grid_panel_bounds(n, c, t)
    for cb, ch, comp, pre in itertools.product([1 << 20, 25_600_000], [1, 8], [0.0, 3.0], [False, True]):
        assert tcosts.stream_model(cb, ch, comp, read_gbps=2.5, h2d_gbps=30.0, prefetch=pre) == \
            rcosts.stream_model(cb, ch, comp, read_gbps=2.5, h2d_gbps=30.0, prefetch=pre)


def test_ring_and_monolithic_models_equal_the_references():
    for n, p, mode, op in itertools.product([1, 185, 2 ** 20], [1, 2, 8], [None, "bf16", "int8_block"],
                                            ["allreduce", "allgather"]):
        assert tcosts.ring_wire_model(n, p, mode, op=op) == rcosts.ring_wire_model(n, p, mode, op=op)
    for shape, item, src, dst, p in itertools.product(SHAPES, [2, 4], LAYOUTS_1D, LAYOUTS_1D, SIZES):
        assert tcosts.monolithic_cost(shape, item, src, dst, p) == rcosts.monolithic_cost(shape, item, src, dst, p)


@pytest.mark.parametrize("mode_for", sorted(MODE_FORS))
def test_plan_cost_equals_the_references(mode_for):
    f = MODE_FORS[mode_for]
    for shape, dt, src, dst, p, ov in itertools.product(
        SHAPES + [(16, 5, 9), (0, 8)], ["float32", "bfloat16", "float64"], LAYOUTS_1D, LAYOUTS_1D,
        SIZES, [False, True],
    ):
        if src is not None and shape[src] % p:
            continue
        assert tcosts.plan_cost(shape, dt, src, dst, p, mode_for=f, overlap=ov) == \
            rcosts.plan_cost(shape, dt, src, dst, p, mode_for=f, overlap=ov)


@pytest.mark.parametrize("mode_for", sorted(MODE_FORS))
@pytest.mark.parametrize("mesh", MESHES)
def test_grid_plan_cost_equals_the_references(mesh, mode_for):
    f = MODE_FORS[mode_for]
    for shape, src, dst, ov in itertools.product([(32, 16), (64, 40), (8, 9)], LAYOUTS_GRID, LAYOUTS_GRID,
                                                 [False, True]):
        if any(g is not None and shape[d] % mesh[g] for d, g in enumerate(src)):
            with pytest.raises(ValueError, match="ragged source"):
                tcosts.grid_plan_cost(shape, "float32", src, dst, mesh, mode_for=f, overlap=ov)
            continue
        assert tcosts.grid_plan_cost(shape, "float32", src, dst, mesh, mode_for=f, overlap=ov) == \
            rcosts.grid_plan_cost(shape, "float32", src, dst, mesh, mode_for=f, overlap=ov)


def test_grid_linalg_models_equal_the_references():
    for (m, k, n), mesh, mode, ov, layout in itertools.product(
        [(1024, 1024, 1024), (100, 37, 64), (8, 1, 8)], [(2, 2), (2, 4), (1, 3)],
        [None, "bf16", "int8_block"], [False, True], ["grid", "rowcol", "colrow"],
    ):
        kw = dict(mode=mode, overlap=ov, layout=layout, compute_ms_per_step=0.25, gbps=GBPS)
        assert tcosts.summa_grid_model(m, k, n, mesh, **kw) == rcosts.summa_grid_model(m, k, n, mesh, **kw)
    for (m, n), mesh, tiles, mode, ov in itertools.product(
        [(4096, 512), (100, 37), (64, 64)], [(2, 2), (2, 4)], [1, 2], [None, "int8_block"], [False, True],
    ):
        kw = dict(tiles_per_proc=tiles, mode=mode, overlap=ov, compute_ms_per_step=0.1, gbps=GBPS)
        assert tcosts.grid_qr_model(m, n, mesh, **kw) == rcosts.grid_qr_model(m, n, mesh, **kw)
    for (m, n), mesh, it, mode in itertools.product([(1024, 256), (100, 37)], [(2, 2), (2, 4)], [1, 5, 12],
                                                    [None, "bf16"]):
        kw = dict(iterations=it, mode=mode, compute_ms_per_step=0.1, gbps=GBPS)
        assert tcosts.qdwh_svd_model(m, n, mesh, **kw) == rcosts.qdwh_svd_model(m, n, mesh, **kw)
    with pytest.raises(ValueError, match="SUMMA layout"):
        tcosts.summa_grid_model(8, 8, 8, (2, 2), layout="diag")


# --------------------------------------------------------------------- #
# LayoutSolver                                                            #
# --------------------------------------------------------------------- #
def _solvers(**kw):
    return tcosts.LayoutSolver(gbps=GBPS, **kw), rcosts.LayoutSolver(gbps=GBPS, **kw)


@pytest.mark.parametrize("size", [2, 8])
def test_solver_price_equals_the_references(size):
    for kw in ({}, {"precision": "int8_block", "threshold": 0}, {"precision": "auto", "choose_precision": True},
               {"overlap": True, "compute_ms_per_step": 0.3}):
        mine, ref = _solvers(size=size, **kw)
        for shape, src, dst in itertools.product(SHAPES[:3], LAYOUTS_1D, LAYOUTS_1D):
            assert mine.price(shape, "float32", src, dst) == ref.price(shape, "float32", src, dst)
        assert mine.matmul_cost(64, 32, 16) == ref.matmul_cost(64, 32, 16)
    for mesh in [(2, 2), (2, 4)]:
        mine, ref = _solvers(mesh_shape=mesh, precision="bf16")
        for src, dst in itertools.product(LAYOUTS_GRID, LAYOUTS_GRID):
            assert mine.price((64, 32), "float32", src, dst) == ref.price((64, 32), "float32", src, dst)


def _summary(shapes, ndim_alts):
    """A layout-transfer summary: one chain of resplits per shape (the
    middle seam free over ``ndim_alts``), an implicit resplit and a
    matmul rider."""
    seams, idx = [], 0
    for shape in shapes:
        alts = tuple(ndim_alts)
        chain = [(0, 1, False), (1, None, False), (None, 0, True)]
        prev = None
        for src, dst, pinned in chain:
            seams.append({"index": idx, "op": "resplit", "line": 10 + idx, "shape": shape, "dtype": "float32",
                          "src": src, "dst": dst, "prev": prev, "pinned": pinned, "alternatives": alts})
            prev = idx
            idx += 1
    seams.append({"index": idx, "op": "implicit_resplit", "line": 99, "shape": shapes[0], "dtype": "float32",
                  "src": 1, "dst": 0})
    seams.append({"index": idx + 1, "op": "matmul", "line": 100, "shape": (64, 32, 16), "dtype": "float32"})
    return {"function": "pipeline", "seams": seams}


@pytest.mark.parametrize("size", [2, 4, 8])
@pytest.mark.parametrize("kw", [{}, {"precision": "int8_block", "threshold": 0, "choose_precision": True},
                                {"overlap": True, "beam_width": 1}])
def test_solver_solve_equals_the_references(size, kw):
    summary = _summary(SHAPES[:3], (None, 0, 1))
    mine, ref = _solvers(size=size, **kw)
    assert mine.solve(summary) == ref.solve(summary)


# --------------------------------------------------------------------- #
# plans                                                                   #
# --------------------------------------------------------------------- #
@contextlib.contextmanager
def precision(mode, threshold=None):
    saved = [(m, m.get_collective_precision(), m.get_collective_threshold()) for m in (rcq, tcq)]
    try:
        for m in (rcq, tcq):
            m.set_collective_precision(mode)
            if threshold is not None:
                m.set_collective_threshold(threshold)
        yield
    finally:
        for m, prec, thr in saved:
            m.set_collective_precision(prec)
            m.set_collective_threshold(thr)


FIELDS = ("global_shape", "dtype", "src", "dst", "size", "mode", "steps", "wire_bytes",
          "exact_wire_bytes", "peak_live_bytes", "max_live_bytes", "mesh_shape", "out_shape", "key")


def _same_plan(mine, ref):
    for f in FIELDS:
        assert getattr(mine, f) == getattr(ref, f), f
    assert mine.explain() == ref.explain()
    wm, rwm = mine.wire_model(0.5), ref.wire_model(0.5)
    hops = rwm["rotate_hops_per_device"]
    assert {k: v for k, v in wm.items() if k != "critical_path_ms"} == \
        {k: v for k, v in rwm.items() if k != "critical_path_ms"}
    assert wm["critical_path_ms"] == {
        "serial": tcosts.critical_path_ms(ref.wire_bytes, hops, 0.5, overlap=False),
        "overlap": tcosts.critical_path_ms(ref.wire_bytes, hops, 0.5, overlap=True),
    }


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8_block", "auto"])
def test_plans_equal_the_references(mode):
    with precision(mode, threshold=1024):
        for shape, dt, src, dst, p in itertools.product(
            [(64, 32), (56, 21, 3)], ["float32", "bfloat16", "int32"], LAYOUTS_1D, LAYOUTS_1D, [1, 2, 4, 7],
        ):
            if src is not None and shape[src] % p:
                with pytest.raises(ValueError, match="ragged source"):
                    trd.plan(shape, dt, src, dst, p)
                continue
            _same_plan(trd.plan(shape, dt, src, dst, p), rrd.plan(shape, dt, src, dst, p))
        for mesh, src, dst in itertools.product([(2, 2), (2, 4)], LAYOUTS_GRID, LAYOUTS_GRID):
            p = mesh[0] * mesh[1]
            _same_plan(trd.plan((64, 40), "float32", src, dst, p, mesh_shape=mesh),
                       rrd.plan((64, 40), "float32", src, dst, p, mesh_shape=mesh))
        # tuple spellings over one mesh axis are their compat ints
        _same_plan(trd.plan((64, 32), torch.float32, (None, 0), (0, None), 4),
                   rrd.plan((64, 32), "float32", (None, 0), (0, None), 4))


def test_monolithic_model_and_max_live_bytes_equal_the_references():
    for shape, src, dst, p in itertools.product([(64, 32), (40, 7)], LAYOUTS_1D, LAYOUTS_1D, [1, 4, 8]):
        assert trd.monolithic_model(shape, "float32", src, dst, p) == \
            rrd.monolithic_model(shape, "float32", src, dst, p)
    peak = trd.plan((64, 64), "float32", 0, 1, 4).peak_live_bytes
    assert trd.plan((64, 64), "float32", 0, 1, 4, max_live_bytes=peak).peak_live_bytes == peak
    for mod in (trd, rrd):
        with pytest.raises(ValueError, match="max_live_bytes"):
            mod.plan((64, 64), "float32", 0, 1, 4, max_live_bytes=peak - 1)
        with pytest.raises(ValueError, match="max_live_bytes"):
            mod.plan((64, 64), "float32", (0, 1), (1, 0), 4, mesh_shape=(2, 2), max_live_bytes=100)
        with pytest.raises(ValueError, match="does not tile"):
            mod.plan((64, 64), "float32", (0, 1), (1, 0), 4, mesh_shape=(2, 4))
        with pytest.raises(ValueError, match="mesh size"):
            mod.plan((64, 64), "float32", 0, 1, 0)


def test_plan_cache_keys_on_the_policies():
    trd.clear_plan_cache()
    assert trd.plan_cache_size() == 0
    a = trd.plan((64, 32), "float32", 0, 1, 4)
    assert trd.plan((64, 32), "float32", 0, 1, 4) is a and trd.plan_cache_size() == 1
    with precision("int8_block", threshold=0):
        b = trd.plan((64, 32), "float32", 0, 1, 4)
    assert b is not a and b.mode == "int8_block" and a.mode is None and trd.plan_cache_size() == 2
    with trd.redistribution("planned"):
        trd.plan((64, 32), "float32", 0, 1, 4)
    assert trd.plan_cache_size() == 3
    trd.clear_plan_cache()
    assert trd.plan_cache_size() == 0


# --------------------------------------------------------------------- #
# the policy knobs and their key tokens                                   #
# --------------------------------------------------------------------- #
def test_comm_surface_equals_the_references():
    assert sorted(htt.comm.__all__) == sorted(ht.comm.__all__)
    assert trd.__all__ == rrd.__all__
    assert sorted(tov.__all__) == sorted(rov.__all__)


def test_policy_knobs_and_tokens_equal_the_references():
    pairs = [(trd._redist_token, rrd._redist_token), (tov._overlap_token, rov._overlap_token)]
    for mine, _ in pairs:
        assert mine in tcompile._KEY_CONTEXT
    for pol, thr, ov in itertools.product(["planned", "monolithic", "auto"], [0, 1 << 16], ["on", "off", "auto"]):
        with trd.redistribution(pol), rrd.redistribution(pol), tov.overlap(ov), rov.overlap(ov):
            for m in (trd, rrd):
                m.set_redistribution_threshold(thr)
            try:
                assert trd.get_redistribution() == rrd.get_redistribution() == pol
                assert tov.get_overlap() == rov.get_overlap() == ov
                for mine, ref in pairs:
                    assert mine() == ref()
            finally:
                for m in (trd, rrd):
                    m.set_redistribution_threshold(1 << 16)
    for mod in (trd, rrd):
        with pytest.raises(ValueError, match="redistribution policy"):
            mod.set_redistribution("eager")
        with pytest.raises(ValueError, match="non-negative"):
            mod.set_redistribution_threshold(-1)
    for mod in (tov, rov):
        with pytest.raises(ValueError, match="overlap mode"):
            mod.set_overlap("maybe")


def test_overlap_enabled():
    """"on" overlaps every ring of two or more positions, "off" none;
    "auto" is serial on the port (every position shares one card), as the
    reference's "auto" is off a TPU."""
    for mode, size in itertools.product(["on", "off", "auto"], [1, 2, 8]):
        with tov.overlap(mode), rov.overlap(mode):
            assert tov.overlap_enabled(size) == rov.overlap_enabled(size) == (mode == "on" and size > 1)


def test_policy_flips_change_the_context_token():
    base = tcompile.context_token()
    with trd.redistribution("planned"):
        planned = tcompile.context_token()
        with tov.overlap("on"):
            both = tcompile.context_token()
    assert len({base, planned, both}) == 3
    trd.set_redistribution_threshold(0)
    try:
        assert tcompile.context_token() != base
    finally:
        trd.set_redistribution_threshold(1 << 16)
    assert tcompile.context_token() == base


# --------------------------------------------------------------------- #
# telemetry, dispatches, traces                                           #
# --------------------------------------------------------------------- #
@pytest.fixture
def tels():
    states = [(c, c.is_enabled()) for c in (tcore, rcore)]
    for c in (tcore, rcore):
        c.enable()
        c.reset()
    yield
    for c, was in states:
        c.reset()
        (c.enable if was else c.disable)()


def _comms(p):
    if len(jax.devices()) < p:
        pytest.skip(f"needs {p} devices")
    return XlaCommunication(jax.devices()[:p]), htt.TorchCommunication(["cpu"] * p)


def _resplit_keys(snap):
    counters = {k: v for k, v in snap["counters"].items()
                if k.startswith("comm.") and k != "comm.reshards"}
    spans = {k: v["count"] for k, v in snap["spans"].items() if k.startswith("comm:") and k != "comm:reshard"}
    return counters, spans


@pytest.mark.parametrize("mode", ["f32", "int8_block"])
@pytest.mark.parametrize("pol", ["planned", "auto"])
def test_planned_resplit_telemetry_equals_the_references(tels, mode, pol):
    rcomm, tcomm = _comms(4)
    data = np.random.default_rng(5).standard_normal((64, 300)).astype(np.float32)
    r = ht.array(data, split=0, comm=rcomm)
    t = htt.array(data, split=0, comm=tcomm)
    with precision(mode, threshold=0), trd.redistribution(pol), rrd.redistribution(pol):
        for c in (tcore, rcore):
            c.reset()
        for dst in (1, None, 0):
            ht.resplit(r, dst)
            htt.resplit(t, dst)
    got, want = _resplit_keys(tcore.snapshot()), _resplit_keys(rcore.snapshot())
    assert got == want
    assert got[0]["comm.resplit.planned"] == (2 if pol == "planned" else 1)  # 0 -> 0 is a no-op
    assert got[1]["comm:resplit"] == got[0]["comm.resplit.planned"]
    assert got[1]["comm:resplit:step:issue"] == got[1]["comm:resplit:step:consume"] == got[1]["comm:resplit"]


@pytest.mark.parametrize("mode", ["f32", "int8_block"])
def test_one_dispatch_a_planned_resplit(mode):
    _, tcomm = _comms(8)
    data = np.random.default_rng(6).standard_normal((64, 1024)).astype(np.float32)
    t = htt.array(data, split=0, comm=tcomm)
    with precision(mode):
        with ttracing.counting_dispatches() as d:
            out = htt.resplit(t, 1)
        assert d.count == 1
        with ttracing.counting_dispatches() as d:
            trd.redistribute(t.larray, 1, tcomm, src=0)
        assert d.count == 1
    assert out.split == 1


def test_resplit_inside_a_fuse_trace_is_exact():
    """Inside ``htt.fuse`` the resplit falls back to the monolithic copy
    (exact, no plan) even under ``int8_block``, as the reference's trace
    branch makes it; the eager call quantizes."""
    rcomm, tcomm = _comms(8)
    data = np.random.default_rng(7).standard_normal((64, 1024)).astype(np.float32)

    def mine(a):
        return htt.resplit(a, 1) * 2.0

    def ref(a):
        return ht.resplit(a, 1) * 2.0

    with precision("int8_block"):
        got = htt.fuse(mine)(htt.array(data, split=0, comm=tcomm))
        want = ht.fuse(ref)(ht.array(data, split=0, comm=rcomm))
        eager = mine(htt.array(data, split=0, comm=tcomm))
    np.testing.assert_array_equal(got.numpy(), data * 2.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.larray))
    assert not np.array_equal(eager.numpy(), data * 2.0)
