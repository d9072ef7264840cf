"""The port's grid redistribution and the grid calls' telemetry held
against the JAX package's, on (2, 2) and (2, 4) grids of positions.

Covered: every splits-tuple pair of a 2-D array under ``int8_block`` on
2 x 4 (the planner's chain of per-mesh-axis stages, the cyclic transpose
``(0, 1) -> (1, 0)`` through replicated), each stage kind exact, ``bf16``
and ``int8_block`` on both grids, a ragged destination padded through
``commit_split`` and a ragged source left exact, each under "planned"
with the collective threshold at 0, bitwise; and the byte ledger, counters and spans that a
planned grid resplit and the grid ``matmul`` (SUMMA), ``qr`` (CAQR) and
``svd`` (QDWH) leave, equal to the reference's.
"""

import contextlib
import itertools

import numpy as np
import pytest

import jax

import heat_tpu as ht
from heat_tpu.comm import compressed as rcq
from heat_tpu.comm import redistribute as rrd
from heat_tpu.core.communication import grid_comm as ref_grid_comm
from heat_tpu.telemetry import _core as rcore
from test_torch_reference_state import reference_state  # noqa: F401,E402  (restores the JAX package's state)

import heat_tpu_torch as htt
from heat_tpu_torch.comm import compressed as tcq
from heat_tpu_torch.comm import redistribute as trd
from heat_tpu_torch.telemetry import _core as tcore

MESHES = [(2, 2), (2, 4)]
LAYOUTS = [
    s for s in itertools.product((None, 0, 1), repeat=2)
    if len([g for g in s if g is not None]) == len({g for g in s if g is not None})
]


def _comms(mesh):
    if len(jax.devices()) < mesh[0] * mesh[1]:
        pytest.skip(f"needs {mesh[0] * mesh[1]} devices")
    return ref_grid_comm(mesh), htt.grid_comm(mesh, ["cpu"] * (mesh[0] * mesh[1]))


@contextlib.contextmanager
def policy(precision, redistribution="planned"):
    saved = [(m, m.get_collective_precision(), m.get_collective_threshold()) for m in (rcq, tcq)]
    saved_rd = [(m, m.get_redistribution()) for m in (rrd, trd)]
    try:
        for m in (rcq, tcq):
            m.set_collective_precision(precision)
            m.set_collective_threshold(0)
        for m in (rrd, trd):
            m.set_redistribution(redistribution)
        yield
    finally:
        for m, prec, thr in saved:
            m.set_collective_precision(prec)
            m.set_collective_threshold(thr)
        for m, pol in saved_rd:
            m.set_redistribution(pol)


def _bits(a):
    a = np.asarray(a)
    return a.view(f"u{a.dtype.itemsize}") if a.dtype.kind == "f" else a


def _resplit_both(data, comms, src, dst):
    rcomm, tcomm = comms
    r = ht.array(data, splits=src, comm=rcomm)
    t = htt.array(data, splits=src, comm=tcomm)
    want, got = ht.resplit(r, dst), htt.resplit(t, dst)
    assert got.splits == want.splits == dst
    np.testing.assert_array_equal(_bits(got.larray.numpy()), _bits(want.larray))
    assert tuple(got._buffer.shape) == tuple(np.asarray(want._buffer).shape)
    return got.larray.numpy()


def test_every_grid_pair_int8():
    """Every pair on the reference benchmark's 2 x 4 mesh (the 2 x 2 mesh
    runs each stage kind below, in all three modes)."""
    mesh = (2, 4)
    comms = _comms(mesh)
    data = np.random.default_rng(sum(mesh)).standard_normal((16, 24)).astype(np.float32)
    with policy("int8_block"):
        for src, dst in itertools.product(LAYOUTS, LAYOUTS):
            got = _resplit_both(data, comms, src, dst)
            moved = any(g is not None and dst[d] != g for d, g in enumerate(src))
            assert np.array_equal(got, data) == (not moved), (src, dst)


STAGE_PAIRS = [((0, 1), (1, 0)), ((0, None), (None, 0)), ((0, 1), (None, None)), ((None, None), (1, 0)),
               ((0, 1), (1, None)), ((None, 1), (0, None))]


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8_block"])
@pytest.mark.parametrize("mesh", MESHES)
def test_grid_stage_kinds(mesh, mode):
    comms = _comms(mesh)
    data = np.random.default_rng(3).standard_normal((16, 24)).astype(np.float32)
    with policy(mode):
        for src, dst in STAGE_PAIRS:
            got = _resplit_both(data, comms, src, dst)
            if mode == "f32":
                np.testing.assert_array_equal(got, data)


@pytest.mark.parametrize("mesh", MESHES)
def test_grid_ragged_destination_and_source(mesh):
    """(8, 10): axis 1 divides neither 4 nor (on (2, 2)) its mesh axis
    both ways; a divisible source moving onto it pads it first, a ragged
    source stays on the monolithic path in both packages."""
    comms = _comms(mesh)
    data = np.random.default_rng(4).standard_normal((8, 10)).astype(np.float32)
    with policy("int8_block"):
        for src, dst in [((0, None), (None, 0)), ((0, None), (1, 0)), ((None, None), (0, 1)),
                         ((None, 1), (0, None)), ((1, 0), (0, 1))]:
            _resplit_both(data, comms, src, dst)


# --------------------------------------------------------------------- #
# telemetry                                                               #
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


def _keys(snap, names):
    counters = {k: v for k, v in snap["counters"].items()
                if k.startswith("comm.") and k != "comm.reshards"}
    spans = {k: v["count"] for k, v in snap["spans"].items() if k.split(":")[1:2] and k.split(":")[1] in names}
    return counters, spans


@pytest.mark.parametrize("mesh", MESHES)
def test_grid_calls_leave_the_references_telemetry(tels, mesh):
    comms = _comms(mesh)
    rng = np.random.default_rng(8)
    a = rng.standard_normal((64, 16)).astype(np.float32)
    b = rng.standard_normal((16, 24)).astype(np.float32)
    out = []
    for pkg, comm, core in ((ht, comms[0], rcore), (htt, comms[1], tcore)):
        x = pkg.array(a, splits=(0, 1), comm=comm)
        y = pkg.array(b, splits=(0, 1), comm=comm)
        z = pkg.array(b, splits=(None, 1), comm=comm)
        w = pkg.array(a, splits=(0, None), comm=comm)
        core.reset()
        pkg.matmul(x, y)
        pkg.matmul(w, z)
        pkg.linalg.qr(x)
        pkg.linalg.svd(x)
        with policy("int8_block"):
            pkg.resplit(x, (1, 0))
        out.append(_keys(core.snapshot(), {"summa2d", "qr2d", "svd2d", "resplit"}))
    assert out[1] == out[0]
    counters, spans = out[1]
    for op in ("summa2d", "qr2d", "svd2d", "resplit"):
        assert counters[f"comm.collectives.{op}"] == (2 if op == "summa2d" else 1)
        assert spans[f"comm:{op}"] == counters[f"comm.collectives.{op}"]
        assert spans[f"comm:{op}:step:issue"] == spans[f"comm:{op}:step:consume"] == spans[f"comm:{op}"]
