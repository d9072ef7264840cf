"""The port's planned redistribution held against the JAX package's, on one
mesh axis: the same numpy inputs laid out at ``src`` and resplit to
``dst`` in both packages, at 2, 4, 7 and 8 positions, exact and under
``bf16`` / ``int8_block`` with the collective threshold at 0.

Covered: the three probes of fault C8 (``resplit`` 0 -> 1, ``resplit_``
and a mixed-split ``x + y`` of a 64 x 1024 float32 array at 8 positions
under ``int8_block``, the reference's planner quantizing every moving
piece); every src -> dst pair of a 2-D and a 3-D array under the
"planned" and "auto" policies (ragged destinations padded through
``commit_split``, a ragged source left exact); float32, bfloat16,
float64 and int32 (the last two exact); the communicator's
``commit_split`` and ``alltoall`` with the source named.

Every comparison is bitwise (float values through their bit patterns):
the wire format is deterministic, so the port's plan gives the
reference's values bit for bit, and an exact plan the input's.
"""

import contextlib
import itertools

import numpy as np
import pytest
import torch

import jax

import heat_tpu as ht
from heat_tpu.comm import compressed as rcq
from heat_tpu.comm import redistribute as rrd
from heat_tpu.core.communication import XlaCommunication
from test_torch_reference_state import reference_state  # noqa: F401,E402  (restores the JAX package's state)

import heat_tpu_torch as htt
from heat_tpu_torch.comm import compressed as tcq
from heat_tpu_torch.comm import redistribute as trd

P = len(jax.devices())
SIZES = [2, 4, 7, 8]
MODES = ["f32", "bf16", "int8_block"]


def _comms(p):
    if P < p:
        pytest.skip(f"needs {p} devices")
    return XlaCommunication(jax.devices()[:p]), htt.TorchCommunication(["cpu"] * p)


@contextlib.contextmanager
def policy(precision="f32", redistribution="auto", threshold=None):
    """Both packages under one collective precision and redistribution
    policy; ``threshold`` (when given) sets both packages' collective and
    redistribution thresholds."""
    saved = [(m, m.get_collective_precision(), m.get_collective_threshold()) for m in (rcq, tcq)]
    saved_rd = [(m, m.get_redistribution(), m.get_redistribution_threshold()) for m in (rrd, trd)]
    try:
        for m in (rcq, tcq):
            m.set_collective_precision(precision)
            if threshold is not None:
                m.set_collective_threshold(threshold)
        for m in (rrd, trd):
            m.set_redistribution(redistribution)
            if threshold is not None:
                m.set_redistribution_threshold(threshold)
        yield
    finally:
        for m, prec, thr in saved:
            m.set_collective_precision(prec)
            m.set_collective_threshold(thr)
        for m, pol, thr in saved_rd:
            m.set_redistribution(pol)
            m.set_redistribution_threshold(thr)


def _bits(a):
    a = np.asarray(a)
    if a.dtype.kind == "f":
        return a.view(f"u{a.dtype.itemsize}")
    return a


def _values(x):
    """A DNDarray's true view as numpy (bfloat16 through float32, which
    holds it exactly)."""
    if isinstance(x, htt.DNDarray):
        t = x.larray
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    a = x.larray
    return np.asarray(a.astype("float32") if str(a.dtype) == "bfloat16" else a)


def _same(port, ref):
    got, want = _values(port), _values(ref)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _pair(data, split, comms, dtype=None):
    rcomm, tcomm = comms
    r = ht.array(data, split=split, comm=rcomm)
    t = htt.array(data, split=split, comm=tcomm)
    if dtype is not None:
        r, t = r.astype(getattr(ht, dtype)), t.astype(getattr(htt, dtype))
    return r, t


# --------------------------------------------------------------------- #
# C8: the three probes                                                   #
# --------------------------------------------------------------------- #
@pytest.fixture
def probe():
    comms = _comms(8)
    x = np.random.default_rng(0).standard_normal((64, 1024)).astype(np.float32)
    return comms, x


def test_c8_resplit_0_to_1_is_the_references(probe):
    comms, x = probe
    with policy("int8_block"):
        r, t = _pair(x, 0, comms)
        want, got = ht.resplit(r, 1), htt.resplit(t, 1)
    assert got.split == want.split == 1
    _same(got, want)
    err = np.abs(_values(got) - x).max()
    assert 0.0 < err <= np.abs(x).max() / 254.0 + 1e-6


def test_c8_resplit_inplace_is_the_references(probe):
    comms, x = probe
    with policy("int8_block"):
        r, t = _pair(x, 0, comms)
        r.resplit_(1)
        t.resplit_(1)
    assert t.split == r.split == 1
    _same(t, r)
    assert np.abs(_values(t) - x).max() > 0.0


def test_c8_mixed_split_add_is_the_references(probe):
    comms, x = probe
    y = np.random.default_rng(1).standard_normal((64, 1024)).astype(np.float32)
    with policy("int8_block"):
        r1, t1 = _pair(x, 0, comms)
        r2, t2 = _pair(y, 1, comms)
        want, got = r1 + r2, t1 + t2
    assert got.split == want.split == 0
    _same(got, want)
    assert not np.array_equal(_values(got), x + y)


# --------------------------------------------------------------------- #
# every src -> dst pair                                                   #
# --------------------------------------------------------------------- #
LAYOUTS = [None, 0, 1]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("p", SIZES)
def test_every_pair_2d_planned(p, mode):
    """All nine pairs of a (4p, 3p + 5) float32 array under "planned"
    with the thresholds at 0: axis 1 is ragged, so a 0 -> 1 change pads it
    before the pieces are cut; 1 -> anything starts from a ragged source
    and stays exact in both packages."""
    comms = _comms(p)
    data = np.random.default_rng(p).standard_normal((4 * p, 3 * p + 5)).astype(np.float32)
    with policy(mode, "planned", threshold=0):
        for src, dst in itertools.product(LAYOUTS, LAYOUTS):
            r, t = _pair(data, src, comms)
            want, got = ht.resplit(r, dst), htt.resplit(t, dst)
            assert got.split == want.split == dst
            _same(got, want)
            assert tuple(got._buffer.shape) == tuple(np.asarray(want._buffer).shape)


@pytest.mark.parametrize("mode", ["int8_block", "bf16"])
@pytest.mark.parametrize("p", [4, 7])
def test_every_pair_3d_auto(p, mode):
    """A (2p, 5, p + 3) array under "auto" with the thresholds at 0: the
    split -> split changes plan (pieces three-dimensional, flattened in
    their own row-major order), split -> None and None -> split stay
    monolithic, as the reference's "auto" keeps them."""
    comms = _comms(p)
    data = np.random.default_rng(10 + p).standard_normal((2 * p, 5, p + 3)).astype(np.float32)
    with policy(mode, "auto", threshold=0):
        for src, dst in itertools.product([None, 0, 1, 2], repeat=2):
            r, t = _pair(data, src, comms)
            want, got = ht.resplit(r, dst), htt.resplit(t, dst)
            assert got.split == want.split == dst
            _same(got, want)


def test_auto_threshold_keeps_small_changes_exact():
    """Under the default thresholds, a split -> split change below 64 KiB
    stays exact in both packages; at 64 KiB it quantizes in both."""
    comms = _comms(8)
    for rows in (8, 16):  # 32 KiB and 64 KiB of float32
        data = np.random.default_rng(rows).standard_normal((rows, 1024)).astype(np.float32)
        with policy("int8_block"):
            r, t = _pair(data, 0, comms)
            want, got = ht.resplit(r, 1), htt.resplit(t, 1)
        _same(got, want)
        assert np.array_equal(_values(got), data) == (rows == 8)


@pytest.mark.parametrize("dtype", ["bfloat16", "float64", "int32"])
@pytest.mark.parametrize("mode", ["bf16", "int8_block"])
def test_dtypes(dtype, mode):
    """bfloat16 pieces go through the wire format (quantized as float32,
    rounded back to bfloat16); float64 and int32 stay exact."""
    comms = _comms(8)
    rng = np.random.default_rng(3)
    data = (rng.standard_normal((32, 45)) * 100).astype(np.float32)
    if dtype == "int32":
        data = np.round(data)
    with policy(mode, "planned", threshold=0):
        for src, dst in [(0, 1), (1, 0), (0, None), (None, 1)]:
            r, t = _pair(data, src, comms, dtype)
            want, got = ht.resplit(r, dst), htt.resplit(t, dst)
            assert str(got.dtype.__name__) == str(want.dtype.__name__) == dtype
            _same(got, want)
            if dtype != "bfloat16":
                np.testing.assert_array_equal(_values(got), _values(t))


@pytest.mark.parametrize("p", [4, 8])
@pytest.mark.parametrize("mode", MODES)
def test_mixed_split_binary_ops_and_resplit_inplace(p, mode):
    comms = _comms(p)
    rng = np.random.default_rng(p)
    x = rng.standard_normal((8 * p, 40)).astype(np.float32)
    y = rng.standard_normal((8 * p, 40)).astype(np.float32)
    with policy(mode, "auto", threshold=0):
        for s1, s2 in [(0, 1), (1, 0)]:
            r1, t1 = _pair(x, s1, comms)
            r2, t2 = _pair(y, s2, comms)
            for op in ("add", "mul", "sub"):
                want, got = getattr(ht, op)(r1, r2), getattr(htt, op)(t1, t2)
                assert got.split == want.split == s1
                _same(got, want)
            r1.resplit_(s2)
            t1.resplit_(s2)
            _same(t1, r1)


@pytest.mark.parametrize("p", [4, 7])
@pytest.mark.parametrize("mode", ["f32", "int8_block"])
def test_commit_split_and_alltoall_with_the_source_named(p, mode):
    """The communicator's own entry points on true-shape tensors: the
    reference reads the source from the array's sharding, the port takes
    it as ``src``.  A ragged destination pads through ``commit_split``;
    ``resplit`` and ``alltoall`` leave it to the monolithic path."""
    rcomm, tcomm = _comms(p)
    data = np.random.default_rng(p).standard_normal((3 * p, 2 * p + 1)).astype(np.float32)
    with policy(mode, "planned", threshold=0):
        src = ht.array(data, split=0, comm=rcomm).larray
        want = np.asarray(rcomm.commit_split(src, 1))
        got = tcomm.commit_split(torch.from_numpy(data), 1, src=0).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want))
        assert got.shape[1] == tcomm.padded_size(2 * p + 1)
        wide = np.random.default_rng(0).standard_normal((2 * p, 3 * p)).astype(np.float32)
        src = ht.array(wide, split=0, comm=rcomm).larray
        want = np.asarray(rcomm.alltoall(src, 1, 0))
        got = tcomm.alltoall(torch.from_numpy(wide), 1, 0).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want))
        assert (mode == "f32") == np.array_equal(got, wide)
