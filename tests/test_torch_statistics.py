"""The rest of the port's statistics held against the JAX package:
``argmax``, ``average``, ``bincount``, ``cov``, ``histc``,
``histogram``, ``kurtosis``, ``skew``, ``maximum``, ``minimum``,
``median`` and ``percentile`` (every route: the ring rank sort for
``axis=None``, the distributed axis sort along the split, a local sort
elsewhere), and their DNDarray method forms.

Both packages get the same seeded numpy inputs at 8 positions and at a
ragged 7, splits None/0/1.  Tolerances:

* exact (bit for bit, shapes, splits and types equal): ``argmax``,
  ``maximum``, ``minimum``, ``bincount`` counts, ``histogram``/``histc``
  counts and edges, the exact percentile methods (lower, higher,
  nearest, midpoint), and the ``int8_block`` ``average`` at 4 positions
  on integer-valued data (whose per-position partial sums are exact in
  any order, so the quantized ring is held bit for bit);
* ``linear`` percentiles and medians: float32 within two ulps (rtol
  2**-22), float64 within rtol 1e-14, atol 1e-14 (the reference's compiled
  interpolation of host-constant weights lands up to 8 float64 ulps from
  the same formula evaluated eagerly, by either package);
* reductions whose summation order is the library's: ``average``,
  weighted ``bincount``: float32 rtol 1e-6, float64 1e-14; ``cov``:
  float32 rtol 1e-5 with atol 1e-6, float64 1e-12; ``kurtosis``/``skew``:
  float32 rtol 1e-4 with atol 1e-5, float64 1e-10.

Cases come from the reference's ``test_statistics.py``,
``test_statistics_sweep.py``, ``test_distributed_sort.py`` and
``test_extended_stats_manip.py``.
"""

import numpy as np
import pytest

import jax

import heat_tpu as ht
from heat_tpu.comm import compressed as jcq
from test_torch_reference_state import reference_state  # noqa: F401,E402  (restores the JAX package's state)

import heat_tpu_torch as htt
from heat_tpu_torch.comm import compressed as tcq

_COMMS = {}


def comms(p: int):
    if p not in _COMMS:
        _COMMS[p] = (ht.core.communication.XlaCommunication(jax.devices()[:p]),
                     htt.TorchCommunication(["cpu"] * p))
    return _COMMS[p]


def both(data, split=None, p=8):
    rc, pc = comms(p)
    return ht.array(data, split=split, comm=rc), htt.array(data, split=split, comm=pc)


def host(x) -> np.ndarray:
    return np.asarray(x.larray) if hasattr(x.larray, "devices") else x.numpy()


def same(t, j, rtol=None, atol=0.0):
    if isinstance(j, (list, tuple)):
        for a, b in zip(t, j):
            same(a, b, rtol, atol)
        return
    assert t.shape == tuple(j.shape) and t.split == j.split, (t.shape, t.split, j.shape, j.split)
    assert t.dtype.__name__ == j.dtype.__name__, (t.dtype, j.dtype)
    got, want = host(t), host(j)
    if rtol is not None:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, equal_nan=True)
    elif got.dtype.kind == "f":
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_array_equal(got[~np.isnan(got)].view(f"u{got.itemsize}"),
                                      want[~np.isnan(want)].view(f"u{want.itemsize}"))
    else:
        np.testing.assert_array_equal(got, want)


def tol(dtype, f32, f64, atol32=0.0):
    return {"rtol": f64} if dtype == "float64" else {"rtol": f32, "atol": atol32}


def data(shape=(13, 5), dtype="float32", seed=0):
    rng = np.random.default_rng(seed)
    if dtype.startswith("int"):
        return rng.integers(-9, 10, size=shape).astype(dtype)
    return rng.normal(size=shape).astype(dtype)


SPLITS = [None, 0, 1]


# --------------------------------------------------------------------- #
# argmax, maximum, minimum                                                #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("split,dtype", [(None, "float32"), (0, "float32"), (1, "float32"), (0, "int32")])
def test_argmax_maximum_minimum(split, dtype):
    x = data(dtype=dtype)
    if dtype == "float32":
        x[3, 2] = x[7, 2] = np.nan  # the first NaN wins argmax
    r, t = both(x, split)
    for axis in (None, 0, 1):
        same(htt.argmax(t, axis), ht.argmax(r, axis))
        same(htt.argmax(t, axis, keepdims=True), ht.argmax(r, axis, keepdims=True))
        same(t.argmax(axis), r.argmax(axis))
    r2, t2 = both(data(dtype="float64", seed=1), split)
    for a, b in ((t, r), (t2, r2)):
        same(htt.maximum(t, a), ht.maximum(r, b))
        same(htt.minimum(t, a), ht.minimum(r, b))
    same(htt.maximum(t, 0.5), ht.maximum(r, 0.5))
    same(htt.minimum(t, 2), ht.minimum(r, 2))


# --------------------------------------------------------------------- #
# average                                                                 #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("dtype", ["float32", "float64", "int32"])
def test_average(split, dtype):
    x = data(dtype=dtype)
    r, t = both(x, split)
    k = tol(dtype, 1e-6, 1e-14)  # int32 averages in float32, as jnp.mean
    for axis in (None, 0, 1):
        same(htt.average(t, axis), ht.average(r, axis), **tol("float32" if dtype == "int32" else dtype, 1e-6, 1e-14))
        same(t.average(axis, returned=True), r.average(axis, returned=True),
             **tol("float32" if dtype == "int32" else dtype, 1e-6, 1e-14))
    rng = np.random.default_rng(2)
    for w, axis in ((rng.random(13).astype(np.float32), 0), (rng.integers(1, 4, 5), 1),
                    (rng.integers(1, 4, (13, 5)), None), (rng.random((13, 5)), 1)):
        (rw, tw) = both(w, None)
        same(htt.average(t, axis, weights=tw), ht.average(r, axis, weights=rw), **k)
        same(htt.average(t, axis, weights=tw, returned=True),
             ht.average(r, axis, weights=rw, returned=True), **k)
    with pytest.raises(ZeroDivisionError):
        htt.average(t, 0, weights=htt.zeros(13, comm=t.comm))
    with pytest.raises(ValueError):
        htt.average(t, 0, weights=htt.ones(4, comm=t.comm))


def test_average_int8_block_bitwise_the_reference_ring_at_four_positions():
    """Integer-valued float32 data: each position's partial sums are exact
    in any order, so what rides the quantized ring (B1, the hops, B2) is
    the same in both packages, and so is the result, bit for bit."""
    x = np.random.default_rng(4).integers(-50, 51, size=(4 * 256, 96)).astype(np.float32)
    r, t = both(x, 0, 4)
    with jcq.collective_precision("int8_block"), tcq.collective_precision("int8_block"):
        want, got = ht.average(r, axis=0), htt.average(t, axis=0)
    same(got, want)
    assert not np.array_equal(host(got), x.astype(np.float64).mean(0).astype(np.float32))  # it quantized


# --------------------------------------------------------------------- #
# bincount, histogram, histc                                              #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("p,split", [(8, 0), (7, 0), (8, None)])
def test_bincount(p, split):
    rng = np.random.default_rng(5)
    x = rng.integers(-2, 12, size=41).astype(np.int32)  # negatives count as 0
    r, t = both(x, split, p)
    same(htt.bincount(t), ht.bincount(r))
    same(htt.bincount(t, minlength=20), ht.bincount(r, minlength=20))
    for w in (rng.random(41).astype(np.float32), rng.random(41), rng.integers(0, 5, 41)):
        rw, tw = both(w, split, p)
        k = {} if w.dtype.kind == "i" else tol(w.dtype.name, 1e-6, 1e-14)
        same(htt.bincount(t, weights=tw), ht.bincount(r, weights=rw), **k)


@pytest.mark.parametrize("split,dtype", [(0, "float32"), (None, "float64"), (0, "int32")])
def test_histogram_edges_and_counts_exact(split, dtype):
    rng = np.random.default_rng(6)
    x = np.concatenate([rng.normal(size=200) * 3, np.arange(-5, 6)]).astype(dtype)  # values on edges
    r, t = both(x, split)
    for bins, rng_ in ((10, None), (7, (-5, 5)), (100, None), (4, (0.5, 0.5)), (np.array([-3, -1, 0, 2.5, 9]), None)):
        same(htt.histogram(t, bins=bins, range=rng_), ht.histogram(r, bins=bins, range=rng_))
    same(htt.histogram(t, bins=5, density=True), ht.histogram(r, bins=5, density=True), rtol=1e-6)
    for w in (rng.random(x.shape[0]).astype(np.float32), rng.random(x.shape[0])):  # f64 weights promote x
        rw, tw = both(w, split)
        same(htt.histogram(t, bins=6, weights=tw), ht.histogram(r, bins=6, weights=rw), rtol=1e-6)
    if dtype != "int32":
        same(htt.histc(t, bins=9), ht.histc(r, bins=9))
        same(htt.histc(t, bins=8, min=-4.0, max=4.0), ht.histc(r, bins=8, min=-4.0, max=4.0))
        out = htt.zeros(9, dtype=getattr(htt, dtype), comm=t.comm)
        assert htt.histc(t, bins=9, out=out) is out
        same(out, ht.histc(r, bins=9))


def test_histogram_nan_counts_in_no_bin():
    x = np.array([0.0, 1.0, np.nan, 2.0, 3.0, np.nan], np.float32)
    r, t = both(x, 0)
    same(htt.histogram(t, bins=3, range=(0, 3)), ht.histogram(r, bins=3, range=(0, 3)))


# --------------------------------------------------------------------- #
# cov, kurtosis, skew                                                     #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("dtype", ["float32", "float64", "int32"])
def test_cov(split, dtype):
    x = data((13, 5), dtype)
    r, t = both(x, split)
    k = tol(dtype, 1e-5, 1e-12, 1e-6)  # int32 in float32, as jnp.mean promotes it
    for kw in ({}, {"rowvar": False}, {"bias": True}, {"ddof": 0}, {"rowvar": False, "ddof": 3}):
        same(htt.cov(t, **kw), ht.cov(r, **kw), **k)
    ry, ty = both(data((13, 5), dtype, seed=3), split)
    same(htt.cov(t, ty), ht.cov(r, ry), **k)
    r1, t1 = both(x[:, 0], split and 0)
    same(htt.cov(t1), ht.cov(r1), **k)
    with pytest.raises(TypeError):
        htt.cov(t, ddof=1.5)


@pytest.mark.parametrize("split,dtype", [(0, "float32"), (1, "float64")])
def test_kurtosis_skew(split, dtype):
    x = (data((40, 6), dtype) ** 3 if dtype != "int32" else data((40, 6), dtype)).astype(dtype)
    r, t = both(x, split)
    k = tol(dtype, 1e-4, 1e-10, 1e-5)
    for axis in (None, 0):
        for unbiased in (True, False):
            same(htt.skew(t, axis, unbiased), ht.skew(r, axis, unbiased), **k)
            same(htt.kurtosis(t, axis, unbiased, unbiased), ht.kurtosis(r, axis, unbiased, unbiased), **k)
    same(t.skew(0), r.skew(0), **k)
    same(t.kurtosis(1), r.kurtosis(1), **k)


# --------------------------------------------------------------------- #
# percentile and median                                                   #
# --------------------------------------------------------------------- #
METHODS = ["linear", "lower", "higher", "midpoint", "nearest"]


def qtol(method, dtype):
    if method != "linear":
        return {}
    return {"rtol": 1e-14, "atol": 1e-14} if dtype != "float32" else {"rtol": 2.0 ** -22}


ROUTES = [(8, None, "linear"), (7, 0, "linear"), (7, 0, "nearest"), (8, 1, "linear")] + [
    (8, 0, m) for m in METHODS]


@pytest.mark.parametrize("p,split,method", ROUTES)
def test_percentile_every_route(p, split, method):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(101, 9)).astype(np.float32)
    r, t = both(x, split, p)
    for axis in (None, 0, 1):
        for q in (30.0, [25.0, 75.0], 0.0, 100.0):
            same(htt.percentile(t, q, axis=axis, interpolation=method),
                 ht.percentile(r, q, axis=axis, interpolation=method), **qtol(method, "float32"))


@pytest.mark.parametrize("p,split,dtype", [(8, 0, "float64"), (7, 1, "int32"), (8, None, "int64")])
def test_percentile_exact_types_interpolate_in_float64(p, split, dtype):
    x = data((37, 8), dtype, seed=8)
    r, t = both(x, split, p)
    for axis in (None, 0, 1):
        same(htt.percentile(t, [10.0, 50.0, 93.0], axis=axis), ht.percentile(r, [10.0, 50.0, 93.0], axis=axis),
             **qtol("linear", dtype))
        same(htt.median(t, axis), ht.median(r, axis), **qtol("linear", dtype))


@pytest.mark.parametrize("split", [None, 0, 1])
def test_percentile_keepdims_q_rank_nan_and_empty(split):
    rng = np.random.default_rng(9)
    x = rng.normal(size=(31, 6)).astype(np.float32)
    x[4, 2] = np.nan  # poisons its column's quantiles and the global ones
    r, t = both(x, split)
    k = qtol("linear", "float32")
    for axis in (None, 0, 1):
        same(htt.percentile(t, 40.0, axis=axis, keepdims=True), ht.percentile(r, 40.0, axis=axis, keepdims=True), **k)
        same(htt.median(t, axis, True), ht.median(r, axis, True), **k)
        same(t.median(axis, keepdims=True), r.median(axis, keepdims=True), **k)
        same(t.percentile(60.0, axis), r.percentile(60.0, axis), **k)
    q2 = [[10.0, 20.0], [30.0, 90.0]]
    for axis in (None, 1):
        same(htt.percentile(t, q2, axis=axis), ht.percentile(r, q2, axis=axis), **k)
    re, te = both(np.zeros((0, 4), np.float32), None)
    for axis in (None, 0):
        same(htt.percentile(te, 50.0, axis=axis), ht.percentile(re, 50.0, axis=axis))
    with pytest.raises(TypeError):
        htt.median(t, 0, htt.zeros(6, comm=t.comm))
    out = htt.zeros(6, comm=t.comm)
    assert htt.percentile(t, 50.0, axis=0, out=out) is out
