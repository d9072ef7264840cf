"""The port's elementwise maps and logical reductions held against the JAX
package: ``exponential``, ``rounding``, ``relational``, ``logical`` and
``trigonometrics``.

The same numpy inputs (float32, float64 and int32, at 8 positions by
default, split None, 0 and 1, ragged) go through both packages.  Results
must have the reference's shape, split and dtype; values: booleans,
rounding, sign and abs equal; transcendental maps within ``rtol 2e-6,
atol 1e-6`` in float32 and ``rtol 1e-13`` in float64 (torch's and XLA's
vectorised ``exp``/``log``/``sin`` may differ in their last ulp); NaN where
the reference has NaN.
"""

import operator

import numpy as np
import pytest

import jax

import heat_tpu as ht

import heat_tpu_torch as htt
from heat_tpu_torch.core import communication as tcomm


@pytest.fixture
def port():
    comm = htt.TorchCommunication(["cpu"] * len(jax.devices()))
    prev = tcomm._default_comm
    htt.use_comm(comm)
    yield comm
    htt.use_comm(prev)


def _data(dtype, seed=0, lo=-3.0, hi=3.0):
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return rng.integers(-5, 6, size=(13, 6)).astype(np.int32)
    x = rng.uniform(lo, hi, size=(13, 6)).astype(dtype)
    x[0, :3] = (0.5, -2.5, 0.0)
    return x


def _same(t, j, exact=False):
    assert t.shape == tuple(j.shape) and t.split == j.split
    assert t.dtype.__name__ == j.dtype.__name__, (t.dtype, j.dtype)
    want = np.asarray(j.numpy())
    if exact or want.dtype.kind in "biu":
        np.testing.assert_array_equal(t.numpy(), want)
    else:
        rtol = 1e-13 if want.dtype == np.float64 else 2e-6
        np.testing.assert_allclose(t.numpy(), want, rtol=rtol, atol=1e-6, equal_nan=True)


UNARY = {
    "exp": (-3, 3), "expm1": (-3, 3), "exp2": (-3, 3), "log": (0.1, 5), "log2": (0.1, 5),
    "log10": (0.1, 5), "log1p": (-0.5, 5), "sqrt": (0, 5), "ceil": (-3, 3), "floor": (-3, 3),
    "trunc": (-3, 3), "fabs": (-3, 3), "arccos": (-1, 1), "arcsin": (-1, 1), "arctan": (-3, 3),
    "cos": (-3, 3), "cosh": (-3, 3), "sin": (-3, 3), "sinh": (-3, 3), "tan": (-1.5, 1.5),
    "tanh": (-3, 3), "deg2rad": (-180, 180), "rad2deg": (-3, 3),
}
EXACT = ("abs", "sign", "isfinite", "isinf", "isnan", "isneginf", "isposinf", "logical_not")


@pytest.mark.parametrize("name", sorted(UNARY))
@pytest.mark.parametrize("dtype", ["float32", "float64", "int32"])
@pytest.mark.parametrize("split", [None, 0, 1])
def test_unary_maps_match_reference(port, name, dtype, split):
    lo, hi = UNARY[name]
    x = _data(dtype, seed=len(name), lo=lo, hi=hi)
    if dtype == "int32":
        x = np.clip(x, int(np.ceil(lo)), int(np.floor(hi))).astype(np.int32)
    _same(getattr(htt, name)(htt.array(x, split=split)), getattr(ht, name)(ht.array(x, split=split)))


@pytest.mark.parametrize("name", EXACT + ("round",))
@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("split", [None, 0, 1])
def test_exact_maps_match_reference(port, name, dtype, split):
    x = _data(dtype, seed=7) * (3 if dtype == "int32" else 1.7)
    if dtype == "float32":
        x[1, :4] = (np.nan, np.inf, -np.inf, 2.5)
    _same(getattr(htt, name)(htt.array(x, split=split)), getattr(ht, name)(ht.array(x, split=split)), exact=True)


def test_aliases_and_options_match_reference(port):
    x = _data("float32", seed=8, lo=-0.9, hi=0.9)
    xt, xj = htt.array(x, split=0), ht.array(x, split=0)
    for alias, name in (("absolute", "abs"), ("acos", "arccos"), ("asin", "arcsin"), ("atan", "arctan"),
                        ("radians", "deg2rad"), ("degrees", "rad2deg")):
        _same(getattr(htt, alias)(xt), getattr(ht, name)(xj))
    _same(htt.round(xt * 100, decimals=1), ht.round(xj * 100, decimals=1))
    _same(htt.abs(xt, dtype=htt.float64), ht.abs(xj, dtype=ht.float64))
    _same(htt.round(xt, dtype=htt.int32), ht.round(xj, dtype=ht.int32), exact=True)
    for lo, hi in ((-0.5, 0.5), (None, 0.2), (-0.1, None)):
        _same(htt.clip(xt, lo, hi), ht.clip(xj, lo, hi), exact=True)
    with pytest.raises(ValueError):
        htt.clip(xt, None, None)
    for got, want in zip(htt.modf(xt * 3), ht.modf(xj * 3)):
        _same(got, want)
    _same(htt.arctan2(xt, xt.T.T + 0.5), ht.arctan2(xj, xj + 0.5))
    i, k = _data("int32", seed=9), _data("int32", seed=10)
    _same(htt.arctan2(htt.array(i, split=0), htt.array(k)), ht.arctan2(ht.array(i, split=0), ht.array(k)))
    # a number operand (the reference's arctan2 takes only arrays)
    np.testing.assert_allclose(htt.arctan2(htt.array(i, split=0), 2).numpy(),
                               np.arctan2(i.astype(np.float32), np.float32(2)), rtol=2e-6)


@pytest.mark.parametrize("name", ["eq", "ne", "lt", "le", "gt", "ge", "logical_and", "logical_or", "logical_xor"])
@pytest.mark.parametrize("split", [None, 0, 1])
def test_binary_predicates_match_reference(port, name, split):
    a = np.round(_data("float32", seed=10))
    b = np.round(_data("float32", seed=11))
    _same(getattr(htt, name)(htt.array(a, split=split), htt.array(b, split=split)),
          getattr(ht, name)(ht.array(a, split=split), ht.array(b, split=split)))
    _same(getattr(htt, name)(htt.array(a, split=split), 1.0), getattr(ht, name)(ht.array(a, split=split), 1.0))


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("axis", [None, 0, 1, (0, 1)])
@pytest.mark.parametrize("keepdims", [False, True])
def test_all_any_match_reference(port, split, axis, keepdims):
    x = (_data("int32", seed=12) > -4).astype(np.int32)
    for name in ("all", "any"):
        _same(getattr(htt, name)(htt.array(x, split=split), axis=axis, keepdims=keepdims),
              getattr(ht, name)(ht.array(x, split=split), axis=axis, keepdims=keepdims))


def test_closeness_and_equal_match_reference(port):
    a = _data("float32", seed=13)
    b = a + np.float32(1e-6) * np.sign(a)
    b[2, 2] = np.nan
    a[3, 3] = np.nan
    for kw in ({}, dict(rtol=0.0, atol=1e-7), dict(equal_nan=True), dict(rtol=1e-3)):
        _same(htt.isclose(htt.array(a, split=0), htt.array(b, split=0), **kw),
              ht.isclose(ht.array(a, split=0), ht.array(b, split=0), **kw))
        assert htt.allclose(htt.array(a, split=0), htt.array(b, split=0), **kw) == \
            ht.allclose(ht.array(a, split=0), ht.array(b, split=0), **kw)
    c = np.nan_to_num(a)
    assert htt.allclose(htt.array(c, split=1), htt.array(c.astype(np.float64)))
    assert htt.allclose(htt.array(c, split=0), c) == ht.allclose(ht.array(c, split=0), c)
    for other in (c, c + 1, c[:5]):
        assert htt.equal(htt.array(c, split=0), htt.array(other)) == ht.equal(ht.array(c, split=0), ht.array(other))


COMPARE = {"==": operator.eq, "!=": operator.ne, "<": operator.lt, "<=": operator.le,
           ">": operator.gt, ">=": operator.ge}


@pytest.mark.parametrize("op", sorted(COMPARE))
@pytest.mark.parametrize("split", [None, 0, 1])
def test_comparison_operators_match_reference(port, op, split):
    """The six operator forms give the reference's bool DNDarrays (shape,
    split, values) with a DNDarray, a number or a numpy array on the
    other side; a numpy array on the left gives numpy's elementwise
    result, as there."""
    f = COMPARE[op]
    a, b = np.round(_data("float32", seed=20)), np.round(_data("float32", seed=21))
    xt, xj = htt.array(a, split=split), ht.array(a, split=split)
    _same(f(xt, htt.array(b, split=split)), f(xj, ht.array(b, split=split)))
    _same(f(xt, htt.array(b)), f(xj, ht.array(b)))
    _same(f(xt, 2), f(xj, 2))
    _same(f(2.0, xt), f(2.0, xj))
    _same(f(xt, b), f(xj, b))
    got, want = f(b, xt), f(b, xj)
    assert isinstance(got, np.ndarray) and isinstance(want, np.ndarray)
    np.testing.assert_array_equal(got.astype(bool), want.astype(bool))


@pytest.mark.parametrize("split", [None, 0, 1])
def test_truth_value_matches_reference(port, split):
    """``bool`` of a one-element array is its value; of a larger one it
    raises as the reference does; DNDarrays are unhashable there too."""
    a = np.round(_data("float32", seed=22))
    xt, xj = htt.array(a, split=split), ht.array(a, split=split)
    for i in range(a.shape[0]):
        assert bool(xt[i, 0] > 0) == bool(xj[i, 0] > 0)
        assert bool(xt[i:i + 1, 2] <= 0) == bool(xj[i:i + 1, 2] <= 0)
    with pytest.raises(ValueError):
        bool(xj > 0)
    with pytest.raises(ValueError):
        bool(xt > 0)
    with pytest.raises(TypeError):
        hash(xt)
    assert htt.all(xt == xt).item() and not htt.any(xt != xt).item()
