"""The rest of the port's ``arithmetics`` held against the JAX package:
``floordiv``, ``fmod``, ``remainder``/``mod``, ``pow``, the bitwise
functions, ``invert``, the shifts, ``prod``, ``cumsum``/``cumprod`` (along
the split axis on the two-level scan) and ``diff``, with the reference's
weak Python scalars in the result types.

The same numpy inputs go through both packages at 8 positions, splits
None/0/1, a ragged (13 x 6) and a divisible (16 x 8) shape.  Integer,
bool and ``diff`` results are exact; float32 maps and scans within ``rtol
2e-6, atol 1e-6``, float64 ``rtol 1e-13``.  Division by zero is held to
numpy's values (the reference's differ: ROADMAP, "Faults of the
reference").  Cases come from the reference's ``test_arithmetics.py`` and
``test_padded_at_rest.py``.
"""

import operator

import numpy as np
import pytest

import jax

import heat_tpu as ht
from test_torch_reference_state import reference_state  # noqa: F401,E402  (restores the JAX package's state)

import heat_tpu_torch as htt
from heat_tpu_torch.core import communication as tcomm


@pytest.fixture
def port():
    comm = htt.TorchCommunication(["cpu"] * len(jax.devices()))
    prev = tcomm._default_comm
    htt.use_comm(comm)
    yield comm
    htt.use_comm(prev)


SHAPES = [(13, 6), (16, 8)]


def _data(dtype, shape=(13, 6), seed=0, lo=-9, hi=10, nonzero=False):
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return rng.integers(0, 2, size=shape).astype(bool)
    if np.dtype(dtype).kind in "iu":
        lo = max(lo, 0) if np.dtype(dtype).kind == "u" else lo
        x = rng.integers(lo, hi, size=shape).astype(dtype)
    else:
        x = rng.uniform(lo, hi, size=shape).astype(dtype)
    if nonzero:
        x[x == 0] = 3
    return x


def _same(t, j, exact=False):
    assert t.shape == tuple(j.shape) and t.split == j.split, (t.shape, t.split, j.shape, j.split)
    assert t.dtype.__name__ == j.dtype.__name__, (t.dtype, j.dtype)
    want = np.asarray(j.numpy())
    got = t.numpy()
    if exact or want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want)
    else:
        rtol = 1e-13 if want.dtype == np.float64 else 2e-6
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6, equal_nan=True)
    if t.split is not None:
        n = t.gshape[t.split]
        pad = t._buffer.narrow(t.split, n, t.padshape[t.split] - n)
        assert not bool(pad.any()), "pad rows are not zero"


BINARY = ["floordiv", "fmod", "remainder", "mod", "pow", "add", "sub", "mul", "div"]


@pytest.mark.parametrize("name", BINARY)
@pytest.mark.parametrize("dtype", ["float32", "float64", "int32"])
@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("shape", SHAPES)
def test_binary_ops_match_reference(port, name, dtype, split, shape):
    a = _data(dtype, shape, seed=1)
    b = _data(dtype, shape, seed=2, lo=1 if name == "pow" else -9, hi=4 if name == "pow" else 10, nonzero=True)
    if name == "pow" and dtype == "int32":
        a = np.clip(a, -3, 3)
    for bsplit in (split, None):
        _same(getattr(htt, name)(htt.array(a, split=split), htt.array(b, split=bsplit)),
              getattr(ht, name)(ht.array(a, split=split), ht.array(b, split=bsplit)))


SCALARS = [2, -3, 2.5, True, np.float32(1.5), np.int64(3), np.float64(0.75)]


#: bool arrays only where torch has the arithmetic on bool
WEAK_CASES = [(name, dtype) for name in ("add", "mul", "sub", "div", "floordiv", "mod", "fmod", "pow")
              for dtype in ("int32", "float32", "int8", "uint8", "bool", "float16", "int64")
              if dtype != "bool" or name in ("add", "mul", "div")]


@pytest.mark.parametrize("name,dtype", WEAK_CASES)
@pytest.mark.parametrize("left", [False, True])
def test_weak_scalars_give_the_reference_types(port, name, dtype, left):
    """Python scalars are weak (an int takes the array's type, a float
    beside an exact array gives float64), numpy scalars typed."""
    a = _data(dtype, seed=3, lo=1, hi=4, nonzero=True)
    for s in SCALARS:
        if dtype == "uint8" and s < 0 or name == "pow" and (left or s < 0):
            continue
        x_t, x_j = htt.array(a, split=0), ht.array(a, split=0)
        args_t, args_j = ((s, x_t), (s, x_j)) if left else ((x_t, s), (x_j, s))
        _same(getattr(htt, name)(*args_t), getattr(ht, name)(*args_j))


@pytest.mark.parametrize("op", ["__floordiv__", "__rfloordiv__", "__mod__", "__rmod__", "__lshift__",
                                "__rshift__", "__and__", "__or__", "__xor__", "__pow__", "__rpow__"])
@pytest.mark.parametrize("split", [None, 0, 1])
def test_operators_match_reference(port, op, split):
    a = _data("int32", seed=4, lo=1, hi=7)
    other = 3 if "shift" not in op else 2
    _same(getattr(htt.array(a, split=split), op)(other), getattr(ht.array(a, split=split), op)(other))
    b = _data("int32", seed=5, lo=1, hi=5)
    if not op.startswith("__r") or op in ("__rshift__",):
        _same(getattr(htt.array(a, split=split), op)(htt.array(b, split=split)),
              getattr(ht.array(a, split=split), op)(ht.array(b, split=split)))


@pytest.mark.parametrize("name", ["bitwise_and", "bitwise_or", "bitwise_xor"])
@pytest.mark.parametrize("dtype", ["int32", "int8", "uint8", "bool", "int64"])
@pytest.mark.parametrize("split", [None, 0, 1])
def test_bitwise_match_reference(port, name, dtype, split):
    a, b = _data(dtype, seed=6), _data(dtype, seed=7)
    _same(getattr(htt, name)(htt.array(a, split=split), htt.array(b, split=split)),
          getattr(ht, name)(ht.array(a, split=split), ht.array(b, split=split)))
    _same(getattr(htt, name)(htt.array(a, split=split), 5), getattr(ht, name)(ht.array(a, split=split), 5))
    with pytest.raises(TypeError):
        getattr(htt, name)(htt.array(a), 1.5)
    with pytest.raises(TypeError):
        getattr(htt, name)(htt.array(a.astype(np.float32)), htt.array(b))


@pytest.mark.parametrize("dtype", ["int32", "int8", "uint8", "bool", "int64"])
@pytest.mark.parametrize("split", [None, 0, 1])
def test_invert_matches_reference(port, dtype, split):
    a = _data(dtype, seed=8)
    _same(htt.invert(htt.array(a, split=split)), ht.invert(ht.array(a, split=split)))
    _same(~htt.array(a, split=split), ~ht.array(a, split=split))
    assert htt.bitwise_not is htt.invert
    with pytest.raises(TypeError):
        htt.invert(htt.array(a.astype(np.float32)))


@pytest.mark.parametrize("dtype", ["int32", "int64", "int8", "uint8", "int16"])
@pytest.mark.parametrize("split", [None, 0])
def test_shifts_by_any_count_match_reference(port, dtype, split):
    bits = np.iinfo(dtype).bits
    rng = np.random.default_rng(9)
    lo = 0 if dtype == "uint8" else -100
    a = rng.integers(lo, 100, size=(13, 6)).astype(dtype)
    a[0, :3] = (np.iinfo(dtype).min, -1 if dtype != "uint8" else 1, np.iinfo(dtype).max)
    counts = np.array([0, 1, bits - 1, bits, bits + 1, 40, 2 * bits, 100] * 10)[:78].reshape(13, 6)
    counts = counts.astype(dtype)
    for fn in ("left_shift", "right_shift"):
        _same(getattr(htt, fn)(htt.array(a, split=split), htt.array(counts, split=split)),
              getattr(ht, fn)(ht.array(a, split=split), ht.array(counts, split=split)))
        for c in (1, bits - 1, bits, bits + 3):
            _same(getattr(htt, fn)(htt.array(a, split=split), c), getattr(ht, fn)(ht.array(a, split=split), c))
        with pytest.raises(TypeError):
            getattr(htt, fn)(htt.array(a.astype(np.float32)), 1)


def test_negative_shift_counts_match_reference(port):
    a = np.array([-8, 8, -1, 5], np.int32)
    c = np.array([-1, -3, -33, -64], np.int32)
    for fn in ("left_shift", "right_shift"):
        _same(getattr(htt, fn)(htt.array(a), htt.array(c)), getattr(ht, fn)(ht.array(a), ht.array(c)))


# --------------------------------------------------------------------- #
# division by zero: numpy's values                                        #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["int32", "int64", "int8", "uint8"])
@pytest.mark.parametrize("split", [None, 0])
def test_integer_division_by_zero_gives_numpys_values(port, dtype, split):
    num = np.array([7, -7, 5, 0, 1, -128, 3, 9], dtype=np.int64)
    den = np.array([0, 2, -3, 0, 0, 0, 1, -2], dtype=np.int64)
    if dtype == "uint8":
        num, den = np.abs(num) % 200, np.abs(den)
    num, den = num.astype(dtype), den.astype(dtype)
    with np.errstate(divide="ignore", invalid="ignore"):
        for name, fn in (("floordiv", np.floor_divide), ("mod", np.remainder), ("remainder", np.remainder),
                         ("fmod", np.fmod)):
            got = getattr(htt, name)(htt.array(num, split=split), htt.array(den, split=split))
            assert got.dtype.__name__ == dtype
            np.testing.assert_array_equal(got.numpy(), fn(num, den), err_msg=name)
            np.testing.assert_array_equal(getattr(htt, name)(htt.array(num), 0).numpy(), fn(num, num * 0))
    np.testing.assert_array_equal((7 // htt.array(den)).numpy(), np.floor_divide(dtype == "uint8" and
                                  np.uint8(7) or 7, den))


def test_reference_integer_floordiv_by_zero_differs_from_numpy():
    """The fault of the reference the port does not copy (ROADMAP)."""
    got = ht.floordiv(ht.array([7, -7, 5, 0]), ht.array([0, 2, -3, 0])).numpy()
    np.testing.assert_array_equal(got, [-2, -4, -2, -1])
    with np.errstate(divide="ignore"):
        np.testing.assert_array_equal(np.floor_divide([7, -7, 5, 0], [0, 2, -3, 0]), [0, -4, -2, 0])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("split", [None, 0])
def test_float_division_by_zero_gives_numpys_values(port, dtype, split):
    num = np.array([1.5, -2.5, 0.0, np.nan, np.inf, -np.inf, 3.0, -0.0], dtype)
    den = np.array([0.0, 0.0, 0.0, 0.0, 0.0, -0.0, -0.0, 0.0], dtype)
    with np.errstate(divide="ignore", invalid="ignore"):
        for name, fn in (("floordiv", np.floor_divide), ("mod", np.remainder), ("fmod", np.fmod)):
            got = getattr(htt, name)(htt.array(num, split=split), htt.array(den, split=split)).numpy()
            np.testing.assert_array_equal(got, fn(num, den), err_msg=name)
            assert (np.signbit(got) == np.signbit(fn(num, den)))[~np.isnan(got)].all(), name
        np.testing.assert_array_equal(htt.floordiv(htt.array(num), 0.0).numpy(), np.floor_divide(num, 0.0))


# --------------------------------------------------------------------- #
# prod, cumsum, cumprod, diff                                             #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "int8", "uint8", "bool"])
@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("axis", [None, 0, 1, (0, 1)])
@pytest.mark.parametrize("keepdims", [False, True])
def test_prod_matches_reference(port, dtype, split, axis, keepdims):
    a = _data(dtype, seed=10, lo=-2, hi=3)
    if dtype.startswith("float"):
        a = _data(dtype, seed=10, lo=0.5, hi=1.5)
    _same(htt.prod(htt.array(a, split=split), axis=axis, keepdims=keepdims),
          ht.prod(ht.array(a, split=split), axis=axis, keepdims=keepdims))
    _same(htt.array(a, split=split).prod(axis), ht.array(a, split=split).prod(axis))


@pytest.mark.parametrize("fn", ["cumsum", "cumprod"])
@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "int8", "uint8", "bool", "int64"])
@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("axis", [0, 1, -1])
@pytest.mark.parametrize("shape", SHAPES)
def test_cumulative_ops_match_reference(port, fn, dtype, split, axis, shape):
    a = _data(dtype, shape, seed=11, lo=-3, hi=4)
    if fn == "cumprod" and dtype.startswith("float"):
        a = _data(dtype, shape, seed=11, lo=0.7, hi=1.3)
    _same(getattr(htt, fn)(htt.array(a, split=split), axis), getattr(ht, fn)(ht.array(a, split=split), axis))


@pytest.mark.parametrize("split", [None, 0, 1])
def test_cumulative_dtype_out_and_methods(port, split):
    a = _data("int32", seed=12, lo=-3, hi=4)
    for dtype in ("float32", "int64", "int8"):
        _same(htt.cumsum(htt.array(a, split=split), 0, dtype=getattr(htt, dtype)),
              ht.cumsum(ht.array(a, split=split), 0, dtype=getattr(ht, dtype)))
    out_t, out_j = htt.zeros((13, 6), dtype=htt.int32, split=split), ht.zeros((13, 6), dtype=ht.int32, split=split)
    htt.cumprod(htt.array(a, split=split), 1, out=out_t)
    ht.cumprod(ht.array(a, split=split), 1, out=out_j)
    _same(out_t, out_j)
    _same(htt.array(a, split=split).cumsum(1), ht.array(a, split=split).cumsum(1))
    _same(htt.array(a, split=split).cumprod(), ht.array(a, split=split).cumprod())
    assert htt.cumproduct is htt.cumprod
    with pytest.raises(NotImplementedError):
        htt.cumsum(htt.array(a), None)


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("axis", [0, 1, -1])
@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("dtype", ["float32", "int32", "bool", "float64"])
def test_diff_matches_reference(port, n, axis, split, dtype):
    a = _data(dtype, seed=13)
    _same(htt.diff(htt.array(a, split=split), n=n, axis=axis),
          ht.diff(ht.array(a, split=split), n=n, axis=axis), exact=True)


@pytest.mark.parametrize("split", [None, 0, 1])
def test_diff_edges_match_reference(port, split):
    a = _data("int32", seed=14)
    edge_row = np.arange(6, dtype=np.int32)[None]
    cases = [dict(prepend=0), dict(append=0.5), dict(prepend=2, append=-1.5),
             dict(prepend=edge_row), dict(append=[[1.5] * 6])]
    for kw in cases:
        kt = {k: htt.array(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
        kj = {k: ht.array(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
        _same(htt.diff(htt.array(a, split=split), axis=0, **kt), ht.diff(ht.array(a, split=split), axis=0, **kj),
              exact=True)
    x = htt.array(a, split=split)
    assert htt.diff(x, n=0) is x
    with pytest.raises(ValueError):
        htt.diff(x, n=-1)


def test_padded_buffers_stay_zero_after_the_slice_ops(port):
    """A ragged split's pad rows stay zero through cumsum, cumprod, diff,
    prod and the masked divisions (the padded-at-rest invariant)."""
    a = _data("float32", (13, 6), seed=15, lo=0.5, hi=1.5)
    for split in (0, 1):
        x = htt.array(a, split=split)
        for res in (htt.cumsum(x, split), htt.cumprod(x, split), htt.diff(x, axis=split),
                    htt.floordiv(x, 0.0 * x + 1.0), htt.mod(x, 0.0), x // 0,
                    x.prod(axis=1 - split, keepdims=True)):
            n = res.gshape[res.split]
            assert not bool(res._buffer.narrow(res.split, n, res.padshape[res.split] - n).any())


@pytest.mark.parametrize("op", [operator.add, operator.mul, operator.sub, operator.truediv])
def test_int64_and_float_scalar_promotion_fixed(port, op):
    """Found while porting: the port computed int-array-with-float-scalar
    ops in float32 and int64 true division in float32, where the reference
    gives float64 (ROADMAP queue C, C4)."""
    a = _data("int32", seed=16, nonzero=True)
    a64 = a.astype(np.int64)
    for x_t, x_j, s in ((htt.array(a), ht.array(a), 0.5), (htt.array(a64), ht.array(a64), 3)):
        _same(op(x_t, s), op(x_j, s))
        _same(op(x_t, x_t), op(x_j, x_j))


@pytest.mark.parametrize("rows", [2049, 5000, 8 * 3000 + 5])
@pytest.mark.parametrize("split", [None, 0, 1])
def test_long_cumulative_ops_scan_in_blocks(port, rows, split):
    """Past two blocks of rows an axis scans in blocks (a thread a column
    of a long axis is slow on the card): integers stay exact against the
    reference, floats within gamma_k * sum|x| of float64 numpy (k the
    number of terms, u = 2^-24)."""
    rng = np.random.default_rng(17)
    ints = rng.integers(-50, 50, size=(rows, 3)).astype(np.int32)
    _same(htt.cumsum(htt.array(ints, split=split), 0), ht.cumsum(ht.array(ints, split=split), 0))
    _same(htt.cumprod(htt.array(np.sign(ints) + (ints == 0), split=split), 0),
          ht.cumprod(ht.array(np.sign(ints) + (ints == 0), split=split), 0))
    x = rng.normal(size=(rows, 3)).astype(np.float32)
    k = np.arange(1, rows + 1, dtype=np.float64)[:, None]
    gamma = k * 2.0 ** -24 / (1 - k * 2.0 ** -24)
    got = htt.cumsum(htt.array(x, split=split), 0)
    assert got.dtype is htt.float32 and got.split == split
    err = np.abs(got.numpy() - np.cumsum(x.astype(np.float64), 0))
    assert (err <= gamma * np.cumsum(np.abs(x.astype(np.float64)), 0)).all()
    f = (1 + 1e-3 * np.sin(100 * x)).astype(np.float32)
    want = np.cumprod(f.astype(np.float64), 0)
    err = np.abs(htt.cumprod(htt.array(f, split=split), 0).numpy() - want)
    assert (err <= gamma * np.abs(want)).all()
