"""The rest of the port's ``factories`` and its ``indexing`` held against
the JAX package: ``asarray``, ``empty``, the ``*_like`` forms, ``eye``,
``linspace``, ``logspace`` (each with ``order=``), ``nonzero`` and
``where`` in both forms.

The same inputs go through both packages at 8 positions, splits
None/0/1, ragged and divisible lengths.  Factories and indices are
exact; float32 ``linspace`` is bitwise the reference's.  ``logspace`` is
the correctly rounded float32 of ``base ** grid``, which the reference's
libm ``powf`` misses by one ulp at about 1 point in 2 000, so it is held
bitwise to a float64 power of the same grid and within one ulp of the
reference.  Cases come from the reference's ``test_factories.py``.
"""

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


def _same(t, j):
    assert t.shape == tuple(j.shape) and t.split == j.split, (t.shape, t.split, j.shape, j.split)
    assert t.dtype.__name__ == j.dtype.__name__, (t.dtype, j.dtype)
    got, want = t.numpy(), np.asarray(j.numpy())
    if want.dtype.kind == "f" and t.dtype.__name__ != "bfloat16":
        np.testing.assert_array_equal(got.view(f"i{got.itemsize}"), want.view(f"i{want.itemsize}"))
    else:
        np.testing.assert_array_equal(got, want.astype(got.dtype))
    if t.split is not None:
        n = t.gshape[t.split]
        assert not bool(t._buffer.narrow(t.split, n, t.padshape[t.split] - n).any())


@pytest.mark.parametrize("name", ["empty", "zeros", "ones"])
@pytest.mark.parametrize("shape", [(13, 6), (16,), (3, 8, 5)])
@pytest.mark.parametrize("split", [None, 0, -1])
@pytest.mark.parametrize("dtype", ["float32", "int64", "bool", "bfloat16"])
def test_shape_factories_match_reference(port, name, shape, split, dtype):
    for order in ("C", "F"):
        _same(getattr(htt, name)(shape, dtype=getattr(htt, dtype), split=split, order=order),
              getattr(ht, name)(shape, dtype=getattr(ht, dtype), split=split, order=order))
    with pytest.raises(ValueError):
        getattr(htt, name)(shape, order="K")


@pytest.mark.parametrize("name", ["empty_like", "zeros_like", "ones_like", "full_like"])
@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("dtype", [None, "int16", "float64"])
def test_like_factories_match_reference(port, name, split, dtype):
    data = np.arange(13 * 6, dtype=np.int32).reshape(13, 6)
    kw_t = {} if dtype is None else {"dtype": getattr(htt, dtype)}
    kw_j = {} if dtype is None else {"dtype": getattr(ht, dtype)}
    extra = (7,) if name == "full_like" else ()
    _same(getattr(htt, name)(htt.array(data, split=split), *extra, **kw_t),
          getattr(ht, name)(ht.array(data, split=split), *extra, **kw_j))
    _same(getattr(htt, name)(data.tolist(), *extra, **kw_t), getattr(ht, name)(data.tolist(), *extra, **kw_j))
    _same(getattr(htt, name)(htt.array(data), *extra, split=split, **kw_t),
          getattr(ht, name)(ht.array(data), *extra, split=split, **kw_j))


def test_like_factories_keep_the_operands_communicator(port):
    four = htt.TorchCommunication(["cpu"] * 4)
    x = htt.array(np.ones((9, 3)), split=0, comm=four)
    for y in (htt.zeros_like(x), htt.ones_like(x), htt.empty_like(x), htt.full_like(x, 2)):
        assert y.comm == four and y.padshape == (12, 3)


@pytest.mark.parametrize("shape", [5, (3, 7), (7, 3), (4,), (20, 20)])
@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("dtype", ["float32", "int32", "bool"])
def test_eye_matches_reference(port, shape, split, dtype):
    _same(htt.eye(shape, dtype=getattr(htt, dtype), split=split),
          ht.eye(shape, dtype=getattr(ht, dtype), split=split))


@pytest.mark.parametrize("args", [(0.1, 7.3, 11), (-3, 2, 50), (0, 1, 1), (5, -5, 1001), (-5.5, 12.25, 9999),
                                  (1e-3, 1e3, 257), (2, 2, 7), (-7, 3, 174), (17.5, -2.25, 173), (-4, 5, 100),
                                  (7, -1, 57), (-3, 2, 500_000)])
@pytest.mark.parametrize("endpoint", [True, False])
@pytest.mark.parametrize("split", [None, 0])
def test_linspace_float32_is_bitwise_the_reference(port, args, endpoint, split):
    start, stop, num = args
    _same(htt.linspace(start, stop, num, endpoint=endpoint, split=split),
          ht.linspace(start, stop, num, endpoint=endpoint, split=split))
    t, ts = htt.linspace(start, stop, num, endpoint=endpoint, retstep=True)
    _, js = ht.linspace(start, stop, num, endpoint=endpoint, retstep=True)
    assert ts == js and type(ts) is float


@pytest.mark.parametrize("dtype", ["float64", "int32", "float16"])
def test_linspace_other_types(port, dtype):
    """Exact types and float16 agree bitwise, float64 at all but a few
    points (LLVM's constant folding of the reference's unrolled small
    grids is not followed) and within one ulp everywhere."""
    for num in (999, 1001, 40, 4097):
        got = htt.linspace(-3, 2, num, dtype=getattr(htt, dtype))
        want = ht.linspace(-3, 2, num, dtype=getattr(ht, dtype))
        if dtype == "float64":
            assert got.dtype is htt.float64
            np.testing.assert_array_max_ulp(got.numpy(), want.numpy(), maxulp=1)
            assert np.mean(got.numpy() != want.numpy()) <= 0.01
        else:
            _same(got, want)
    with pytest.raises(ValueError):
        htt.linspace(0, 1, 0)


def _near_float16_ties() -> np.ndarray:
    """float64 values just off the midpoint of two float16 neighbours,
    where rounding through float32 first lands on the tie."""
    base = np.array([1.0, 2.0, -3.0, 1000.0, 6.1e-5, 3e-7, -0.5, 60000.0], np.float16)
    half = np.spacing(np.abs(base)).astype(np.float64) / 2
    b = base.astype(np.float64)
    nudge = np.maximum(np.abs(b), 2.0 ** -24) * 2.0 ** -40
    return np.concatenate([b + np.sign(b) * (half + nudge), b + np.sign(b) * (half - nudge)])


@pytest.mark.parametrize("site", ["astype", "array", "list", "full", "scalar_right", "scalar_left", "where",
                                  "linspace"])
def test_float16_rounds_once_as_the_reference(port, site):
    """float64 data, Python floats and the float64 linspace grid reach
    float16 rounded once, as the reference rounds them (torch rounds
    through float32: twice)."""
    x = _near_float16_ties()
    assert not np.array_equal(x.astype(np.float32).astype(np.float16), x.astype(np.float16))
    if site == "astype":
        t, j = htt.array(x, split=0).astype(htt.float16), ht.array(x, split=0).astype(ht.float16)
    elif site == "array":
        t, j = htt.array(x, dtype=htt.float16, split=0), ht.array(x, dtype=ht.float16, split=0)
    elif site == "list":
        t, j = htt.array(x.tolist(), dtype=htt.float16), ht.array(x.tolist(), dtype=ht.float16)
    elif site == "full":
        for v in x:
            _same(htt.full((3,), float(v), dtype=htt.float16), ht.full((3,), float(v), dtype=ht.float16))
        return
    elif site in ("scalar_right", "scalar_left"):
        for v in x:
            zt, zj = htt.zeros((5,), dtype=htt.float16, split=0), ht.zeros((5,), dtype=ht.float16, split=0)
            if site == "scalar_right":
                _same(zt + float(v), zj + float(v))
            else:
                _same(float(v) - zt, float(v) - zj)
        return
    elif site == "where":
        c = np.arange(x.size) % 3 == 0
        xt, xj = htt.zeros(x.size, dtype=htt.float16), ht.zeros(x.size, dtype=ht.float16)
        for v in x[:4]:
            _same(htt.where(htt.array(c), xt, float(v)), ht.where(ht.array(c), xj, float(v)))
        t, j = htt.where(htt.array(c), xt, htt.array(x).astype(htt.float16)), \
            ht.where(ht.array(c), xj, ht.array(x).astype(ht.float16))
    else:
        t = htt.linspace(-3, 2, 500_000, dtype=htt.float16, split=0)
        j = ht.linspace(-3, 2, 500_000, dtype=ht.float16, split=0)
    _same(t, j)


@pytest.mark.parametrize("args", [(0, 2, 5), (-3, 2, 5000), (1, 3, 77), (-2, -1, 11)])
@pytest.mark.parametrize("base", [10.0, 2.0, 3.5])
@pytest.mark.parametrize("split", [None, 0])
def test_logspace_matches_reference(port, args, base, split):
    start, stop, num = args
    got = htt.logspace(start, stop, num, base=base, split=split)
    want = ht.logspace(start, stop, num, base=base, split=split)
    assert (got.shape, got.split, got.dtype.__name__) == (want.shape, want.split, want.dtype.__name__)
    np.testing.assert_array_max_ulp(got.numpy(), want.numpy(), maxulp=1)
    grid = htt.linspace(start, stop, num).numpy().astype(np.float64)
    np.testing.assert_array_equal(got.numpy(), np.power(base, grid).astype(np.float32))
    mismatch = float(np.mean(got.numpy() != want.numpy()))
    assert mismatch <= 2e-3, mismatch
    if num < 100:
        _same(htt.logspace(start, stop, num, base=base, dtype=htt.int64),
              ht.logspace(start, stop, num, base=base, dtype=ht.int64))


@pytest.mark.parametrize("obj", ["dnd", "list", "ndarray"])
def test_asarray(port, obj):
    data = np.arange(6, dtype=np.float32).reshape(2, 3)
    src = {"dnd": htt.array(data, split=0), "list": data.tolist(), "ndarray": data}[obj]
    ref = {"dnd": ht.array(data, split=0), "list": data.tolist(), "ndarray": data}[obj]
    a, b = htt.asarray(src), ht.asarray(ref)
    _same(a, b)
    if obj == "dnd":
        assert a is src and htt.asarray(src, dtype=htt.float32) is src
        _same(htt.asarray(src, dtype=htt.int32), ht.asarray(ref, dtype=ht.int32))
    with pytest.raises(ValueError):
        htt.asarray(src, order="X")


# --------------------------------------------------------------------- #
# indexing                                                                #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("shape", [(13,), (13, 6), (16, 8), (3, 5, 7)])
@pytest.mark.parametrize("split", [None, 0, -1])
@pytest.mark.parametrize("dtype", ["float32", "int32", "bool"])
def test_nonzero_matches_reference(port, shape, split, dtype):
    rng = np.random.default_rng(len(shape))
    data = (rng.integers(0, 3, size=shape) * rng.integers(0, 2, size=shape)).astype(dtype)
    _same(htt.nonzero(htt.array(data, split=split)), ht.nonzero(ht.array(data, split=split)))
    _same(htt.array(data, split=split).nonzero(), ht.array(data, split=split).nonzero())
    _same(htt.where(htt.array(data, split=split)), ht.where(ht.array(data, split=split)))


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("case", ["int32_0", "int32_0.5", "f32_0", "1_0", "arrays", "bool_x", "int8_300",
                                  "np_f64", "broadcast", "list"])
def test_where_matches_reference(port, split, case):
    rng = np.random.default_rng(3)
    xi = rng.integers(-5, 5, size=(13, 6)).astype(np.int32)
    xf = rng.uniform(-2, 2, size=(13, 6)).astype(np.float32)
    cond = xi > 0

    def args(m):
        c = m.array(cond, split=split)
        return {
            "int32_0": (c, m.array(xi, split=split), 0),
            "int32_0.5": (c, m.array(xi, split=split), 0.5),
            "f32_0": (c, m.array(xf, split=split), 0),
            "1_0": (c, 1, 0),
            "arrays": (c, m.array(xi, split=split), m.array(xf, split=split)),
            "bool_x": (c, m.array(cond, split=split), False),
            "int8_300": (c, m.array(xi.astype(np.int8), split=split), 3),
            "np_f64": (c, m.array(xf, split=split), np.float64(1.0)),
            "broadcast": (c, m.array(xf[0]), -1.0),
            "list": (c, m.array(xi, split=split), [7] * 6),
        }[case]

    _same(htt.where(*args(htt)), ht.where(*args(ht)))


def test_where_needs_both_operands(port):
    c = htt.array([True, False])
    with pytest.raises(TypeError):
        htt.where(c, 1)
    with pytest.raises(TypeError):
        htt.where([True], 1, 0)
