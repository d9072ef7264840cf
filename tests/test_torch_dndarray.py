"""The rest of the port's DNDarray held against the JAX package:
``__setitem__`` with basic keys, ``fill_diagonal``, ``__iadd__``, the
operators and method forms, layout properties (``lshape_map``,
``nbytes``, ``strides``, ...), ``redistribute_``, halos, conversions,
``lloc``, and printing (``printing.py``: options, profiles, bfloat16).

The same numpy inputs go through both packages at 8 positions, splits
None/0/1, ragged (13 rows) and divisible (16 rows).  Values, layouts,
``lshape_map`` and printed strings are exact; float32 method forms of
transcendental maps within ``rtol 2e-6, atol 1e-6``.  Each write leaves
the at-rest buffer with zero pad rows.  Cases come from the reference's
``test_setitem_matrix.py``, ``test_dndarray.py``, ``test_padded_at_rest.py``
and ``test_printing_io_options.py``.
"""

import warnings

import numpy as np
import pytest
import torch

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


@pytest.fixture
def printopts():
    """Restore both packages' print options as they were, ``sci_mode``
    included (``set_printoptions`` cannot set an option back to None)."""
    live = [vars(mod)["__PRINT_OPTIONS"] for mod in (htt.printing, ht.printing)]
    saved = [dict(opts) for opts in live]
    yield
    for opts, was in zip(live, saved):
        opts.clear()
        opts.update(was)


def _pads_zero(t):
    if t.split is not None:
        n = t.gshape[t.split]
        assert not bool(t._buffer.narrow(t.split, n, t.padshape[t.split] - n).any()), "pad rows not zero"


def _same(t, j, close=False):
    assert t.shape == tuple(j.shape) and t.split == j.split, (t.shape, t.split, j.shape, j.split)
    assert t.dtype.__name__ == j.dtype.__name__, (t.dtype, j.dtype)
    if close:
        rtol = 1e-13 if t.dtype is htt.float64 else 2e-6
        np.testing.assert_allclose(t.numpy(), np.asarray(j.numpy()), rtol=rtol, atol=1e-6, equal_nan=True)
    else:
        np.testing.assert_array_equal(t.numpy(), np.asarray(j.numpy()))
    _pads_zero(t)


# --------------------------------------------------------------------- #
# __setitem__                                                             #
# --------------------------------------------------------------------- #
KEYS = [
    (10, 0), 10, -1, slice(1, 4), slice(8, 12), (slice(1, 11), 2), (slice(None), slice(None, None, 2)),
    (slice(None, None, -1),), (slice(10, 2, -3), slice(None, None, -2)), Ellipsis, (Ellipsis, 3),
    (2, Ellipsis), (None, 3), (slice(2, 5), None, 1), True, (False, 1), (np.int64(4), np.int32(-2)),
    (slice(12, 13),), (slice(0, 0),), (-13,), (slice(-3, None), slice(1, 3)),
]
VALUES = ["scalar", "row", "float_into_int", "dnd"]


@pytest.mark.parametrize("key", KEYS, ids=[repr(k) for k in KEYS])
@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("rows", [13, 16])
@pytest.mark.parametrize("value", VALUES)
def test_setitem_basic_keys_match_reference(port, key, split, rows, value):
    data = np.arange(rows * 5, dtype=np.float32).reshape(rows, 5)
    dtype = "int32" if value == "float_into_int" else "float32"
    a_t = htt.array(data.astype(dtype), split=split)
    a_j = ht.array(data.astype(dtype), split=split)
    sel_shape = data[key].shape
    if value == "scalar":
        v_t = v_j = 7
    elif value == "float_into_int":
        v_t = v_j = 2.75
    elif value == "row":
        v_t = v_j = (np.arange(sel_shape[-1] if sel_shape else 1, dtype=np.float32) - 3.5).tolist()
    else:
        v = (np.arange(int(np.prod(sel_shape)), dtype=np.float32) * -1).reshape(sel_shape)
        v_t, v_j = htt.array(v), ht.array(v)
    try:
        a_j[key] = v_j
    except ValueError:
        with pytest.raises(ValueError):
            a_t[key] = v_t
        return
    a_t[key] = v_t
    _same(a_t, a_j)
    _same(a_t[key], a_j[key])


@pytest.mark.parametrize("split", [None, 0, 1])
def test_setitem_keeps_views_and_copies_apart(port, split):
    data = np.arange(16 * 4, dtype=np.float32).reshape(16, 4)
    a = htt.array(data, split=split)
    view = a[2:10]
    a[3] = -1
    np.testing.assert_array_equal(view.numpy(), data[2:10])
    a.lloc[0, 0] = 42
    assert a.lloc[0, 0].item() == 42 and a[0, 0].item() == 42
    j = ht.array(data, split=split)
    j.lloc[0, 0] = 42
    j[3] = -1
    _same(a, j)


def test_setitem_errors_match_reference(port):
    a, j = htt.zeros((13, 5), split=0), ht.zeros((13, 5), split=0)
    for key in ((13, 0), (0, 5), (-14,), (0, 0, 0), (Ellipsis, Ellipsis)):
        with pytest.raises(IndexError):
            j[key] = 1
        with pytest.raises(IndexError):
            a[key] = 1
    # array keys write (they raised before the ring scatter was ported)
    a[htt.array([1, 2])] = 3
    j[ht.array([1, 2])] = 3
    a[[4, -1, 40]] = 5
    j[[4, -1, 40]] = 5
    _same(a, j)


@pytest.mark.parametrize("shape", [(13, 5), (5, 13), (16, 16)])
@pytest.mark.parametrize("split", [None, 0, 1])
def test_fill_diagonal_matches_reference(port, shape, split):
    data = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    a, j = htt.array(data, split=split), ht.array(data, split=split)
    assert a.fill_diagonal(-2.5) is a
    j.fill_diagonal(-2.5)
    _same(a, j)
    with pytest.raises(ValueError):
        htt.zeros((3,)).fill_diagonal(1)


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("other", ["scalar", "float", "row", "dnd"])
def test_iadd_matches_reference(port, split, other):
    data = np.arange(13 * 5, dtype=np.int32).reshape(13, 5)
    a, j = htt.array(data, split=split), ht.array(data, split=split)
    o_t, o_j = {"scalar": (3, 3), "float": (0.5, 0.5), "row": (htt.arange(5), ht.arange(5)),
                "dnd": (htt.array(data, split=split), ht.array(data, split=split))}[other]
    before = id(a)
    a += o_t
    j += o_j
    assert id(a) == before
    _same(a, j)
    with pytest.raises(ValueError):
        row = htt.arange(5)
        row += htt.zeros((3, 5))


# --------------------------------------------------------------------- #
# operators and method forms                                              #
# --------------------------------------------------------------------- #
UNARY_METHODS = ["exp", "expm1", "exp2", "log", "log2", "log10", "log1p", "sqrt", "sin", "cos", "tan", "sinh",
                 "cosh", "tanh", "arcsin", "arccos", "arctan", "abs", "absolute", "fabs", "ceil", "floor",
                 "trunc", "round", "all", "any", "sum", "prod", "mean", "var", "std", "min", "max", "argmin",
                 "cumsum", "cumprod", "nonzero", "transpose", "tril", "triu", "norm"]


@pytest.mark.parametrize("name", UNARY_METHODS)
@pytest.mark.parametrize("split", [None, 0, 1])
def test_method_forms_match_reference(port, name, split):
    rng = np.random.default_rng(1)
    data = rng.uniform(0.1, 0.9, size=(13, 6)).astype(np.float32)
    _same(getattr(htt.array(data, split=split), name)(), getattr(ht.array(data, split=split), name)(), close=True)


@pytest.mark.parametrize("split", [None, 0, 1])
def test_binary_method_forms_match_reference(port, split):
    rng = np.random.default_rng(2)
    a = rng.uniform(0.5, 2, size=(13, 6)).astype(np.float32)
    b = rng.uniform(0.5, 2, size=(13, 6)).astype(np.float32)
    x_t, y_t, x_j, y_j = htt.array(a, split=split), htt.array(b, split=split), ht.array(a, split=split), ht.array(b, split=split)
    for name in ("add", "sub", "mul", "div", "fmod", "pow"):
        _same(getattr(x_t, name)(y_t), getattr(x_j, name)(y_j), close=True)
    _same(x_t.clip(0.7, 1.5), x_j.clip(0.7, 1.5))
    _same(x_t.isclose(y_t, atol=0.3), x_j.isclose(y_j, atol=0.3))
    assert x_t.allclose(x_t + 1e-9) == x_j.allclose(x_j + 1e-9)
    _same(x_t.matmul(y_t.T), x_j.matmul(y_j.T), close=True)
    _same(x_t.dot(y_t.T), x_j.dot(y_j.T), close=True)
    q_t, r_t = htt.array(a, split=0).qr()
    np.testing.assert_allclose((q_t @ r_t).numpy(), a, rtol=1e-5, atol=1e-5)
    for f, m in (("modf", x_t.modf()),):
        for got, want in zip(m, x_j.modf()):
            _same(got, want)


@pytest.mark.parametrize("split", [None, 0, 1])
def test_unary_operators_match_reference(port, split):
    data = (np.arange(13 * 6, dtype=np.int32).reshape(13, 6) - 30)
    t, j = htt.array(data, split=split), ht.array(data, split=split)
    _same(abs(t), abs(j))
    assert +t is t
    _same(-t, -j)
    _same(~t, ~j)
    f = htt.array(data.astype(np.float32), split=split)
    _same(abs(f), abs(ht.array(data.astype(np.float32), split=split)))


# --------------------------------------------------------------------- #
# layout and properties                                                   #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("shape", [(13, 5), (16, 5), (5,), (3, 13, 2), ()])
@pytest.mark.parametrize("split", [None, 0, -1])
@pytest.mark.parametrize("dtype", ["float32", "int16", "bfloat16", "bool"])
def test_layout_properties_match_reference(port, shape, split, dtype):
    if not shape:
        split = None
    data = np.ones(shape, np.float32)
    t, j = htt.array(data, split=split, dtype=getattr(htt, dtype)), ht.array(data, split=split, dtype=getattr(ht, dtype))
    np.testing.assert_array_equal(t.lshape_map, j.lshape_map)
    np.testing.assert_array_equal(t.create_lshape_map(), j.create_lshape_map())
    for prop in ("nbytes", "gnbytes", "lnbytes", "itemsize", "gnumel", "lnumel", "stride", "strides", "lshape",
                 "balanced", "size", "ndim"):
        assert getattr(t, prop) == getattr(j, prop), prop
    assert t.is_balanced() and t.is_balanced(force_check=True)
    assert t.is_distributed() == j.is_distributed()
    assert t.balance_() is None
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert t.numdims == t.ndim
        assert any(issubclass(x.category, DeprecationWarning) for x in w)


@pytest.mark.parametrize("split", [None, 0, 1])
def test_redistribute_accepts_only_the_canonical_map(port, split):
    t, j = htt.zeros((13, 5), split=split), ht.zeros((13, 5), split=split)
    t.redistribute_()
    t.redistribute_(target_map=t.create_lshape_map())
    j.redistribute_(target_map=j.create_lshape_map())
    other = t.create_lshape_map()
    if split is not None:
        other[0, split] += 1
        other[-1, split] -= 1
        for x in (t, j):
            with pytest.raises(NotImplementedError):
                x.redistribute_(target_map=other)
    with pytest.raises(ValueError):
        t.redistribute_(target_map=np.zeros((3, 3)))
    flat = htt.zeros((13,), split=0)
    flat.redistribute_(target_map=flat.create_lshape_map().reshape(-1))


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("rows", [13, 16])
def test_conversions_match_reference(port, split, rows):
    data = np.arange(rows * 3, dtype=np.float32).reshape(rows, 3) / 4
    t, j = htt.array(data, split=split), ht.array(data, split=split)
    assert t.tolist() == j.tolist()
    for a, b in zip(t, j):
        _same(a, b)
    assert complex(htt.array(2.5)) == complex(ht.array(2.5)) == 2.5 + 0j
    c = t.copy()
    c[0] = 9
    assert t[0, 0].item() == data[0, 0]
    assert t.cpu() is t and t.to_device("cpu") is t
    assert t.real is t
    _same(t.imag, j.imag)
    cast = t.astype(htt.int32, copy=False)
    assert cast is t and t.dtype is htt.int32
    _same(t, j.astype(ht.int32, copy=False))
    r = htt.array(data, split=split)
    assert r.resplit_(1 if split != 1 else 0) is r
    _same(r, ht.array(data, split=split).resplit_(1 if split != 1 else 0))


# --------------------------------------------------------------------- #
# halos                                                                   #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("split", [0, 1])
@pytest.mark.parametrize("rows", [13, 16, 24])
@pytest.mark.parametrize("halo", [1, 2])
def test_halos_match_reference(port, split, rows, halo):
    data = np.arange(rows * 4, dtype=np.float32).reshape(rows, 4) + 1
    if split == 1:
        data = np.ascontiguousarray(data.T)
    t, j = htt.array(data, split=split), ht.array(data, split=split)
    if t.comm.shard_width(rows) < halo:
        with pytest.raises(ValueError):
            t.get_halo(halo)
        return
    t.get_halo(halo)
    j.get_halo(halo)
    np.testing.assert_array_equal(t.halo_prev.numpy(), np.asarray(j.halo_prev))
    np.testing.assert_array_equal(t.halo_next.numpy(), np.asarray(j.halo_next))
    np.testing.assert_array_equal(t.array_with_halos.numpy(), np.asarray(j.array_with_halos))
    t[0] = 5
    assert t.halo_prev is None and t.array_with_halos.shape == t.shape


def test_halo_arguments(port):
    t = htt.zeros((16, 2), split=0)
    with pytest.raises(TypeError):
        t.get_halo(1.0)
    with pytest.raises(ValueError):
        t.get_halo(-1)
    t.get_halo(0)
    assert t.halo_prev is None
    r = htt.zeros((16, 2))
    r.get_halo(2)
    assert r.halo_next is None and torch.equal(r.array_with_halos, r.larray)


# --------------------------------------------------------------------- #
# printing                                                                #
# --------------------------------------------------------------------- #
PRINT_CASES = {
    "float32": lambda: np.random.default_rng(0).normal(size=(13, 6)).astype(np.float32) * 100,
    "float64": lambda: np.random.default_rng(1).normal(size=(7, 3)),
    "int32": lambda: np.arange(40, dtype=np.int32).reshape(8, 5) - 20,
    "bool": lambda: np.arange(12).reshape(3, 4) % 3 == 0,
    "big": lambda: np.arange(3000, dtype=np.float32).reshape(60, 50) / 7,
    "scalar": lambda: np.float32(3.25),
    "empty": lambda: np.zeros((0, 3), np.float32),
    "tiny": lambda: np.array([1e-8, 1.0, 1e8], np.float32),
    "bfloat16": lambda: (np.random.default_rng(2).normal(size=(9, 7)) * 50).astype(np.float32),
    "bfloat16_big": lambda: np.linspace(-3, 3, 2000, dtype=np.float32).reshape(40, 50),
    "big_3d": lambda: np.random.default_rng(3).normal(size=(30, 2, 40)).astype(np.float32) * 1e3,
    "big_int": lambda: np.arange(1500, dtype=np.int64).reshape(1500) * 7 - 5000,
}


@pytest.mark.parametrize("case", sorted(PRINT_CASES))
@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("profile", [None, "short", "full", "default"])
def test_str_equals_reference(port, printopts, case, split, profile):
    data = PRINT_CASES[case]()
    dtype = {"bfloat16": "bfloat16", "bfloat16_big": "bfloat16"}.get(case)
    kw_t = {"dtype": getattr(htt, dtype)} if dtype else {}
    kw_j = {"dtype": getattr(ht, dtype)} if dtype else {}
    if profile:
        htt.set_printoptions(profile=profile)
        ht.set_printoptions(profile=profile)
    assert htt.get_printoptions() == ht.get_printoptions()
    split = split if np.ndim(data) else None
    t, j = htt.array(data, split=split, **kw_t), ht.array(data, split=split, **kw_j)
    assert str(t) == str(j)
    assert repr(t) == repr(j)


@pytest.mark.parametrize("shape", [(7,), (6,), (7, 7), (3, 9, 2), (2, 2, 2, 5)])
@pytest.mark.parametrize("edgeitems", [0, 1, 3])
def test_str_summarized_at_each_axis_length(port, printopts, shape, edgeitems):
    """Only what numpy shows is brought to the host: axes of length
    2 * edgeitems and 2 * edgeitems + 1, on both sides of the threshold."""
    data = np.arange(np.prod(shape), dtype=np.float32).reshape(shape) / 3
    for threshold in (5, 10_000):
        htt.set_printoptions(threshold=threshold, edgeitems=edgeitems)
        ht.set_printoptions(threshold=threshold, edgeitems=edgeitems)
        assert str(htt.array(data, split=0)) == str(ht.array(data, split=0))


def test_print_options_roundtrip(printopts):
    for key, value in (("precision", 6), ("threshold", 7), ("edgeitems", 8), ("linewidth", 9), ("sci_mode", True)):
        htt.set_printoptions(**{key: value})
        ht.set_printoptions(**{key: value})
        assert htt.get_printoptions() == ht.get_printoptions()
    htt.set_printoptions(profile="short", precision=3)
    ht.set_printoptions(profile="short", precision=3)
    assert htt.get_printoptions() == ht.get_printoptions()
    opts = htt.get_printoptions()
    opts["precision"] = 99
    assert htt.get_printoptions()["precision"] == 3


def test_printing_module_str(port, printopts):
    data = np.arange(6, dtype=np.float32).reshape(2, 3) / 3
    htt.set_printoptions(precision=2, linewidth=20)
    ht.set_printoptions(precision=2, linewidth=20)
    assert htt.printing.__str__(htt.array(data, split=1)) == ht.printing.__str__(ht.array(data, split=1))
