"""The port's linear algebra held against the JAX package.

The same numpy inputs go through ``heat_tpu`` and ``heat_tpu_torch`` at as
many positions (all on the CPU) as the JAX package has devices under
``tests/conftest.py`` (8 by default), so most shapes here are ragged.
Tolerances, each with its reason:

* result splits, shapes, dtypes, integer products, transposes, tril/triu
  and indexing: equal (exact bookkeeping, or no arithmetic);
* float32 products, dots and norms: ``rtol 1e-5, atol 1e-5`` (float32 sums
  taken in another order);
* QR and SVD: the factors of torch's LAPACK and of XLA's own QR/SVD differ
  in the signs of R's rows, Q's columns and U/V's columns, so those are
  compared after the signs are normalised (R's diagonal, each V column's
  largest entry made positive), ``atol 1e-4`` in float32 (the reference's
  own QR/SVD gates) and ``1e-10`` in float64; S ``rtol 1e-5``; every
  factorization also holds its reconstruction and orthonormality;
* cg: ``rtol 1e-4, atol 1e-5`` (the same Krylov steps, rounded in another
  order, on a well-conditioned system).
"""

import warnings

import numpy as np
import pytest

import jax

import heat_tpu as ht

import torch

import heat_tpu_torch as htt
from heat_tpu_torch.core import communication as tcomm
from heat_tpu_torch.core.linalg import basics as tbasics

RTOL, ATOL = 1e-5, 1e-5


@pytest.fixture
def p():
    """Positions of the port's communicator: the JAX package's device count."""
    return len(jax.devices())


@pytest.fixture
def port(p):
    """The port's default communicator: ``p`` positions on the CPU."""
    comm = htt.TorchCommunication(["cpu"] * p)
    prev = tcomm._default_comm
    htt.use_comm(comm)
    yield comm
    htt.use_comm(prev)


def _both(data, split=None):
    return htt.array(data, split=split), ht.array(data, split=split)


def _same(t, j, rtol=RTOL, atol=ATOL, exact=False):
    """``t`` (port) and ``j`` (JAX package) agree: shape, split, dtype,
    values; and the port's pads at rest are zero."""
    assert t.shape == tuple(j.shape) and t.split == j.split
    assert t.dtype.__name__ == j.dtype.__name__
    want = np.asarray(j.numpy())
    if exact:
        np.testing.assert_array_equal(t.numpy(), want)
    else:
        np.testing.assert_allclose(t.numpy(), want, rtol=rtol, atol=atol)
    if t.split is not None:
        n = t.shape[t.split]
        assert not t._buffer.narrow(t.split, n, t.padshape[t.split] - n).any()


def _rand(shape, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


# --------------------------------------------------------------------- #
# matmul                                                                 #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("sa", [None, 0, 1])
@pytest.mark.parametrize("sb", [None, 0, 1])
@pytest.mark.parametrize("m,k,n", [(13, 7, 11), (16, 8, 24), (5, 3, 2)])
def test_matmul_all_splits_match_reference(port, sa, sb, m, k, n):
    a, b = _rand((m, k), 1), _rand((k, n), 2)
    at, aj = _both(a, sa)
    bt, bj = _both(b, sb)
    _same(at @ bt, aj @ bj)


@pytest.mark.parametrize("sa", [None, 0])
@pytest.mark.parametrize("sb", [None, 0, 1])
def test_matmul_vectors_match_reference(port, sa, sb):
    v, w, m = _rand((7,), 3), _rand((7,), 4), _rand((7, 5), 5)
    vt, vj = _both(v, sa)
    mt, mj = _both(m, sb)
    _same(htt.matmul(vt, mt), ht.matmul(vj, mj))
    _same(htt.matmul(htt.array(m.T, split=sa), vt), ht.matmul(ht.array(m.T, split=sa), vj))
    wt, wj = _both(w, sb if sb != 1 else None)
    _same(htt.matmul(vt, wt), ht.matmul(vj, wj))


@pytest.mark.parametrize("sa", [None, 0, 1, 2])
@pytest.mark.parametrize("bshape", [(4, 3), (2, 4, 3), (1, 4, 3), (4,)])
def test_matmul_batched_matches_reference(port, sa, bshape):
    a, b = _rand((2, 5, 4), 6), _rand(bshape, 7)
    at, aj = _both(a, sa)
    bt, bj = _both(b, 0)
    _same(at @ bt, aj @ bj)
    left = _rand((3, 4), 8)
    ct, cj = _both(np.ascontiguousarray(a.transpose(0, 2, 1)), sa)
    _same(htt.array(left, split=0) @ ct, ht.array(left, split=0) @ cj)


@pytest.mark.parametrize("da,db", [("int32", "int32"), ("int32", "float32"), ("float32", "float64"), ("int64", "int32"), ("bool", "int32")])
@pytest.mark.parametrize("split", [None, 0, 1])
def test_matmul_dtype_promotion_matches_reference(port, da, db, split):
    rng = np.random.default_rng(8)
    a = rng.integers(-4, 5, size=(9, 6)).astype(da)
    b = rng.integers(-4, 5, size=(6, 10)).astype(db)
    at, aj = _both(a, split)
    bt, bj = _both(b, split)
    # small integers: every product and sum is exact in each type
    _same(at @ bt, aj @ bj, exact=True)


@pytest.mark.parametrize("dtype,hi", [("int32", 5), ("int32", 2**20), ("int64", 2**40), ("bool", 2)])
@pytest.mark.parametrize("split", [None, 0, 1])
def test_integer_matmul_chunks_over_k_like_reference(port, monkeypatch, dtype, hi, split):
    """An integer or bool product summed in k-chunks (a budget of three
    columns a chunk, so k = 11 ends on a short chunk of two) equals the
    reference's integer dot, wrapping included (int32 and int64 operands
    whose products overflow)."""
    m, k, n = 9, 11, 10
    item = np.dtype(dtype).itemsize
    monkeypatch.setattr(tbasics, "INT_MATMUL_BUDGET", 8 * m * n + 3 * item * m * n)
    rng = np.random.default_rng(28)
    a = rng.integers(-hi if hi > 2 else 0, hi, size=(m, k)).astype(dtype)
    b = rng.integers(-hi if hi > 2 else 0, hi, size=(k, n)).astype(dtype)
    at, aj = _both(a, split)
    bt, bj = _both(b, split)
    _same(at @ bt, aj @ bj, exact=True)
    vt, vj = _both(a[0], None)
    _same(htt.dot(vt, vt), ht.dot(vj, vj), exact=True)


def test_matmul_errors_match_reference(port):
    cases = [
        (np.ones(()), np.ones(3)),
        (np.ones((3, 4)), np.ones((5, 2))),
        (np.ones((2, 3, 4)), np.ones((3, 4, 2))),
        (np.ones(3), np.ones(4)),
    ]
    for a, b in cases:
        with pytest.raises(ValueError):
            ht.matmul(ht.array(a), ht.array(b))
        with pytest.raises(ValueError):
            htt.matmul(htt.array(a), htt.array(b))
    with pytest.raises(ValueError):
        htt.matmul(htt.ones((2, 2)), htt.ones((2, 2)), precision="bf16")
    with pytest.raises(ValueError):
        htt.linalg.set_matmul_precision("tf32")


def test_matmul_out_receives_the_product(port):
    a, b = _rand((6, 4), 9), _rand((4, 5), 10)
    out = htt.zeros((6, 5), split=0)
    res = htt.matmul(htt.array(a, split=0), htt.array(b), out=out)
    assert res is out
    np.testing.assert_allclose(out.numpy(), a @ b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("precision,torch_name", [("highest", "highest"), ("float32", "high"), ("default", "medium")])
def test_matmul_precision_is_scoped_to_the_call(port, monkeypatch, precision, torch_name):
    seen = []
    real = tbasics._mm

    def spy(x, y):
        seen.append(torch.get_float32_matmul_precision())
        return real(x, y)

    monkeypatch.setattr(tbasics, "_mm", spy)
    a = htt.array(_rand((4, 4), 11), split=0)
    htt.matmul(a, a, precision=precision)
    prev = htt.linalg.get_matmul_precision()
    htt.linalg.set_matmul_precision(precision)
    try:
        htt.dot(a, a)
        assert htt.linalg.get_matmul_precision() == precision
    finally:
        htt.linalg.set_matmul_precision(prev)
    assert seen == [torch_name, torch_name]
    assert torch.get_float32_matmul_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32


def test_matmul_precision_restored_when_the_call_raises(port, monkeypatch):
    def boom(x, y):
        assert torch.get_float32_matmul_precision() == "medium"
        raise RuntimeError("boom")

    monkeypatch.setattr(tbasics, "_mm", boom)
    a = htt.array(_rand((4, 4), 12))
    with pytest.raises(RuntimeError, match="boom"):
        htt.matmul(a, a, precision="default")
    assert torch.get_float32_matmul_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32


# --------------------------------------------------------------------- #
# dot, norms, outer, projection, transpose, tril/triu                    #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("split", [None, 0])
def test_dot_matches_reference(port, split):
    v, w = _rand((13,), 13), _rand((13,), 14)
    vt, vj = _both(v, split)
    wt, wj = _both(w, split)
    _same(htt.dot(vt, wt), ht.dot(vj, wj))
    _same(htt.dot(htt.array(2.0), htt.array(3.0)), ht.dot(ht.array(2.0), ht.array(3.0)))
    m = _rand((13, 4), 15)
    _same(htt.dot(vt, htt.array(m, split=split)), ht.dot(vj, ht.array(m, split=split)))


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("dtype", ["float32", "float64", "int32"])
def test_norms_match_reference(port, split, dtype):
    a = (_rand((11, 5), 16) * 4).astype(dtype)
    at, aj = _both(a, split)
    _same(htt.linalg.norm(at), ht.linalg.norm(aj))
    for ord in (1, 2, np.inf, 0):
        _same(htt.linalg.vector_norm(at, ord), ht.linalg.vector_norm(aj, ord))
    for ord in (None, "fro", "nuc", 1, 2, np.inf):
        _same(htt.linalg.matrix_norm(at, ord), ht.linalg.matrix_norm(aj, ord), rtol=1e-4)


@pytest.mark.parametrize("sa,sb,split", [(0, None, None), (None, None, None), (None, 0, 1), (0, 0, 0)])
def test_outer_matches_reference(port, sa, sb, split):
    a, b = _rand((9,), 17), _rand((5,), 18)
    at, aj = _both(a, sa)
    bt, bj = _both(b, sb)
    _same(htt.linalg.outer(at, bt, split=split), ht.linalg.outer(aj, bj, split=split))


def test_projection_matches_reference(port):
    a, b = _rand((7,), 19), _rand((7,), 20)
    at, aj = _both(a, 0)
    bt, bj = _both(b, 0)
    _same(htt.linalg.projection(at, bt), ht.linalg.projection(aj, bj))
    with pytest.raises(RuntimeError):
        htt.linalg.projection(htt.ones((2, 2)), bt)


@pytest.mark.parametrize("split", [None, 0, 1, 2])
@pytest.mark.parametrize("axes", [None, (2, 0, 1), (1, 0, 2), (-1, 0, 1)])
def test_transpose_matches_reference(port, split, axes):
    data = _rand((3, 9, 4), 21)
    xt, xj = _both(data, split)
    _same(htt.linalg.transpose(xt, axes), ht.linalg.transpose(xj, axes), exact=True)
    _same(xt.T, xj.T, exact=True)
    _same(xt.transpose(axes), xj.transpose(axes), exact=True)
    with pytest.raises(ValueError):
        htt.linalg.transpose(xt, (0, 0, 1))


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("k", [0, 1, -2])
def test_tril_triu_match_reference(port, split, k):
    data = _rand((9, 6), 22)
    xt, xj = _both(data, split)
    _same(htt.tril(xt, k), ht.tril(xj, k), exact=True)
    _same(htt.triu(xt, k), ht.triu(xj, k), exact=True)
    cube = _rand((2, 5, 4), 23)
    _same(htt.triu(htt.array(cube, split=split), k), ht.triu(ht.array(cube, split=split), k), exact=True)
    vec = _rand((5,), 24)
    vs = None if split == 1 else split
    _same(htt.tril(htt.array(vec, split=vs), k), ht.tril(ht.array(vec, split=vs), k), exact=True)


KEYS = [
    1, -1, slice(1, None), slice(None, None, -1), slice(2, 9, 3), slice(8, 1, -2),
    (slice(None), 1), (Ellipsis, 2), (1, Ellipsis), (None, slice(1, 4)), (slice(None), None, 0),
    (2, 3), (Ellipsis,), (slice(3, 3),), (-3, slice(None), None),
    True, (True, 1), (slice(None), False), (True, Ellipsis, 2), (False, None),
]


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("key", KEYS, ids=str)
def test_basic_getitem_matches_reference(port, split, key):
    data = _rand((11, 6), 25)
    xt, xj = _both(data, split)
    _same(xt[key], xj[key], exact=True)


@pytest.mark.parametrize("split", [None, 0, 1])
def test_numpy_bool_key_like_numpy(port, split):
    """A numpy bool scalar key inserts an axis as numpy's does (the JAX
    package's indexing asserts on it; ROADMAP, faults of the reference)."""
    data = _rand((11, 6), 29)
    x = htt.array(data, split=split)
    for key in ((np.True_, Ellipsis, 2), (np.False_,), (slice(None), np.True_)):
        np.testing.assert_array_equal(x[key].numpy(), data[key])


def test_getitem_rejects_what_it_does_not_port(port):
    x = htt.arange(10, split=0)
    with pytest.raises(NotImplementedError, match="take.py"):
        x[np.array([1, 2])]
    with pytest.raises(IndexError):
        x[1, 2]
    with pytest.raises(IndexError):
        x[..., ...]


# --------------------------------------------------------------------- #
# QR                                                                     #
# --------------------------------------------------------------------- #
def _signed_qr(q, r):
    """Q, R with R's diagonal made non-negative (QR is unique so)."""
    d = np.sign(np.diag(r)).astype(r.dtype)
    d[d == 0] = 1
    return (None if q is None else q * d), r * d[:, None]


def _tol(dtype):
    return 1e-10 if dtype == np.float64 else 1e-4


def _check_qr(qt, rt, qj, rj, a):
    atol = _tol(a.dtype)
    assert rt.split == rj.split and rt.shape == tuple(rj.shape)
    assert rt.dtype.__name__ == rj.dtype.__name__
    r_t, r_j = rt.numpy(), np.asarray(rj.numpy())
    np.testing.assert_allclose(r_t, np.triu(r_t), atol=0)
    if qt is None:
        assert qj is None
        np.testing.assert_allclose(_signed_qr(None, r_t)[1], _signed_qr(None, r_j)[1], atol=atol)
        return
    assert qt.split == qj.split and qt.shape == tuple(qj.shape)
    q_t, q_j = qt.numpy(), np.asarray(qj.numpy())
    np.testing.assert_allclose(q_t @ r_t, a, atol=atol * max(1.0, np.abs(a).max()))
    np.testing.assert_allclose(q_t.T @ q_t, np.eye(q_t.shape[1]), atol=atol)
    st, sj = _signed_qr(q_t, r_t), _signed_qr(q_j, r_j)
    np.testing.assert_allclose(st[0], sj[0], atol=atol)
    np.testing.assert_allclose(st[1], sj[1], atol=atol * max(1.0, np.abs(a).max()))
    if qt.split is not None:
        n = qt.shape[qt.split]
        assert not qt._buffer.narrow(qt.split, n, qt.padshape[qt.split] - n).any()


@pytest.mark.filterwarnings("ignore:qr.*fewer rows:UserWarning")
@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("shape", [(61, 5), (64, 8), (100, 12), (21, 7), (7, 21), (14, 14), (40, 3)], ids=str)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_qr_matches_reference(port, split, shape, dtype):
    a = _rand(shape, 26, dtype)
    at, aj = _both(a, split)
    qt, rt = htt.linalg.qr(at)
    qj, rj = ht.linalg.qr(aj)
    _check_qr(qt, rt, qj, rj, a)
    _check_qr(None, htt.linalg.qr(at, calc_q=False).R, None, ht.linalg.qr(aj, calc_q=False).R, a)


@pytest.mark.parametrize("tiles", [1, 2, 3, 5])
@pytest.mark.parametrize("shape", [(50, 12), (70, 21)], ids=str)
def test_qr_tiles_per_proc_split1_matches_reference(port, tiles, shape):
    a = _rand(shape, 27)
    at, aj = _both(a, 1)
    qt, rt = htt.linalg.qr(at, tiles_per_proc=tiles)
    qj, rj = ht.linalg.qr(aj, tiles_per_proc=tiles)
    _check_qr(qt, rt, qj, rj, a)


def test_qr_integer_input_factors_in_float32(port):
    a = np.random.default_rng(28).integers(-5, 6, size=(40, 4)).astype(np.int32)
    at, aj = _both(a, 0)
    qt, rt = htt.linalg.qr(at)
    qj, rj = ht.linalg.qr(aj)
    _check_qr(qt, rt, qj, rj, a.astype(np.float32))


def test_qr_wide_shards_warn_like_reference(port, p):
    if p == 1:
        pytest.skip("needs several positions")
    a = _rand((30, 30), 29)
    at, aj = _both(a, 0)
    with pytest.warns(UserWarning, match="fewer rows"):
        qj, rj = ht.linalg.qr(aj)
    with pytest.warns(UserWarning, match="fewer rows"):
        qt, rt = htt.linalg.qr(at)
    _check_qr(qt, rt, qj, rj, a)
    # TSQR proper warns about nothing
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        htt.linalg.qr(htt.array(_rand((30 * p, 30), 30), split=0))


def test_qr_validation_matches_reference(port):
    with pytest.raises(ValueError):
        htt.linalg.qr(htt.ones(4))
    with pytest.raises(TypeError):
        htt.linalg.qr(htt.ones((4, 4)), tiles_per_proc="x")
    with pytest.raises(ValueError):
        htt.linalg.qr(htt.ones((4, 4)), tiles_per_proc=0)
    assert htt.linalg.QR._fields == ht.linalg.QR._fields


# --------------------------------------------------------------------- #
# SVD                                                                    #
# --------------------------------------------------------------------- #
def _signed_uv(u, v):
    """U, V with each V column's largest-magnitude entry made positive."""
    idx = np.argmax(np.abs(v), axis=0)
    d = np.sign(v[idx, np.arange(v.shape[1])])
    d[d == 0] = 1
    return u * d, v * d


def _check_svd(rt, rj, a):
    atol = _tol(a.dtype)
    scale = max(1.0, np.abs(a).max())
    for t, j in zip(rt, rj):
        assert t.split == j.split and t.shape == tuple(j.shape)
        assert t.dtype.__name__ == j.dtype.__name__
    u, s, v = (x.numpy() for x in rt)
    uj, sj, vj = (np.asarray(x.numpy()) for x in rj)
    np.testing.assert_allclose(s, sj, rtol=RTOL if a.dtype == np.float32 else 1e-12)
    np.testing.assert_allclose(u @ np.diag(s) @ v.T, a, atol=atol * scale)
    np.testing.assert_allclose(u.T @ u, np.eye(u.shape[1]), atol=atol)
    su, sv = _signed_uv(u, v)
    sju, sjv = _signed_uv(uj, vj)
    np.testing.assert_allclose(su, sju, atol=atol * 10)
    np.testing.assert_allclose(sv, sjv, atol=atol * 10)


@pytest.mark.filterwarnings("ignore:qr.*fewer rows:UserWarning")
@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("shape", [(80, 6), (61, 5), (6, 30), (12, 70)], ids=str)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_svd_matches_reference(port, split, shape, dtype):
    a = _rand(shape, 31, dtype)
    # well separated singular values: the singular vectors are then
    # determined to the stated tolerance
    a = a * np.linspace(1.0, 3.0, shape[1], dtype=dtype)[None, :]
    at, aj = _both(a, split)
    _check_svd(htt.linalg.svd(at), ht.linalg.svd(aj), a)
    st, sj = htt.linalg.svd(at, compute_uv=False), ht.linalg.svd(aj, compute_uv=False)
    assert st.split == sj.split and st.shape == tuple(sj.shape)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj.numpy()), rtol=RTOL if dtype == np.float32 else 1e-12)


@pytest.mark.parametrize("shape,split", [((9, 70), 0), ((70, 9), 1), ((9, 72), 0)], ids=str)
def test_svd_columns_on_fewer_positions_against_numpy(port, shape, split):
    """Nine columns over eight positions, split on columns (a wide matrix
    split on rows becomes that when transposed): the JAX package's fused
    float32 pipeline returns wrong singular values here (ROADMAP queue C),
    so the port is held to numpy in float64, at the float32 tolerances."""
    a = _rand(shape, 31) * np.linspace(1.0, 3.0, shape[1], dtype=np.float32)[None, :]
    u, s, v = (x.numpy() for x in htt.linalg.svd(htt.array(a, split=split)))
    want = np.linalg.svd(a.astype(np.float64), compute_uv=False)
    np.testing.assert_allclose(s, want, rtol=RTOL)
    np.testing.assert_allclose(htt.linalg.svd(htt.array(a, split=split), compute_uv=False).numpy(), want, rtol=RTOL)
    np.testing.assert_allclose(u @ np.diag(s) @ v.T, a, atol=1e-4 * np.abs(a).max())
    np.testing.assert_allclose(u.T @ u, np.eye(u.shape[1]), atol=1e-4)
    np.testing.assert_allclose(v.T @ v, np.eye(v.shape[1]), atol=1e-4)


def test_svd_small_split_resplits_silently_like_reference(port, p):
    if p == 1:
        pytest.skip("needs several positions")
    a = _rand((30, 30), 32) * np.linspace(1.0, 3.0, 30, dtype=np.float32)[None, :]
    at, aj = _both(a, 0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        rt = htt.linalg.svd(at)
        rj = ht.linalg.svd(aj)
    assert rt.U.split == rj.U.split == 0
    _check_svd(rt, rj, a)


def test_svd_validation(port):
    with pytest.raises(ValueError):
        htt.linalg.svd(htt.ones(4))
    with pytest.raises(NotImplementedError):
        htt.linalg.svd(htt.ones((4, 2)), full_matrices=True)
    assert htt.linalg.SVD._fields == ht.linalg.SVD._fields


# --------------------------------------------------------------------- #
# solvers                                                                #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("n", [10, 37])
def test_cg_matches_reference(port, split, n):
    rng = np.random.default_rng(n)
    m = rng.normal(size=(n, n)).astype(np.float32)
    spd = m @ m.T + n * np.eye(n, dtype=np.float32)
    b = rng.normal(size=n).astype(np.float32)
    xt = htt.linalg.cg(htt.array(spd, split=split), htt.array(b, split=split), htt.zeros(n, split=split))
    xj = ht.linalg.cg(ht.array(spd, split=split), ht.array(b, split=split), ht.zeros(n, split=split))
    _same(xt, xj, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(spd @ xt.numpy(), b, atol=1e-3)


def test_cg_promotes_and_propagates_nan_like_reference(port):
    rng = np.random.default_rng(0)
    M = rng.normal(size=(8, 8)).astype(np.float32)
    spd = M @ M.T + 8 * np.eye(8, dtype=np.float32)
    b = rng.normal(size=(8,)).astype(np.float32)
    xt = htt.linalg.cg(htt.array(spd), htt.array(b), htt.zeros(8, dtype=htt.int32))
    xj = ht.linalg.cg(ht.array(spd), ht.array(b), ht.zeros(8, dtype=ht.int32))
    _same(xt, xj, rtol=1e-4, atol=1e-5)
    b[0] = np.nan
    assert np.isnan(htt.linalg.cg(htt.array(spd), htt.array(b), htt.zeros(8)).numpy()).any()
    for bad in ((htt.ones(3), htt.ones(3), htt.ones(3)), (htt.ones((3, 3)), htt.ones((3, 1)), htt.ones(3))):
        with pytest.raises(RuntimeError):
            htt.linalg.cg(*bad)


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("start", ["drawn", "given"])
def test_lanczos_matches_reference(port, split, start):
    """V and T within 1e-5 of the reference's from the same seed (the
    start vector and the restart matrix drawn from its streams), V
    orthonormal and T = V^T A V; the generator ends in the reference's
    state.  Non-square and non-positive-m inputs raise as there."""
    m = _rand((40, 40), 26)
    a = (m + m.T) / 2
    v0 = _rand((40,), 27)
    htt.random.seed(5)
    ht.random.seed(5)
    kw_t = {} if start == "drawn" else {"v0": htt.array(v0)}
    kw_j = {} if start == "drawn" else {"v0": ht.array(v0)}
    Vt, Tt = htt.linalg.lanczos(htt.array(a, split=split), 12, **kw_t)
    Vj, Tj = ht.linalg.lanczos(ht.array(a, split=split), 12, **kw_j)
    _same(Vt, Vj)
    _same(Tt, Tj)
    assert htt.random.get_state() == ht.random.get_state()
    V, T = Vt.numpy().astype(np.float64), Tt.numpy().astype(np.float64)
    np.testing.assert_allclose(V.T @ V, np.eye(12), atol=1e-5)
    np.testing.assert_allclose(V.T @ a @ V, T, atol=1e-4)
    with pytest.raises(RuntimeError):
        htt.linalg.lanczos(htt.ones((3, 4)), 2)
    with pytest.raises(RuntimeError):
        htt.linalg.lanczos(htt.ones((4, 4)), 0)


def test_lanczos_breakdown_restarts_like_reference(port):
    """From e_1 on 2I the first step breaks down exactly (w = 0): the
    second column is the restart draw, re-orthogonalized, as there; V_out
    and T_out receive the result."""
    e = np.zeros(10, np.float32)
    e[0] = 1.0
    a = 2 * np.eye(10, dtype=np.float32)
    htt.random.seed(3)
    ht.random.seed(3)
    Vo, To = htt.zeros((10, 2)), htt.zeros((2, 2))
    Vt, Tt = htt.linalg.lanczos(htt.array(a, split=0), 2, v0=htt.array(e), V_out=Vo, T_out=To)
    Vj, Tj = ht.linalg.lanczos(ht.array(a, split=0), 2, v0=ht.array(e))
    assert Vt is Vo and Tt is To
    _same(Vt, Vj)
    _same(Tt, Tj)
    with pytest.raises(NotImplementedError, match="16"):
        htt.linalg.lanczos(htt.array(a), 2, checkpoint_every=1)
