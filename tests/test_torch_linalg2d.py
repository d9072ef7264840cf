"""The port's grid linear algebra held against the JAX package's: the grid
blocked CAQR QR, the QDWH polar SVD and ``norm`` on a 2-D grid of
positions (``tests/test_linalg2d.py``).

The same numpy inputs go through ``heat_tpu`` on ``grid_comm(mesh)`` and
``heat_tpu_torch`` on a grid of as many CPU positions, at meshes (2, 2)
and (2, 4).  Tolerances, each with its reason:

* layouts, shapes, the guards' exception types, the panel schedule and
  the QDWH iteration counts: equal;
* QR in float32: Q and R within ``atol 1e-5`` of the reference's (the same
  panel algorithm on LAPACK's Householder QR in both packages, so the
  signs agree; matrix products round apart), and the reference's own
  gates: ``QR - A`` within 1e-4, ``Q^T Q - I`` within 2e-4, R's strict
  lower triangle within 1e-5;
* the QDWH coefficients ``(a, b, c, l')`` over ``l`` from 1e-7 to 1: bit
  for bit the reference's formula evaluated op by op (its float32 ``cbrt``
  is XLA's ``pow(x, float32(1/3))``, emulated in float64 and rounded once),
  and within 4 ulps of it compiled, as its SVD kernel runs it (XLA
  contracts its multiply-adds into FMAs: up to 3 ulps seen);
* SVD: S within ``rtol 1e-5`` of the reference's in float32 (``1e-12`` in
  float64); U and V columns, after their signs are aligned, within ``50
  eps s_max / gap`` of the reference's, ``gap`` the distance of the
  column's singular value to its nearest neighbour (a singular vector is
  determined only to its value's separation); the reference's gates:
  S within ``50 eps s_max`` of numpy's, ``U S V^T - A`` within ``100 eps
  s_max``, ``U^T U - I`` and ``V^T V - I`` within ``200 eps``;
* ``norm``: ``rtol 1e-6`` against numpy.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import heat_tpu as ht
from heat_tpu.core.communication import grid_comm as ref_grid_comm
from test_torch_reference_state import reference_state  # noqa: F401,E402  (restores the JAX package's state)

import heat_tpu_torch as htt
from heat_tpu_torch.comm import _costs as tcosts

_jsvd = importlib.import_module("heat_tpu.core.linalg.svd")
_tsvd = importlib.import_module("heat_tpu_torch.core.linalg.svd")
_jcosts = importlib.import_module("heat_tpu.comm._costs")

MESHES = [(2, 2), (2, 4)]
QR_SHAPES = [(16, 8), (19, 10), (33, 7), (9, 9)]


def _comms(mesh):
    if len(jax.devices()) < mesh[0] * mesh[1]:
        pytest.skip(f"needs {mesh[0] * mesh[1]} devices")
    return ref_grid_comm(mesh), htt.grid_comm(mesh, ["cpu"] * (mesh[0] * mesh[1]))


def _operands(comms, a_np, splits=(0, 1)):
    ref, mine = comms
    return ht.array(a_np, comm=ref).resplit(splits), htt.array(a_np, comm=mine).resplit(splits)


def _rand(m, n, seed=31, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((m, n)).astype(dtype)


def _conditioned(m, n, cond, dtype, seed=11):
    """A matrix with the exact geometric singular spectrum 1 .. 1/cond."""
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((m, n)))
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    s = np.geomspace(1.0, 1.0 / cond, n)
    return ((u * s) @ v.T).astype(dtype)


def _ref_values(x):
    return np.asarray(x.larray)[tuple(slice(0, s) for s in x.shape)]


# --------------------------------------------------------------------- #
# grid CAQR QR                                                           #
# --------------------------------------------------------------------- #
def test_grid_panel_bounds_match_reference():
    for n in range(0, 40):
        for c in (1, 2, 3, 4, 8):
            for t in (1, 2, 3):
                assert tcosts.grid_panel_bounds(n, c, t) == _jcosts.grid_panel_bounds(n, c, t)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("m,n", QR_SHAPES)
@pytest.mark.parametrize("tiles", [1, 2])
def test_grid_qr_matches_reference(mesh, m, n, tiles):
    a_np = _rand(m, n)
    ja, ta = _operands(_comms(mesh), a_np)
    jq, jr = ht.linalg.qr(ja, tiles_per_proc=tiles)
    q, r = htt.linalg.qr(ta, tiles_per_proc=tiles)
    assert q.splits == jq.splits == (0, 1) and q.shape == (m, n)
    assert r.splits == jr.splits == (None, 1) and r.shape == (n, n)
    qv, rv = q.numpy(), r.numpy()
    np.testing.assert_allclose(qv, _ref_values(jq), atol=1e-5)
    np.testing.assert_allclose(rv, _ref_values(jr), atol=1e-5)
    np.testing.assert_allclose(qv @ rv, a_np, atol=1e-4)
    np.testing.assert_allclose(qv.T @ qv, np.eye(n), atol=2e-4)
    np.testing.assert_allclose(np.tril(rv, -1), 0, atol=1e-5)
    for x in (q, r):
        buf = x._buffer
        assert not buf[x.shape[0]:].any() and not buf[:, x.shape[1]:].any()


@pytest.mark.parametrize("mesh", MESHES)
def test_grid_qr_calc_q_false_and_float64(mesh):
    comms = _comms(mesh)
    _, ta = _operands(comms, _rand(16, 8))
    full = htt.linalg.qr(ta)
    r_only = htt.linalg.qr(ta, calc_q=False)
    assert r_only.Q is None and r_only.R.splits == (None, 1)
    np.testing.assert_array_equal(r_only.R.numpy(), full.R.numpy())
    a64 = _rand(19, 10, dtype=np.float64)
    ja, ta = _operands(comms, a64)
    (jq, jr), (q, r) = ht.linalg.qr(ja), htt.linalg.qr(ta)
    assert q.dtype is htt.float64
    np.testing.assert_allclose(q.numpy(), _ref_values(jq), atol=1e-12)
    np.testing.assert_allclose(r.numpy(), _ref_values(jr), atol=1e-12)


def test_grid_qr_wide_input_raises_with_shapes_and_mesh():
    comms = _comms((2, 2))
    ja, ta = _operands(comms, _rand(8, 16))
    for mod, a in ((ht, ja), (htt, ta)):
        with pytest.raises(ValueError, match=r"8x16.*2x2"):
            mod.linalg.qr(a)


def test_grid_qr_short_shards_raise_with_geometry():
    # (4, 2) mesh, 8 x 8: row shards of 2 rows against 4-wide panels
    comms = _comms((4, 2))
    ja, ta = _operands(comms, _rand(8, 8))
    for mod, a in ((ht, ja), (htt, ta)):
        with pytest.raises(ValueError, match=r"8x8.*4x2"):
            mod.linalg.qr(a)


# --------------------------------------------------------------------- #
# the QDWH polar SVD                                                     #
# --------------------------------------------------------------------- #
def _ulps(x, y, dtype):
    it = np.int32 if dtype == np.float32 else np.int64
    return abs(int(np.asarray(x, dtype).view(it)) - int(np.asarray(y, dtype).view(it)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_qdwh_coeffs_match_reference(dtype):
    compiled = jax.jit(_jsvd._qdwh_coeffs)
    for l in np.geomspace(1e-7, 1.0, 301).astype(dtype):
        got = _tsvd._qdwh_coeffs(dtype(l))
        for g, e, c in zip(got, _jsvd._qdwh_coeffs(jnp.asarray(l)), compiled(jnp.asarray(l))):
            assert _ulps(g, e, dtype) == 0, (l, g, e)
            assert _ulps(g, c, dtype) <= 4, (l, g, c)


def _gaps(s):
    d = np.abs(s[:, None] - s[None, :])
    np.fill_diagonal(d, np.inf)
    return d.min(axis=1)


def _hold_svd(res, jres, a_np, dtype, s_rtol):
    """``res`` (port) against ``jres`` (reference) and numpy, with the
    module docstring's tolerances."""
    u, s, v = (x.numpy() for x in res)
    ju, js, jv = (_ref_values(x) for x in jres)
    eps = np.finfo(dtype).eps
    sref = np.linalg.svd(a_np.astype(np.float64), compute_uv=False)
    smax = float(sref[0])
    assert s.dtype == np.dtype(dtype)
    np.testing.assert_allclose(s, js, rtol=s_rtol, atol=s_rtol * smax)
    assert np.abs(s - sref).max() <= 50 * eps * smax
    assert np.abs(u @ np.diag(s) @ v.T - a_np).max() <= 100 * eps * smax
    assert np.abs(u.T @ u - np.eye(u.shape[1])).max() <= 200 * eps
    assert np.abs(v.T @ v - np.eye(v.shape[1])).max() <= 200 * eps
    sign = np.sign((v * jv).sum(0))
    bound = 50 * eps * smax / np.maximum(_gaps(sref), eps * smax)
    assert (np.abs(v * sign - jv).max(0) <= bound).all()
    assert (np.abs(u * sign - ju).max(0) <= bound).all()


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("m,n", [(16, 8), (19, 10), (32, 12)])
def test_grid_svd_matches_reference(mesh, m, n):
    a_np = _rand(m, n)
    ja, ta = _operands(_comms(mesh), a_np)
    jres, res = ht.linalg.svd(ja), htt.linalg.svd(ta)
    assert res.U.splits == jres.U.splits == (0, 1) and res.U.shape == (m, n)
    assert res.S.splits == (None,) and res.V.splits == tuple(jres.V.splits) == (None, None)
    _hold_svd(res, jres, a_np, np.float32, 1e-5)
    buf = res.U._buffer
    assert not buf[m:].any() and not buf[:, n:].any()


def _ref_iterations(ja, k):
    """True when the reference's QDWH loop stops after exactly ``k``
    iterations: capped at ``k`` it gives its uncapped result bit for bit,
    capped at ``k - 1`` it does not."""
    base = [np.asarray(x.larray) for x in ht.linalg.svd(ja)]
    orig = _jsvd._QDWH_MAXIT
    try:
        runs = []
        for cap in (k, k - 1):
            _jsvd._QDWH_MAXIT = cap
            got = [np.asarray(x.larray) for x in ht.linalg.svd(ja)]
            runs.append(all(np.array_equal(g, b) for g, b in zip(got, base)))
    finally:
        _jsvd._QDWH_MAXIT = orig
    return runs == [True, False]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("cond", [1e1, 1e3, 1e5, 1e7])
def test_grid_svd_ill_conditioned_sweep(dtype, cond):
    comms = _comms((2, 2))
    a_np = _conditioned(24, 8, cond, dtype)
    ja, ta = _operands(comms, a_np)
    htype = htt.float32 if dtype == np.float32 else htt.float64
    _, _, _, k = _tsvd._grid_svd_parts(ta, htype)
    assert 1 <= k < _tsvd._QDWH_MAXIT
    assert _ref_iterations(ja, k)
    _hold_svd(htt.linalg.svd(ta), ht.linalg.svd(ja), a_np, dtype, 1e-5 if dtype == np.float32 else 1e-12)


@pytest.mark.parametrize("mesh", MESHES)
def test_grid_svd_wide_and_transposed_layouts(mesh):
    comms = _comms(mesh)
    a_np = _rand(8, 16, seed=29)
    ja, ta = _operands(comms, a_np)
    jres, res = ht.linalg.svd(ja), htt.linalg.svd(ta)
    assert res.U.splits == tuple(jres.U.splits) == (None, None)
    assert res.V.splits == tuple(jres.V.splits) == (0, 1)
    u, s, v = (x.numpy() for x in res)
    np.testing.assert_allclose(s, _ref_values(jres.S), rtol=1e-5)
    np.testing.assert_allclose(u @ np.diag(s) @ v.T, a_np, atol=5e-4)
    s_only = htt.linalg.svd(ta, compute_uv=False)
    assert s_only.splits == (None,)
    np.testing.assert_array_equal(s_only.numpy(), s)
    # a (1, 0) operand is laid out at (0, 1) first
    tall = _rand(19, 10)
    ja, ta = _operands(comms, tall, (1, 0))
    jres, res = ht.linalg.svd(ja), htt.linalg.svd(ta)
    assert res.U.splits == (0, 1)
    _hold_svd(res, jres, tall, np.float32, 1e-5)


def test_grid_svd_compute_uv_false_matches():
    _, ta = _operands(_comms((2, 2)), _rand(16, 8))
    full = htt.linalg.svd(ta)
    s_only = htt.linalg.svd(ta, compute_uv=False)
    np.testing.assert_array_equal(s_only.numpy(), full.S.numpy())


@pytest.mark.parametrize("size", [1, 2, 4, 8])
@pytest.mark.parametrize("split", [0, 1])
def test_svd_wide_on_1d_meshes(size, split):
    """The 1-D transpose-and-swap wide path at 1, 2, 4 and 8 positions:
    the reference's layouts, S within 1e-5 of its values, and its gates
    (``tests/test_linalg2d.py``)."""
    if len(jax.devices()) < size:
        pytest.skip(f"needs {size} devices")
    a_np = np.random.default_rng(37).standard_normal((6, 20)).astype(np.float32)
    ja = ht.array(a_np, split=split, comm=ht.core.communication.XlaCommunication(jax.devices()[:size]))
    ta = htt.array(a_np, split=split, comm=htt.TorchCommunication(["cpu"] * size))
    jres, res = ht.linalg.svd(ja), htt.linalg.svd(ta)
    for x, jx in zip(res, jres):
        assert x.shape == tuple(jx.shape) and x.split == jx.split
    u, s, v = (x.numpy() for x in res)
    np.testing.assert_allclose(s, _ref_values(jres.S), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(u @ np.diag(s) @ v.T, a_np, atol=5e-4)
    np.testing.assert_allclose(u.T @ u, np.eye(6), atol=5e-4)


def test_grid_svd_short_stacked_shards_raise_with_geometry():
    # (8, 1) mesh: 16 x 16 stacks (2 + 2)-row shards against 16-wide panels
    comms = _comms((8, 1))
    ja, ta = _operands(comms, _rand(16, 16))
    for mod, a in ((ht, ja), (htt, ta)):
        with pytest.raises(ValueError, match=r"16x16.*8x1"):
            mod.linalg.svd(a)


# --------------------------------------------------------------------- #
# norm                                                                   #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("splits", [(0, 1), (1, 0), (None, 1), (0, None), (None, None)])
def test_norm_on_grid_splits(mesh, splits):
    a_np = _rand(13, 9)
    ja, ta = _operands(_comms(mesh), a_np, splits)
    res = htt.linalg.norm(ta)
    assert res.shape == () and res.split is None and res.splits == ()
    np.testing.assert_allclose(float(res), np.linalg.norm(a_np), rtol=1e-6)
    np.testing.assert_allclose(float(res), float(ht.linalg.norm(ja)), rtol=1e-6)
    poisoned = htt.DNDarray(ta._buffer.clone().fill_(float("inf")), ta.shape, ta.dtype, ta.splits,
                            ta.device, ta.comm)
    poisoned.larray.copy_(torch.from_numpy(a_np))
    np.testing.assert_allclose(float(htt.linalg.norm(poisoned)), np.linalg.norm(a_np), rtol=1e-6)
