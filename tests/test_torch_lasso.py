"""The port's Lasso held against the JAX package.

The same numpy inputs go through ``heat_tpu.regression.Lasso`` and
``heat_tpu_torch.regression.Lasso`` at as many positions (all on the CPU)
as the JAX package has devices under ``tests/conftest.py`` (8 by default).
Tolerances, each with its reason:

* exact ``cd`` and ``gd``: theta within ``rtol 1e-4, atol 1e-5`` of the
  JAX fit and the same ``n_iter`` (the same float32 updates, their sums
  taken in another order; the port computes ``rho_j`` as ``(x_j . r +
  theta_j |x_j|^2) / n``);
* quantized ``gd``: the loss within ``1e-3 * loss(exact)`` of both JAX
  fits, the reference's own gate for its compressed fit
  (``tests/test_compressed_collectives.py``); the per-step partials are
  rounded differently by XLA's and torch's products, so a block may
  quantize differently and the trajectories drift apart.  theta is held
  to the exact fit by the ring bound: ISTA with a gradient error of at
  most ``eps`` per coordinate a step stays within ``sqrt(m) * eps / mu``
  of the exact minimiser (2-norm), ``mu`` the least eigenvalue of
  ``A^T A / n``, and the error-feedback ring's ``eps`` is ``(p + 1) *
  sum_i absmax_i / 254 / n`` of the partials at the solution;
* the ring itself, on the JAX package's own partials: bitwise;
* exact ``gd`` of both packages against ``chip_smoke.numpy_ista``, the
  float64 replay that ``chip_smoke.py`` phase 7 holds the card's fit to:
  within ``chip_smoke.GD_TOL`` of the largest coefficient, and a step
  1e-3 short must fall outside it;
* ``predict``: ``rtol 1e-5, atol 1e-5``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec

import heat_tpu as ht
from heat_tpu.comm import compressed as jcq
from heat_tpu.core._jax_compat import shard_map
from heat_tpu.core.communication import XlaCommunication
from test_torch_reference_state import reference_state  # noqa: F401,E402  (restores the JAX package's state)

import torch

import chip_smoke
import heat_tpu_torch as htt
from heat_tpu_torch.comm import compressed as tcq
from heat_tpu_torch.core import communication as tcomm

RTOL, ATOL = 1e-4, 1e-5
THETA_TRUE = np.array([0.0, 2.0, -3.0, 0.0, 1.5, 0.0], np.float32)


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


def _data(n, seed=0, noise=0.01):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, len(THETA_TRUE))).astype(np.float32)
    y = (a @ THETA_TRUE + 0.5 + noise * rng.normal(size=n)).astype(np.float32)
    return a, y


def _theta(est) -> np.ndarray:
    return np.asarray(est.theta.numpy()).reshape(-1)


def _loss(a, y, th, lam=0.1):
    r = a @ th[1:] + th[0] - y
    return 0.5 * float(np.mean(r * r)) + lam * float(np.abs(th[1:]).sum())


def _fit_both(a, y, split=0, **kw):
    jt = ht.regression.Lasso(**kw).fit(ht.array(a, split=split), ht.array(y, split=split))
    tt = htt.regression.Lasso(**kw).fit(htt.array(a, split=split), htt.array(y, split=split))
    return tt, jt


@pytest.mark.parametrize("solver", ["cd", "gd"])
@pytest.mark.parametrize("tol,max_iter", [(-1.0, 25), (1e-4, 500)])
@pytest.mark.parametrize("n,split", [(800, 0), (203, 0), (96, None)])
def test_exact_fit_matches_reference(port, solver, tol, max_iter, n, split):
    a, y = _data(n, seed=n)
    tt, jt = _fit_both(a, y, split, lam=0.1, max_iter=max_iter, tol=tol, solver=solver)
    np.testing.assert_allclose(_theta(tt), _theta(jt), rtol=RTOL, atol=ATOL)
    assert tt.n_iter == jt.n_iter
    if tol < 0:
        assert tt.n_iter == max_iter
    assert tt.theta.shape == (7, 1) and tt.theta.split is None and tt.theta.dtype is htt.float32
    for attr in ("coef_", "intercept_"):
        got, want = getattr(tt, attr), getattr(jt, attr)
        assert got.shape == tuple(want.shape) and got.split == want.split
        np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()), rtol=RTOL, atol=ATOL)


def test_fit_accepts_a_column_y_and_lam_sets(port):
    a, y = _data(120, seed=3)
    tt, jt = _fit_both(a, y.reshape(-1, 1), 0, lam=0.3, max_iter=40, tol=-1.0)
    np.testing.assert_allclose(_theta(tt), _theta(jt), rtol=RTOL, atol=ATOL)
    tt.lam = 0.2
    assert tt.lam == 0.2 and tt.get_params()["lam"] == 0.2


def _ring_bound(a, y, th, p):
    """(p + 1) * sum_i absmax(partial_i) / 254 / n at theta: the error
    feedback ring's per-coordinate error on the gradient."""
    n = a.shape[0]
    aa = np.concatenate([np.ones((n, 1)), a], axis=1).astype(np.float64)
    blocks, yb = aa.reshape(p, n // p, -1), y.astype(np.float64).reshape(p, -1)
    parts = np.einsum("pij,pi->pj", blocks, np.einsum("pij,j->pi", blocks, th) - yb)
    eps = (p + 1) * np.abs(parts).max(axis=1).sum() / 254.0 / n
    mu = np.linalg.eigvalsh(aa.T @ aa / n).min()
    return np.sqrt(aa.shape[1]) * eps / mu


def test_quantized_gd_holds_the_reference_loss_gate(port, p):
    a, y = _data(64 * p, seed=11)
    kw = dict(lam=0.1, max_iter=2000, tol=1e-8, solver="gd")
    exact_t, exact_j = _fit_both(a, y, 0, **kw)
    with jcq.collective_precision("int8_block"), tcq.collective_precision("int8_block"):
        comp_t, comp_j = _fit_both(a, y, 0, **kw)
    le = _loss(a, y, _theta(exact_j))
    lq = _loss(a, y, _theta(comp_t))
    assert abs(lq - le) <= 1e-3 * max(le, 1e-6)
    assert abs(lq - _loss(a, y, _theta(comp_j))) <= 1e-3 * max(le, 1e-6)
    assert abs(_loss(a, y, _theta(exact_t)) - le) <= 1e-3 * max(le, 1e-6)
    bound = _ring_bound(a, y, _theta(exact_t).astype(np.float64), p)
    dist = float(np.linalg.norm(_theta(comp_t).astype(np.float64) - _theta(exact_t)))
    assert dist <= bound, (dist, bound)
    assert dist > 0  # the ring quantized


COUNTED = ("quantize_blocks", "dequantize_blocks", "dequantize_fma_blocks", "dequantize_add_quantize_blocks")


@pytest.mark.parametrize("q", [4, 8])
def test_quantized_gd_step_drives_the_ring(port, monkeypatch, q):
    """Per ISTA step at q positions: the EF encode and the ring's first
    encode (2 quantize), 1 dequantize_fma (the residual), q - 1 hops and 1
    dequantize: at q = 4 and m = 7 (or the chip smoke's 33), 7 wrapper
    calls, which launch 7 kernels on the card."""
    calls = {name: 0 for name in COUNTED}
    for name in COUNTED:
        real = getattr(tcq, name)

        def spy(*args, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*args, **kw)

        monkeypatch.setattr(tcq, name, spy)
    comm = htt.TorchCommunication(["cpu"] * q)
    a, y = _data(16 * q, seed=12)
    steps = 9
    with tcq.collective_precision("int8_block"):
        est = htt.regression.Lasso(lam=0.1, max_iter=steps, tol=-1.0, solver="gd").fit(
            htt.array(a, split=0, comm=comm), htt.array(y, split=0, comm=comm)
        )
    assert est.n_iter == steps
    assert calls == {"quantize_blocks": 2 * steps, "dequantize_blocks": steps,
                     "dequantize_fma_blocks": steps, "dequantize_add_quantize_blocks": (q - 1) * steps}


def test_quantized_gd_stays_exact_where_the_reference_does(port, p):
    """Rows that do not divide over the positions, or a replicated input,
    keep the exact gradient combine under the int8 policy, as in the
    reference: the fit equals the exact one."""
    a, y = _data(8 * p + 3, seed=13)
    for split in (0, None):
        exact = htt.regression.Lasso(lam=0.1, max_iter=30, tol=-1.0, solver="gd").fit(
            htt.array(a, split=split), htt.array(y, split=split))
        with tcq.collective_precision("int8_block"):
            comp = htt.regression.Lasso(lam=0.1, max_iter=30, tol=-1.0, solver="gd").fit(
                htt.array(a, split=split), htt.array(y, split=split))
        np.testing.assert_array_equal(_theta(comp), _theta(exact))


@pytest.mark.parametrize("q", [2, 4, 8])
def test_ef_ring_bitwise_on_reference_partials(q):
    """The quantized step's combine, on the JAX package's own per-position
    partials ``A_p^T (A_p theta - y_p)`` and an EF residual: the port's
    ring returns the reference's sum and residual bit for bit."""
    devs = jax.devices()
    if len(devs) < q:
        pytest.skip(f"needs {q} JAX devices")
    comm = XlaCommunication(devs[:q])
    name = comm.axis_name
    a, y = _data(32 * q, seed=14)
    arr = np.concatenate([np.ones((len(a), 1), np.float32), a], axis=1)
    th = np.random.default_rng(15).normal(size=arr.shape[1]).astype(np.float32)
    err = (np.random.default_rng(16).normal(size=(q, arr.shape[1])) * 1e-2).astype(np.float32)

    def body(ab, yb, e):
        part = ab.T @ (ab @ jnp.asarray(th) - yb)
        g, e2 = jcq.ring_allreduce_q_ef(part, jnp.squeeze(e, 0), name, size=q, mode="int8_block")
        return part[None], g, e2[None]

    fn = jax.jit(shard_map(
        body, mesh=comm.mesh,
        in_specs=(PartitionSpec(name), PartitionSpec(name), PartitionSpec(name)),
        out_specs=(PartitionSpec(name), PartitionSpec(), PartitionSpec(name)), check_vma=False,
    ))
    parts, g_j, e_j = (np.array(t) for t in fn(jnp.asarray(arr), jnp.asarray(y), jnp.asarray(err)))
    g_t, e_t = tcq.ring_allreduce_q_ef(torch.from_numpy(parts), torch.from_numpy(err), size=q, mode="int8_block")
    np.testing.assert_array_equal(g_t.numpy().view(np.int32), g_j.view(np.int32))
    np.testing.assert_array_equal(e_t.numpy().view(np.int32), e_j.view(np.int32))


@pytest.mark.parametrize("solver", ["cd", "gd"])
@pytest.mark.parametrize("split", [0, None, 1])
def test_from_fitted_predicts_like_reference(port, solver, split):
    a, y = _data(150, seed=17)
    jt = ht.regression.Lasso(lam=0.05, max_iter=200, solver=solver).fit(ht.array(a, split=0), ht.array(y, split=0))
    tt = htt.regression.Lasso.from_fitted(_theta(jt), jt.n_iter, lam=0.05, solver=solver)
    assert tt.n_iter == jt.n_iter and tt.lam == 0.05 and tt.solver == solver
    new = np.random.default_rng(18).normal(size=(37, a.shape[1])).astype(np.float32)
    got = tt.predict(htt.interop.array_from_numpy(new, split=split))
    want = jt.predict(ht.array(new, split=split))
    assert got.shape == tuple(want.shape) and got.split == want.split
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tt.rmse(htt.array(y[:37]), got), jt.rmse(ht.array(y[:37]), want), rtol=1e-5)


def test_soft_threshold_matches_reference():
    rho = np.array([-3.0, -0.5, 0.0, 0.25, 0.5, 2.0, np.inf, -np.inf, np.nan], np.float32)
    for lam in (0.0, 0.5, 1.0):
        got = htt.regression.Lasso.soft_threshold(torch.from_numpy(rho), lam).numpy()
        want = np.asarray(ht.regression.Lasso.soft_threshold(jnp.asarray(rho), lam))
        np.testing.assert_array_equal(got, want)


def test_validation_matches_reference(port):
    for kw in (dict(solver="sgd"), dict(solver="cd", mini_batch=8), dict(solver="gd", mini_batch=0)):
        with pytest.raises(ValueError):
            ht.regression.Lasso(**kw)
        with pytest.raises(ValueError):
            htt.regression.Lasso(**kw)
    x, y = htt.ones((8, 3), split=0), htt.ones(8, split=0)
    with pytest.raises(ValueError):
        htt.regression.Lasso().fit(htt.ones(8), y)
    with pytest.raises(ValueError):
        htt.regression.Lasso().fit(x, htt.ones((8, 2)))
    with pytest.raises(RuntimeError):
        htt.regression.Lasso().predict(x)
    # mini-batch and checkpointed fits are ported (ROADMAP A12, A16b):
    # a mini-batch fit runs, and a snapshot or a resume without a path
    # raises as the reference's does
    assert htt.regression.Lasso(solver="gd", mini_batch=4, max_iter=2).fit(x, y).n_iter == 4
    for pkg, xx, yy in ((htt, x, y), (ht, ht.ones((8, 3), split=0), ht.ones(8, split=0))):
        with pytest.raises(ValueError, match="checkpoint_every > 0 requires checkpoint_path"):
            pkg.regression.Lasso(checkpoint_every=2).fit(xx, yy)
        with pytest.raises(ValueError, match="resume requires checkpoint_path"):
            pkg.regression.Lasso().fit(xx, yy, resume=True)
    fitted = htt.regression.Lasso(max_iter=3).fit(x, y)
    with pytest.raises(ValueError):
        fitted.predict(htt.ones((4, 2)))


def test_estimator_surface_matches_reference(port):
    tt, jt = htt.regression.Lasso(lam=0.2), ht.regression.Lasso(lam=0.2)
    assert tt.get_params() == jt.get_params()
    assert htt.is_regressor(tt) and not htt.is_regressor(htt.cluster.KMeans())
    assert isinstance(tt, htt.RegressionMixin)
    assert tt.coef_ is None and tt.intercept_ is None and tt.theta is None
    assert "Lasso(" in repr(tt)


def _blobs(n, f=32, k=8, seed=0):
    """Blobs as ``chip_smoke.py`` phase 7 fits them (8 centres at scale 10,
    y as the reference benchmark builds it), at ``n`` rows."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=10, size=(k, f))
    a = (centers[rng.integers(k, size=n)] + rng.normal(size=(n, f))).astype(np.float32)
    y = (a @ np.arange(1, f + 1) / f + rng.normal(size=n)).astype(np.float32)
    return a, y


@pytest.mark.parametrize("package", ["port", "jax"])
def test_exact_gd_holds_the_float64_ista_replay(port, package):
    a, y = _blobs(16_000)
    steps = chip_smoke.LASSO_STEPS
    lib = htt if package == "port" else ht
    est = lib.regression.Lasso(lam=0.1, max_iter=steps, tol=-1.0, solver="gd").fit(
        lib.array(a, split=0), lib.array(y, split=0))
    want = chip_smoke.numpy_ista(a, y, 0.1, steps)
    assert np.abs(_theta(est) - want).max() <= chip_smoke.GD_TOL * np.abs(want).max()


def test_float64_ista_replay_sees_a_step_fault(port, monkeypatch):
    """A step size 1e-3 short moves the fit outside the replay's gate."""
    a, y = _blobs(16_000)
    lasso = htt.regression.lasso.Lasso
    lipschitz = lasso._lipschitz
    monkeypatch.setattr(lasso, "_lipschitz", staticmethod(lambda cols: lipschitz(cols) * 1.001))
    est = lasso(lam=0.1, max_iter=chip_smoke.LASSO_STEPS, tol=-1.0, solver="gd").fit(
        htt.array(a, split=0), htt.array(y, split=0))
    want = chip_smoke.numpy_ista(a, y, 0.1, chip_smoke.LASSO_STEPS)
    assert np.abs(_theta(est) - want).max() > chip_smoke.GD_TOL * np.abs(want).max()
