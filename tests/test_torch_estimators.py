"""The estimators that draw from the RNG, and what they stand on, held
against the JAX package: ``rbf``, ``manhattan``, ``Laplacian``,
``Spectral``, ``KMedians``, ``KMedoids``, ``GaussianNB`` (exact and
``int8_block``, with ``class_moments_q``), ``KNN`` and each
``from_fitted``.

The same numpy inputs (blobs from a numpy seed, a few hundred rows, at 8
positions by default and 7 for uneven chunks) go through both packages.
Tolerances:

* ``rbf``, ``manhattan`` and ``Laplacian``: ``rtol 1e-6, atol 1e-6`` on
  unit-scale data (the quadratic expansion's float32 rounding of ``d^2``
  stays under that there);
* KMedians and KMedoids: centers and labels bit for bit (the medians are
  values of the data, picked by exact counts; the medoids are rows);
  KMedians' medians also bit for bit against ``numpy.median`` of each
  cluster's rows under the port's own labels;
* Spectral: labels equal (the Lanczos bases agree to 1e-5 and the blobs
  are far apart);
* GaussianNB: ``theta_``/``sigma_`` within ``rtol 1e-10`` (float64);
  posteriors within ``1e-6``; under ``int8_block`` the ring is bit for bit
  the reference's on the reference's own per-position partials, and the
  fit within the ring bound of the exact one;
* KNN: labels equal.
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

import heat_tpu_torch as htt
from heat_tpu_torch.comm import compressed as tcq
from heat_tpu_torch.core import communication as tcomm

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture
def p():
    return len(jax.devices())


@pytest.fixture
def port(p):
    comm = htt.TorchCommunication(["cpu"] * p)
    prev = tcomm._default_comm
    htt.use_comm(comm)
    yield comm
    htt.use_comm(prev)


def _blobs(n_per=40, k=4, f=5, scale=6.0, seed=0):
    """Shuffled blobs around k centers and their blob labels."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=scale, size=(k, f)).astype(np.float32)
    labels = np.repeat(np.arange(k), n_per)
    pts = (centers[labels] + rng.normal(size=(k * n_per, f))).astype(np.float32)
    perm = rng.permutation(len(pts))
    return pts[perm], labels[perm], centers


def _np(a):
    return np.asarray(a.numpy())


def _seed(s=0):
    htt.random.seed(s)
    ht.random.seed(s)


# --------------------------------------------------------------------- #
# distances and Laplacians                                                #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("quadratic", [False, True])
@pytest.mark.parametrize("with_y", [False, True])
def test_rbf_matches_reference(port, split, quadratic, with_y):
    x = np.random.default_rng(1).normal(size=(37, 4)).astype(np.float32)
    y = np.random.default_rng(2).normal(size=(11, 4)).astype(np.float32)
    yt, yj = (htt.array(y), ht.array(y)) if with_y else (None, None)
    t = htt.spatial.rbf(htt.array(x, split=split), yt, sigma=1.3, quadratic_expansion=quadratic)
    j = ht.spatial.rbf(ht.array(x, split=split), yj, sigma=1.3, quadratic_expansion=quadratic)
    assert t.shape == tuple(j.shape) and t.split == j.split and t.dtype.__name__ == j.dtype.__name__
    np.testing.assert_allclose(t.numpy(), _np(j), **TOL)


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("dtype", ["float32", "float64", "int32"])
def test_manhattan_matches_reference(port, split, dtype):
    x = (np.random.default_rng(3).normal(size=(29, 6)) * 3).astype(dtype)
    y = (np.random.default_rng(4).normal(size=(9, 6)) * 3).astype(dtype)
    for yt, yj in ((None, None), (htt.array(y), ht.array(y))):
        t = htt.spatial.manhattan(htt.array(x, split=split), yt)
        j = ht.spatial.manhattan(ht.array(x, split=split), yj)
        assert t.shape == tuple(j.shape) and t.split == j.split and t.dtype.__name__ == j.dtype.__name__
        np.testing.assert_allclose(t.numpy(), _np(j), **TOL)


@pytest.mark.parametrize("definition", ["simple", "norm_sym"])
@pytest.mark.parametrize("mode,key", [("fully_connected", "upper"), ("eNeighbour", "upper"), ("eNeighbour", "lower")])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("split", [None, 0])
def test_laplacian_matches_reference(port, definition, mode, key, weighted, split):
    x = np.random.default_rng(5).normal(size=(30, 3)).astype(np.float32)
    kw = dict(weighted=weighted, definition=definition, mode=mode, threshold_key=key, threshold_value=0.4)
    Lt = htt.graph.Laplacian(lambda a: htt.spatial.rbf(a, sigma=1.0), **kw).construct(htt.array(x, split=split))
    Lj = ht.graph.Laplacian(lambda a: ht.spatial.rbf(a, sigma=1.0), **kw).construct(ht.array(x, split=split))
    assert Lt.shape == tuple(Lj.shape) and Lt.split == Lj.split and Lt.dtype is htt.float32
    np.testing.assert_allclose(Lt.numpy(), _np(Lj), **TOL)


def test_laplacian_rejects_what_the_reference_rejects(port):
    sim = lambda a: htt.spatial.rbf(a)  # noqa: E731
    with pytest.raises(NotImplementedError):
        htt.graph.Laplacian(sim, definition="random_walk")
    with pytest.raises(NotImplementedError):
        htt.graph.Laplacian(sim, mode="kNN")


# --------------------------------------------------------------------- #
# Spectral                                                               #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("n_clusters", [4, None])
def test_spectral_matches_reference(port, split, n_clusters):
    pts, _, _ = _blobs(n_per=30, seed=6)
    kw = dict(n_clusters=n_clusters, gamma=0.05, n_lanczos=40)
    st = htt.cluster.Spectral(**kw).fit(htt.array(pts, split=split))
    sj = ht.cluster.Spectral(**kw).fit(ht.array(pts, split=split))
    assert st._embedding_dim == sj._embedding_dim
    np.testing.assert_array_equal(st.labels_.numpy(), _np(sj.labels_))
    assert st.labels_.split == sj.labels_.split
    # predict embeds its input anew: on the fitted data the same basis
    pred = st.predict(htt.array(pts, split=split))
    np.testing.assert_array_equal(pred.numpy(), _np(sj.predict(ht.array(pts, split=split))))
    np.testing.assert_array_equal(pred.numpy(), st.labels_.numpy())
    assert htt.random.get_state() == ht.random.get_state()


def test_spectral_validation_matches_reference(port):
    pts, _, _ = _blobs(n_per=10, seed=7)
    with pytest.raises(NotImplementedError):
        htt.cluster.Spectral(metric="cosine")
    with pytest.raises(NotImplementedError):
        htt.cluster.Spectral().fit(htt.array(pts, split=1))
    with pytest.raises(RuntimeError):
        htt.cluster.Spectral().predict(htt.array(pts))


def test_spectral_from_fitted_predicts_reference_labels(port):
    pts, _, _ = _blobs(n_per=30, seed=8)
    kw = dict(n_clusters=4, gamma=0.05, n_lanczos=40)
    sj = ht.cluster.Spectral(**kw).fit(ht.array(pts, split=0))
    state = {"embedding_dim": sj._embedding_dim, "cluster_centers": _np(sj._kmeans.cluster_centers_)}
    st = htt.cluster.Spectral.from_fitted(state, **kw)
    np.testing.assert_array_equal(st.predict(htt.array(pts, split=0)).numpy(), _np(sj.predict(ht.array(pts, split=0))))


# --------------------------------------------------------------------- #
# KMedians and KMedoids                                                   #
# --------------------------------------------------------------------- #
def _assert_fit_equal(kt, kj):
    np.testing.assert_array_equal(kt.cluster_centers_.numpy(), _np(kj.cluster_centers_))
    np.testing.assert_array_equal(kt.labels_.numpy(), _np(kj.labels_))
    assert kt.n_iter_ == kj.n_iter_
    assert kt.labels_.split == kj.labels_.split and kt.cluster_centers_.split is None


@pytest.mark.parametrize("cls", ["KMedians", "KMedoids"])
@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("init", ["centers", "random", "probability_based", "plusplus"])
def test_kclusterer_matches_reference(port, cls, split, init):
    """Every init: the fitted centers, labels and step count are the
    reference's bit for bit."""
    pts, _, centers = _blobs(seed=9)
    kw = dict(n_clusters=4, max_iter=12, random_state=3)
    if cls == "KMedians":
        kw["tol"] = -1.0
    if init == "centers":
        it, ij = htt.array(centers), ht.array(centers)
    else:
        name = {"KMedians": "kmedians++", "KMedoids": "kmedoids++"}[cls] if init == "plusplus" else init
        it = ij = name
    kt = getattr(htt.cluster, cls)(init=it, **kw).fit(htt.array(pts, split=split))
    kj = getattr(ht.cluster, cls)(init=ij, **kw).fit(ht.array(pts, split=split))
    _assert_fit_equal(kt, kj)
    np.testing.assert_array_equal(kt.predict(htt.array(pts[:17])).numpy(), _np(kj.predict(ht.array(pts[:17]))))


def _median_replay(data, init, steps, assign):
    """``steps`` median updates in numpy: per-cluster ``numpy.median`` of
    the member rows under ``assign``'s labels; an empty cluster keeps its
    center."""
    c = init.copy()
    for _ in range(steps):
        labels = assign(c)
        c = np.stack([np.median(data[labels == j], axis=0) if (labels == j).any() else c[j]
                      for j in range(len(c))]).astype(np.float32)
    return c


@pytest.mark.parametrize("init_rows", [False, True])
def test_kmedians_medians_equal_numpy(port, init_rows):
    """The bisection's medians equal ``numpy.median`` bit for bit over 8
    steps, from the blob centers and from the first rows (whose labels
    churn, so warm brackets fail and widen back)."""
    from heat_tpu_torch.cluster.kmeans import _assign
    from heat_tpu_torch.cluster.kmedians import KMedians

    pts, _, centers = _blobs(n_per=300, k=5, f=4, scale=2.0, seed=10)
    init = pts[:5].copy() if init_rows else centers
    arr = torch.from_numpy(pts)
    got, _, n_iter = KMedians._fit_loop(arr, torch.from_numpy(init), -1.0, 8)
    want = _median_replay(pts, init, 8, lambda c: _assign(arr, torch.from_numpy(c)).numpy())
    assert n_iter == 8
    np.testing.assert_array_equal(got.numpy(), want)


def test_kmedians_keeps_empty_clusters_and_rejects_too_many_rows(port, monkeypatch):
    from heat_tpu_torch.cluster import kmedians

    pts, _, centers = _blobs(seed=11)
    far = np.concatenate([centers, np.full((1, centers.shape[1]), 1e4, np.float32)])
    kt = htt.cluster.KMedians(n_clusters=5, init=htt.array(far), max_iter=4, tol=-1.0).fit(htt.array(pts, split=0))
    kj = ht.cluster.KMedians(n_clusters=5, init=ht.array(far), max_iter=4, tol=-1.0).fit(ht.array(pts, split=0))
    _assert_fit_equal(kt, kj)
    np.testing.assert_array_equal(kt.cluster_centers_.numpy()[4], far[4])
    monkeypatch.setattr(kmedians, "_MAX_ROWS", 100)
    with pytest.raises(ValueError, match="float32"):
        htt.cluster.KMedians(n_clusters=4, init=htt.array(centers)).fit(htt.array(pts))


def test_kmedoids_step_loop_matches_reference(port):
    pts, _, centers = _blobs(seed=12)
    from heat_tpu.cluster.kmedoids import KMedoids as JK

    got = htt.cluster.KMedoids._step_loop(torch.from_numpy(pts), torch.from_numpy(centers), 9)
    want = np.asarray(JK._step_loop(jnp.asarray(pts), jnp.asarray(centers), jnp.int32(9)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert all((pts == row).all(axis=1).any() for row in got.numpy())


@pytest.mark.parametrize("cls", ["KMedians", "KMedoids"])
def test_kclusterer_from_fitted_predicts_reference_labels(port, cls):
    pts, _, centers = _blobs(seed=13)
    kj = getattr(ht.cluster, cls)(n_clusters=4, init=ht.array(centers), max_iter=20).fit(ht.array(pts, split=0))
    state = {"cluster_centers": _np(kj.cluster_centers_), "n_iter": kj.n_iter_}
    kt = getattr(htt.cluster, cls).from_fitted(state)
    new, _, _ = _blobs(n_per=9, seed=14)
    np.testing.assert_array_equal(kt.predict(htt.array(new, split=0)).numpy(), _np(kj.predict(ht.array(new, split=0))))
    assert kt.n_iter_ == kj.n_iter_


def test_kclusterer_params_and_aliases(port):
    km = htt.cluster.KMedians(init="kmedians++")
    assert km.init == "probability_based" and km.get_params()["n_clusters"] == 8
    kd = htt.cluster.KMedoids(init="kmedoids++", max_iter=5)
    assert kd.init == "probability_based" and kd.tol == 0.0 and "KMedoids(" in repr(kd)
    with pytest.raises(ValueError, match="init"):
        htt.cluster.KMedoids(init="bogus").fit(htt.array(np.ones((10, 2), np.float32)))


# --------------------------------------------------------------------- #
# GaussianNB                                                              #
# --------------------------------------------------------------------- #
def _nb_same(nt, nj):
    for name in ("theta_", "sigma_"):
        np.testing.assert_allclose(getattr(nt, name), np.asarray(getattr(nj, name)), rtol=1e-10, atol=1e-12)
    for name in ("class_count_", "class_prior_"):
        np.testing.assert_allclose(getattr(nt, name), np.asarray(getattr(nj, name)), rtol=1e-12)
    np.testing.assert_array_equal(nt.classes_, np.asarray(nj.classes_))
    assert nt.epsilon_ == pytest.approx(nj.epsilon_, rel=1e-10)


@pytest.mark.parametrize("split", [None, 0, 1])
def test_gaussian_nb_fit_and_predict_match_reference(port, split):
    pts, lab, _ = _blobs(seed=15)
    X, Y = htt.array(pts, split=split), ht.array(pts, split=split)
    yt, yj = htt.array(lab, split=0 if split == 0 else None), ht.array(lab, split=0 if split == 0 else None)
    nt, nj = htt.naive_bayes.GaussianNB().fit(X, yt), ht.naive_bayes.GaussianNB().fit(Y, yj)
    _nb_same(nt, nj)
    q = pts[::4] + np.float32(0.7)
    qt, qj = htt.array(q, split=split), ht.array(q, split=split)
    pt, pj = nt.predict(qt), nj.predict(qj)
    np.testing.assert_array_equal(pt.numpy(), _np(pj))
    assert pt.dtype.__name__ == pj.dtype.__name__ and pt.split == pj.split
    for fn in ("predict_proba", "predict_log_proba"):
        a, b = getattr(nt, fn)(qt), getattr(nj, fn)(qj)
        assert a.dtype is htt.float32 and a.split == b.split
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-6, atol=1e-6)
    assert htt.is_classifier(nt) and not htt.is_regressor(nt)


def test_gaussian_nb_partial_fit_weights_and_priors_match_reference(port):
    pts, lab, _ = _blobs(seed=16)
    w = np.random.default_rng(17).uniform(0.5, 2.0, size=len(pts))
    classes = np.arange(4)
    nt = htt.naive_bayes.GaussianNB(priors=[0.1, 0.2, 0.3, 0.4])
    nj = ht.naive_bayes.GaussianNB(priors=[0.1, 0.2, 0.3, 0.4])
    for sl, cls_arg in ((slice(0, 70), classes), (slice(70, 160), None)):
        nt.partial_fit(htt.array(pts[sl], split=0), htt.array(lab[sl], split=0), classes=cls_arg,
                       sample_weight=htt.array(w[sl]))
        nj.partial_fit(ht.array(pts[sl], split=0), ht.array(lab[sl], split=0), classes=cls_arg,
                       sample_weight=ht.array(w[sl]))
    _nb_same(nt, nj)
    np.testing.assert_array_equal(nt.predict(htt.array(pts)).numpy(), _np(nj.predict(ht.array(pts))))
    with pytest.raises(ValueError):
        nt.partial_fit(htt.array(pts), htt.array(lab), classes=np.arange(5))
    with pytest.raises(ValueError):
        nt.partial_fit(htt.array(pts), htt.array(lab + 7))
    with pytest.raises(ValueError):
        htt.naive_bayes.GaussianNB(priors=[0.5, 0.6, 0.0, 0.0]).fit(htt.array(pts), htt.array(lab))
    with pytest.raises(RuntimeError):
        htt.naive_bayes.GaussianNB().predict(htt.array(pts))


def _reference_ssd_ring(pts, member, q):
    """The reference's class_moments_q body at q mesh positions, returning
    each position's centered partial and the ring's sum before its clamp."""
    comm = XlaCommunication(jax.devices()[:q])
    name = comm.axis_name

    def body(a, m):
        c_local = jnp.sum(m, axis=0)
        s_local = m.T @ a
        sq_local = m.T @ (a * a)
        counts = jax.lax.psum(c_local, name)
        sums = jax.lax.psum(s_local, name)
        mu = sums / jnp.maximum(counts, 1.0)[:, None]
        ssd_local = sq_local - 2.0 * mu * s_local + c_local[:, None] * mu * mu
        ssd = jcq.ring_allreduce_q(ssd_local, name, size=q, mode="int8_block")
        return ssd_local[None], ssd

    fn = jax.jit(shard_map(
        body, mesh=comm.mesh, in_specs=(PartitionSpec(name), PartitionSpec(name)),
        out_specs=(PartitionSpec(name), PartitionSpec()), check_vma=False,
    ))
    parts, ssd = fn(jnp.asarray(pts), jnp.asarray(member))
    return np.array(parts), np.array(ssd)


@pytest.mark.parametrize("q", [2, 4, 8])
def test_class_moments_ring_bitwise_on_reference_partials(q):
    devs = jax.devices()
    if len(devs) < q:
        pytest.skip(f"needs {q} JAX devices")
    pts, lab, _ = _blobs(n_per=8 * q, seed=18)
    member = np.eye(4, dtype=np.float32)[lab]
    parts, ssd_j = _reference_ssd_ring(pts, member, q)
    ssd_t = tcq.ring_allreduce_q(torch.from_numpy(parts), size=q, mode="int8_block")
    np.testing.assert_array_equal(ssd_t.numpy().view(np.int32), ssd_j.view(np.int32))


def test_class_moments_q_matches_reference(port, p):
    """The whole function: counts and sums exact against the reference's
    (float32 sums in another order: 1e-6 relative), ssd within the ring
    bound of the exact centered sums of squares."""
    if p == 1:
        pytest.skip("at one position the quantized ring is an identity")
    pts, lab, _ = _blobs(n_per=2 * p, seed=19)
    member = np.eye(4, dtype=np.float32)[lab]
    ct, st, qt = tcq.class_moments_q(torch.from_numpy(pts), torch.from_numpy(member), comm=port, mode="int8_block")
    X = ht.array(pts, split=0)
    cj, sj, qj = jcq.class_moments_q(X.larray, ht.array(member, split=0).larray, comm=X.comm, mode="int8_block")
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6, atol=1e-5)
    d = pts.astype(np.float64)
    exact = np.stack([((d[lab == c] - d[lab == c].mean(0)) ** 2).sum(0) for c in range(4)])
    blocks, lb = d.reshape(p, -1, d.shape[1]), lab.reshape(p, -1)
    mu = np.stack([d[lab == c].mean(0) for c in range(4)])
    parts = np.stack([np.stack([((blocks[i][lb[i] == c] - mu[c]) ** 2).sum(0) for c in range(4)]) for i in range(p)])
    bound = p * np.abs(parts).reshape(p, -1).max(1).sum() / 254.0
    assert np.abs(qt.numpy() - exact).max() <= bound
    assert np.abs(np.asarray(qj) - exact).max() <= bound


def test_gaussian_nb_int8_block_rides_the_ring(port, p, monkeypatch):
    """Under ``int8_block`` a row-split fit takes class_moments_q (one
    ring: 1 quantize, p - 1 hops and 1 dequantize), and
    its ``sigma_`` lies within the ring bound ``(p + 1) sum absmax / 254 /
    count`` of the exact fit's; the reference's compressed fit too."""
    if p == 1:
        pytest.skip("at one position the quantized ring is an identity")
    pts, lab, _ = _blobs(n_per=4 * p, seed=20)
    X, yt = htt.array(pts, split=0), htt.array(lab, split=0)
    exact = htt.naive_bayes.GaussianNB().fit(X, yt)
    calls = []
    names = ("quantize_blocks", "dequantize_blocks", "dequantize_fma_blocks", "dequantize_add_quantize_blocks")
    for name in names:
        orig = getattr(tcq, name)
        monkeypatch.setattr(tcq, name, lambda *a, _o=orig, _n=name, **k: calls.append(_n) or _o(*a, **k))
    with tcq.collective_precision("int8_block"), jcq.collective_precision("int8_block"):
        comp = htt.naive_bayes.GaussianNB().fit(X, yt)
        comp_j = ht.naive_bayes.GaussianNB().fit(ht.array(pts, split=0), ht.array(lab, split=0))
    assert [calls.count(n) for n in names] == [1, 1, 0, p - 1]
    np.testing.assert_allclose(comp.theta_, exact.theta_, rtol=1e-6, atol=1e-5)
    d = pts.astype(np.float64)
    blocks, lb = d.reshape(p, -1, d.shape[1]), lab.reshape(p, -1)
    parts = np.stack([np.stack([((blocks[i][lb[i] == c] - exact.theta_[c]) ** 2).sum(0) for c in range(4)])
                      for i in range(p)])
    bound = (p + 1) * np.abs(parts).reshape(p, -1).max(1).sum() / 254.0 / np.bincount(lab).min()
    assert np.abs(comp.sigma_ - exact.sigma_).max() <= bound
    assert np.abs(np.asarray(comp_j.sigma_) - exact.sigma_).max() <= bound


def test_gaussian_nb_from_fitted_predicts_reference_labels(port):
    pts, lab, _ = _blobs(seed=21)
    nj = ht.naive_bayes.GaussianNB().fit(ht.array(pts, split=0), ht.array(lab, split=0))
    state = {name: np.asarray(getattr(nj, name)) for name in
             ("theta_", "sigma_", "class_prior_", "class_count_", "classes_", "epsilon_")}
    nt = htt.naive_bayes.GaussianNB.from_fitted(state)
    q = pts[::3] * np.float32(1.1)
    np.testing.assert_array_equal(nt.predict(htt.array(q, split=0)).numpy(), _np(nj.predict(ht.array(q, split=0))))
    np.testing.assert_allclose(nt.predict_proba(htt.array(q)).numpy(), _np(nj.predict_proba(ht.array(q))),
                               rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------- #
# KNN                                                                     #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("k", [1, 5, 12])
@pytest.mark.parametrize("one_hot", [False, True])
def test_knn_matches_reference(port, split, k, one_hot):
    pts, lab, _ = _blobs(scale=2.0, seed=22)
    yt, yj = htt.array(lab, split=0 if split == 0 else None), ht.array(lab, split=0 if split == 0 else None)
    if one_hot:
        yt, yj = htt.classification.KNN.label_to_one_hot(yt), ht.classification.KNN.label_to_one_hot(yj)
        np.testing.assert_array_equal(yt.numpy(), _np(yj))
        assert yt.split == yj.split
    kt = htt.classification.KNN(htt.array(pts, split=split), yt, k)
    kj = ht.classification.KNN(ht.array(pts, split=split), yj, k)
    q = np.random.default_rng(23).normal(scale=3.0, size=(31, pts.shape[1])).astype(np.float32)
    pt, pj = kt.predict(htt.array(q, split=split)), kj.predict(ht.array(q, split=split))
    np.testing.assert_array_equal(pt.numpy(), _np(pj))
    assert pt.dtype is htt.int64 and pt.split == pj.split


def test_knn_validation_and_from_fitted(port):
    pts, lab, _ = _blobs(seed=24)
    with pytest.raises(ValueError):
        htt.classification.KNN(htt.array(pts), htt.array(lab[:-1]), 3)
    with pytest.raises(ValueError):
        htt.classification.KNN(htt.array(pts), htt.array(lab), 0)
    with pytest.raises(ValueError):
        htt.classification.KNN(htt.array(pts), htt.array(lab.reshape(-1, 1, 1)), 3)
    kj = ht.classification.KNN(ht.array(pts, split=0), ht.array(lab, split=0), 7)
    kt = htt.classification.KNN.from_fitted({"x": pts, "y": lab, "num_neighbours": 7})
    q = pts[::5] + np.float32(0.3)
    np.testing.assert_array_equal(kt.predict(htt.array(q, split=0)).numpy(), _np(kj.predict(ht.array(q, split=0))))
    assert htt.is_classifier(kt)
