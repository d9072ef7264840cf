"""The port's analytics slice held against the JAX package.

The same numpy inputs go through ``heat_tpu`` and ``heat_tpu_torch``: the
port runs at as many positions (all on the CPU) as the JAX package has
devices under ``tests/conftest.py`` (8 by default).  Tolerances, each with
its reason:

* layout helpers, factories' values and padded buffers, dtypes, labels,
  integer results and exact collectives: equal (they are integer or exact
  bookkeeping);
* elementwise arithmetic: ``rtol 1e-6`` (one float32 rounding each; torch
  and XLA may vectorise pow differently);
* moments, cdist and exact KMeans centers: ``rtol 1e-5`` (float32 sums
  and products taken in another order);
* ``int8_block`` KMeans centers: within 0.1 of each other and of the
  exact fit, the reference's own gate for its compressed fit, on its
  small test blobs; on the benchmark's blob geometry, within 1e-4 of each
  other (the same quantized ring on sums taken in another order) and
  inside the ring bound of the exact fit.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import heat_tpu as ht
from heat_tpu.comm import compressed as jcq
from heat_tpu.core.communication import XlaCommunication
from test_torch_reference_state import reference_state  # noqa: F401,E402  (restores the JAX package's state)

import torch

import chip_smoke
import heat_tpu_torch as htt
from heat_tpu_torch.comm import compressed as tcq
from heat_tpu_torch.core import communication as tcomm


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


def _blobs(n_per, centers, seed=0, scale=0.5):
    rng = np.random.default_rng(seed)
    pts = np.concatenate(
        [rng.normal(size=(n_per, centers.shape[1])).astype(np.float32) * scale + c for c in centers]
    )
    return pts[rng.permutation(len(pts))].astype(np.float32)


# --------------------------------------------------------------------- #
# layout                                                                 #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("n", [0, 1, 5, 8, 61, 64, 103])
def test_layout_helpers_bitwise(port, p, n):
    ref = XlaCommunication(jax.devices())
    assert port.size == ref.size == p
    assert port.shard_width(n) == ref.shard_width(n)
    assert port.padded_size(n) == ref.padded_size(n)
    assert port.valid_counts(n) == ref.valid_counts(n)
    for shape, split in [((n,), 0), ((n, 3), 0), ((4, n), 1), ((n, 2), None)]:
        assert port.counts_displs_shape(shape, split or 0) == ref.counts_displs_shape(shape, split or 0)
        for r in range(p):
            assert port.chunk(shape, split, rank=r) == ref.chunk(shape, split, rank=r)
    data = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    padded_t = port.pad_to_shards(torch.from_numpy(data), axis=0).numpy()
    padded_j = np.asarray(ref.pad_to_shards(jnp.asarray(data), axis=0))
    np.testing.assert_array_equal(padded_t, padded_j)
    np.testing.assert_array_equal(port.unpad(torch.from_numpy(padded_t), n).numpy(), data)


@pytest.mark.parametrize("shape,split", [((61, 7), 0), ((103,), 0), ((6, 61), 1), ((16, 4), 0), ((5, 3), None)])
def test_array_padded_at_rest_like_reference(port, shape, split):
    data = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    xt = htt.array(data, split=split)
    xj = ht.array(data, split=split)
    assert xt.shape == xj.shape and xt.split == xj.split
    assert xt.padshape == xj.padshape
    assert xt.lshape == xj.comm.chunk(shape, split, rank=0)[1]
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj.numpy()))
    if split is not None:
        pad = xt._buffer.narrow(split, shape[split], xt.padshape[split] - shape[split])
        assert not pad.any()  # pad rows are zero


def test_factories_match_reference(port):
    pairs = [
        (htt.arange(10, split=0), ht.arange(10, split=0)),
        (htt.arange(1.5, 7.0, 0.5), ht.arange(1.5, 7.0, 0.5)),
        (htt.zeros((9, 4), split=0), ht.zeros((9, 4), split=0)),
        (htt.ones((3, 11), split=1), ht.ones((3, 11), split=1)),
        (htt.full((13,), 2.5, split=0), ht.full((13,), 2.5, split=0)),
        (htt.array([[1, 2], [3, 4]]), ht.array([[1, 2], [3, 4]])),
        (htt.array([1.5, 2.5]), ht.array([1.5, 2.5])),
        (htt.array(np.arange(6, dtype=np.float64), split=0), ht.array(np.arange(6, dtype=np.float64), split=0)),
        (htt.array([True, False]), ht.array([True, False])),
        (htt.array([2**40]), ht.array([2**40])),
    ]
    for t, j in pairs:
        assert t.dtype.__name__ == j.dtype.__name__
        assert t.shape == j.shape and t.split == j.split and t.padshape == j.padshape
        np.testing.assert_array_equal(t.numpy(), np.asarray(j.numpy()))


def test_array_is_split_concatenates_pieces(port):
    pieces = [np.full((2, 3), i, np.float32) for i in range(3)]
    t = htt.array(pieces, is_split=0)
    j = ht.array(pieces, is_split=0)
    assert t.shape == j.shape == (6, 3) and t.split == 0
    np.testing.assert_array_equal(t.numpy(), np.asarray(j.numpy()))


NAMES = ["bool", "int32", "int64", "float32", "float64", "bfloat16"]


@pytest.mark.parametrize("a", NAMES)
def test_promote_types_matches_reference(a):
    for b in NAMES:
        got = htt.types.promote_types(getattr(htt.types, a), getattr(htt.types, b))
        want = ht.types.promote_types(getattr(ht.types, a), getattr(ht.types, b))
        assert got.__name__ == want.__name__, (a, b)
        assert htt.types.heat_type_is_exact(got) == ht.types.heat_type_is_exact(want)


def test_canonical_heat_type_spellings():
    t = htt.types
    assert t.canonical_heat_type("float32") is t.float32
    assert t.canonical_heat_type(float) is t.float32
    assert t.canonical_heat_type(int) is t.int32
    assert t.canonical_heat_type(bool) is t.bool
    assert t.canonical_heat_type(torch.float64) is t.float64
    assert t.canonical_heat_type(np.int64) is t.int64
    assert t.canonical_heat_type(jnp.bfloat16) is t.bfloat16
    with pytest.raises(TypeError):
        t.canonical_heat_type(t.floating)
    with pytest.raises(TypeError):
        t.canonical_heat_type("complex256")


# --------------------------------------------------------------------- #
# op engine                                                              #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("op", ["add", "sub", "mul", "div", "pow"])
@pytest.mark.parametrize("split", [None, 0, 1])
def test_binary_ops_match_reference(port, op, split):
    rng = np.random.default_rng(2)
    a = rng.uniform(0.5, 2.0, size=(61, 5)).astype(np.float32)
    b = rng.uniform(0.5, 2.0, size=(61, 5)).astype(np.float32)
    row = rng.uniform(0.5, 2.0, size=(5,)).astype(np.float32)
    fn_t, fn_j = getattr(htt, op), getattr(ht, op)
    for rhs_t, rhs_j in [
        (htt.array(b, split=split), ht.array(b, split=split)),
        (htt.array(row), ht.array(row)),
        (1.5, 1.5),
    ]:
        got = fn_t(htt.array(a, split=split), rhs_t)
        want = fn_j(ht.array(a, split=split), rhs_j)
        assert got.split == want.split and got.shape == want.shape
        assert got.dtype.__name__ == want.dtype.__name__
        np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()), rtol=1e-6)
    got = fn_t(2.0, htt.array(a, split=split)).numpy()
    want = np.asarray(fn_j(2.0, ht.array(a, split=split)).numpy())
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_dunders_and_out(port):
    a = np.arange(12, dtype=np.float32).reshape(4, 3)
    x = htt.array(a, split=0)
    np.testing.assert_array_equal((-(x * 2 - 1) / 2 + 0.5).numpy(), -(a * 2 - 1) / 2 + 0.5)
    np.testing.assert_array_equal((2 ** htt.array([1.0, 2.0])).numpy(), [2.0, 4.0])
    out = htt.zeros((4, 3), split=0)
    htt.add(x, x, out=out)
    np.testing.assert_array_equal(out.numpy(), a + a)


# --------------------------------------------------------------------- #
# reductions and moments                                                 #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("fn", ["sum", "mean", "var", "std", "min", "max", "argmin"])
@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("axis", [None, 0, 1])
def test_reductions_match_reference(port, fn, split, axis):
    data = (np.random.default_rng(4).normal(size=(61, 7)) * 3 + 1).astype(np.float32)
    got = getattr(htt, fn)(htt.array(data, split=split), axis=axis)
    want = getattr(ht, fn)(ht.array(data, split=split), axis=axis)
    assert got.shape == want.shape and got.split == want.split
    assert got.dtype.__name__ == want.dtype.__name__
    if fn == "argmin":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want.numpy()))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("ddof", [0, 1])
def test_var_std_keepdims_ddof(port, ddof):
    data = np.random.default_rng(5).normal(size=(37, 4)).astype(np.float32)
    for fn in ("var", "std"):
        got = getattr(htt, fn)(htt.array(data, split=0), axis=0, ddof=ddof, keepdims=True)
        want = getattr(ht, fn)(ht.array(data, split=0), axis=0, ddof=ddof, keepdims=True)
        assert got.shape == want.shape == (1, 4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()), rtol=1e-5)


def test_nan_propagates_through_min_max(port):
    data = np.arange(20, dtype=np.float32)
    data[13] = np.nan
    assert np.isnan(htt.max(htt.array(data, split=0)).item())
    assert np.isnan(htt.min(htt.array(data, split=0)).item())


# --------------------------------------------------------------------- #
# cdist                                                                  #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("quadratic", [True, False])
@pytest.mark.parametrize("split", [None, 0])
def test_cdist_matches_reference(port, quadratic, split):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(61, 5)).astype(np.float32)
    y = rng.normal(size=(9, 5)).astype(np.float32) + 3.0
    got = htt.spatial.cdist(htt.array(x, split=split), htt.array(y), quadratic_expansion=quadratic)
    want = ht.spatial.cdist(ht.array(x, split=split), ht.array(y), quadratic_expansion=quadratic)
    assert got.shape == want.shape and got.split == want.split
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()), rtol=1e-5)


def test_cdist_self(port):
    x = np.random.default_rng(7).normal(size=(24, 3)).astype(np.float32)
    got = htt.spatial.cdist(htt.array(x, split=0)).numpy()
    want = np.asarray(ht.spatial.cdist(ht.array(x, split=0)).numpy())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------- #
# communicator                                                           #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("op", ["sum", "prod", "max", "min"])
def test_exact_allreduce_matches_reference(port, p, op):
    stacked = np.random.default_rng(8).uniform(0.5, 1.5, size=(p, 33)).astype(np.float32)
    got = port.allreduce(torch.from_numpy(stacked), op).numpy()
    want = np.asarray(XlaCommunication(jax.devices()).allreduce(jnp.asarray(stacked), op))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("n", [16, 61])
@pytest.mark.parametrize("shift", [1, 3])
def test_ring_permute_matches_reference(port, n, shift):
    data = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    got = port.ring_permute(torch.from_numpy(data), shift).numpy()
    want = np.asarray(XlaCommunication(jax.devices()).ring_permute(jnp.asarray(data), shift))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("src,dst", [(0, None), (None, 0), (0, 1), (1, 0)])
def test_resplit_matches_reference(port, src, dst):
    data = np.random.default_rng(9).normal(size=(13, 11)).astype(np.float32)
    got = htt.array(data, split=src).resplit(dst)
    want = ht.array(data, split=src).resplit(dst)
    assert got.split == want.split and got.padshape == want.padshape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.numpy()))


def test_allgather_is_exact_by_default(port):
    data = torch.arange(16, dtype=torch.float32).reshape(8, 2)
    assert port.allgather(data, axis=0) is data


# --------------------------------------------------------------------- #
# KMeans                                                                 #
# --------------------------------------------------------------------- #
CENTERS = np.array([[0, 0], [6, 6], [-6, 5]], np.float32)


def _fit_both(pts, init, **kw):
    kt = htt.cluster.KMeans(n_clusters=len(init), init=htt.array(init), **kw).fit(htt.array(pts, split=0))
    kj = ht.cluster.KMeans(n_clusters=len(init), init=ht.array(init), **kw).fit(ht.array(pts, split=0))
    return kt, kj


@pytest.mark.parametrize("tol,max_iter", [(1e-6, 100), (-1.0, 7)])
def test_kmeans_exact_matches_reference(port, tol, max_iter):
    pts = _blobs(80, CENTERS, seed=1)
    kt, kj = _fit_both(pts, CENTERS + 0.3, max_iter=max_iter, tol=tol)
    np.testing.assert_array_equal(kt.labels_.numpy(), np.asarray(kj.labels_.numpy()))
    np.testing.assert_allclose(
        kt.cluster_centers_.numpy(), np.asarray(kj.cluster_centers_.numpy()), rtol=1e-5, atol=1e-6
    )
    assert kt.n_iter_ == kj.n_iter_
    assert kt.labels_.split == 0 and kt.cluster_centers_.split is None
    np.testing.assert_allclose(kt.inertia_, kj.inertia_, rtol=1e-4)
    np.testing.assert_array_equal(kt.predict(htt.array(pts, split=0)).numpy(), kt.labels_.numpy())


def test_kmeans_int8_block_matches_reference(port):
    """The error-feedback fit at p positions: labels equal to the
    reference's compressed fit, centers within 0.1 of it and of the exact
    fit."""
    pts = _blobs(80, CENTERS, seed=2)
    init = CENTERS + 0.3
    exact_t, _ = _fit_both(pts, init, max_iter=100, tol=1e-6)
    with jcq.collective_precision("int8_block"), tcq.collective_precision("int8_block"):
        kt, kj = _fit_both(pts, init, max_iter=100, tol=1e-6)
    np.testing.assert_array_equal(kt.labels_.numpy(), np.asarray(kj.labels_.numpy()))
    ct = kt.cluster_centers_.numpy()
    assert np.max(np.abs(ct - np.asarray(kj.cluster_centers_.numpy()))) < 0.1
    assert np.max(np.abs(ct - exact_t.cluster_centers_.numpy())) < 0.1
    assert kt.inertia_ <= exact_t.inertia_ * 1.05


def test_kmeans_int8_block_on_benchmark_blobs(port, p):
    """The reference benchmark's blob geometry (k=8 centers of scale 10 in
    32 features, explicit init at the true centers, fixed steps): the
    port's EF fit equals the reference's (labels equal, centers within
    1e-4: the same quantized ring on sums taken in another order).  On
    this geometry the reference's own compressed centers lie MORE than 0.1
    from the exact fit, since each step's sums carry a quantization error
    of about ``max|center| / 254`` per element after division by the
    counts; both stay inside the ring bound ``(p + 1) * sum_i absmax_i /
    254 / min count`` of the last step's sums."""
    if p == 1:
        pytest.skip("at one position the quantized ring is an identity")
    k, f, n_per = 8, 32, p * (250 // p)  # rows divide over the positions
    rng = np.random.default_rng(0)
    centers = rng.normal(scale=10, size=(k, f)).astype(np.float32)
    data = np.concatenate([c + rng.normal(size=(n_per, f)).astype(np.float32) for c in centers])
    kw = dict(max_iter=10, tol=-1.0)
    exact_t, _ = _fit_both(data, centers, **kw)
    with jcq.collective_precision("int8_block"), tcq.collective_precision("int8_block"):
        kt, kj = _fit_both(data, centers, **kw)
    labels = exact_t.labels_.numpy()
    np.testing.assert_array_equal(kt.labels_.numpy(), np.asarray(kj.labels_.numpy()))
    ct, cj = kt.cluster_centers_.numpy(), np.asarray(kj.cluster_centers_.numpy())
    np.testing.assert_allclose(ct, cj, rtol=0, atol=1e-4)
    blocks, lab = data.astype(np.float64).reshape(p, -1, f), labels.reshape(p, -1)
    sums = np.stack([np.stack([blocks[i][lab[i] == c].sum(0) for c in range(k)]) for i in range(p)])
    bound = (p + 1) * np.abs(sums).reshape(p, -1).max(1).sum() / 254.0 / np.bincount(labels).min()
    shift_t = np.abs(ct - exact_t.cluster_centers_.numpy()).max()
    shift_j = np.abs(cj - exact_t.cluster_centers_.numpy()).max()
    assert 0.1 < shift_j <= bound and shift_t <= bound


def test_kmeans_int8_block_drives_the_quantized_ring(port, p):
    """Under the policy the fit really takes the EF ring: the quantizer
    runs, and the trajectory differs from the exact one."""
    pts = _blobs(64, np.array([[0, 0, 0, 0], [5, 5, 0, 0], [0, 5, 5, 5], [-5, 0, 0, 5]], np.float32), seed=3)
    init = htt.array(pts[:4])
    x = htt.array(pts, split=0)
    calls = []
    orig = tcq.quantize_blocks_plain
    tcq.quantize_blocks_plain = lambda x2: calls.append(x2.shape) or orig(x2)
    try:
        with tcq.collective_precision("int8_block"):
            htt.cluster.KMeans(n_clusters=4, init=init, max_iter=3, tol=-1.0).fit(x)
    finally:
        tcq.quantize_blocks_plain = orig
    # per step: one EF round trip + (p-1) reduce-scatter hops + one gather
    assert len(calls) == 3 * (1 + p)


def test_kmeans_from_fitted_predicts_reference_labels(port):
    pts = _blobs(70, CENTERS, seed=4)
    kj = ht.cluster.KMeans(n_clusters=3, init=ht.array(CENTERS + 0.5), max_iter=50).fit(ht.array(pts, split=0))
    state = {
        "cluster_centers": np.asarray(kj.cluster_centers_.numpy()),
        "n_iter": kj.n_iter_,
        "inertia": kj.inertia_,
    }
    kt = htt.cluster.KMeans.from_fitted(state)
    new = _blobs(30, CENTERS, seed=5)
    got = kt.predict(htt.interop.array_from_numpy(new, split=0)).numpy()
    want = np.asarray(kj.predict(ht.array(new, split=0)).numpy())
    np.testing.assert_array_equal(got, want)
    assert kt.n_iter_ == kj.n_iter_ and kt.inertia_ == pytest.approx(kj.inertia_)


def test_array_from_numpy_of_reference_global_array(port):
    data = np.random.default_rng(6).normal(size=(61, 3)).astype(np.float32)
    xj = ht.array(data, split=0)
    xt = htt.interop.array_from_numpy(np.asarray(xj.numpy()), split=0)
    assert xt.padshape == xj.padshape and xt.dtype is htt.float32
    np.testing.assert_array_equal(xt.numpy(), data)


@pytest.mark.parametrize("init", ["random", "probability_based", "kmeans++"])
@pytest.mark.parametrize("split", [None, 0, 1])
def test_kmeans_rng_inits_match_reference(port, init, split):
    """The string inits draw the reference's rows from the same seed (the
    initial centers bitwise), leave the generator in the reference's
    state, and the default-init fit lands on the reference's centers.
    k-means++ first asserts that no draw on this data lies within
    ``chip_smoke.KPP_GAP`` of the total from a step of the float64 d^2
    CDF, where two float32 cumsums could pick neighbouring rows."""
    pts = _blobs(40, CENTERS, seed=7)
    if init != "random":
        htt.random.seed(11)
        first = htt.random.randint(0, len(pts), (1,)).larray[0]
        us = htt.random.rand(3).larray.numpy()
        ht.random.seed(11)
        kj = ht.cluster.KMeans(n_clusters=3, init=init)
        kj._initialize_cluster_centers(ht.array(pts))
        picks = chip_smoke.rows_of(pts, np.asarray(kj.cluster_centers_.numpy()))
        near, gap = chip_smoke.kpp_check(pts.astype(np.float64), picks, us)
        assert picks[0] == int(first) and near == 0 and gap > chip_smoke.KPP_GAP
    kt = htt.cluster.KMeans(n_clusters=3, init=init, random_state=11)
    kj = ht.cluster.KMeans(n_clusters=3, init=init, random_state=11)
    kt._initialize_cluster_centers(htt.array(pts, split=split))
    kj._initialize_cluster_centers(ht.array(pts, split=split))
    np.testing.assert_array_equal(kt.cluster_centers_.numpy(), np.asarray(kj.cluster_centers_.numpy()))
    assert htt.random.get_state() == ht.random.get_state()
    kt.fit(htt.array(pts, split=split))
    kj.fit(ht.array(pts, split=split))
    np.testing.assert_allclose(
        kt.cluster_centers_.numpy(), np.asarray(kj.cluster_centers_.numpy()), rtol=1e-5, atol=1e-5
    )


def test_kmeans_rejects_bad_init_shape(port):
    x = htt.array(_blobs(8, CENTERS), split=0)
    with pytest.raises(ValueError, match="centroids"):
        htt.cluster.KMeans(n_clusters=2, init=htt.array(CENTERS)).fit(x)


def test_estimator_params(port):
    km = htt.cluster.KMeans(n_clusters=4, tol=0.5)
    assert km.get_params()["n_clusters"] == 4
    km.set_params(max_iter=9)
    assert km.max_iter == 9 and "KMeans(" in repr(km)
    with pytest.raises(ValueError):
        km.set_params(bogus=1)
