"""Estimator checkpoints cross between the port and the JAX package.

* KMeans, Lasso and GaussianNB (and Spectral's nested KMeans, KNN's
  DNDarray parameters) saved by the reference load in the port and
  predict the same labels or values, and the same estimators saved by
  the port load in the reference;
* the port writes the reference's manifest: class paths
  ``heat_tpu.<module>:<Class>``, the same entries; a Lasso built from the
  reference's theta writes the reference's manifest string exactly;
* ``list_checkpoints`` gives the same rows for a directory of both
  packages' files;
* the port refuses ``os:system``, ``heat_tpu_torch_evil:X`` and any
  other prefix, at load and at save, and imports no ``heat_tpu`` module
  on its load path (``tests/test_torch_isolation.py`` runs one in a
  fresh interpreter);
* the error contracts of ``save_estimator``/``load_estimator``/``load``.

Predictions are compared exactly; fitted values of the two packages'
own fits within the tolerances their parity files state.
"""

import json
import sys

import numpy as np
import pytest

import jax

import heat_tpu as ht
from test_torch_reference_state import reference_state  # noqa: F401,E402  (restores the JAX package's state)

import heat_tpu_torch as htt
from heat_tpu_torch.core import checkpoint
from heat_tpu_torch.core import communication as tcomm

RNG = np.random.default_rng(21)
CENTERS = np.array([[6, 0, 0], [-6, 0, 0], [0, 6, 0]], np.float32)
X = (CENTERS[RNG.integers(0, 3, 64)] + RNG.normal(size=(64, 3))).astype(np.float32)
LABELS = np.argmin(((X[:, None] - CENTERS[None]) ** 2).sum(-1), axis=1).astype(np.int32)
Y = (X @ np.array([1.0, -2.0, 0.5], np.float32) + 0.25).astype(np.float32)


@pytest.fixture(autouse=True)
def port():
    comm = htt.TorchCommunication(["cpu"] * len(jax.devices()))
    prev = tcomm._default_comm
    htt.use_comm(comm)
    yield comm
    htt.use_comm(prev)


def _manifest(path):
    import h5py

    with h5py.File(path, "r") as f:
        return json.loads(f.attrs["heat_tpu_estimator"])


def _fits(pkg):
    Xd = pkg.array(X, split=0)
    return {
        "kmeans": pkg.cluster.KMeans(n_clusters=3, init=pkg.array(CENTERS + 0.3), max_iter=10).fit(Xd),
        "lasso": pkg.regression.Lasso(lam=0.01, max_iter=30).fit(Xd, pkg.array(Y, split=0)),
        "nb": pkg.naive_bayes.GaussianNB().fit(Xd, pkg.array(LABELS, split=0)),
    }


def _predict(pkg, est):
    out = est.predict(pkg.array(X, split=0))
    return out.numpy() if pkg is htt else np.asarray(out.larray)


def _same_predictions(a, b):
    """Labels exactly; Lasso's values within rtol 1e-5, atol 1e-5 (each
    package's own product, as ``tests/test_torch_lasso.py`` holds them)."""
    if a.dtype.kind == "f":
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["kmeans", "lasso", "nb"])
def test_reference_files_load_in_the_port_and_back(tmp_path, name):
    ref = _fits(ht)[name]
    rpath = str(tmp_path / "ref.h5")
    ref.save(rpath)
    mine = htt.load_estimator(rpath)
    assert type(mine).__module__.startswith("heat_tpu_torch.") and type(mine).__name__ == type(ref).__name__
    assert mine.get_params().keys() == ref.get_params().keys()
    _same_predictions(_predict(htt, mine), _predict(ht, ref))
    ppath = str(tmp_path / "port.h5")
    htt.save(mine, ppath)
    back = ht.load_estimator(ppath)
    np.testing.assert_array_equal(_predict(ht, back), _predict(ht, ref))
    m_port, m_ref = _manifest(ppath), _manifest(rpath)
    assert m_port["root"]["class"] == m_ref["root"]["class"]
    assert m_port["root"]["params"] == m_ref["root"]["params"]
    assert m_port["root"]["fitted"].keys() == m_ref["root"]["fitted"].keys()


@pytest.mark.parametrize("name", ["kmeans", "lasso", "nb"])
def test_port_files_load_in_the_reference(tmp_path, name):
    mine, ref = _fits(htt)[name], _fits(ht)[name]
    path = str(tmp_path / "port.h5")
    mine.save(path)
    back = ht.load_estimator(path)
    assert type(back) is type(ref)
    _same_predictions(_predict(ht, back), _predict(htt, mine))
    if name == "kmeans":
        np.testing.assert_allclose(np.asarray(back.cluster_centers_.larray), np.asarray(ref.cluster_centers_.larray),
                                   rtol=1e-5, atol=1e-5)
        assert back.n_iter_ == ref.n_iter_ and back.labels_.split == 0
    if name == "lasso":
        np.testing.assert_allclose(np.asarray(back.theta.larray), np.asarray(ref.theta.larray), rtol=1e-4, atol=1e-5)


def test_lasso_manifest_is_the_reference_string(tmp_path):
    ref = _fits(ht)["lasso"]
    mine = htt.regression.Lasso.from_fitted(np.asarray(ref.theta.larray), n_iter=ref.n_iter, lam=0.01, max_iter=30)
    ref.save(str(tmp_path / "ref.h5"))
    mine.save(str(tmp_path / "port.h5"))
    assert _manifest(str(tmp_path / "port.h5")) == _manifest(str(tmp_path / "ref.h5"))
    theta = htt.load_estimator(str(tmp_path / "ref.h5")).theta
    np.testing.assert_array_equal(theta.numpy(), np.asarray(ref.theta.larray))


def test_nested_and_dndarray_params_cross(tmp_path):
    sp = ht.cluster.Spectral(n_clusters=2, n_lanczos=20).fit(ht.array(X[:40], split=0))
    sp.save(str(tmp_path / "sp.h5"))
    mine = htt.load_estimator(str(tmp_path / "sp.h5"))
    assert isinstance(mine._kmeans, htt.cluster.KMeans)
    assert mine._labels is mine._kmeans._labels  # written once, re-linked
    np.testing.assert_array_equal(mine.labels_.numpy(), np.asarray(sp.labels_.larray))
    knn = ht.classification.KNN(ht.array(X, split=0), ht.array(LABELS), 3)
    knn.save(str(tmp_path / "knn.h5"))
    mine = htt.load_estimator(str(tmp_path / "knn.h5"))
    np.testing.assert_array_equal(_predict(htt, mine), _predict(ht, knn))


def test_list_checkpoints_equal_over_both_packages_files(tmp_path):
    _fits(ht)["kmeans"].save(str(tmp_path / "a.h5"))
    _fits(htt)["lasso"].save(str(tmp_path / "b.hdf5"))
    htt.save(htt.array(X), str(tmp_path / "data.h5"), "x")
    (tmp_path / "notes.txt").write_text("x")
    mine, ref = htt.list_checkpoints(str(tmp_path)), ht.list_checkpoints(str(tmp_path))
    assert mine == ref
    assert [r["class"] for r in mine] == ["heat_tpu.cluster.kmeans:KMeans", "heat_tpu.regression.lasso:Lasso"]
    (tmp_path / "bad.h5").write_bytes(b"not hdf5")
    for pkg in (htt, ht):
        with pytest.raises(ValueError, match="bad.h5"):
            pkg.list_checkpoints(str(tmp_path))


@pytest.mark.parametrize("path", ["os:system", "heat_tpu_torch_evil:X", "heat_tpu_evil.x:Cls",
                                  "heat_tpu_torch.cluster.kmeans:KMeans", "numpy:ndarray"])
def test_foreign_class_paths_are_refused(tmp_path, path):
    with pytest.raises(ValueError, match="refusing to import"):
        checkpoint._resolve_class(path)
    import h5py

    km = _fits(htt)["kmeans"]
    p = str(tmp_path / "km.h5")
    km.save(p)
    with h5py.File(p, "a") as f:
        manifest = json.loads(f.attrs["heat_tpu_estimator"])
        manifest["root"]["class"] = path
        f.attrs["heat_tpu_estimator"] = json.dumps(manifest)
    before = set(sys.modules)
    with pytest.raises(ValueError, match="refusing to import"):
        htt.load_estimator(p)
    assert set(sys.modules) == before


def test_save_refuses_classes_outside_the_port(tmp_path):
    class Mine(htt.BaseEstimator):
        pass

    Mine.__module__ = "user_code"
    with pytest.raises(TypeError, match="only heat_tpu_torch estimator classes"):
        htt.save_estimator(Mine(), str(tmp_path / "m.h5"))


def test_error_contracts(tmp_path):
    km = _fits(htt)["kmeans"]
    with pytest.raises(TypeError):
        htt.save_estimator("not an estimator", str(tmp_path / "x.h5"))
    with pytest.raises(TypeError):
        htt.save_estimator(km, 123)
    with pytest.raises(ValueError, match="are HDF5"):
        km.save(str(tmp_path / "x.nc"))
    with pytest.raises(TypeError, match="no dataset/option arguments"):
        htt.save(km, str(tmp_path / "x.h5"), "data")
    data_file = str(tmp_path / "plain.h5")
    htt.save(htt.array(X), data_file, "data")
    with pytest.raises(ValueError, match="not an estimator checkpoint"):
        htt.load_estimator(data_file)
    km.save(str(tmp_path / "km.h5"))
    with pytest.raises(TypeError, match="holds a KMeans, not a Lasso"):
        htt.regression.Lasso.load(str(tmp_path / "km.h5"))
    assert isinstance(htt.BaseEstimator.load(str(tmp_path / "km.h5")), htt.cluster.KMeans)
    with pytest.raises(ValueError, match="not a readable estimator checkpoint"):
        htt.load_estimator(str(tmp_path / "nope.h5"))
    unfit = htt.cluster.KMeans(n_clusters=4, tol=0.5, checkpoint_every=3, checkpoint_path="s.h5", mini_batch=9)
    unfit.save(str(tmp_path / "unfit.h5"))
    back = htt.load_estimator(str(tmp_path / "unfit.h5"))
    assert back.get_params() == unfit.get_params() and back.cluster_centers_ is None
    assert ht.load_estimator(str(tmp_path / "unfit.h5")).get_params() == unfit.get_params()


def test_large_host_arrays_spill_and_cross(tmp_path):
    nb = _fits(htt)["nb"]
    big = np.arange(20_000, dtype=np.float64).reshape(100, 200)
    nb.theta_ = big
    nb.sigma_ = big  # aliased: spilled once
    p = str(tmp_path / "nb.h5")
    nb.save(p)
    fitted = _manifest(p)["root"]["fitted"]
    assert fitted["theta_"]["kind"] == "nparray_dataset" and fitted["theta_"]["key"] == fitted["sigma_"]["key"]
    for pkg in (htt, ht):
        back = pkg.load_estimator(p)
        np.testing.assert_array_equal(back.theta_, big)
        assert back.theta_.dtype == np.float64
