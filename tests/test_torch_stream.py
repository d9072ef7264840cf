"""The port's out-of-core stream and mini-batch fits held against the JAX
package's.

* ``stream_chunks``' chunks and valid counts bitwise the reference's at
  ``n`` in {103, 96, 17} rows and ``p`` in {8, 4, 2, 1} positions (the
  pad rows zero), over two epochs, with several sources;
* prefetch on bitwise prefetch off, the slab peaks 2 and 1, the policy's
  modes, and an abandoned stream giving its slabs back;
* the file sources (HDF5, NetCDF-3) reading the reference's files, their
  errors; a seeded ``io_error`` on the ``stream.read`` seam healed under
  the retry policy with the reference's incidents, the fit bitwise the
  unfaulted one;
* ``stream_model`` equal to the reference's at the same rates;
* mini-batch KMeans and Lasso: the port's twins bitwise (streamed from
  HDF5 and NetCDF-3 against in memory, prefetch on against off, every
  number of positions against every other), and the reference's fits
  within tolerance: centers within ``1e-5`` of their largest value and
  the same step counts on separated blobs from the blobs' centers (the
  same float32 updates, the products summed in another order by torch's
  and XLA's CPU GEMMs), Lasso's theta within ``rtol 1e-4, atol 1e-5``
  (as ``tests/test_torch_lasso.py`` holds the in-memory ISTA).
"""

import itertools
import time

import numpy as np
import pytest

import jax

import heat_tpu as ht
from heat_tpu.comm import _costs as rcosts
from heat_tpu.core.communication import XlaCommunication
from heat_tpu.io import stream as rstream
from heat_tpu.resilience import faults as rfaults
from heat_tpu.resilience import incidents as rincidents
from heat_tpu.resilience import retry as rretry
from test_torch_reference_state import reference_state  # noqa: F401,E402  (restores the JAX package's state)

import heat_tpu_torch as htt
from heat_tpu_torch.comm import _costs
from heat_tpu_torch.core import communication as tcomm
from heat_tpu_torch.io import stream
from heat_tpu_torch.resilience import faults, incidents, retry

RNG = np.random.default_rng(11)
N, F, K, MB = 103, 6, 4, 16
H = -(-N // MB)
BLOB_CENTERS = np.array([[8, 0, 0, 0, 0, 0], [-8, 0, 0, 0, 0, 0], [0, 8, 0, 0, 0, 0], [0, -8, 0, 0, 0, 0]],
                        np.float32)
DATA = (BLOB_CENTERS[RNG.integers(0, K, N)] + RNG.normal(size=(N, F))).astype(np.float32)
YW = np.array([1.5, 0.0, -2.0, 0.0, 0.5, 1.0], np.float32)
YV = (DATA @ YW + 0.3 + 0.01 * RNG.normal(size=N)).astype(np.float32)


@pytest.fixture(autouse=True)
def _clean():
    def scrub():
        for f, i, r, s in ((faults, incidents, retry, stream), (rfaults, rincidents, rretry, rstream)):
            f.clear()
            i.clear_incident_log()
            r.set_sleep(None)
            s.set_prefetch("auto")
            s.reset_slab_peak()

    scrub()
    prev = tcomm._default_comm
    htt.use_comm(htt.TorchCommunication(["cpu"] * len(jax.devices())))
    yield
    htt.use_comm(prev)
    scrub()


def _comms(p):
    if len(jax.devices()) < p:
        pytest.skip(f"needs {p} devices")
    return XlaCommunication(jax.devices()[:p]), htt.TorchCommunication(["cpu"] * p)


def _bits(a):
    a = a.numpy() if hasattr(a, "numpy") and not isinstance(a, np.ndarray) else np.asarray(a)
    return np.ascontiguousarray(a).view(np.uint8).tobytes()


@pytest.fixture
def files(tmp_path):
    """The data as the reference writes it: HDF5 and NetCDF-3."""
    h5, nc = str(tmp_path / "train.h5"), str(tmp_path / "train.nc")
    ht.save_hdf5(ht.array(DATA), h5, "features")
    ht.save_hdf5(ht.array(YV.reshape(-1, 1)), h5, "target", mode="a")
    ht.save_netcdf(ht.array(DATA), nc, "features")
    ht.save_netcdf(ht.array(YV), nc, "target", mode="a", dimension_names=["dim_0"])
    return h5, nc


# --------------------------------------------------------------------- #
# the chunk pipeline                                                      #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("n", [N, 96, 17])
@pytest.mark.parametrize("p", [8, 4, 2, 1])
def test_chunks_and_valid_counts_bitwise_the_reference(n, p):
    rc, tc = _comms(p)
    srcs = lambda mod: (mod.ArraySource(DATA[:n]), mod.ArraySource(YV[:n]))  # noqa: E731
    h = -(-n // MB)
    mine = list(stream.stream_chunks(srcs(stream), MB, 1, 2 * h + 1, comm=tc))
    ref = list(rstream.stream_chunks(srcs(rstream), MB, 1, 2 * h + 1, comm=rc))
    assert len(mine) == len(ref) == 2 * h
    for (ma, mnv), (ra, rnv) in zip(mine, ref):
        assert mnv == rnv
        for m, r in zip(ma, ra):
            assert tuple(m.shape) == r.shape == (-(-MB // p) * p,) + r.shape[1:]
            assert _bits(m) == _bits(r)
            assert not m[mnv:].any()


def test_prefetch_on_bitwise_off_and_slab_peaks():
    src = stream.ArraySource(DATA)
    runs = {}
    for mode in ("off", "on"):
        with stream.prefetch(mode):
            stream.reset_slab_peak()
            runs[mode] = [(_bits(a[0]), nv) for a, nv in stream.stream_chunks(src, MB, 0, 2 * H)]
            runs[mode + "_peak"] = stream.slab_peak()
    assert runs["on"] == runs["off"]
    assert (runs["off_peak"], runs["on_peak"]) == (1, 2)
    assert _costs.stream_model(MB * F * 4, H, prefetch=False)["peak_host_slabs"] == 1


def test_prefetch_policy_modes():
    assert stream.get_prefetch() == "auto"
    assert not stream.prefetch_enabled("cpu") and stream.prefetch_enabled("cuda")
    with stream.prefetch("on"):
        assert stream.prefetch_enabled("cpu")
    with stream.prefetch("off"):
        assert not stream.prefetch_enabled("cuda")
    assert stream.get_prefetch() == "auto"
    with pytest.raises(ValueError, match="unknown prefetch mode"):
        stream.set_prefetch("sometimes")


def test_prefetch_reads_the_next_chunk_while_one_is_consumed():
    overlapped, consuming = [], [False]

    class Probe(stream.StreamSource):
        shape = (N, F)
        np_dtype = np.dtype(np.float32)

        def read(self, lo, hi):
            overlapped.append(consuming[0])
            return DATA[lo:hi]

    with stream.prefetch("on"):
        for _ in stream.stream_chunks(Probe(), MB, 0, H):
            consuming[0] = True
            time.sleep(0.02)
            consuming[0] = False
    assert any(overlapped)


def test_abandoned_stream_gives_its_slabs_back():
    with stream.prefetch("on"):
        gen = stream.stream_chunks(stream.ArraySource(DATA), MB, 0, H)
        next(gen)
        assert stream._SLABS.live == 2
        gen.close()
    assert stream._SLABS.live == 0


def test_stream_errors_equal():
    for mod in (stream, rstream):
        src = mod.ArraySource(DATA)
        with pytest.raises(ValueError, match="mini_batch must be >= 1"):
            list(mod.stream_chunks(src, 0, 0, 1))
        with pytest.raises(ValueError, match="disagree on length: 103 vs 50"):
            list(mod.stream_chunks((src, mod.ArraySource(DATA[:50])), MB, 0, 1))
        with pytest.raises(ValueError, match="at least one source"):
            list(mod.stream_chunks((), MB, 0, 1))


def test_file_sources_read_the_reference_files(files, tmp_path):
    h5, nc = files
    for mine, ref in ((stream.HDF5Source(h5, "features"), rstream.HDF5Source(h5, "features")),
                      (stream.NetCDFSource(nc, "features"), rstream.NetCDFSource(nc, "features"))):
        assert mine.shape == ref.shape == (N, F) and len(mine) == N
        assert _bits(mine.read(5, 40)) == _bits(ref.read(5, 40))
    for cls, rcls, path in ((stream.HDF5Source, rstream.HDF5Source, h5),
                            (stream.NetCDFSource, rstream.NetCDFSource, nc)):
        msgs = []
        for c in (cls, rcls):
            with pytest.raises(ValueError) as e:
                c(path, "absent")
            msgs.append(str(e.value))
            with pytest.raises(TypeError):
                c(3, "x")
        assert msgs[0] == msgs[1]


def test_stream_model_equals_the_reference_at_the_same_rates():
    for prefetch, compute in itertools.product((True, False), (0.0, 0.5, 40.0)):
        kw = dict(read_gbps=1.7, h2d_gbps=31.0, prefetch=prefetch)
        assert _costs.stream_model(3_200_000, 8, compute, **kw) == rcosts.stream_model(3_200_000, 8, compute, **kw)
    assert htt.comm.stream_model is _costs.stream_model


def test_read_seam_fault_heals_with_the_reference_incidents(files):
    h5, _ = files
    clean = _km().fit(stream.HDF5Source(h5, "features"))
    logs = []
    for mod, est, f, r, i in ((stream, _km(), faults, retry, incidents),
                              (rstream, _rkm(), rfaults, rretry, rincidents)):
        r.set_sleep(lambda s: None)
        with f.inject("io_error", site="stream.read", nth=3, max_faults=1, seed=2):
            out = est.fit(mod.HDF5Source(h5, "features"))
        logs.append([(e.kind, e.site, e.action) for e in i.incident_log()])
        if mod is stream:
            assert _bits(out.cluster_centers_.larray) == _bits(clean.cluster_centers_.larray)
    assert logs[0] == logs[1] and logs[0]


# --------------------------------------------------------------------- #
# mini-batch fits                                                         #
# --------------------------------------------------------------------- #
def _km(**kw):
    kw.setdefault("init", htt.array(BLOB_CENTERS + 0.5))
    return htt.cluster.KMeans(n_clusters=K, mini_batch=MB, max_iter=3, **kw)


def _rkm(**kw):
    kw.setdefault("init", ht.array(BLOB_CENTERS + 0.5))
    return ht.cluster.KMeans(n_clusters=K, mini_batch=MB, max_iter=3, **kw)


def _ls(mod, **kw):
    return mod.regression.Lasso(lam=0.05, solver="gd", mini_batch=MB, max_iter=3, **kw)


def test_minibatch_kmeans_twins_bitwise_and_the_reference_within_tolerance(files):
    h5, nc = files
    fits = [_km().fit(stream.HDF5Source(h5, "features")), _km().fit(stream.NetCDFSource(nc, "features")),
            _km().fit(htt.array(DATA, split=0))]
    with stream.prefetch("on"):
        fits.append(_km().fit(stream.HDF5Source(h5, "features")))
    for p in (1, 2, 4):
        fits.append(_km().fit(stream.ArraySource(DATA), comm=_comms(p)[1]))
    want = _bits(fits[0].cluster_centers_.larray)
    assert all(_bits(f.cluster_centers_.larray) == want for f in fits)
    assert fits[0].n_iter_ == 3 * H and fits[0].labels_ is None and fits[0].inertia_ is None
    ref = _rkm().fit(rstream.HDF5Source(h5, "features"))
    got, exp = fits[0].cluster_centers_.numpy(), np.asarray(ref.cluster_centers_.larray)
    assert np.abs(got - exp).max() <= 1e-5 * np.abs(exp).max()
    assert ref.n_iter_ == fits[0].n_iter_
    np.testing.assert_array_equal(fits[0].predict(htt.array(DATA, split=0)).numpy(),
                                  np.asarray(ref.predict(ht.array(DATA, split=0)).larray))


def test_minibatch_kmeans_random_init_draws_the_reference_rows():
    mine = htt.cluster.KMeans(n_clusters=K, mini_batch=MB, max_iter=1, random_state=7)
    ref = ht.cluster.KMeans(n_clusters=K, mini_batch=MB, max_iter=1, random_state=7)
    np.testing.assert_array_equal(mine._init_minibatch_centers(stream.ArraySource(DATA), N, F, K, MB),
                                  ref._init_minibatch_centers(rstream.ArraySource(DATA), N, F, K, MB))


def test_minibatch_lasso_twins_bitwise_and_the_reference_within_tolerance(files):
    h5, nc = files
    fits = [_ls(htt).fit(stream.HDF5Source(h5, "features"), stream.HDF5Source(h5, "target")),
            _ls(htt).fit(stream.NetCDFSource(nc, "features"), stream.NetCDFSource(nc, "target")),
            _ls(htt).fit(htt.array(DATA, split=0), htt.array(YV, split=0))]
    with stream.prefetch("on"):
        fits.append(_ls(htt).fit(stream.HDF5Source(h5, "features"), stream.HDF5Source(h5, "target")))
    for p in (1, 2, 4):
        fits.append(_ls(htt).fit(stream.ArraySource(DATA), stream.ArraySource(YV), comm=_comms(p)[1]))
    want = _bits(fits[0].theta.larray)
    assert all(_bits(f.theta.larray) == want for f in fits)
    ref = _ls(ht).fit(rstream.HDF5Source(h5, "features"), rstream.HDF5Source(h5, "target"))
    np.testing.assert_allclose(fits[0].theta.numpy(), np.asarray(ref.theta.larray), rtol=1e-4, atol=1e-5)
    assert fits[0].n_iter == ref.n_iter == 3 * H


@pytest.mark.parametrize("n", [96, 17])
def test_ragged_tails_bitwise_across_positions(n):
    base = None
    for p in (8, 4, 2, 1):
        tc = _comms(p)[1]
        c = _km(init=htt.array(BLOB_CENTERS + 0.5, comm=tc)).fit(stream.ArraySource(DATA[:n]), comm=tc)
        t = _ls(htt).fit(stream.ArraySource(DATA[:n]), stream.ArraySource(YV[:n]), comm=tc)
        got = (_bits(c.cluster_centers_.larray), _bits(t.theta.larray))
        base = got if base is None else base
        assert got == base


def test_minibatch_errors_equal():
    for pkg, mod in ((htt, stream), (ht, rstream)):
        with pytest.raises(ValueError, match="mini_batch must be >= 1"):
            pkg.cluster.KMeans(n_clusters=2, mini_batch=0)
        with pytest.raises(ValueError, match="requires solver='gd'"):
            pkg.regression.Lasso(mini_batch=8)
        with pytest.raises(ValueError, match="requires KMeans"):
            pkg.cluster.KMeans(n_clusters=2).fit(mod.ArraySource(DATA))
        with pytest.raises(ValueError, match="support init='random'"):
            pkg.cluster.KMeans(n_clusters=2, mini_batch=8, init="probability_based").fit(mod.ArraySource(DATA))
        with pytest.raises(ValueError, match="first chunk's 8 rows"):
            pkg.cluster.KMeans(n_clusters=9, mini_batch=8).fit(mod.ArraySource(DATA))
