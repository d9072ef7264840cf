"""Loop snapshots and strict resume of every resumable loop, held against
the JAX package.

For each loop the reference makes resumable (KMeans exact, ``int8_block``
and mini-batch; Lasso cd, gd, ``int8_block`` gd and mini-batch gd;
``lanczos``), at 8 positions:

* the port killed by a seeded preemption after its second snapshot and
  resumed with ``resume=True`` is bitwise its uninterrupted fit, with the
  same step count;
* the two packages' snapshots of the same loop, killed at the same
  point, carry the same manifest (algo tag, meta, ``mesh``, ``splits``,
  ``it``) and entries of the same dtypes and shapes; each package resumes
  the other's snapshot, and the result is within the loop's cross-package
  tolerance of the resuming package's uninterrupted fit: exact KMeans and
  the mini-batch fits 1e-5 of the largest center, Lasso ``rtol 1e-4,
  atol 1e-5`` (``tests/test_torch_lasso.py``'s), ``lanczos``' T 1e-4 of
  its largest entry; the quantized loops, whose error-feedback residual
  the other package's products round differently, resume the other's
  residual bitwise and land within the reference's own 1e-3 loss gate
  (Lasso) or 1e-2 of the largest center (KMeans, two separated blobs);
* ``save_loop_state`` writes byte-identical files in both packages, and
  the readers' and the checkpointer's error texts (a strict resume at
  another mesh size included) are the reference's;
* a seeded ``preempt`` / ``device_loss`` plan at ``rate`` fires at the
  same loop iteration in both packages for the same chaos seed.
"""

import shutil

import numpy as np
import pytest

import jax

import heat_tpu as ht
from heat_tpu.core.communication import XlaCommunication
from heat_tpu.core.linalg import solver as rsolver
from heat_tpu.resilience import elastic as relastic
from heat_tpu.resilience import faults as rfaults
from heat_tpu.resilience import incidents as rincidents
from heat_tpu.resilience import resume as rresume
from test_torch_reference_state import reference_state  # noqa: F401,E402  (restores the JAX package's state)

import heat_tpu_torch as htt
from heat_tpu_torch.core.linalg import solver
from heat_tpu_torch.resilience import elastic, faults, incidents, resume

RNG = np.random.default_rng(31)
XK = np.concatenate([RNG.normal(size=(32, 4)) + 4, RNG.normal(size=(32, 4)) - 4]).astype(np.float32)
C0 = np.array([[3, 3, 3, 3], [-3, -3, -3, -3]], np.float32)
XL = RNG.normal(size=(64, 6)).astype(np.float32)
YL = (XL @ np.array([1.5, 0, -2, 0, 0.7, 0], np.float32) + 0.01 * RNG.normal(size=64)).astype(np.float32)
M = RNG.normal(size=(24, 24)).astype(np.float32)
M = M @ M.T

LOOPS = ["kmeans", "kmeans-q", "kmeans-mb", "lasso-cd", "lasso-gd", "lasso-gd-q", "lasso-mb", "lanczos"]
#: snapshot every so many steps: each loop is killed after its second
EVERY = {"kmeans": 3, "kmeans-q": 3, "kmeans-mb": 2, "lasso-cd": 4, "lasso-gd": 5, "lasso-gd-q": 5,
         "lasso-mb": 2, "lanczos": 3}


@pytest.fixture(autouse=True)
def _clean():
    def scrub():
        for f, i, e in ((faults, incidents, elastic), (rfaults, rincidents, relastic)):
            f.clear()
            i.clear_incident_log()
            e.set_watchdog(None)

    scrub()
    yield
    scrub()


def _comm(pkg, p):
    if len(jax.devices()) < p:
        pytest.skip(f"needs {p} devices")
    return htt.TorchCommunication(["cpu"] * p) if pkg is htt else XlaCommunication(jax.devices()[:p])


def _host(a):
    return a.numpy() if isinstance(a, htt.DNDarray) else np.asarray(a.larray)


def run(pkg, loop, p=8, resume=False, **ckpt):
    """One fit of ``loop`` by ``pkg`` at ``p`` positions: ``(result, steps)``."""
    comm = _comm(pkg, p)
    arr = lambda a, split=0: pkg.array(a, split=split, comm=comm)  # noqa: E731
    if loop == "lanczos":
        (htt.random if pkg is htt else ht.random).seed(99)
        fn = solver.lanczos if pkg is htt else rsolver.lanczos
        _, T = fn(arr(M), 10, resume=resume, **ckpt)
        return _host(T), 10
    if loop.startswith("kmeans"):
        kw = dict(mini_batch=16, max_iter=3) if loop == "kmeans-mb" else dict(max_iter=12, tol=-1.0)
        est = pkg.cluster.KMeans(n_clusters=2, init=arr(C0, None), **kw, **ckpt)
        with pkg.comm.collective_precision("int8_block" if loop == "kmeans-q" else "f32"):
            est.fit(arr(XK), resume=resume)
        return _host(est.cluster_centers_), est.n_iter_
    solver_ = "cd" if loop == "lasso-cd" else "gd"
    kw = dict(mini_batch=16, max_iter=3) if loop == "lasso-mb" else dict(max_iter=20, tol=-1.0)
    est = pkg.regression.Lasso(lam=0.01, solver=solver_, **kw, **ckpt)
    with pkg.comm.collective_precision("int8_block" if loop == "lasso-gd-q" else "f32"):
        est.fit(arr(XL), arr(YL), resume=resume)
    return _host(est.theta), est.n_iter


def kill(pkg, loop, path, kind="preempt", nth=2, p=8):
    f = faults if pkg is htt else rfaults
    err = (faults.Preempted, rfaults.Preempted) if kind == "preempt" else (faults.DeviceLossError,
                                                                            rfaults.DeviceLossError)
    with pytest.raises(err):
        with f.inject(kind, site="iteration", nth=nth):
            run(pkg, loop, p=p, checkpoint_every=EVERY[loop], checkpoint_path=path)


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8).tobytes()


@pytest.mark.parametrize("loop", LOOPS)
def test_strict_resume_is_bitwise_the_uninterrupted_fit(tmp_path, loop):
    clean, steps = run(htt, loop)
    path = str(tmp_path / "snap.h5")
    kill(htt, loop, path)
    state, meta = resume.load_loop_state(path)
    # lanczos' loop starts at step 1 (its first column comes before it)
    assert meta["it"] == (loop == "lanczos") + 2 * EVERY[loop] and meta["algo"] == loop and meta["mesh"] == 8
    got, got_steps = run(htt, loop, resume=True, checkpoint_every=EVERY[loop], checkpoint_path=path)
    assert _bits(got) == _bits(clean) and got_steps == steps


def _close(loop, got, want):
    if loop in ("kmeans", "kmeans-mb", "lanczos"):
        tol = 1e-4 if loop == "lanczos" else 1e-5
        assert np.abs(got - want).max() <= tol * np.abs(want).max()
    elif loop == "kmeans-q":
        assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()
    elif loop == "lasso-gd-q":
        a = np.concatenate([np.ones((64, 1)), XL], axis=1)

        def loss(th):
            th = th.reshape(-1).astype(np.float64)
            return 0.5 * np.mean((a @ th - YL) ** 2) + 0.01 * np.abs(th[1:]).sum()

        assert abs(loss(got) - loss(want)) <= 1e-3 * loss(want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("loop", LOOPS)
def test_snapshots_cross_between_packages(tmp_path, loop):
    mine, ref = str(tmp_path / "mine.h5"), str(tmp_path / "ref.h5")
    kill(htt, loop, mine)
    kill(ht, loop, ref)
    (s_mine, m_mine), (s_ref, m_ref) = resume.load_loop_state(mine), rresume.load_loop_state(ref)
    assert m_mine == m_ref
    assert {k: (v.dtype, v.shape) for k, v in s_mine.items()} == {k: (v.dtype, v.shape) for k, v in s_ref.items()}
    assert resume.load_loop_state(ref)[1] == m_ref and rresume.load_loop_state(mine)[1] == m_mine
    for k, v in resume.load_loop_state(ref)[0].items():
        assert _bits(v) == _bits(s_ref[k])  # the residual too, bitwise
    every = EVERY[loop]
    got, steps = run(htt, loop, resume=True, checkpoint_every=every, checkpoint_path=ref)
    _close(loop, got, run(htt, loop)[0])
    back, rsteps = run(ht, loop, resume=True, checkpoint_every=every, checkpoint_path=mine)
    _close(loop, back, run(ht, loop)[0])
    assert steps == rsteps


def test_mesh_mismatch_on_strict_resume_names_both_meshes(tmp_path):
    msgs = []
    for pkg, mod in ((htt, resume), (ht, rresume)):
        path = str(tmp_path / f"{pkg.__name__}.h5")
        ck = mod.LoopCheckpointer(path, 2, "demo", {"n": 4}, comm=_comm(pkg, 2), splits={"x": None})
        ck.tick(2, {"it": np.int32(2), "x": np.zeros(4, np.float32)})
        with pytest.raises(mod.MeshMismatchError) as e:
            mod.LoopCheckpointer(path, 2, "demo", {"n": 4}, comm=_comm(pkg, 1), splits={"x": None}).load()
        assert (e.value.snapshot_mesh, e.value.current_mesh) == (2, 1)
        msgs.append(str(e.value).replace(path, "P"))
    assert msgs[0] == msgs[1]
    with pytest.raises(resume.MeshMismatchError, match='resume="elastic"'):
        kill(htt, "lasso-gd", str(tmp_path / "l.h5"), p=2)
        run(htt, "lasso-gd", p=1, resume=True, checkpoint_every=5, checkpoint_path=str(tmp_path / "l.h5"))


def test_snapshot_files_are_byte_identical(tmp_path):
    state = {"it": np.int32(7), "theta": RNG.normal(size=5).astype(np.float32), "delta": np.float32(0.25),
             "error": RNG.normal(size=(8, 5)).astype(np.float32), "i": np.int64(3)}
    meta = {"n": 64, "lam": 0.01, "algo": "lasso-gd-q", "it": 7, "mesh": 8, "splits": {"error": "mesh"}}
    a, b = str(tmp_path / "a.h5"), str(tmp_path / "b.h5")
    resume.save_loop_state(a, state, meta)
    rresume.save_loop_state(b, state, meta)
    assert open(a, "rb").read() == open(b, "rb").read()
    got, got_meta = resume.load_loop_state(b)
    assert got_meta == meta and got.keys() == state.keys()
    for k in state:
        assert got[k].dtype == np.asarray(state[k]).dtype and _bits(got[k]) == _bits(np.asarray(state[k]))


def test_reader_and_checkpointer_errors_equal(tmp_path):
    import h5py

    junk = tmp_path / "junk.h5"
    junk.write_bytes(b"not hdf5")
    plain = str(tmp_path / "plain.h5")
    ht.save_hdf5(ht.array(np.ones(3, np.float32)), plain, "x")
    good = str(tmp_path / "good.h5")
    resume.save_loop_state(good, {"it": np.int32(1), "x": np.ones(2, np.float32)}, {"algo": "a", "n": 2})
    old = str(tmp_path / "old.h5")
    shutil.copyfile(good, old)
    with h5py.File(old, "a") as f:
        f.attrs["heat_tpu_loop_state"] = f.attrs["heat_tpu_loop_state"].replace('"format_version": 1',
                                                                              '"format_version": 9')
    gone = str(tmp_path / "gone.h5")
    shutil.copyfile(good, gone)
    with h5py.File(gone, "a") as f:
        del f["x"]
    for path in (str(junk), plain, old, gone, str(tmp_path / "nope.h5")):
        msgs = []
        for mod in (resume, rresume):
            with pytest.raises(ValueError) as e:
                mod.load_loop_state(path)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    for mod in (resume, rresume):
        with pytest.raises(ValueError, match="written by 'a', not 'b'"):
            mod.LoopCheckpointer(good, 1, "b", {}).load()
        with pytest.raises(ValueError, match=r"snapshot n=2 does not match the current fit \(n=3\)"):
            mod.LoopCheckpointer(good, 1, "a", {"n": 3}).load()
        with pytest.raises(ValueError, match="checkpoint_every must be >= 0"):
            mod.LoopCheckpointer(good, -1, "a", {})
        with pytest.raises(ValueError, match="requires checkpoint_path"):
            mod.LoopCheckpointer(None, 2, "a", {})
        with pytest.raises(ValueError, match="resume requires checkpoint_path"):
            mod.LoopCheckpointer(None, 0, "a", {}).load()
    assert resume.stream_position(13, 7) == rresume.stream_position(13, 7) == (1, 6)


@pytest.mark.parametrize("kind,loop", [("preempt", "lasso-cd"), ("device_loss", "kmeans")])
def test_seeded_plans_fire_at_the_reference_iteration(tmp_path, kind, loop, chaos_seed):
    its = []
    for pkg, f, mod in ((htt, faults, resume), (ht, rfaults, rresume)):
        path = str(tmp_path / f"{pkg.__name__}.h5")
        with pytest.raises((f.Preempted, f.DeviceLossError)):
            with f.inject(kind, site="iteration", rate=0.3, seed=chaos_seed + 5):
                run(pkg, loop, checkpoint_every=1, checkpoint_path=path)
        its.append(mod.load_loop_state(path)[1]["it"])
    assert its[0] == its[1]


@pytest.fixture
def chaos_seed():
    import os

    return int(os.environ.get("HEAT_CHAOS_SEED", "0"))


@pytest.mark.parametrize("loop", ["kmeans-q", "lasso-gd-q"])
def test_segmentation_calls_no_extra_kernel(tmp_path, loop, monkeypatch):
    """A killed and resumed ``int8_block`` fit calls each block-quant
    wrapper exactly as often as the uninterrupted fit (on the card each
    call is one launch): the snapshots add host copies and nothing
    else."""
    from heat_tpu_torch.comm import compressed as cq

    counts = {}
    for name in ("quantize_blocks", "dequantize_blocks", "dequantize_fma_blocks", "dequantize_add_quantize_blocks"):
        fn = getattr(cq, name)

        def counted(*a, _fn=fn, _name=name, **k):
            counts[_name] = counts.get(_name, 0) + 1
            return _fn(*a, **k)

        monkeypatch.setattr(cq, name, counted)
    run(htt, loop)
    plain, counts = dict(counts), {}
    path = str(tmp_path / "snap.h5")
    kill(htt, loop, path)
    run(htt, loop, resume=True, checkpoint_every=EVERY[loop], checkpoint_path=path)
    assert counts == plain and plain["dequantize_add_quantize_blocks"] > 0
