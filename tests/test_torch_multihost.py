"""The port across processes, against the reference's ``tests/test_multihost.py``.

Three clusters of two port processes each boot over gloo on the CPU
(``htt.init_multihost``, every process asking for the CPU explicitly):

* 2 x 4 positions run the reference's WORKER flow through ``htt``;
* 2 x 4 positions run its FAIL_WORKER flow (a writer failure raised on
  every process);
* 2 x 3 positions run the quantized collectives on a ragged 19-row array,
  ``allreduce_q``, ``moments_q`` and an ``int8_block`` KMeans fit, the
  tensor collectives, the slab store, and every refusal of this slice.

The parent computes the same flows with the JAX package on its CPU
devices (8 for the WORKER flow, 6 for the quantized one) and with the
port in one process, from the same numpy inputs.  Each child asserts at
exit that neither ``jax`` nor any ``heat_tpu`` module was imported.

The communicator's process identity (C14) is pinned in one process too,
against the reference's at 1, 4 and 8 positions.
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import heat_tpu as ht
from heat_tpu.comm import compressed as jcq
from heat_tpu.core import dndarray as jdnd
from heat_tpu.core.communication import XlaCommunication
from test_torch_reference_state import reference_state  # noqa: F401  (restores the JAX package's state)

import torch

import heat_tpu_torch as htt
from heat_tpu_torch.cluster import kmeans as tkm
from heat_tpu_torch.comm import compressed as tcq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the flows, run by the children with ``heat_tpu_torch`` and by the
#: parent with the JAX package (``ht`` either package, ``dnd`` its
#: dndarray module); each returns a dict of host values
FLOWS = r'''
import numpy as np


def worker(ht, dnd, path, comm):
    out = {}
    ht.random.seed(12)
    out["size"], out["rank"], out["local_position"] = comm.size, comm.rank, comm.local_position()
    X = ht.arange(24, dtype=ht.float32, split=0)
    out["X.sum"] = float(X.sum())
    out["X.lshape"], out["X.lshape_map"] = X.lshape, np.asarray(X.lshape_map)
    Y = X.reshape((4, 6)).resplit(1)
    out["Y.split"], out["Y.mean"], out["Y"] = Y.split, float(Y.mean()), Y.numpy()
    A = ht.random.randn(16, 8, split=0)
    B = ht.random.randn(8, 16, split=1)
    AB = A @ B
    out["A"], out["B"], out["AB.split"], out["AB"] = A.numpy(), B.numpy(), AB.split, AB.numpy()
    out["norm"] = float(ht.linalg.norm(AB))
    data = np.random.default_rng(0).normal(size=(64, 4)).astype(np.float32)
    km = ht.cluster.KMeans(n_clusters=3, random_state=0).fit(ht.array(data, split=0))
    out["km.n_iter"], out["km.centers"] = km.n_iter_, km.cluster_centers_.numpy()
    out["km.labels"], out["km.labels.split"] = km.labels_.numpy(), km.labels_.split
    ht.save_hdf5(X.reshape((4, 6)), path, "var")
    Z = ht.load_hdf5(path, "var", split=0)
    out["Z.sum"], out["Z.lshape_map"], out["Z"] = float(Z.sum()), np.asarray(Z.lshape_map), Z.numpy()
    R = ht.arange(19, dtype=ht.float32, split=0)
    out["R.padshape"], out["R.sum"] = R.padshape, float(R.sum())
    out["R2.sum"] = float((R * 2.0 + 1.0).sum())
    out["R.mean"] = float(R.mean())
    cs = R.cumsum(0)
    out["cs"], out["cs.max"] = cs.numpy(), float(cs.max())
    v, idx = ht.sort(-1.0 * R)
    out["v"], out["idx"], out["v.sum"], out["v.min"] = v.numpy(), idx.numpy(), float(v.sum()), float(v.min())
    keep = dnd._RING_INDEX_MIN
    dnd._RING_INDEX_MIN = 0
    try:
        perm = np.random.default_rng(1).permutation(19)
        taken = R[perm]
        out["taken"], out["taken.sum"] = taken.numpy(), float(taken.sum())
        back = ht.zeros_like(R)
        back[perm] = taken
        out["back"], out["back.err"] = back.numpy(), float(abs(back - R).sum())
    finally:
        dnd._RING_INDEX_MIN = keep
    ckpt = path + ".est.h5"
    km.save(ckpt)
    km2 = ht.load_estimator(ckpt)
    out["km2.type"], out["km2.labels.split"] = type(km2).__name__, km2.labels_.split
    out["km2.err"] = float(abs(km2.cluster_centers_ - km.cluster_centers_).sum())
    return out


def fail_worker(ht, dnd, path, comm):
    X = ht.arange(24, dtype=ht.float32, split=0)
    out = {"failed": False}
    try:
        ht.save_hdf5(X, path, "var")
    except Exception:
        out["failed"] = True
    out["X.sum"] = float(X.sum())
    return out


def quantized(ht, cq, comm, stack):
    """``stack(a)``: this process's rows of a per-position (6, ...) array."""
    rng = np.random.default_rng(7)
    r19 = (rng.normal(size=(19, 40)) * 3).astype(np.float32)
    pay = rng.normal(size=(6, 1000)).astype(np.float32)
    blobs = np.concatenate([rng.normal(loc=c, size=(32, 4)) for c in (-5, 0, 5)]).astype(np.float32)
    out = {}
    threshold = cq.get_collective_threshold()
    cq.set_collective_precision("int8_block")
    cq.set_collective_threshold(0)
    try:
        R = ht.array(r19, split=0, comm=comm)
        out["sum0"], out["mean0"] = R.sum(0).numpy(), R.mean(0).numpy()
        out["std0"], out["var0"] = R.std(0).numpy(), R.var(0).numpy()
        out["allreduce_q"] = np.asarray(cq.allreduce_q(stack(pay), comm=comm))
        out["moments_q"] = np.asarray(cq.moments_q(
            R._slab if hasattr(R, "_slab") else R._buffer, comm=comm, split=0, axes=(0,),
            keepdims=False, mode="int8_block", true_n=19, split_valid=19, finalize="std"))
        X = ht.array(blobs, split=0, comm=comm)
        init = ht.array(blobs[[0, 40, 80]], split=None, comm=comm)
        km = ht.cluster.KMeans(n_clusters=3, init=init, max_iter=10, tol=-1.0).fit(X)
        out["km.centers"], out["km.labels"], out["km.n_iter"] = (
            km.cluster_centers_.numpy(), km.labels_.numpy(), km.n_iter_)
    finally:
        cq.set_collective_precision("f32")
        cq.set_collective_threshold(threshold)
    out["blobs"], out["r19"], out["pay"] = blobs, r19, pay
    return out
'''

CHILD = r'''
import os, pickle, sys
pid, port, flow, nlocal, path, out_path = sys.argv[1:7]
pid, nlocal = int(pid), int(nlocal)
sys.path.insert(0, {repo!r})
import numpy as np
import torch
import heat_tpu_torch as htt
from heat_tpu_torch.core import dndarray as dnd
htt.use_device("cpu")
comm = htt.init_multihost(f"127.0.0.1:{{port}}", num_processes=2, process_id=pid,
                          local_device_ids=["cpu"] * nlocal)
ns = {{}}
exec({flows!r}, ns)
out = {{"backend": comm.backend, "transport": comm.transport}}
if flow == "worker":
    out.update(ns["worker"](htt, dnd, path, comm))
elif flow == "fail":
    out.update(ns["fail_worker"](htt, dnd, path, comm))
else:
    exec(open({quant!r}).read(), globals())
    out.update(run_quant(ns, comm))
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "heat_tpu" or m.startswith("heat_tpu."))
assert not bad, bad
with open(out_path, "wb") as fh:
    pickle.dump(out, fh)
print(f"proc {{pid}} OK", flush=True)
'''

#: the quantized cluster's own checks: tensor collectives, the slab
#: store, and the refusals, beside the flow
QUANT = r'''
import torch
from heat_tpu_torch.comm import compressed as cq


def run_quant(ns, comm):
    first, pl = comm.local_position(), comm.local_size
    stack = lambda a: torch.from_numpy(np.ascontiguousarray(a[first:first + pl]))  # noqa: E731
    out = ns["quantized"](htt, cq, comm, stack)
    g = np.arange(19 * 5, dtype=np.float32).reshape(19, 5)
    X = htt.array(g, split=0)
    out["slab"] = X._slab.numpy()
    out["lloc"] = X.lloc[:].numpy()
    for name, fn in (("larray", lambda: X.larray), ("_buffer", lambda: X._buffer)):
        try:
            fn()
            out[f"raises.{name}"] = "no raise"
        except NotImplementedError as e:
            out[f"raises.{name}"] = str(e)
    out["str"] = str(X)
    slab = X._slab
    out["c.allgather"] = comm.allgather(slab, axis=0).numpy()
    out["c.gather"] = comm.gather(slab, root=2, axis=0).numpy()
    out["c.ring_permute"] = comm.ring_permute(slab, 1).numpy()
    out["c.permute"] = comm.permute(slab, [(0, 4), (4, 1), (2, 2)]).numpy()
    out["c.bcast"] = comm.bcast(slab, root=4, split=0, n=19).numpy()
    out["c.scatter"] = comm.scatter(torch.from_numpy(g), axis=0).numpy()
    stacked = torch.from_numpy(np.arange(6 * 3, dtype=np.float32).reshape(6, 3) ** 1.5)[first:first + pl]
    for op in ("sum", "prod", "max", "min"):
        out[f"c.allreduce.{op}"] = comm.allreduce(stacked, op).numpy()
        out[f"c.scan.{op}"] = comm.scan(stacked, op).numpy()
    out["c.reduce"] = comm.reduce(stacked, "sum", root=1).numpy()
    out["c.exscan"] = comm.exscan(stacked, "sum").numpy()
    out["c.alltoall"] = comm.alltoall(slab, 1, 0, gshape=(19, 5)).numpy()
    out["c.resplit.None"] = comm.resplit(slab, None, src=0, gshape=(19, 5)).numpy()
    out["refusals"] = refusals(X)
    out["ops"] = extra_ops(htt, comm)
    return out


def extra_ops(htt, comm):
    """Exact ops beyond the reference's flow, run across processes here
    and by the parent in one process at as many positions."""
    rng = np.random.default_rng(11)
    a = (rng.normal(size=(19, 5)) + 2.0).astype(np.float32)
    X = htt.array(a, split=0, comm=comm)
    Y = htt.array(a.T.copy(), split=1, comm=comm)
    out = {}
    for name, fn in (("std0", lambda: X.std(0)), ("var0", lambda: X.var(0, ddof=1)),
                     ("max0", lambda: X.max(0)), ("min0", lambda: X.min(0)),
                     ("sum1", lambda: X.sum(1)), ("mean1", lambda: X.mean(1)),
                     ("cumprod0", lambda: X.cumprod(0)), ("cumsum1", lambda: X.cumsum(1)),
                     ("any", lambda: (X > 4.0).any()), ("all0", lambda: (X > -9.0).all(0)),
                     ("prod", lambda: (X * 0.5).prod()),
                     ("exp", lambda: htt.exp(X)), ("bcast_row", lambda: X - X.mean(0)),
                     ("resplit10", lambda: X.resplit(1).resplit(0)),
                     ("resplit_none", lambda: Y.resplit(None)),
                     ("reshape_split1", lambda: Y.reshape((19, 5), new_split=1)),
                     ("matmul_01", lambda: X @ Y), ("matmul_10", lambda: Y @ X),
                     ("matmul_n1", lambda: htt.array(a, comm=comm) @ Y),
                     ("sort_desc", lambda: htt.sort(X, axis=0, descending=True)[1]),
                     ("sort_axis1", lambda: htt.sort(X, axis=1)[0]),
                     ("rand", lambda: (htt.random.seed(5), htt.random.rand(19, 5, split=0, comm=comm))[1]),
                     ("randn1", lambda: (htt.random.seed(6), htt.random.randn(5, 19, split=1, comm=comm))[1])):
        got = fn()
        out[name] = (got.numpy(), got.split, tuple(got.shape))
    return out


def refusals(X):
    import importlib

    from heat_tpu_torch.io import stream
    from heat_tpu_torch.parallel import ring_attention
    got = {}
    q = torch.zeros((12, 2, 8))
    cases = {
        "untaught op (flip)": lambda: htt.flip(X, 0),
        "untaught op (concatenate)": lambda: htt.concatenate([X, X]),
        "untaught op (basic index)": lambda: X[3],
        "untaught op (argmin over the split)": lambda: X.argmin(0),
        "fuse": lambda: htt.fuse(lambda a: a + 1)(X),
        "autoshard": lambda: htt.autoshard(lambda a: a + 1)(X),
        "grid_comm": lambda: htt.grid_comm((2, 3)),
        "linalg.qr": lambda: htt.linalg.qr(X),
        "linalg.svd": lambda: htt.linalg.svd(X),
        "Lasso.fit": lambda: htt.regression.Lasso().fit(X, X),
        "cdist": lambda: htt.spatial.cdist(X, X),
        "attention": lambda: ring_attention(q, q, q),
        "io streaming": lambda: list(stream.stream_chunks(stream.as_source(np.zeros((6, 2))), 2, 0, 1)),
        "redistribution plan": lambda: importlib.import_module(
            "heat_tpu_torch.comm.redistribute").redistribute(torch.zeros((24, 6)), 1, src=0),
    }
    for name, fn in cases.items():
        try:
            fn()
            got[name] = "no raise"
        except NotImplementedError as e:
            got[name] = "NotImplementedError: " + str(e)
        except Exception as e:  # noqa: BLE001 - reported to the parent
            got[name] = f"{type(e).__name__}: {e}"
    return got
'''

REFUSALS = ["untaught op (flip)", "untaught op (concatenate)", "untaught op (basic index)",
            "untaught op (argmin over the split)", "fuse", "autoshard", "grid_comm", "linalg.qr",
            "linalg.svd", "Lasso.fit", "cdist", "attention", "io streaming", "redistribution plan"]


def _port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _boot(script, flow: str, nlocal: int, path: str, outs):
    """One boot of the two processes: their return codes and logs."""
    port = _port()
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(i), str(port), flow, str(nlocal), path, str(outs[i])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
            cwd=str(script.parent),
        )
        for i in range(2)
    ]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], logs


def _cluster(tmp, flow: str, nlocal: int, path: str):
    """Boot two port processes on ``flow`` and return their results.  A
    boot whose rendezvous failed (the free port taken between its probe
    and the coordinator's bind, as the reference's test can see too) is
    retried once on another port; the flows' own failures are not."""
    script = tmp / "child.py"
    quant = tmp / "quant.py"
    quant.write_text(QUANT)
    script.write_text(CHILD.format(repo=REPO, flows=FLOWS, quant=str(quant)))
    outs = [tmp / f"{flow}_{i}.pkl" for i in range(2)]
    for attempt in range(2):
        rcs, logs = _boot(script, flow, nlocal, path, outs)
        rendezvous = any("DistNetworkError" in log or "EADDRINUSE" in log for log in logs)
        if all(rc == 0 for rc in rcs) or not rendezvous:
            break
    for i, (rc, log) in enumerate(zip(rcs, logs)):
        assert rc == 0, f"process {i} failed:\n{log[-4000:]}"
        assert f"proc {i} OK" in log
    results = []
    for o in outs:
        with open(o, "rb") as fh:
            results.append(pickle.load(fh))
    return results


def _flows() -> dict:
    ns: dict = {}
    exec(FLOWS, ns)
    return ns


@pytest.fixture(scope="module")
def worker_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mh_worker")
    port = _cluster(tmp, "worker", 4, str(tmp / "port.h5"))
    ref = _flows()["worker"](ht, jdnd, str(tmp / "ref.h5"), ht.get_comm())
    return port, ref


@pytest.fixture(scope="module")
def fail_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mh_fail")
    return _cluster(tmp, "fail", 4, str(tmp / "no_such_dir" / "out.h5"))


@pytest.fixture(scope="module")
def quant_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mh_quant")
    port = _cluster(tmp, "quant", 3, str(tmp / "unused"))
    flows = _flows()
    # the port in one process at the same 6 positions
    one = htt.TorchCommunication(["cpu"] * 6)
    htt.use_comm(one)
    try:
        single = flows["quantized"](htt, tcq, one, lambda a: torch.from_numpy(a))
    finally:
        htt.use_comm(None)
    # the reference's communicator over 6 of its devices
    six = XlaCommunication(jax.devices()[:6])
    ht.use_comm(six)
    try:
        ref = flows["quantized"](ht, jcq, six, lambda a: jnp.asarray(a))
    finally:
        ht.use_comm(None)
    return port, single, ref, one


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint8) if a.dtype.kind == "f" else a


def _bitwise(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b))


# --------------------------------------------------------------------- #
# C14: the communicator's process identity, in one process               #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("p", [1, 4, 8])
def test_process_identity_equals_reference(p):
    mine = htt.TorchCommunication(["cpu"] * p)
    ref = XlaCommunication(jax.devices()[:p])
    assert (mine.rank, mine.is_distributed(), mine.local_position()) == (
        ref.rank, ref.is_distributed(), ref.local_position())
    assert (mine.nprocs, mine.local_size, mine.spans_processes, mine.backend) == (1, p, False, None)
    x = htt.arange(19, split=0, comm=mine)
    y = ht.arange(19, split=0, comm=ref)
    assert x.lshape == y.lshape
    np.testing.assert_array_equal(x.lshape_map, np.asarray(y.lshape_map))


# --------------------------------------------------------------------- #
# the 2 x 4 cluster: the reference's WORKER flow                          #
# --------------------------------------------------------------------- #
def test_worker_identity(worker_runs):
    port, ref = worker_runs
    for pid, got in enumerate(port):
        assert (got["size"], got["rank"], got["local_position"]) == (8, pid, 4 * pid)
        assert (got["backend"], got["transport"]) == ("gloo", "gloo, staged through host memory")
    assert (ref["size"], ref["rank"], ref["local_position"]) == (8, 0, 0)


EXACT = ["X.sum", "X.lshape_map", "Y.split", "AB.split", "km.n_iter", "km.labels", "km.labels.split",
         "Z.sum", "Z.lshape_map", "Z", "R.padshape", "R.sum", "R2.sum", "cs", "cs.max", "v", "idx",
         "v.sum", "v.min", "taken", "taken.sum", "back", "back.err", "km2.type", "km2.labels.split",
         "Y"]
CLOSE = ["Y.mean", "A", "B", "AB", "norm", "R.mean"]


@pytest.mark.parametrize("key", EXACT)
def test_worker_exact_values_equal_reference(worker_runs, key):
    port, ref = worker_runs
    for got in port:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(ref[key]), err_msg=key)


@pytest.mark.parametrize("key", CLOSE)
def test_worker_float_values_within_reference_gates(worker_runs, key):
    port, ref = worker_runs
    for got in port:
        # the reference's own gate (tests/test_multihost.py), relative for
        # values away from 1; randn is held to ulps of the reference's
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(ref[key]), rtol=1e-5, atol=1e-5,
                                   err_msg=key)


def test_worker_lshape_is_the_callers(worker_runs):
    port, ref = worker_runs
    for pid, got in enumerate(port):
        assert tuple(got["X.lshape"]) == tuple(ref["X.lshape_map"][4 * pid])
    assert tuple(ref["X.lshape"]) == (3,)


def test_worker_kmeans_centers_and_checkpoint(worker_runs):
    port, ref = worker_runs
    for got in port:
        np.testing.assert_allclose(got["km.centers"], ref["km.centers"], rtol=1e-5, atol=1e-6)
        assert got["km2.err"] < 1e-5 and ref["km2.err"] < 1e-5
    assert _bitwise(port[0]["km.centers"], port[1]["km.centers"])


# --------------------------------------------------------------------- #
# the 2 x 4 cluster: the reference's FAIL_WORKER flow                     #
# --------------------------------------------------------------------- #
def test_writer_failure_raises_on_every_process(fail_runs):
    for got in fail_runs:
        assert got["failed"] is True
        assert got["X.sum"] == 276.0


# --------------------------------------------------------------------- #
# the 2 x 3 cluster: the quantized path, collectives, slabs, refusals     #
# --------------------------------------------------------------------- #
QUANT_KEYS = ["sum0", "mean0", "std0", "var0", "allreduce_q", "moments_q"]


def _ulps(a, b) -> int:
    """Largest distance in float32 units in the last place."""
    ia = np.asarray(a, dtype=np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, dtype=np.float32).view(np.int32).astype(np.int64)
    return int(np.max(np.abs(ia - ib)))


def _block_sums_agree(r19, p: int) -> bool:
    """Whether the per-position partial sums of x and x*x (the reduce and
    moments rings' payloads before centering) are bitwise the reference's
    compiled ones: the partials rule."""
    padded = np.zeros((p * -(-19 // p), r19.shape[1]), np.float32)
    padded[:19] = r19
    blocks = padded.reshape(p, -1, r19.shape[1])
    t = torch.from_numpy(blocks)
    ref = jax.jit(lambda b: (jnp.sum(b, axis=1), jnp.sum(b * b, axis=1)))(blocks)
    return all(_bitwise(torch.sum(m, dim=1).numpy(), np.asarray(r))
               for m, r in zip((t, t * t), ref))


@pytest.mark.parametrize("key", QUANT_KEYS)
def test_quantized_bitwise_one_process_and_reference(quant_runs, key):
    port, single, ref, _ = quant_runs
    for got in port:
        assert _bitwise(got[key], single[key]), key
    if key == "allreduce_q" or _block_sums_agree(single["r19"], 6):
        assert _bitwise(single[key], ref[key]), key
    else:
        # the partials rule: torch sums a block's rows in another order
        # than XLA, so the rings start one rounding apart
        # (tests/test_torch_compressed.py holds reduce_q/moments_q to a
        # bound for the same reason); here that shows as ulps
        assert _ulps(single[key], ref[key]) <= 4, key


def _partials(blobs, centers, p):
    """The first step's per-position (k, f) sums: the port's expressions
    and the reference's compiled ones."""
    blocks = blobs.reshape(p, -1, blobs.shape[1])
    k = centers.shape[0]
    t = torch.from_numpy(blocks)
    sel = tkm._one_hot(tkm._assign(t, torch.from_numpy(centers)), k, t.dtype)
    mine = torch.matmul(sel.transpose(1, 2), t).numpy()

    @jax.jit
    def step(a, c):
        c2 = jnp.sum(c * c, axis=1)[None, :]
        labels = jnp.argmin(c2 - 2.0 * jnp.matmul(a, c.T), axis=1)
        return jnp.matmul(jax.nn.one_hot(labels, k, dtype=a.dtype).T, a)

    theirs = np.stack([np.asarray(step(b, centers)) for b in blocks])
    return mine, theirs


def test_quantized_kmeans_fit(quant_runs):
    port, single, ref, _ = quant_runs
    for got in port:
        for key in ("km.centers", "km.labels", "km.n_iter"):
            assert _bitwise(got[key], single[key]), key
    np.testing.assert_array_equal(single["km.labels"], ref["km.labels"])
    assert single["km.n_iter"] == ref["km.n_iter"]
    blobs = single["blobs"]
    mine, theirs = _partials(blobs, blobs[[0, 40, 80]], 6)
    if _bitwise(mine, theirs):
        assert _bitwise(single["km.centers"], ref["km.centers"])
    else:  # the ring bound of ROADMAP's numerics rules
        counts = np.bincount(ref["km.labels"], minlength=3)[:, None]
        bound = 7 * np.abs(blobs).max() * blobs.shape[0] / 254 / np.maximum(counts, 1)
        assert np.all(np.abs(single["km.centers"] - ref["km.centers"]) <= bound)


def test_slab_store_and_local_reads(quant_runs):
    port, _, _, one = quant_runs
    g = np.arange(19 * 5, dtype=np.float32).reshape(19, 5)
    padded = np.zeros((24, 5), dtype=np.float32)
    padded[:19] = g
    for pid, got in enumerate(port):
        np.testing.assert_array_equal(got["slab"], padded[12 * pid:12 * pid + 12])
        np.testing.assert_array_equal(got["lloc"], g[12 * pid:min(12 * pid + 12, 19)])
        for name in ("larray", "_buffer"):
            assert "ROADMAP A3b2" in got[f"raises.{name}"], got[f"raises.{name}"]
        assert got["str"] == str(htt.array(g, split=0, comm=one))


def _one_process_collectives(one):
    g = torch.from_numpy(np.arange(19 * 5, dtype=np.float32).reshape(19, 5))
    buf = one.pad_to_shards(g, axis=0)
    stacked = torch.from_numpy(np.arange(6 * 3, dtype=np.float32).reshape(6, 3) ** 1.5)
    want = {
        "c.allgather": buf, "c.gather": buf,
        "c.ring_permute": one.ring_permute(buf, 1),
        "c.permute": one.permute(buf, [(0, 4), (4, 1), (2, 2)]),
        "c.bcast": one.bcast(g, root=4, split=0),
        "c.reduce": one.reduce(stacked, "sum", root=1),
        "c.exscan": one.exscan(stacked, "sum"),
        "c.alltoall": one.pad_to_shards(g, axis=1),
        "c.resplit.None": g,
    }
    for op in ("sum", "prod", "max", "min"):
        want[f"c.allreduce.{op}"] = one.allreduce(stacked, op)
        want[f"c.scan.{op}"] = one.scan(stacked, op)
    return {k: v.numpy() for k, v in want.items()}, buf.numpy()


COLLECTIVES = ["c.allgather", "c.gather", "c.ring_permute", "c.permute", "c.bcast", "c.scatter",
               "c.reduce", "c.exscan", "c.alltoall", "c.resplit.None"] + [
    f"c.{c}.{op}" for c in ("allreduce", "scan") for op in ("sum", "prod", "max", "min")]


@pytest.mark.parametrize("key", COLLECTIVES)
def test_tensor_collectives_across_processes(quant_runs, key):
    port, _, _, one = quant_runs
    want, buf = _one_process_collectives(one)
    for pid, got in enumerate(port):
        rows = slice(12 * pid, 12 * pid + 12)
        if key in ("c.ring_permute", "c.permute"):
            expect = want[key][rows]
        elif key == "c.scatter":
            expect = buf[rows]
        elif key.startswith("c.scan") or key == "c.exscan":
            expect = want[key][3 * pid:3 * pid + 3]
        elif key == "c.alltoall":
            expect = np.pad(want[key][:, 3 * pid:3 * pid + 3],
                            ((0, 0), (0, 3 - want[key][:, 3 * pid:3 * pid + 3].shape[1])))
        else:
            expect = want[key]
        assert _bitwise(got[key], expect), (key, pid)


EXTRA = ["std0", "var0", "max0", "min0", "sum1", "mean1", "cumprod0", "cumsum1", "any", "all0", "prod",
         "exp", "bcast_row", "resplit10", "resplit_none", "reshape_split1", "matmul_01", "matmul_10",
         "matmul_n1", "sort_desc", "sort_axis1", "rand", "randn1"]
#: results whose reduction order differs across processes (partials
#: combined in process order): held to float32's rounding, not bitwise
ROUNDED = {"std0", "var0", "mean1", "prod", "bcast_row", "matmul_10"}


@pytest.mark.parametrize("name", EXTRA)
def test_ops_across_processes_equal_one_process(quant_runs, name):
    port, _, _, one = quant_runs
    ns = {"np": np, "torch": torch, "htt": htt}
    exec(QUANT, ns)
    htt.use_comm(one)
    try:
        want = ns["extra_ops"](htt, one)[name]
    finally:
        htt.use_comm(None)
    for got in port:
        values, split, shape = got["ops"][name]
        assert (split, shape) == want[1:], name
        if name in ROUNDED:
            np.testing.assert_allclose(values, want[0], rtol=2e-6, atol=1e-6, err_msg=name)
        else:
            assert _bitwise(values, want[0]), name


@pytest.mark.parametrize("name", REFUSALS)
def test_refusals_name_the_next_item(quant_runs, name):
    port = quant_runs[0]
    for got in port:
        said = got["refusals"][name]
        assert said.startswith("NotImplementedError") and "ROADMAP A3b2" in said, said
