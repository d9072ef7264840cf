"""The port stands alone: no JAX, no heat_tpu, no silent CPU fallback.

Each check runs in a fresh interpreter, because this test process has
already imported jax (``tests/conftest.py``).
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from test_torch_reference_state import reference_state  # noqa: F401  (restores the JAX package's state)

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "heat_tpu_torch"


def _run(code: str, **env) -> subprocess.CompletedProcess:
    full_env = dict(os.environ)
    full_env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]
    )
    full_env.update(env)
    return subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=full_env,
        capture_output=True, text=True, timeout=120,
    )


def test_import_leaves_jax_and_heat_tpu_out():
    proc = _run(
        "import sys, heat_tpu_torch\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'heat_tpu' or m.startswith('heat_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_each_slice_module_imports_without_jax_or_heat_tpu():
    modules = [
        "heat_tpu_torch.core.linalg.basics", "heat_tpu_torch.core.linalg.qr",
        "heat_tpu_torch.core.linalg.svd", "heat_tpu_torch.core.linalg.solver",
        "heat_tpu_torch.regression.lasso", "heat_tpu_torch.core.exponential",
        "heat_tpu_torch.core.rounding", "heat_tpu_torch.core.relational",
        "heat_tpu_torch.core.logical", "heat_tpu_torch.core.trigonometrics",
        "heat_tpu_torch.core.random", "heat_tpu_torch.graph.laplacian",
        "heat_tpu_torch.cluster.spectral", "heat_tpu_torch.cluster.kmedians",
        "heat_tpu_torch.cluster.kmedoids", "heat_tpu_torch.naive_bayes.gaussianNB",
        "heat_tpu_torch.classification.knn", "heat_tpu_torch.core.constants",
        "heat_tpu_torch.core.stride_tricks", "heat_tpu_torch.core.memory",
        "heat_tpu_torch.core.indexing", "heat_tpu_torch.core.printing",
        "heat_tpu_torch.core.arithmetics", "heat_tpu_torch.core.factories",
        "heat_tpu_torch.core.types", "heat_tpu_torch.core.sanitation",
        "heat_tpu_torch.core.communication", "heat_tpu_torch.core.dndarray",
        "heat_tpu_torch.core.manipulations", "heat_tpu_torch.core.statistics",
        "heat_tpu_torch.core.tiling", "heat_tpu_torch.parallel.sort", "heat_tpu_torch.parallel.take",
        "heat_tpu_torch.utils", "heat_tpu_torch.utils.matrixgallery", "heat_tpu_torch.utils.profiler",
        "heat_tpu_torch.comm._costs", "heat_tpu_torch.comm.overlap", "heat_tpu_torch.comm.redistribute",
        "heat_tpu_torch.comm", "heat_tpu_torch.core._split_semantics",
        "heat_tpu_torch.telemetry", "heat_tpu_torch.telemetry._core", "heat_tpu_torch.telemetry.hist",
        "heat_tpu_torch.telemetry.flight", "heat_tpu_torch.telemetry.slo", "heat_tpu_torch.telemetry.export",
        "heat_tpu_torch.telemetry.httpz", "heat_tpu_torch.net", "heat_tpu_torch.net._base",
        "heat_tpu_torch.resilience", "heat_tpu_torch.resilience.incidents",
        "heat_tpu_torch.resilience.retry", "heat_tpu_torch.resilience.faults",
        "heat_tpu_torch.resilience.guards", "heat_tpu_torch.resilience.fixtures",
        "heat_tpu_torch.resilience.resume", "heat_tpu_torch.resilience.elastic",
        "heat_tpu_torch.core.io", "heat_tpu_torch.core.checkpoint", "heat_tpu_torch.io",
        "heat_tpu_torch.io.stream", "heat_tpu_torch.native", "heat_tpu_torch.datasets",
        "heat_tpu_torch.obs", "heat_tpu_torch.cluster.kmeans",
        "heat_tpu_torch.core._tracing", "heat_tpu_torch.core._compile",
        "heat_tpu_torch.core.fuse", "heat_tpu_torch.core.aot", "heat_tpu_torch.version",
        "heat_tpu_torch.net.wire", "heat_tpu_torch.serve", "heat_tpu_torch.serve.errors",
        "heat_tpu_torch.serve.registry", "heat_tpu_torch.serve.batcher",
        "heat_tpu_torch.serve.engine", "heat_tpu_torch.serve.loadgen",
        "heat_tpu_torch.serve.health", "heat_tpu_torch.serve.wfq", "heat_tpu_torch.serve.fleet",
        "heat_tpu_torch.serve.procfleet", "heat_tpu_torch.serve.ingress",
        "heat_tpu_torch.serve._replica_main", "heat_tpu_torch.core.autoshard",
        "heat_tpu_torch.analysis", "heat_tpu_torch.analysis.core", "heat_tpu_torch.analysis.rules",
        "heat_tpu_torch.analysis.splitflow", "heat_tpu_torch.analysis.splitflow.domain",
        "heat_tpu_torch.analysis.splitflow.transfer", "heat_tpu_torch.analysis.splitflow.registry",
        "heat_tpu_torch.analysis.splitflow.engine", "heat_tpu_torch.analysis.splitflow.summary",
        "heat_tpu_torch.analysis.splitflow.report", "heat_tpu_torch.analysis.splitflow.checkers",
        "heat_tpu_torch.analysis.checkers", "heat_tpu_torch.analysis.baseline",
        "heat_tpu_torch.analysis.cache", "heat_tpu_torch.analysis.cli",
    ]
    proc = _run(
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'heat_tpu' or m.startswith('heat_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_fuse_and_aot_run_without_jax_or_heat_tpu():
    """``htt.fuse`` (a pipeline, a library predict) and an AOT export and
    install on CPU positions, with neither jax nor heat_tpu imported."""
    proc = _run(
        "import pickle, sys, numpy as np, heat_tpu_torch as htt\n"
        "from heat_tpu_torch.core import aot\n"
        "htt.use_device('cpu')\n"
        "comm = htt.TorchCommunication(['cpu'] * 4)\n"
        "x = htt.array(np.arange(24, dtype=np.float32).reshape(6, 4), split=0, comm=comm)\n"
        "f = htt.fuse(htt.sqrt)\n"
        "with aot.capture_programs() as cap:\n"
        "    want = f(x).numpy()\n"
        "    k = htt.kurtosis(x, axis=0).numpy()\n"
        "bundles = pickle.loads(pickle.dumps(aot.export_programs(cap)))\n"
        "htt.fuse.clear_cache()\n"
        "assert aot.install_programs(bundles, comm=comm) == 2\n"
        "assert f(x).numpy().tobytes() == want.tobytes()\n"
        "assert htt.kurtosis(x, axis=0).numpy().tobytes() == k.tobytes()\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'heat_tpu' or m.startswith('heat_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_a_replica_serves_without_jax_or_heat_tpu(tmp_path):
    """The replica body (``_replica_main.serve``) boots on two CPU
    positions, warms from the port's sidecar, answers a predict, a stats
    and a close frame from a parent thread, with neither jax nor heat_tpu
    imported in its interpreter."""
    proc = _run(
        "import json, secrets, socket, sys, threading, numpy as np, heat_tpu_torch as htt\n"
        "from heat_tpu_torch.net import wire\n"
        "from heat_tpu_torch.serve import ModelRegistry, ServeEngine, _replica_main, procfleet\n"
        "htt.use_comm(htt.TorchCommunication(['cpu'] * 2))\n"
        "x = np.random.default_rng(0).normal(size=(32, 4)).astype(np.float32)\n"
        "km = htt.cluster.KMeans(n_clusters=3, max_iter=3, random_state=0).fit(htt.array(x, split=0))\n"
        f"reg = ModelRegistry({str(tmp_path / 'models')!r})\n"
        "reg.publish('t', 'km', km)\n"
        "src = ServeEngine(reg, min_bucket=8)\n"
        "bundles = src.export_warm('t', 'km')\n"
        "reg.publish_executables('t', 'km', 1, bundles)\n"
        "src.close()\n"
        "htt.fuse.clear_cache()\n"
        "lis = socket.create_server(('127.0.0.1', 0))\n"
        "cfg = {'port': lis.getsockname()[1], 'token': secrets.token_hex(4), 'replica': 0,\n"
        "       'registry_root': reg.root, 'warm_models': [['t', 'km', 1]],\n"
        "       'engine_kwargs': {'min_bucket': 8}, 'policy': procfleet._policy_snapshot(),\n"
        "       'placement': procfleet._placement_snapshot()}\n"
        "got = {}\n"
        "def parent():\n"
        "    conn, _ = lis.accept()\n"
        "    got['hello'] = wire.recv_frame(conn)[0]\n"
        "    wire.send_frame(conn, {'kind': 'predict', 'rid': 'r', 'tenant': 't', 'model': 'km',\n"
        "                           'version': 1}, {'x': x[:5]})\n"
        "    got['reply'] = wire.recv_frame(conn)\n"
        "    wire.send_frame(conn, {'kind': 'stats'})\n"
        "    got['stats'] = wire.recv_frame(conn)[0]\n"
        "    wire.send_frame(conn, {'kind': 'close'})\n"
        "    got['bye'] = wire.recv_frame(conn)[0]\n"
        "t = threading.Thread(target=parent)\n"
        "t.start()\n"
        "assert _replica_main.serve(cfg, ModelRegistry(reg.root)) == 0\n"
        "t.join(60)\n"
        "h = got['hello']\n"
        "assert (h['installed'], h['fuse_misses'], h['compile_misses']) == (len(bundles), 0, 0), h\n"
        "msg, blobs = got['reply']\n"
        "assert msg['kind'] == 'reply' and msg['trace_id'] == 'r'\n"
        "assert blobs['y'].tobytes() == km.predict(htt.array(x[:5])).numpy().tobytes()\n"
        "assert got['stats']['stats']['requests'] == 2 and got['bye']['kind'] == 'bye'\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'heat_tpu' or m.startswith('heat_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize(
    "path",
    sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_card.py",
                                 ROOT / "tests" / "test_torch_capture_rules.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_jax_or_heat_tpu_import(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "heat_tpu"), f"{path}: imports {name}"


@pytest.mark.parametrize(
    "path", sorted((PKG / "analysis").rglob("*.py")), ids=lambda p: str(p.relative_to(ROOT)),
)
def test_the_linter_imports_only_the_stdlib(path):
    """``heat_tpu_torch/analysis`` imports no torch, no jax, nothing of
    ``heat_tpu`` and nothing of the port outside itself."""
    import sys as _sys

    tree = ast.parse(path.read_text(), filename=str(path))
    depth = len(path.relative_to(PKG / "analysis").parts) - 1
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            assert node.level <= depth + 1, f"{path}: imports outside analysis/: {ast.unparse(node)}"
            if node.level:
                continue
            tops = [node.module.split(".")[0]]
        else:
            continue
        for top in tops:
            assert top in _sys.stdlib_module_names or top == "__future__", f"{path} imports {top}"


def test_the_linter_runs_on_the_stdlib_alone(tmp_path):
    """The linter, its cache, its CLI and splitflow's cost report run in
    an interpreter without site-packages (``-I -S``: no torch, no numpy,
    no jax), the port's package entered without its ``__init__``."""
    src = tmp_path / "m.py"
    src.write_text("import heat_tpu_torch as ht\n\n\ndef f(x, comm):\n"
                   "    for _ in range(4):\n        x = comm.resplit(x, 1)\n    return ht.ones((8, 4), split=0).resplit(1)\n")
    code = (
        "import sys, types\n"
        f"pkg = types.ModuleType('heat_tpu_torch'); pkg.__path__ = [{str(PKG)!r}]\n"
        "sys.modules['heat_tpu_torch'] = pkg\n"
        "from heat_tpu_torch.analysis import analyze_file\n"
        "from heat_tpu_torch.analysis import cli\n"
        f"found = analyze_file({str(src)!r}, relpath='m.py')\n"
        "assert [f.rule for f in found] == ['SPMD206'], found\n"
        f"assert cli.main([{str(src)!r}, '--cache-dir', {str(tmp_path / 'cache')!r}, '-q']) == 1\n"
        f"assert cli.main([{str(src)!r}, '--cost-report', '--format', 'json']) == 0\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] not in sys.stdlib_module_names"
        " and n.split('.')[0] != 'heat_tpu_torch' and n not in ('__main__', '__mp_main__'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-I", "-S", "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"


def test_grid_paths_run_without_jax_or_heat_tpu():
    """The grid's layouts, SUMMA, CAQR and QDWH run with neither jax nor
    heat_tpu imported (every import they make is lazy)."""
    proc = _run(
        "import sys, numpy as np, heat_tpu_torch as htt\n"
        "comm = htt.grid_comm((2, 2), ['cpu'] * 4)\n"
        "a = htt.array(np.random.default_rng(0).normal(size=(12, 6)).astype(np.float32), splits=(0, 1), comm=comm)\n"
        "q, r = htt.linalg.qr(a)\n"
        "u, s, v = htt.linalg.svd(a)\n"
        "p = a.T.resplit((0, 1)) @ a\n"
        "assert q.splits == (0, 1) and r.splits == (None, 1) and p.splits == (0, 1)\n"
        "assert float(htt.linalg.norm(a)) > 0 and a.sum(0).shape == (6,)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'heat_tpu' or m.startswith('heat_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_base_layer_runs_without_jax_or_heat_tpu():
    """Telemetry on, a fault armed and a guard set around an int8 ring on
    CPU positions, with neither jax nor heat_tpu imported."""
    proc = _run(
        "import sys, torch, heat_tpu_torch as htt\n"
        "from heat_tpu_torch.comm import compressed as cq\n"
        "htt.telemetry.enable()\n"
        "comm = htt.TorchCommunication(['cpu'] * 4)\n"
        "x = torch.ones(4, 256)\n"
        "with htt.resilience.guard('degrade'), htt.resilience.inject('saturate', nth=1):\n"
        "    out = cq.allreduce_q(x, comm=comm, precision='int8_block')\n"
        "assert torch.equal(out, x.sum(0))\n"
        "assert [i.action for i in htt.resilience.incident_log()] == ['degraded']\n"
        "assert htt.telemetry.snapshot()['spans']['commq:allreduce']['count'] == 1\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'heat_tpu' or m.startswith('heat_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_reference_checkpoints_and_snapshots_load_without_jax_or_heat_tpu(tmp_path):
    """``htt.load_estimator`` of files the JAX package wrote (a KMeans, a
    Lasso), an elastic resume from its 8-device loop snapshot at one
    position, a mini-batch fit streamed
    from its NetCDF-3 file and its CSV through the native scanner, in a
    fresh interpreter with neither jax nor heat_tpu imported."""
    import numpy as np

    import heat_tpu as ht

    x = np.random.default_rng(3).normal(size=(32, 3)).astype(np.float32)
    y = (x @ np.array([1.0, -1.0, 2.0], np.float32)).astype(np.float32)
    ht.cluster.KMeans(n_clusters=2, init=ht.array(x[:2]), max_iter=5).fit(ht.array(x)).save(str(tmp_path / "km.h5"))
    ht.regression.Lasso(lam=0.01, max_iter=10).fit(ht.array(x), ht.array(y)).save(str(tmp_path / "ls.h5"))
    ht.save_netcdf(ht.array(x), str(tmp_path / "x.nc"), "x")
    ht.save_csv(ht.array(x), str(tmp_path / "x.csv"))
    ht.save_csv(ht.array(y), str(tmp_path / "y.csv"))
    from heat_tpu.resilience import faults as rfaults

    try:
        with rfaults.inject("preempt", site="iteration", nth=1):
            ht.regression.Lasso(lam=0.01, max_iter=10, tol=-1.0, checkpoint_every=4,
                                checkpoint_path=str(tmp_path / "snap.h5")).fit(ht.array(x), ht.array(y))
    except rfaults.Preempted:
        pass
    proc = _run(
        "import sys, numpy as np, heat_tpu_torch as htt\n"
        "htt.use_device('cpu')\n"
        f"d = {str(tmp_path)!r}\n"
        "km = htt.load_estimator(d + '/km.h5')\n"
        "ls = htt.load_estimator(d + '/ls.h5')\n"
        "assert type(km).__module__ == 'heat_tpu_torch.cluster.kmeans' and km.n_iter_ == 5\n"
        "x = htt.load_csv(d + '/x.csv')\n"
        "assert km.predict(x).shape == (32,) and ls.predict(x).shape == (32, 1)\n"
        "src = htt.io.NetCDFSource(d + '/x.nc', 'x')\n"
        "mb = htt.cluster.KMeans(n_clusters=2, mini_batch=8, max_iter=2).fit(src)\n"
        "assert mb.n_iter_ == 8\n"
        "r = htt.regression.Lasso(lam=0.01, max_iter=10, tol=-1.0, checkpoint_every=4,"
        " checkpoint_path=d + '/snap.h5')\n"
        "r.fit(x, htt.load_csv(d + '/y.csv'), resume='elastic')\n"
        "assert r.n_iter == 10\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'heat_tpu' or m.startswith('heat_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n",
        CUDA_VISIBLE_DEVICES="",
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_call_without_device_raises_without_cuda():
    proc = _run(
        "import heat_tpu_torch as ht\n"
        "try:\n"
        "    ht.array([1.0, 2.0])\n"
        "except RuntimeError as e:\n"
        "    assert 'use_device' in str(e), e\n"
        "    print('raised')\n",
        CUDA_VISIBLE_DEVICES="",
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "raised"


def test_cpu_runs_when_asked_for():
    proc = _run(
        "import heat_tpu_torch as ht\n"
        "ht.use_device('cpu')\n"
        "x = ht.array([[1.0, 2.0], [3.0, 5.0]], split=0)\n"
        "assert x.larray.device.type == 'cpu'\n"
        "print(float(ht.mean(x)))\n",
        CUDA_VISIBLE_DEVICES="",
    )
    assert proc.returncode == 0, proc.stderr
    assert float(proc.stdout) == 2.75


def test_float32_matmuls_run_without_tf32():
    proc = _run(
        "import torch, heat_tpu_torch\n"
        "assert torch.get_float32_matmul_precision() == 'highest'\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "print('ok')\n"
    )
    assert proc.returncode == 0, proc.stderr


def test_autoshard_runs_without_jax_or_heat_tpu(tmp_path):
    """``htt.autoshard`` analyzes, solves and runs a staged pipeline on
    CPU positions (the static analysis and the by-path cost model
    included), with neither jax nor heat_tpu imported."""
    src = tmp_path / "staged.py"
    src.write_text(
        "import heat_tpu_torch as ht\n\n\n"
        "def staged(comm=None):\n"
        "    x = ht.ones((64, 32), dtype=ht.float32, split=0, comm=comm)\n"
        "    t = x.resplit(1)\n"
        "    w = t.resplit(None)\n"
        "    return x, w\n"
    )
    proc = _run(
        "import sys, importlib.util, heat_tpu_torch as htt\n"
        "htt.use_device('cpu')\n"
        f"spec = importlib.util.spec_from_file_location('staged', {str(src)!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "comm = htt.TorchCommunication(['cpu'] * 4)\n"
        "auto = htt.autoshard(mod.staged)\n"
        "plan = auto.plan(comm)\n"
        "assert plan['modeled_wire_bytes'] < plan['hand_wire_bytes'], plan\n"
        "x, w = auto(comm)\n"
        "assert w.split is None and (w.numpy() == 1).all()\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'heat_tpu' or m.startswith('heat_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
