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
        "heat_tpu_torch.classification.knn",
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
    sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_card.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_jax_or_heat_tpu_import(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "heat_tpu"), f"{path}: imports {name}"


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
