"""The splitflow oracle lane on the port: static inference against the
port's running system, and the port's static views against the
reference's.

The fixture is ``tests/splitflow_pipelines.py`` with its one import line
swapped to ``heat_tpu_torch``, written under a temporary directory and
imported from there by path: the port analyzes and runs literally the
reference's source.

1. **Split oracle**: every pipeline is analyzed statically and run on
   CPU positions (1, 2, 4 and 8); the runtime ``.split`` of every returned
   array equals the split the port's engine inferred for that variable,
   and every literal shape inferred is the real one.  The port's inferred
   specs are the reference's on the reference's own fixture.
2. **Byte oracle**: the resplit pipeline's modeled wire and exact bytes
   (the port's cost report) equal the port's telemetry ledger after a run
   under the planned redistribution policy, and each priced event equals
   the port's ``redistribute.plan``.
3. **Registry oracle**: the port's static registry (parsed, no import)
   equals its runtime registry, name, kind and params, and equals the
   reference's static registry (the difference, listed in
   ``REGISTRY_DIFFERENCE``, is empty).
4. The by-path runtime modules the static side loads
   (``comm/_costs.py``, ``core/_split_semantics.py``) import nothing but
   the standard library.
"""

import ast
import importlib.util
import os
import subprocess
import sys

import pytest

import heat_tpu_torch as htt
from heat_tpu_torch import telemetry
from heat_tpu_torch.comm import redistribute as rd

from test_torch_reference_state import reference_state  # noqa: F401  (restores the JAX package's state)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "splitflow_pipelines.py")
SITE = "port_splitflow_pipelines.py::resplit_pipeline"

MESHES = [1, 2, 4, 8]

#: pipeline -> the variable names its return tuple binds, in order
RETURNS = {
    "svd_pipeline": ("a", "u", "s", "v"),
    "kmeans_pipeline": ("x", "labels"),
    "lasso_pipeline": ("x", "y", "pred"),
    "gnb_pipeline": ("x", "y", "pred", "proba"),
    "fused_pipeline": ("a", "b", "out"),
    "resplit_pipeline": ("x", "y", "z", "w"),
    "staged_resplit_pipeline": ("x", "w"),
}

#: names in exactly one of the two static registries, each with why
REGISTRY_DIFFERENCE: dict = {}


def port_fixture_source() -> str:
    with open(FIXTURE, encoding="utf-8") as fh:
        src = fh.read()
    assert src.count("\nimport heat_tpu as ht\n") == 1
    return src.replace("\nimport heat_tpu as ht\n", "\nimport heat_tpu_torch as ht\n")


@pytest.fixture(scope="module")
def fixture_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("splitflow") / "port_splitflow_pipelines.py"
    path.write_text(port_fixture_source(), encoding="utf-8")
    return str(path)


@pytest.fixture(scope="module")
def pipelines(fixture_path):
    spec = importlib.util.spec_from_file_location("port_splitflow_pipelines", fixture_path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def program(fixture_path):
    from heat_tpu_torch.analysis.core import FileContext, norm_relpath
    from heat_tpu_torch.analysis.splitflow import build_program

    ctx = FileContext(fixture_path, relpath=norm_relpath(fixture_path, os.path.dirname(fixture_path)))
    assert not ctx.skip_file
    return build_program([ctx])


@pytest.fixture(autouse=True)
def on_cpu():
    prev = htt.core.devices._default
    htt.use_device("cpu")
    yield
    htt.use_device(prev)


def _comm(k):
    return htt.TorchCommunication(["cpu"] * k)


def _static_env(program, fn_name):
    for (_mod, qual), env in program.fn_envs.items():
        if qual == fn_name:
            return env
    raise AssertionError(f"no static env for {fn_name}")


# --------------------------------------------------------------------- #
# 1. split oracle
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", sorted(RETURNS))
def test_runtime_split_matches_static_inference(program, pipelines, name, mesh):
    env = _static_env(program, name)
    out = getattr(pipelines, name)(_comm(mesh))
    assert len(out) == len(RETURNS[name])
    for var, arr in zip(RETURNS[name], out):
        spec = env[var]
        assert spec.is_array, (name, var)
        assert arr.split == spec.split, (
            f"{name}: runtime {var}.split={arr.split} but splitflow inferred {spec.split} (mesh {mesh})")
        if spec.shape is not None:
            assert tuple(spec.shape) == tuple(arr.shape), (name, var)


def test_inferred_specs_equal_the_references(program):
    """The port's specs on its fixture are the reference's on the
    reference's fixture, local for local."""
    from heat_tpu.analysis.core import FileContext, norm_relpath
    from heat_tpu.analysis.splitflow import build_program

    ref = build_program([FileContext(FIXTURE, relpath=norm_relpath(FIXTURE, REPO))])
    for name in RETURNS:
        mine = {k: repr(v) for k, v in _static_env(program, name).items()}
        want = {k: repr(v) for k, v in _static_env(ref, name).items()}
        assert mine == want, name
    key = lambda ev: (ev.line, getattr(ev.node, "col_offset", 0), ev.qualname, ev.fact.op,  # noqa: E731
                      repr(ev.fact.src), repr(ev.fact.dst), ev.fact.shape, ev.fact.dtype)
    assert [key(ev) for ev in program.events] == [key(ev) for ev in ref.events]


# --------------------------------------------------------------------- #
# 2. byte oracle
# --------------------------------------------------------------------- #
@pytest.fixture
def ledger():
    was = telemetry.is_enabled()
    telemetry.enable()
    telemetry.reset()
    yield
    telemetry.reset()
    (telemetry.enable if was else telemetry.disable)()


@pytest.mark.parametrize("mesh", MESHES)
def test_modeled_bytes_match_telemetry_ledger(program, pipelines, ledger, mesh):
    from heat_tpu_torch.analysis.splitflow import cost_report

    report = cost_report(program, mesh=mesh, precision="f32")
    assert SITE in report["functions"], sorted(report["functions"])
    modeled = report["functions"][SITE]
    with rd.redistribution("planned"):
        pipelines.resplit_pipeline(_comm(mesh))
    counters = telemetry.snapshot()["counters"]
    assert modeled["modeled_wire_bytes"] == counters.get("comm.wire_bytes", 0)
    assert modeled["modeled_exact_bytes"] == counters.get("comm.exact_bytes", 0)
    if mesh == 1:
        assert counters.get("comm.wire_bytes", 0) == 0
    else:
        assert counters["comm.wire_bytes"] > 0
        assert counters.get("comm.resplit.planned", 0) == 2


@pytest.mark.parametrize("mesh", [2, 4, 8])
def test_modeled_bytes_match_plan_objects(program, mesh):
    from heat_tpu_torch.analysis.splitflow import cost_report

    fn = cost_report(program, mesh=mesh, precision="f32")["functions"][SITE]
    priced = [e for e in fn["events"] if e.get("wire_bytes") is not None]
    assert len(priced) == 2
    for ev in priced:
        p = rd.plan(tuple(ev["shape"]), ev["dtype"], int(ev["src"]), int(ev["dst"]), mesh)
        assert ev["wire_bytes"] == p.wire_bytes
        assert ev["exact_wire_bytes"] == p.exact_wire_bytes


def test_fixture_is_clean_under_program_rules(fixture_path):
    from heat_tpu_torch.analysis.core import FileContext, analyze_contexts

    findings = analyze_contexts([FileContext(fixture_path, relpath="port_splitflow_pipelines.py")])
    assert [f for f in findings if f.rule.startswith("SPMD5")] == []


# --------------------------------------------------------------------- #
# 3. registry oracle
# --------------------------------------------------------------------- #
def _decl(sem):
    return sem.kind, tuple(sem.params)


def test_static_registry_equals_runtime_registry():
    from heat_tpu_torch.analysis.splitflow.registry import package_registry
    from heat_tpu_torch.core._split_semantics import REGISTRY

    static = package_registry()
    assert set(static) == set(REGISTRY), (
        f"only-static={sorted(set(static) - set(REGISTRY))} only-runtime={sorted(set(REGISTRY) - set(static))}")
    for name, sem in REGISTRY.items():
        assert static[name].kind == sem.kind, name
        assert static[name].params == sem.params, name


def test_static_registry_equals_the_references():
    from heat_tpu.analysis.splitflow.registry import package_registry as ref_registry
    from heat_tpu_torch.analysis.splitflow.registry import package_registry

    mine, ref = package_registry(), ref_registry()
    differ = sorted(set(mine) ^ set(ref)) + sorted(n for n in set(mine) & set(ref) if _decl(mine[n]) != _decl(ref[n]))
    assert sorted(differ) == sorted(REGISTRY_DIFFERENCE)


def test_static_registry_reads_the_ports_files_only():
    """The walk skips the port's ``analysis/`` and never reaches the
    reference's tree."""
    from heat_tpu_torch.analysis.splitflow import registry

    seen = []
    real = registry.parse_declarations

    def spy(tree):
        seen.append(tree)
        return real(tree)

    registry.package_registry.cache_clear()
    registry.parse_declarations = spy
    try:
        opened = []
        real_open = open

        def spy_open(path, *a, **k):
            opened.append(os.path.abspath(path))
            return real_open(path, *a, **k)

        registry.open = spy_open
        try:
            registry.package_registry()
        finally:
            del registry.open
    finally:
        registry.parse_declarations = real
        registry.package_registry.cache_clear()
    pkg = os.path.join(REPO, "heat_tpu_torch") + os.sep
    assert opened and all(p.startswith(pkg) for p in opened)
    assert not any(p.startswith(pkg + "analysis" + os.sep) for p in opened)
    assert len(seen) >= 20  # the op modules that declare semantics


# --------------------------------------------------------------------- #
# 4. the by-path modules are stdlib-only
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("rel", ["heat_tpu_torch/comm/_costs.py", "heat_tpu_torch/core/_split_semantics.py"])
def test_by_path_modules_import_only_the_stdlib(rel):
    path = os.path.join(REPO, rel)
    tree = ast.parse(open(path, encoding="utf-8").read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, f"{rel}: relative import"
            tops = [node.module.split(".")[0]]
        else:
            continue
        for top in tops:
            assert top in sys.stdlib_module_names or top == "__future__", f"{rel} imports {top}"
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('m', {path!r})\n"
        "m = importlib.util.module_from_spec(spec)\n"
        "sys.modules['m'] = m\n"
        "spec.loader.exec_module(m)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] not in sys.stdlib_module_names"
        " and n not in ('m', '__main__', '__mp_main__'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    # -I: no working directory on the path (core/types.py would shadow the
    # stdlib's types), -S: no site-packages
    proc = subprocess.run([sys.executable, "-I", "-S", "-c", code], capture_output=True, text=True,
                          timeout=60, cwd=os.path.dirname(path))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_fixture_copy_differs_only_in_its_import_line():
    src = open(FIXTURE, encoding="utf-8").read().splitlines()
    mine = port_fixture_source().splitlines()
    diff = [(a, b) for a, b in zip(src, mine) if a != b]
    assert len(src) == len(mine) and diff == [("import heat_tpu as ht", "import heat_tpu_torch as ht")]
