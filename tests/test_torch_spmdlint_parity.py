"""The oracle: the port's linter against the reference's, fixture by fixture.

* Every fixture of ``tests/test_spmdlint.py`` whose rule the port keeps
  (read from that file's source, never copied) has its torch twin in
  ``test_torch_spmdlint.TWINS``, and the reference's analyzer on the JAX
  original and the port's on the twin give the same ``(rule, line)`` set,
  with and without the dynamic rules.
* The rules that do not depend on the framework (SPMD001, 204, 206, 207,
  211-214) give equal findings on the SAME source: the reference's
  fixtures, their twins, SPMD001's fixture and both packages' whole
  trees, through ``analyze_file``/``analyze_paths`` and through both
  CLIs' ``--format json``.  Equal means rule, path, line, message,
  context and fingerprint; a hint may differ only by naming the port's
  package where the reference's names its own.
* The gate as a user runs it: ``python -m heat_tpu_torch.analysis.cli
  --baseline`` exits 0 over the whole port.
"""

import ast
import contextlib
import io
import json
import os
import subprocess
import sys

import pytest

import heat_tpu.analysis as ref
import heat_tpu_torch.analysis as port
from heat_tpu.analysis import cli as ref_cli
from heat_tpu_torch.analysis import cli as port_cli

from test_torch_reference_state import reference_state  # noqa: F401  (restores the JAX package's state)
from test_torch_spmdlint import PORTED, NOT_PORTED, SPMD001_SRC, TWINS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_TESTS = os.path.join(REPO, "tests", "test_spmdlint.py")
#: rules whose verdict does not depend on the framework's constructs
AGNOSTIC = ["SPMD001", "SPMD204", "SPMD206", "SPMD207", "SPMD211", "SPMD212", "SPMD213", "SPMD214"]
#: the reference's tests of generic mechanics, kept with their fixtures
GENERIC = ("test_inline_suppression_and_skip_file", "test_suppression_is_rule_specific")


def reference_fixtures() -> dict:
    """``"<test>:<variable>" -> source`` for every string fixture a
    reference test of a ported rule (or of the generic mechanics) assigns."""
    tree = ast.parse(open(REF_TESTS, encoding="utf-8").read())
    out = {}
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef) or not fn.name.startswith("test_"):
            continue
        rule = fn.name.split("_")[1].upper()
        if not (rule in PORTED or fn.name in GENERIC):
            continue
        for st in fn.body:
            if (isinstance(st, ast.Assign) and len(st.targets) == 1 and isinstance(st.targets[0], ast.Name)
                    and isinstance(st.value, ast.Constant) and isinstance(st.value.value, str)):
                out[f"{fn.name}:{st.targets[0].id}"] = st.value.value
    return out


REFERENCE = reference_fixtures()
FIXTURE_PATH = os.path.join(REPO, "tests", "_fixture.py")


def findings(pkg, source, dynamic=True, rules=None):
    return pkg.analyze_file(FIXTURE_PATH, source=source, dynamic=dynamic, relpath="tests/_fixture.py",
                            rules=rules)


def rule_lines(found, keep=PORTED) -> set:
    return {(f.rule, f.line) for f in found if f.rule in keep}


def comparable(f) -> tuple:
    return (f.rule, f.path, f.line, f.message, f.context, f.fingerprint())


def same_hint(ref_hint: str, port_hint: str) -> bool:
    return port_hint in (ref_hint, ref_hint.replace("heat_tpu.", "heat_tpu_torch."))


def assert_equal_findings(ref_found, port_found):
    assert [comparable(f) for f in port_found] == [comparable(f) for f in ref_found]
    for r, p in zip(ref_found, port_found):
        assert same_hint(r.hint, p.hint), (r.rule, r.hint, p.hint)


# --------------------------------------------------------------------- #
# 1. every fixture of a ported rule has its twin, and the twin agrees     #
# --------------------------------------------------------------------- #
def test_every_reference_fixture_of_a_ported_rule_has_a_twin():
    assert len(REFERENCE) == 77
    assert sorted(REFERENCE) == sorted(TWINS)
    tested = {name.split("_")[1].upper() for name in (k.split(":")[0] for k in REFERENCE)
              if name not in GENERIC}
    # SPMD001 and the program rules have no fixture in the reference's file
    assert tested == set(PORTED[1:16])
    assert not {k for k in reference_fixtures_all() if k.split("_")[1].upper() in NOT_PORTED} & set(TWINS)


def reference_fixtures_all() -> set:
    tree = ast.parse(open(REF_TESTS, encoding="utf-8").read())
    return {fn.name for fn in tree.body if isinstance(fn, ast.FunctionDef) and fn.name.startswith("test_spmd")}


def test_every_twin_keeps_its_originals_line_count():
    for key, src in REFERENCE.items():
        assert len(TWINS[key].splitlines()) == len(src.splitlines()), key


@pytest.mark.parametrize("key", sorted(REFERENCE))
def test_twin_gives_the_reference_rule_lines(key):
    for dynamic in (True, False):
        want = rule_lines(findings(ref, REFERENCE[key], dynamic))
        got = rule_lines(findings(port, TWINS[key], dynamic))
        assert got == want, (dynamic, sorted(got), sorted(want))


def test_the_twins_fire_what_the_reference_fires():
    # the oracle is not vacuous: the twins fire every file-scope rule (SPMD001
    # at the reference's bare SPMD204 suppression)
    fired = {f.rule for key in REFERENCE for f in findings(port, TWINS[key])}
    assert fired == set(PORTED[:16])


# --------------------------------------------------------------------- #
# 2. the framework-agnostic rules on the same sources                    #
# --------------------------------------------------------------------- #
def _agnostic_sources() -> dict:
    out = {f"ref:{k}": v for k, v in REFERENCE.items() if k.split("_")[1].upper() in AGNOSTIC}
    out.update({f"twin:{k}": v for k, v in TWINS.items() if k.split("_")[1].upper() in AGNOSTIC})
    out["spmd001"] = SPMD001_SRC
    out["spmd001_reference_spelling"] = SPMD001_SRC.replace("heat_tpu_torch", "heat_tpu")
    return out


AGNOSTIC_SOURCES = _agnostic_sources()


@pytest.mark.parametrize("key", sorted(AGNOSTIC_SOURCES))
def test_agnostic_rules_give_equal_findings_on_the_same_source(key):
    src = AGNOSTIC_SOURCES[key]
    assert_equal_findings(findings(ref, src, rules=AGNOSTIC), findings(port, src, rules=AGNOSTIC))


def test_agnostic_sources_fire_every_agnostic_rule():
    fired = {f.rule for src in AGNOSTIC_SOURCES.values() for f in findings(port, src, rules=AGNOSTIC)}
    assert fired == set(AGNOSTIC)


@pytest.mark.parametrize("tree", ["heat_tpu", "heat_tpu_torch"])
def test_agnostic_rules_give_equal_findings_on_both_trees(tree):
    path = os.path.join(REPO, tree)
    want = ref.analyze_paths([path], root=REPO, rules=AGNOSTIC)
    got = port.analyze_paths([path], root=REPO, rules=AGNOSTIC)
    assert_equal_findings(want, got)


def _run_main(main, args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(args)
    return rc, out.getvalue()


def test_agnostic_rules_through_both_clis_json(tmp_path):
    for i, (key, src) in enumerate(sorted(AGNOSTIC_SOURCES.items())):
        (tmp_path / f"f{i:03d}.py").write_text(src)
    args = [str(tmp_path), "--no-cache", "--format", "json"] + [a for r in AGNOSTIC for a in ("--rule", r)]
    ref_rc, ref_out = _run_main(ref_cli.main, args)
    port_rc, port_out = _run_main(port_cli.main, args)
    ref_doc, port_doc = json.loads(ref_out), json.loads(port_out)
    assert ref_rc == port_rc == 1
    assert port_doc["count"] == ref_doc["count"] > 20
    strip = [{k: v for k, v in f.items() if k != "hint"} for f in ref_doc["findings"]]
    assert [{k: v for k, v in f.items() if k != "hint"} for f in port_doc["findings"]] == strip
    assert all(same_hint(r["hint"], p["hint"]) for r, p in zip(ref_doc["findings"], port_doc["findings"]))


# --------------------------------------------------------------------- #
# 3. the surface and the gate                                            #
# --------------------------------------------------------------------- #
def test_the_package_surface_is_the_references():
    from heat_tpu.analysis.core import _register_all_rules as ref_register
    from heat_tpu_torch.analysis.core import _register_all_rules as port_register

    ref_register()
    port_register()
    assert port.__all__ == ref.__all__
    ref_ids = [r.id for r in ref.all_rules()]
    assert [i for i in ref_ids if i not in NOT_PORTED] == [r.id for r in port.all_rules()] == PORTED
    for r in port.all_rules():
        assert r.scope == ref.RULES[r.id].scope and r.dynamic == ref.RULES[r.id].dynamic


def test_the_cli_gate_passes_on_the_ports_tree(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    proc = subprocess.run([sys.executable, "-m", "heat_tpu_torch.analysis.cli", "--baseline",
                           "--cache-dir", str(tmp_path / "cache")], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    last = proc.stdout.strip().splitlines()[-1]
    assert last.startswith("spmdlint: 0 new, 0 baselined, 0 stale baseline entries"), last
    files = sum(1 for _ in port.iter_py_files([os.path.join(REPO, "heat_tpu_torch")]))
    assert f"cache 0 hit, {files} miss" in last
