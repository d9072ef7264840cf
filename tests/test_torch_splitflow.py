"""splitflow on the port: the reference's engine cases, held to the reference.

Every source below is the reference's ``tests/test_splitflow.py`` case,
written in the reference's spelling (``import heat_tpu as ht``).  The
reference's analyzer reads it as it is; the port's
(``heat_tpu_torch.analysis``) reads it with the package name swapped.
On every source the two must agree:

* the inferred split, shape and dtype of every local of every function
  (``Program.fn_envs``) and the return spec (``fn_specs``);
* every ``CommEvent``: site, op, shape, dtype, source and destination
  split, note;
* the SPMD501-505 findings: rule, path, line, message, hint and
  fingerprint;
* the cost report, field for field, but for the name of the cost model's
  file and the modeled times, which the two models' rates of a move
  between positions scale (``RATE_RATIO``).

Then each case's own assertion runs on the port's result, as the
reference's test states it.  The findings cache, the baseline and SPMD001
belong to the file-scope linter (``tests/test_torch_spmdlint.py``).
"""

import ast
import json
import os

import pytest

import heat_tpu.analysis.core as rcore
import heat_tpu.analysis.splitflow as rsf
import heat_tpu_torch.analysis.core as pcore
import heat_tpu_torch.analysis.splitflow as psf
from heat_tpu_torch.analysis import analyze_file
from heat_tpu_torch.analysis.core import FileContext
from heat_tpu_torch.analysis.splitflow import (
    NOT_ARRAY,
    Spec,
    TOP,
    UNKNOWN,
    apply_kind,
    build_program,
    cost_report,
    join,
    package_registry,
    static_registry,
)
from heat_tpu_torch.analysis.splitflow.registry import parse_declarations
from heat_tpu_torch.analysis.splitflow.transfer import NONLIT

from test_torch_reference_state import reference_state  # noqa: F401  (restores the JAX package's state)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_source(src: str) -> str:
    """The reference's spelling of a source, in the port's."""
    return src.replace("import heat_tpu as ht", "import heat_tpu_torch as ht").replace(
        "from heat_tpu.", "from heat_tpu_torch.")


def _contexts(core, sources, port: bool):
    ctxs = []
    for i, item in enumerate(sources):
        rel, src = item if isinstance(item, tuple) else (f"tests/_fix{i}.py", item)
        ctxs.append(core.FileContext(os.path.join(REPO, rel), source=port_source(src) if port else src,
                                     relpath=rel))
    return ctxs


def _spec(v) -> str:
    # Spec and ⊤ are classes of each package; their reprs are the same text
    return repr(v)


def envs_of(program) -> dict:
    return {key: {name: _spec(v) for name, v in env.items()} for key, env in program.fn_envs.items()}


def specs_of(program) -> dict:
    return {key: _spec(v) for key, v in program.fn_specs.items()}


def events_of(program, fmt) -> list:
    return [(ev.ctx.relpath, ev.line, getattr(ev.node, "col_offset", 0), ev.qualname, ev.fact.op,
             fmt(ev.fact.src), fmt(ev.fact.dst), ev.fact.shape, ev.fact.dtype, ev.fact.note)
            for ev in program.events]


def hold_programs(ref, mine) -> None:
    """The port's Program equals the reference's on the same source."""
    assert envs_of(mine) == envs_of(ref)
    assert specs_of(mine) == specs_of(ref)
    assert events_of(mine, psf.engine._fmt_split) == events_of(ref, rsf.engine._fmt_split)


def program_of(*sources):
    """Both packages' Programs of the sources (text, or ``(relpath, text)``),
    held equal; the port's is returned."""
    ref = rsf.build_program(_contexts(rcore, sources, port=False))
    mine = build_program(_contexts(pcore, sources, port=True))
    hold_programs(ref, mine)
    return mine


def lint(source, rule=None):
    """The port's findings on ``source``, held equal to the reference's
    of the rules the port has (its SPMD102, 209, 301 and 302 are left
    out: not ported)."""
    from heat_tpu_torch.analysis import RULES

    pcore._register_all_rules()
    path = os.path.join(REPO, "tests", "_fixture.py")
    ref = [f for f in rcore.analyze_file(path, source=source, relpath="tests/_fixture.py")
           if f.rule in RULES]
    mine = analyze_file(path, source=port_source(source), relpath="tests/_fixture.py")
    assert [f.to_dict() for f in mine] == [f.to_dict() for f in ref]
    if rule is not None:
        mine = [f for f in mine if f.rule == rule]
    return mine


def env_of(program, fn):
    for (_mod, qual), env in program.fn_envs.items():
        if qual == fn:
            return env
    raise AssertionError(f"no env for {fn}: {sorted(program.fn_envs)}")


#: the one number the two cost models set differently: the rate of a move
#: between positions (the reference's figure is a TPU link's, the port's
#: the card's roll), which divides every modeled critical path
RATE_RATIO = rsf.report.load_costs().DEFAULT_ICI_GBPS / psf.report.load_costs().DEFAULT_ICI_GBPS


def split_times(obj, times: list):
    """``obj`` with every ``*critical_path_ms`` value taken out into
    ``times`` (in walk order)."""
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if k.endswith("critical_path_ms"):
                times.append(v)
                out[k] = "<ms>"
            else:
                out[k] = split_times(v, times)
        return out
    if isinstance(obj, (list, tuple)):
        return type(obj)(split_times(v, times) for v in obj)
    return obj


def hold_times(mine: list, ref: list) -> None:
    """Each modeled time of the port is the reference's at the port's rate."""
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k] == pytest.approx(b[k] * RATE_RATIO, rel=1e-12, abs=0.0)


def report_pair(program_ref, program_mine, **kw):
    """The cost report of both packages: equal but for the model's file
    name and the modeled times, which scale by :data:`RATE_RATIO`."""
    ref = rsf.cost_report(program_ref, **kw)
    mine = cost_report(program_mine, **kw)
    assert ref.pop("cost_model") == "heat_tpu/comm/_costs.py"
    assert mine.pop("cost_model") == "heat_tpu_torch/comm/_costs.py"
    t_ref, t_mine = [], []
    assert split_times(mine, t_mine) == split_times(ref, t_ref)
    hold_times(t_mine, t_ref)
    return mine


# --------------------------------------------------------------------- #
# the sources                                                            #
# --------------------------------------------------------------------- #
SOURCES = {
    "helper": """
import heat_tpu as ht

def helper(x):
    return x.resplit(1)

def caller():
    a = ht.ones((8, 8), split=0)
    b = helper(a)
    return b
""",
    "star_import": """
from heat_tpu.core.factories import *

def f():
    a = ones((8, 8), split=0)
    return a
""",
    "type_checking": """
from typing import TYPE_CHECKING
if TYPE_CHECKING:
    from heat_tpu.core.dndarray import DNDarray
import heat_tpu as ht

def f(x: "DNDarray"):
    a = ht.ones((8, 8), split=1)
    return a
""",
    "loops": """
import heat_tpu as ht

def f():
    a = ht.ones((8, 8), split=0)
    for _ in range(3):
        a = a + 1.0
    b = ht.ones((8, 8), split=0)
    for _ in range(3):
        b = b.resplit(1)
    return a, b
""",
    "branch": """
import heat_tpu as ht

def f(flag):
    a = ht.ones((8, 8), split=0)
    if flag:
        a = a.resplit(1)
    return a
""",
    "inplace": """
import heat_tpu as ht

def f():
    a = ht.ones((8, 8), split=0)
    a.resplit_(1)
    return a
""",
    "svd_unpack": """
import heat_tpu as ht

def f():
    a = ht.ones((64, 8), split=0)
    u, s, v = ht.linalg.svd(a)
    return u, s, v
""",
    "qr_unpack": """
import heat_tpu as ht

def f():
    a = ht.ones((64, 8), split=0)
    q, r = ht.linalg.qr(a)
    return q, r
""",
    "recursion": """
import heat_tpu as ht

def spin(x):
    return spin(x.resplit(1))

def f():
    a = ht.ones((8, 8), split=0)
    b = spin(a)
    return b
""",
    "spmd501": """
import heat_tpu as ht

def f():
    a = ht.ones((8, 8), split=0)
    b = ht.ones((8, 8), split=1)
    return a + b
""",
    "spmd501_clean": """
import heat_tpu as ht

def f():
    a = ht.ones((8, 8), split=0)
    b = ht.ones((8, 8), split=0)
    return a + b
""",
    "spmd501_suppressed": """
import heat_tpu as ht

def f():
    a = ht.ones((8, 8), split=0)
    b = ht.ones((8, 8), split=1)
    return a + b  # spmdlint: disable=SPMD501 -- mixed layouts on purpose
""",
    "spmd502_nested": """
import heat_tpu as ht

def f():
    a = ht.ones((8, 8), split=0)
    return a.resplit(1).resplit(None)
""",
    "spmd502_single_use": """
import heat_tpu as ht

def f():
    a = ht.ones((8, 8), split=0)
    t = a.resplit(1)
    return t.resplit(None)
""",
    "spmd502_used": """
import heat_tpu as ht

def f():
    a = ht.ones((8, 8), split=0)
    t = a.resplit(1)
    col_sum = t.sum(axis=0)
    return t.resplit(None), col_sum
""",
    "spmd503_factory": """
import heat_tpu as ht

def f():
    return ht.ones((8, 8), split=2)
""",
    "spmd503_resplit": """
import heat_tpu as ht

def f():
    a = ht.ones((8, 8), split=0)
    return a.resplit(5)
""",
    "spmd503_clean": """
import heat_tpu as ht

def f():
    return ht.ones((8, 8), split=1)
""",
    "spmd503_grid_no_comm": """
import heat_tpu as ht

def f():
    return ht.ones((8, 8), splits=(0, 1))
""",
    "spmd503_arity": """
import heat_tpu as ht

def f():
    return ht.ones((8, 8), splits=(0, None, None))
""",
    "spmd503_duplicate_axis": """
import heat_tpu as ht

def f():
    g = ht.grid_comm((2, 2))
    return ht.ones((8, 8), splits=(0, 0), comm=g)
""",
    "spmd503_grid_with_comm": """
import heat_tpu as ht

def f():
    g = ht.grid_comm((2, 2))
    return ht.ones((8, 8), splits=(0, 1), comm=g)
""",
    "spmd503_one_hot": """
import heat_tpu as ht

def f():
    return ht.ones((8, 8), splits=(0, None))
""",
    "spmd503_resplit_tuple": """
import heat_tpu as ht

def f():
    a = ht.ones((8, 8), split=0)
    return a.resplit((0, 1, None))
""",
    "spmd504_tuple": """
import heat_tpu as ht

def f():
    a = ht.ones((8, 8), split=0)
    return a.resplit((0, None))
""",
    "grid_matmul": """
import heat_tpu as ht

def f():
    g = ht.grid_comm((2, 2))
    a = ht.ones((8, 8), splits=(0, 1), comm=g)
    b = ht.ones((8, 8), splits=(0, 1), comm=g)
    c = a @ b
    return c
""",
    "spmd504": """
import heat_tpu as ht

def f():
    a = ht.ones((8, 8), split=0)
    return a.resplit(0)
""",
    "spmd504_inplace": """
import heat_tpu as ht

def f():
    a = ht.ones((8, 8), split=0)
    a.resplit_(None)
    a.resplit_(0)
    return a
""",
    "spmd505_decorator": """
import heat_tpu as ht

@ht.autoshard
def pipeline():
    a = ht.ones((8, 8), split=0)
    return a.resplit(1)
""",
    "spmd505_inline": """
import heat_tpu as ht

def pipeline():
    a = ht.ones((8, 8), split=0)
    return a.resplit(1)

solved = ht.autoshard(pipeline)
""",
    "spmd505_plain": """
import heat_tpu as ht

def pipeline():
    a = ht.ones((8, 8), split=0)
    return a.resplit(1)
""",
    "spmd505_layout_free": """
import heat_tpu as ht

@ht.autoshard
def pipeline(x, y):
    return ht.sqrt(ht.abs(x + y))
""",
    "spmd505_suppressed": """
import heat_tpu as ht

@ht.autoshard
def pipeline():
    a = ht.ones((8, 8), split=0)
    return a.resplit(1)  # spmdlint: disable=SPMD505
""",
    "unknown_params": """
import heat_tpu as ht

def f(a, b):
    c = a + b
    return c.resplit(0)
""",
    "cost": """
import heat_tpu as ht

def mover():
    x = ht.ones((64, 8), dtype=ht.float32, split=0)
    y = x.resplit(1)
    return y
""",
    "cost_dynamic": """
import heat_tpu as ht

def f(n):
    x = ht.ones(n, split=0)
    return x.resplit(1)
""",
}

COST_SRC = SOURCES["cost"]


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_program_equals_reference(name):
    """Envs, return specs and CommEvents of the port's Program are the
    reference's, on every source."""
    prog = program_of(SOURCES[name])
    assert prog.fn_envs  # every source defines a function


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_findings_equal_reference(name):
    lint(SOURCES[name])


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_cost_report_equals_reference(name):
    """At 1, 2, 4 and 8 positions, under every collective precision."""
    ref = rsf.build_program(_contexts(rcore, [SOURCES[name]], port=False))
    mine = build_program(_contexts(pcore, [SOURCES[name]], port=True))
    for mesh in (1, 2, 4, 8):
        for precision in ("f32", "int8_block", "bf16", "auto"):
            report_pair(ref, mine, mesh=mesh, precision=precision)


# --------------------------------------------------------------------- #
# domain lattice                                                         #
# --------------------------------------------------------------------- #
def test_join_is_least_upper_bound():
    s0 = Spec(split=0)
    s1 = Spec(split=1)
    srep = Spec(split=None)
    assert join(s0, s0).split == 0
    assert join(s0, s1).split is TOP
    assert join(s0, srep).split is TOP  # replicated is a KNOWN layout
    assert join(s0, UNKNOWN).split is TOP
    assert join(UNKNOWN, UNKNOWN).split is TOP


def test_join_merges_shape_dtype_componentwise():
    a = Spec(split=0, shape=(8, 8), dtype="float32")
    b = Spec(split=0, shape=(8, 8), dtype="float32")
    j = join(a, b)
    assert (j.split, j.shape, j.dtype) == (0, (8, 8), "float32")
    j2 = join(a, Spec(split=0, shape=(4, 4), dtype="int32"))
    assert j2.split == 0 and j2.shape is None and j2.dtype is None


def test_join_non_array_with_array_stays_sound():
    assert join(NOT_ARRAY, NOT_ARRAY) is NOT_ARRAY
    assert join(Spec(split=0), NOT_ARRAY).is_array  # mixed -> array, split ⊤


def test_lattice_height_two_loops_converge_in_two_passes():
    vals = [Spec(split=0), Spec(split=1), Spec(split=None), UNKNOWN]
    for a in vals:
        for b in vals:
            j = join(a, b)
            assert join(j, b).split == j.split
            assert join(j, a).split == j.split


# --------------------------------------------------------------------- #
# transfer functions: the port's against the reference's                  #
# --------------------------------------------------------------------- #
def _both_kinds(kind, operands, **params):
    """apply_kind in both packages on the same abstract operands."""
    def conv(mod, v):
        if v is TOP:
            return mod.TOP
        if isinstance(v, Spec):
            split = mod.TOP if v.split is TOP else v.split
            return mod.Spec(split=split, shape=v.shape, dtype=v.dtype, ragged=v.ragged, is_array=v.is_array)
        return v

    def conv_param(mod, v):
        if v is NONLIT:
            return mod.transfer.NONLIT
        return conv(mod, v)

    mine = apply_kind(kind, operands, **params)
    ref = rsf.apply_kind(kind, [conv(rsf, o) for o in operands],
                         **{k: conv_param(rsf, v) for k, v in params.items()})
    fmt = lambda facts: [(f.op, repr(f.src), repr(f.dst), f.shape, f.dtype, f.note) for f in facts]  # noqa: E731
    assert repr(mine[0]) == repr(ref[0])
    assert fmt(mine[1]) == fmt(ref[1])
    return mine


def test_binary_left_anchor_and_implicit_resplit_fact():
    a = Spec(split=0, shape=(8, 8), dtype="float32")
    b = Spec(split=1, shape=(8, 8), dtype="float32")
    out, facts = _both_kinds("binary", [a, b])
    assert out.split == 0
    assert [f.op for f in facts] == ["implicit_resplit"]
    assert (facts[0].src, facts[0].dst) == (1, 0)
    out, facts = _both_kinds("binary", [a, a])
    assert out.split == 0 and facts == []


def test_reduction_drops_or_shifts_the_split():
    x = Spec(split=1, shape=(4, 8, 16), dtype="float32")
    out, facts = _both_kinds("reduction", [x], axis=1)
    assert out.split is None
    assert [f.op for f in facts] == ["reduce"]
    out, facts = _both_kinds("reduction", [x], axis=0)
    assert out.split == 0 and facts == []
    out, _ = _both_kinds("reduction", [Spec(split=0, shape=(4, 8))], axis=1)
    assert out.split == 0
    out, _ = _both_kinds("reduction", [x], axis=None)
    assert out.split is None
    out, _ = _both_kinds("reduction", [x])
    assert out.split is TOP


def test_matmul_row_and_column_anchors():
    a = Spec(split=0, shape=(8, 4), dtype="float32")
    b = Spec(split=None, shape=(4, 8), dtype="float32")
    out, _ = _both_kinds("matmul", [a, b])
    assert out.split == 0
    out, _ = _both_kinds("matmul", [Spec(split=None, shape=(8, 4)), Spec(split=1, shape=(4, 8))])
    assert out.split == 1
    out, facts = _both_kinds("matmul", [Spec(split=1, shape=(8, 4)), Spec(split=None, shape=(4, 8))])
    assert out.split is None
    assert [f.op for f in facts] == ["reduce"]


def test_transpose_permutes_the_split():
    x = Spec(split=0, shape=(4, 8, 16), dtype="float32")
    out, _ = _both_kinds("transpose", [x], axis=(2, 0, 1))
    assert out.split == 1
    out, _ = _both_kinds("transpose", [x], axis=None)
    assert out.split == 2
    out, _ = _both_kinds("transpose", [x])
    assert out.split is TOP


def test_reshape_keeps_in_range_split():
    x = Spec(split=1, shape=(8, 8), dtype="float32")
    out, _ = _both_kinds("reshape", [x], shape=(8, 4, 2))
    assert out.split == 1
    out, _ = _both_kinds("flatten", [x])
    assert out.split == 0


def test_resplit_emits_facts():
    x = Spec(split=0, shape=(8, 8), dtype="float32")
    out, facts = _both_kinds("resplit", [x], split=1)
    assert out.split == 1
    assert [f.op for f in facts] == ["resplit"]
    out, facts = _both_kinds("resplit", [x], split=0)
    assert [f.op for f in facts] == ["noop_collective"]
    out, facts = _both_kinds("resplit", [x], split=5)
    assert [f.op for f in facts] == ["split_oob"]
    out, facts = _both_kinds("resplit", [x], split=NONLIT)
    assert out.split is TOP and facts == []


def test_factory_literals_and_oob():
    out, facts = _both_kinds("factory", [], shape=(8, 8), split=1, dtype="float32")
    assert (out.split, out.shape, out.dtype) == (1, (8, 8), "float32")
    assert facts == []
    _, facts = _both_kinds("factory", [], shape=(8, 8), split=3)
    assert [f.op for f in facts] == ["split_oob"]
    out, _ = _both_kinds("factory", [], shape=(8, 8), split=NONLIT)
    assert out.split is TOP


def test_entry_svd_tall_and_wide():
    u, s, v = _both_kinds("entry_svd", [Spec(split=0, shape=(64, 8))])[0]
    assert (u.split, s.split, v.split) == (0, None, None)
    u, s, v = _both_kinds("entry_svd", [Spec(split=1, shape=(8, 64))])[0]
    assert (u.split, v.split) == (None, 0)


def test_entry_svd_grid_layouts():
    u, s, v = _both_kinds("entry_svd", [Spec(split=(0, 1), shape=(64, 8))])[0]
    assert (u.split, s.split, v.split) == ((0, 1), None, None)
    u, s, v = _both_kinds("entry_svd", [Spec(split=(1, 0), shape=(8, 64))])[0]
    assert (u.split, s.split, v.split) == (None, None, (0, 1))
    u, s, v = _both_kinds("entry_svd", [Spec(split=(0, 1))])[0]
    assert u.split is TOP and v.split is TOP and s.split is None
    out = _both_kinds("entry_svd", [Spec(split=(0, 1), shape=(64, 8))], compute_uv=False)[0]
    assert out.split is None


def test_entry_qr_grid_and_1d():
    q, r = _both_kinds("entry_qr", [Spec(split=(0, 1), shape=(64, 8))])[0]
    assert (q.split, r.split) == ((0, 1), (None, 1))
    q, r = _both_kinds("entry_qr", [Spec(split=0, shape=(64, 8))])[0]
    assert (q.split, r.split) == (0, None)
    q, r = _both_kinds("entry_qr", [Spec(split=1, shape=(64, 8))])[0]
    assert (q.split, r.split) == (1, 1)
    q, r = _both_kinds("entry_qr", [Spec(split=None, shape=(64, 8))])[0]
    assert (q.split, r.split) == (None, None)
    q, r = _both_kinds("entry_qr", [Spec(split=(1, 0), shape=(64, 8))])[0]
    assert q.split is TOP and r.split is TOP
    q, r = _both_kinds("entry_qr", [Spec(split=(0, 1), shape=(64, 8))], calc_q=False)[0]
    assert not q.is_array and r.split == (None, 1)


def test_matmul_rank_local_grid_layouts():
    row = Spec(split=(0, None), shape=(64, 32))
    col = Spec(split=(None, 1), shape=(32, 16))
    out, facts = _both_kinds("matmul", [row, col])
    assert out.split == (0, 1) and facts == []
    out, facts = _both_kinds("matmul", [Spec(split=(None, 1), shape=(64, 32)),
                                        Spec(split=(0, None), shape=(32, 16))])
    assert out.split == (0, 1) and facts == []
    out, _ = _both_kinds("matmul", [row, Spec(split=(0, 1), shape=(32, 16))])
    assert out.split is TOP


def test_unknown_operands_stay_unknown():
    out, facts = _both_kinds("binary", [UNKNOWN, Spec(split=1)])
    assert out.split is TOP and facts == []
    out, facts = _both_kinds("resplit", [UNKNOWN], split=1)
    assert out.split == 1
    assert facts == []


# --------------------------------------------------------------------- #
# the static registry                                                    #
# --------------------------------------------------------------------- #
def test_package_registry_parses_the_ports_declarations():
    reg = package_registry()
    assert len(reg) > 50
    assert reg["add"].kind == "binary"
    assert reg["resplit"].kind == "resplit"
    assert reg["ones"].kind == "factory"
    assert reg["svd"].kind == "entry_svd"
    assert reg["qr"].kind == "entry_qr"
    from heat_tpu_torch.analysis.splitflow import registry

    assert registry._package_root() == os.path.join(REPO, "heat_tpu_torch")


def test_parse_declarations_all_three_forms():
    tree = ast.parse(
        "declare_split_semantics_table('m', {'binary': ('f', 'g')})\n"
        "declare_split_semantics('h', 'reduction')\n"
        "@split_semantics('elementwise')\n"
        "def k(x):\n    return x\n"
    )
    decls = parse_declarations(tree)
    assert {n: d.kind for n, d in decls.items()} == {
        "f": "binary", "g": "binary", "h": "reduction", "k": "elementwise",
    }


def test_static_registry_merges_fixture_trees():
    tree = ast.parse("declare_split_semantics('my_op', 'elementwise')")
    merged = static_registry([tree])
    assert merged["my_op"].kind == "elementwise"
    assert "my_op" not in package_registry()


# --------------------------------------------------------------------- #
# the engine                                                             #
# --------------------------------------------------------------------- #
def test_interprocedural_propagation_through_helper():
    assert env_of(program_of(SOURCES["helper"]), "caller")["b"].split == 1


def test_star_import_resolves_factory():
    spec = env_of(program_of(SOURCES["star_import"]), "f")["a"]
    assert (spec.split, spec.shape) == (0, (8, 8))


def test_type_checking_imports_do_not_break_resolution():
    assert env_of(program_of(SOURCES["type_checking"]), "f")["a"].split == 1


@pytest.mark.parametrize("init_src", [
    "from .impl import helper\n",
    "from .impl import *\n",
])
def test_reexport_through_package_init(init_src):
    prog = program_of(
        ("pkg/impl.py", "def helper(x):\n    return x.resplit(1)\n"),
        ("pkg/__init__.py", init_src),
        ("use.py", """
import heat_tpu as ht
from pkg import helper

def caller():
    a = ht.ones((8, 8), split=0)
    b = helper(a)
    return b
"""),
    )
    assert env_of(prog, "caller")["b"].split == 1


@pytest.mark.parametrize("name,module", [
    ("heat_tpu_torch.comm.plan", "heat_tpu_torch.comm.redistribute"),
    ("heat_tpu_torch.comm.collective_precision", "heat_tpu_torch.comm.compressed"),
])
def test_real_comm_init_reexports_resolve(name, module):
    """``comm/__init__``'s re-exports resolve to the defining module, as
    the reference's resolve through its own ``comm/__init__``."""
    files = ["heat_tpu_torch/comm/__init__.py", "heat_tpu_torch/comm/redistribute.py",
             "heat_tpu_torch/comm/compressed.py"]
    ctxs = [FileContext(os.path.join(REPO, f), relpath=f) for f in files]
    prog = build_program(ctxs)
    resolved = prog.resolve_def(name)
    assert resolved is not None
    ctx, fn = resolved
    assert ctx.module == module and fn.name == name.rsplit(".", 1)[-1]


def test_loop_fixpoint_stable_and_widening():
    env = env_of(program_of(SOURCES["loops"]), "f")
    assert env["a"].split == 0
    assert env["b"].split is TOP


def test_branch_join_widens_disagreeing_layouts():
    assert env_of(program_of(SOURCES["branch"]), "f")["a"].split is TOP


def test_inplace_resplit_rebinds_the_receiver():
    assert env_of(program_of(SOURCES["inplace"]), "f")["a"].split == 1


def test_tuple_unpacking_of_svd():
    env = env_of(program_of(SOURCES["svd_unpack"]), "f")
    assert env["u"].split == 0
    assert env["s"].split is None
    assert env["v"].split is None


def test_tuple_unpacking_of_qr():
    env = env_of(program_of(SOURCES["qr_unpack"]), "f")
    assert env["q"].split == 0
    assert env["r"].split is None


def test_recursion_terminates_at_unknown():
    assert env_of(program_of(SOURCES["recursion"]), "f")["b"].split is TOP


def test_reference_factories_are_not_creation_kinds_here():
    """A factory reached through ``heat_tpu.`` creates no array for the
    port's engine (only ``heat_tpu_torch`` does); the reference's own
    engine takes it."""
    src = SOURCES["spmd501"]
    path = os.path.join(REPO, "tests", "_fix0.py")
    mine = build_program([FileContext(path, source=src, relpath="tests/_fix0.py")])
    env = env_of(mine, "f")
    assert not env["a"].is_array and not env["b"].is_array
    assert not mine.events
    ref = rsf.build_program([rcore.FileContext(path, source=src, relpath="tests/_fix0.py")])
    assert env_of(ref, "f")["a"].split == 0
    # a package whose name merely starts with the port's is no creator either
    other = src.replace("import heat_tpu as ht", "import heat_tpu_torchlike as ht")
    env = env_of(build_program([FileContext(path, source=other, relpath="tests/_fix0.py")]), "f")
    assert not env["a"].is_array
    assert analyze_file(path, source=src, relpath="tests/_fix0.py") == []


# --------------------------------------------------------------------- #
# SPMD501-505                                                            #
# --------------------------------------------------------------------- #
def test_spmd501_triggers_on_disagreeing_binary_splits():
    findings = lint(SOURCES["spmd501"], "SPMD501")
    assert findings, "split-0 + split-1 must fire SPMD501"
    assert "implicit" in findings[0].message


def test_spmd501_clean_on_matching_splits():
    assert lint(SOURCES["spmd501_clean"], "SPMD501") == []


def test_spmd501_suppressible_inline():
    assert lint(SOURCES["spmd501_suppressed"], "SPMD501") == []


def test_spmd502_triggers_on_chained_resplit():
    assert lint(SOURCES["spmd502_nested"], "SPMD502")


def test_spmd502_triggers_on_single_use_intermediate():
    assert lint(SOURCES["spmd502_single_use"], "SPMD502")


def test_spmd502_clean_when_intermediate_is_used():
    assert lint(SOURCES["spmd502_used"], "SPMD502") == []


def test_spmd503_triggers_on_out_of_range_factory_split():
    assert lint(SOURCES["spmd503_factory"], "SPMD503")


def test_spmd503_triggers_on_out_of_range_resplit():
    assert lint(SOURCES["spmd503_resplit"], "SPMD503")


def test_spmd503_clean_in_range():
    assert lint(SOURCES["spmd503_clean"], "SPMD503") == []


def test_spmd503_triggers_on_grid_splits_without_comm():
    findings = lint(SOURCES["spmd503_grid_no_comm"], "SPMD503")
    assert findings and "mesh" in findings[0].message


def test_spmd503_triggers_on_splits_arity_mismatch():
    assert lint(SOURCES["spmd503_arity"], "SPMD503")


def test_spmd503_triggers_on_duplicate_mesh_axis():
    assert lint(SOURCES["spmd503_duplicate_axis"], "SPMD503")


def test_spmd503_clean_on_grid_splits_with_comm():
    assert lint(SOURCES["spmd503_grid_with_comm"], "SPMD503") == []


def test_spmd503_clean_on_one_hot_splits_tuple():
    assert lint(SOURCES["spmd503_one_hot"], "SPMD503") == []


def test_spmd503_triggers_on_resplit_tuple_arity_mismatch():
    assert lint(SOURCES["spmd503_resplit_tuple"], "SPMD503")


def test_spmd504_triggers_on_noop_tuple_resplit():
    assert lint(SOURCES["spmd504_tuple"], "SPMD504")


def test_tuple_splits_flow_through_matmul():
    env = env_of(program_of(SOURCES["grid_matmul"]), "f")
    assert env["a"].split == (0, 1)
    assert env["c"].split == (0, 1)


def test_spmd504_triggers_on_noop_resplit():
    assert lint(SOURCES["spmd504"], "SPMD504")


def test_spmd504_clean_after_inplace_layout_change():
    assert lint(SOURCES["spmd504_inplace"], "SPMD504") == []


def test_spmd505_triggers_on_resplit_under_autoshard_decorator():
    findings = lint(SOURCES["spmd505_decorator"], "SPMD505")
    assert findings and "solver owns" in findings[0].message


def test_spmd505_triggers_on_inline_wrapped_def():
    assert lint(SOURCES["spmd505_inline"], "SPMD505")


def test_spmd505_clean_without_autoshard():
    assert lint(SOURCES["spmd505_plain"], "SPMD505") == []


def test_spmd505_clean_for_layout_free_autoshard_body():
    assert lint(SOURCES["spmd505_layout_free"], "SPMD505") == []


def test_spmd505_suppression_honored():
    assert lint(SOURCES["spmd505_suppressed"], "SPMD505") == []


def test_program_rules_never_fire_on_unknown_layouts():
    assert [f for f in lint(SOURCES["unknown_params"]) if f.rule.startswith("SPMD5")] == []


def test_only_the_program_rules_are_registered():
    # the program-scope rules are SPMD501-505; the file-scope linter's
    # ported rules come before them (tests/test_torch_spmdlint.py)
    from heat_tpu_torch.analysis import all_rules

    lint(SOURCES["spmd501"])
    assert [r.id for r in all_rules()] == [
        "SPMD001", "SPMD101", "SPMD201", "SPMD202", "SPMD203", "SPMD204", "SPMD205",
        "SPMD206", "SPMD207", "SPMD208", "SPMD210", "SPMD211", "SPMD212", "SPMD213",
        "SPMD214", "SPMD401", "SPMD501", "SPMD502", "SPMD503", "SPMD504", "SPMD505",
    ]
    assert [r.id for r in all_rules() if r.scope == "program"] == [
        "SPMD501", "SPMD502", "SPMD503", "SPMD504", "SPMD505"]


# --------------------------------------------------------------------- #
# cost report                                                            #
# --------------------------------------------------------------------- #
def test_cost_report_prices_with_the_runtime_model():
    from heat_tpu_torch.comm import _costs

    rep = cost_report(program_of(COST_SRC), mesh=8, precision="f32")
    site = "tests/_fix0.py::mover"
    assert site in rep["functions"]
    expected = _costs.plan_cost(
        (64, 8), "float32", 0, 1, 8,
        mode_for=lambda n: _costs.resolve_mode("float32", n, "f32"),
    )
    assert rep["functions"][site]["modeled_wire_bytes"] == expected["wire_bytes"]
    assert rep["totals"]["modeled_wire_bytes"] == expected["wire_bytes"]
    assert rep["totals"]["unmodeled_events"] == 0
    assert rep["cost_model"] == "heat_tpu_torch/comm/_costs.py"


def test_cost_report_counts_unpriceable_events():
    rep = cost_report(program_of(SOURCES["cost_dynamic"]), mesh=8)
    assert rep["totals"]["unmodeled_events"] == 1
    assert rep["totals"]["modeled_wire_bytes"] == 0


def test_cost_report_is_deterministic():
    a = json.dumps(cost_report(program_of(COST_SRC), mesh=8), sort_keys=True)
    b = json.dumps(cost_report(program_of(COST_SRC), mesh=8), sort_keys=True)
    assert a == b


def test_cost_report_render_table_equals_reference():
    from heat_tpu_torch.analysis.splitflow import render_table

    ref = rsf.cost_report(rsf.build_program(_contexts(rcore, [COST_SRC], port=False)), mesh=4)
    mine = cost_report(program_of(COST_SRC), mesh=4)
    out = render_table(mine)
    assert "mover" in out and "TOTAL" in out
    assert out == rsf.render_table(ref).replace("heat_tpu/comm", "heat_tpu_torch/comm")
    assert RATE_RATIO == 45.0 / 790.5


def test_cost_model_loads_as_the_ports_own_module():
    """The by-path modules carry names of the port's own, so the two
    analyzers in one process never price with each other's model."""
    from heat_tpu_torch.analysis.splitflow import report, summary

    mine = report.load_costs()
    assert mine.__name__ == "heat_tpu_torch_comm_costs_static"
    assert mine.__file__ == os.path.join(REPO, "heat_tpu_torch", "comm", "_costs.py")
    assert summary._semantics().__name__ == "heat_tpu_torch_split_semantics_static"
    assert summary._semantics().__file__ == os.path.join(REPO, "heat_tpu_torch", "core",
                                                         "_split_semantics.py")
    ref = rsf.report.load_costs()
    assert ref.__file__ == os.path.join(REPO, "heat_tpu", "comm", "_costs.py")
    assert mine.DEFAULT_ICI_GBPS != ref.DEFAULT_ICI_GBPS  # each prices with its own model
