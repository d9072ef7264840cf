"""Per-call layout-transfer summaries: the auto-layout solver's search graph.

Port of ``heat_tpu/analysis/splitflow/summary.py``; the op layer's
declarations are the port's ``core/_split_semantics.py``.

:func:`layout_summary` projects one analyzed function's slice of the
:class:`~heat_tpu_torch.analysis.splitflow.engine.Program` event stream into
plain data — the input :class:`heat_tpu_torch.comm._costs.LayoutSolver`
searches.  Each *seam* is one layout-transfer event (explicit
``resplit``, layout no-op, or ``__binary_op``'s implicit reshard) with a
literal shape/dtype, the hand-placed ``src``/``dst`` layouts, and two
pieces of provenance the solver's chain DP needs:

``prev``
    the seam whose result this seam consumes, RECORDED ONLY when that
    intermediate is dead — directly nested
    (``x.resplit(1).resplit(None)``) or a single-use temporary (the
    SPMD502 single-load rule, via :meth:`Program.load_count`).  A dead
    intermediate's placement is the solver's to choose; a live one is
    pinned.
``alternatives``
    the op layer's declared legal placements for this seam's result
    (:func:`heat_tpu_torch.core._split_semantics.layout_alternatives`, a
    dependency-free import), enumerated for the target mesh rank —
    1-D splits or splits tuples.

A summary is ``complete`` only when every seam is modelable (literal
shape, known dtype, int/``None``/tuple layouts) and the function's
layout behavior is statically faithful: no seams under loops or
branches (call-order alignment with the plan would be unsound), no
in-place ``resplit_``, and no calls into local helpers that carry their
own layout traffic (interprocedural solving is future work).
``htt.autoshard`` falls back to the hand layout on incomplete summaries
rather than guess.

Everything returned is dicts/tuples on purpose: ``comm/_costs.py`` is
loaded by file path (stdlib-only) and must consume the summary without
importing this package.
"""

from __future__ import annotations

import ast
import importlib.util
import os
from typing import Dict, List, Optional

from .engine import CommEvent, Program

__all__ = ["layout_summary"]

_SEMANTICS_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "core", "_split_semantics.py",
)
_semantics_mod = None


def _semantics():
    """The op layer's declarations, loaded by file path (no package
    import, no torch) — the same discipline as :func:`report.load_costs`."""
    global _semantics_mod
    if _semantics_mod is None:
        import sys

        spec = importlib.util.spec_from_file_location(
            "heat_tpu_torch_split_semantics_static", _SEMANTICS_PATH
        )
        mod = importlib.util.module_from_spec(spec)
        # registered under the private static name so the dataclass
        # machinery can resolve the module at class-creation time
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
        _semantics_mod = mod
    return _semantics_mod

#: event ops that become seams, in the engine's emission vocabulary
_SEAM_OPS = ("resplit", "noop_collective", "implicit_resplit")


def _is_layout(x) -> bool:
    if x is None or isinstance(x, int):
        return True
    return isinstance(x, tuple) and all(
        g is None or isinstance(g, int) for g in x
    )


def _bound_name(ctx, node: ast.AST) -> Optional[str]:
    """Name an ``x = <seam>`` statement binds, if the seam IS the whole
    right-hand side (a nested seam has no name of its own)."""
    parent = ctx.parents.get(node)
    if isinstance(parent, ast.Assign) and parent.value is node:
        if len(parent.targets) == 1 and isinstance(parent.targets[0], ast.Name):
            return parent.targets[0].id
    return None


def _operand_expr(node: ast.AST) -> Optional[ast.AST]:
    """The expression a resplit call reads: ``x`` in ``x.resplit(a)`` or
    ``ht.resplit(x, a)``."""
    if not isinstance(node, ast.Call):
        return None
    if isinstance(node.func, ast.Attribute):
        return node.func.value
    if node.args:
        return node.args[0]
    return None


def _under_control_flow(ctx, node: ast.AST, fn: ast.AST) -> bool:
    cur = ctx.parents.get(node)
    while cur is not None and cur is not fn:
        if isinstance(cur, (ast.For, ast.While, ast.If, ast.Try)):
            return True
        cur = ctx.parents.get(cur)
    return False


def _assign_count(fn: ast.AST, name: str) -> int:
    n = 0
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == name:
                    n += 1
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            t = node.target
            if isinstance(t, ast.Name) and t.id == name:
                n += 1
    return n


def _fn_def(program: Program, ctx, qualname: str) -> Optional[ast.FunctionDef]:
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.FunctionDef):
            if Program._qual_of_def(ctx, node) == qualname:
                return node
    return None


def _callee_qualnames(program: Program, ctx, fn: ast.FunctionDef) -> List[str]:
    """Qualnames of local defs transitively reachable from ``fn`` by
    direct name calls (the summary's helper-traffic guard)."""
    out: List[str] = []
    seen = {fn.name}
    work = [fn]
    while work:
        cur = work.pop()
        for node in ast.walk(cur):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
                callee = ctx.module_function(node.func.id)
                if callee is not None and callee.name not in seen:
                    seen.add(callee.name)
                    out.append(Program._qual_of_def(ctx, callee))
                    work.append(callee)
    return out


def layout_summary(
    program: Program,
    qualname: str,
    *,
    module: Optional[str] = None,
    mesh_ndim: int = 1,
) -> Dict:
    """Export ``qualname``'s layout-transfer summary from ``program``.

    ``mesh_ndim`` selects the alternatives spelling (1 → int splits,
    N → splits tuples).  See the module docstring for the seam schema
    and the ``complete`` contract.
    """
    layout_alternatives = _semantics().layout_alternatives

    events: List[CommEvent] = [
        ev for ev in program.events
        if ev.qualname == qualname
        and (module is None or ev.ctx.module == module)
        and ev.fact.op in _SEAM_OPS
    ]
    events.sort(key=lambda ev: (
        ev.line, getattr(ev.node, "col_offset", 0), ev.fact.op,
    ))
    notes: List[str] = []
    complete = True

    ctx = events[0].ctx if events else None
    if ctx is None:
        for c in program.contexts:
            if module is not None and c.module != module:
                continue
            if _fn_def(program, c, qualname) is not None:
                ctx = c
                break
    if ctx is None:
        return {
            "function": qualname, "module": module, "path": None,
            "complete": False, "notes": [f"no analyzed def for {qualname!r}"],
            "seams": (),
        }
    fn = _fn_def(program, ctx, qualname)
    if fn is None:
        return {
            "function": qualname, "module": ctx.module, "path": ctx.relpath,
            "complete": False, "notes": [f"no def node for {qualname!r}"],
            "seams": (),
        }

    event_nodes = {id(ev.node) for ev in events}
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if node.func.attr == "resplit_":
                complete = False
                notes.append(
                    f"L{node.lineno}: in-place resplit_ rebinds layout "
                    "behind the summary's back"
                )
            elif node.func.attr == "resplit" and id(node) not in event_nodes:
                # the engine derived no layout fact for this call (dynamic
                # axis, unknown operand layout): the summary cannot see
                # all of the function's traffic, so it must not be solved
                complete = False
                notes.append(
                    f"L{node.lineno}: resplit with no statically derived "
                    "layout fact"
                )
    helper_quals = _callee_qualnames(program, ctx, fn)
    if helper_quals:
        noisy = sorted({
            ev.qualname for ev in program.events
            if ev.ctx is ctx and ev.qualname in helper_quals
            and ev.fact.op in _SEAM_OPS
        })
        if noisy:
            complete = False
            notes.append(
                "local helper(s) carry their own layout traffic: "
                + ", ".join(noisy)
            )
    oob = [
        ev for ev in program.events
        if ev.qualname == qualname and ev.ctx is ctx
        and ev.fact.op == "split_oob"
    ]
    if oob:
        complete = False
        notes.append("statically invalid split axis (SPMD503) in this function")

    seams: List[Dict] = []
    node_to_index: Dict[int, int] = {}
    var_to_index: Dict[str, int] = {}
    for i, ev in enumerate(events):
        f = ev.fact
        shape = f.shape
        modeled = (
            shape is not None
            and all(isinstance(s, int) for s in shape)
            and isinstance(f.dtype, str)
            and _is_layout(f.src) and _is_layout(f.dst)
        )
        if not modeled:
            complete = False
            notes.append(
                f"L{ev.line}: {f.op} with statically unknown "
                "shape/dtype/layout"
            )
        if _under_control_flow(ctx, ev.node, fn):
            complete = False
            notes.append(
                f"L{ev.line}: {f.op} under control flow — call order "
                "cannot be aligned with a static plan"
            )
        explicit = f.op in ("resplit", "noop_collective")
        var = _bound_name(ctx, ev.node) if explicit else None
        ndim = len(shape) if shape is not None else 0
        seam = {
            "index": i,
            "line": ev.line,
            "op": f.op,
            "shape": tuple(shape) if shape is not None else None,
            "dtype": f.dtype,
            "src": f.src,
            "dst": f.dst,
            "var": var,
            "pinned": True,
            "prev": None,
            "alternatives": (
                layout_alternatives("resplit", ndim, mesh_ndim)
                if explicit and modeled else ()
            ),
        }
        seams.append(seam)
        node_to_index[id(ev.node)] = i
        if var is not None:
            var_to_index[var] = i  # latest binding wins, in program order

        if explicit:
            operand = _operand_expr(ev.node)
            prev_i: Optional[int] = None
            if isinstance(operand, ast.Call) and id(operand) in node_to_index:
                prev_i = node_to_index[id(operand)]  # nested: dead by construction
            elif isinstance(operand, ast.Name):
                cand = var_to_index.get(operand.id)
                if (
                    cand is not None and cand != i
                    and program.load_count(ctx, fn, operand.id) == 1
                    and _assign_count(fn, operand.id) == 1
                ):
                    prev_i = cand
            if prev_i is not None and seams[prev_i]["op"] != "implicit_resplit":
                seam["prev"] = prev_i
                seams[prev_i]["pinned"] = False

    return {
        "function": qualname,
        "module": ctx.module,
        "path": ctx.relpath,
        "complete": complete,
        "notes": notes,
        "seams": tuple(seams),
    }
