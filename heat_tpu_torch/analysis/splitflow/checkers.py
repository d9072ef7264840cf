"""Program-scope rules over the splitflow dataflow results.

Port of ``heat_tpu/analysis/splitflow/checkers.py``: the same rules,
messages and hints (the hints name ``ht.autoshard`` as the reference's
do, so findings compare equal across the two packages).

Each checker receives the whole :class:`~heat_tpu_torch.analysis.splitflow.engine.Program`
and translates the engine's :class:`CommEvent` stream into findings.
All four fire only on *known* layout facts — a ⊤ anywhere in the derived
state produces no event, so these rules cannot guess.

SPMD501 implicit resplit
    ``__binary_op`` silently reshards its right operand when both
    operands are split along different axes.  The program still computes
    the right answer — it just moves a whole operand over the wire on
    every evaluation, invisibly.  Resplit one input once, up front.

SPMD502 redundant resplit chain
    ``x.resplit(1).resplit(0)`` (directly nested, or through a
    single-use temporary) materializes an intermediate layout nothing
    reads.  Each hop is a full collective; go to the final split in one.

SPMD503 split axis out of range
    A literal split/resplit axis outside ``[-ndim, ndim)`` for a value of
    statically-known rank is a guaranteed ``ValueError`` from
    ``sanitize_axis`` at runtime.  A lint finding beats a crash at step
    40k of a training run.

SPMD504 layout collective on a replicated/identical layout
    ``resplit`` to the split the value already has (including
    ``resplit(None)`` of a value inferred replicated) is a no-op
    layout-wise, but still walks the full plan/dispatch path every call.
    Delete it, or gate it on ``x.split != target``.

SPMD505 hand-placed resplit inside an autoshard-wrapped function
    Under ``htt.autoshard`` the solver owns interior layout: every
    non-final placement is searched and may be rerouted or elided, so a
    hand resplit there is at best a request the plan overrides and at
    worst forces an incomplete summary back onto the hand layout.  Keep
    layout out of solved pipelines (or suppress where a pinned hop is
    genuinely intended).
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from ..rules import Finding, rule
from .engine import Program, _fmt_split

__all__ = [
    "check_implicit_resplit", "check_resplit_chain",
    "check_split_out_of_range", "check_noop_collective",
    "check_autoshard_hand_layout",
]


def _findings_for(program: Program, op: str, build) -> List[Finding]:
    out: List[Finding] = []
    seen: set = set()
    for ev in program.events:
        if ev.fact.op != op:
            continue
        message, hint = build(ev)
        f = ev.ctx.finding(_RULE_FOR[op], ev.node, message, hint)
        if f is None:
            continue
        fp = f.fingerprint()
        if fp in seen:
            continue
        seen.add(fp)
        out.append(f)
    return out


_RULE_FOR = {
    "implicit_resplit": "SPMD501",
    "resplit_chain": "SPMD502",
    "split_oob": "SPMD503",
    "noop_collective": "SPMD504",
}


@rule("SPMD501", "implicit resplit: operand splits disagree", scope="program")
def check_implicit_resplit(program: Program) -> Iterable[Finding]:
    def build(ev):
        f = ev.fact
        where = f" of shape {f.shape}" if f.shape is not None else ""
        return (
            f"operands are split along axes {_fmt_split(f.src)} and "
            f"{_fmt_split(f.dst)}; the right operand{where} is implicitly "
            f"resharded to split={_fmt_split(f.dst)} on every evaluation",
            "resplit one operand explicitly (once, outside any loop) so "
            "the wire cost is visible and paid a single time",
        )

    return _findings_for(program, "implicit_resplit", build)


@rule("SPMD502", "redundant resplit chain", scope="program")
def check_resplit_chain(program: Program) -> Iterable[Finding]:
    def build(ev):
        return (
            "resplit of a value that is itself a fresh resplit result; "
            "the intermediate layout is never used",
            "collapse the chain into a single resplit to the final axis — "
            "each hop is a full redistribution collective",
        )

    return _findings_for(program, "resplit_chain", build)


@rule("SPMD503", "split axis statically out of range", scope="program")
def check_split_out_of_range(program: Program) -> Iterable[Finding]:
    def build(ev):
        f = ev.fact
        ndim = len(f.shape) if f.shape is not None else "?"
        if isinstance(f.dst, tuple):
            # splits-tuple spelling: the transfer function records WHICH
            # mesh invariant broke (entry range / arity / duplicate axis)
            return (
                f"invalid splits tuple {_fmt_split(f.dst)} for the "
                f"{ndim}-d value (shape {f.shape}): {f.note}; "
                f"normalize_splits raises ValueError at runtime",
                "each entry names a mesh axis of the target comm "
                "(the default comm's mesh is 1-D — pass comm=grid_comm(...) "
                "for 2-D layouts), at most once, one entry per array dim",
            )
        return (
            f"split axis {_fmt_split(f.dst)} is out of range for the "
            f"{ndim}-d value (shape {f.shape}); sanitize_axis raises "
            f"ValueError at runtime",
            f"use an axis in [-{ndim}, {ndim}) or fix the shape",
        )

    return _findings_for(program, "split_oob", build)


@rule("SPMD504", "layout collective on an already-matching layout",
      scope="program")
def check_noop_collective(program: Program) -> Iterable[Finding]:
    def build(ev):
        f = ev.fact
        what = ("resplit(None) of a value inferred replicated"
                if f.dst is None else
                f"resplit to split={_fmt_split(f.dst)}, the split the value "
                f"already has")
        return (
            f"{what}; the collective is a layout no-op",
            "drop the call, or guard it with `if x.split != target:` when "
            "the input layout varies",
        )

    return _findings_for(program, "noop_collective", build)


def _autoshard_wrapped_defs(ctx) -> List[ast.AST]:
    """Defs the file statically hands to ``autoshard`` — decorated
    (``@htt.autoshard`` / ``@autoshard(donate=True)``) or wrapped inline
    (``solved = htt.autoshard(pipeline)``)."""
    wrapped: List[ast.AST] = []
    seen: set = set()

    def _mark(fn_node):
        if fn_node is not None and id(fn_node) not in seen:
            seen.add(id(fn_node))
            wrapped.append(fn_node)

    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.FunctionDef):
            for dec in node.decorator_list:
                target = dec.func if isinstance(dec, ast.Call) else dec
                if ctx.resolves_to(target, "autoshard"):
                    _mark(node)
        elif isinstance(node, ast.Call) and ctx.resolves_to(node.func, "autoshard"):
            if node.args and isinstance(node.args[0], ast.Name):
                _mark(ctx.local_function(node.args[0].id, node))
    return wrapped


@rule("SPMD505", "hand-placed resplit inside an autoshard-wrapped function",
      scope="program")
def check_autoshard_hand_layout(program: Program) -> Iterable[Finding]:
    out: List[Finding] = []
    seen: set = set()
    for ctx in program.contexts:
        wrapped = _autoshard_wrapped_defs(ctx)
        if not wrapped:
            continue
        wrapped_ids = {id(fn) for fn in wrapped}
        for ev in program.events:
            if ev.ctx is not ctx or ev.fact.op not in ("resplit", "noop_collective"):
                continue
            if not any(id(fn) in wrapped_ids for fn in ctx.enclosing_functions(ev.node)):
                continue
            f = ctx.finding(
                "SPMD505", ev.node,
                f"hand-placed resplit to {_fmt_split(ev.fact.dst)} inside an "
                "autoshard-wrapped function; the solver owns interior layout "
                "here and may reroute or elide this hop",
                "let ht.autoshard place the layout (drop the call), or "
                "suppress if this hop is a deliberately pinned placement",
            )
            if f is None:
                continue
            fp = f.fingerprint()
            if fp in seen:
                continue
            seen.add(fp)
            out.append(f)
    out.sort(key=lambda f: (f.path, f.line))
    return out
