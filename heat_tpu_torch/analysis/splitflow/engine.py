"""Interprocedural sharding-dataflow engine.

Port of ``heat_tpu/analysis/splitflow/engine.py``: the same
interpretation, over the port's declarations, with creation kinds
accepted only for callees that resolve into ``heat_tpu_torch``.

``build_program(contexts)`` runs an abstract interpretation of every
analyzed file over the :mod:`domain` lattice:

- module bodies execute first (factory calls at module scope bind
  concrete Specs);
- every function/method is then analyzed once with all-⊤ parameters — the
  "open-world" pass that guarantees coverage;
- every *call site* whose callee resolves to an analyzed def triggers a
  summary computation with the caller's argument Specs — the
  interprocedural pass that recovers precision through helpers, across
  modules, through ``comm/__init__``-style re-exports and single-star
  imports (resolution rides :class:`~heat_tpu_torch.analysis.core.FileContext`'s
  alias machinery plus the Program-level export chain).

Summaries are memoized on ``(function, argument layout key)`` with a
recursion guard, loops run to fixpoint (two joined passes — the lattice
has height 2), and branches join.  Ops with declared split semantics
(:mod:`registry`) are dispatched through :mod:`transfer`, which also
yields :class:`~heat_tpu_torch.analysis.splitflow.transfer.OpFact` records; the
engine stamps those with their AST site into :class:`CommEvent` — the
single feed for the SPMD501–504 rules and the comm-cost report.
"""

from __future__ import annotations

import ast
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..core import FileContext
from .domain import NOT_ARRAY, Spec, TOP, UNKNOWN, join
from .registry import StaticSem, static_registry
from .transfer import MISSING, NONLIT, OpFact, apply_kind

__all__ = ["CommEvent", "Program", "build_program"]

_DTYPE_NAMES = {
    "bool", "int8", "uint8", "int16", "uint16", "int32", "uint32",
    "int64", "uint64", "float16", "bfloat16", "float32", "float64",
    "complex64", "complex128",
}

#: kinds that may fire with no array operand (they CREATE the array), so
#: the "some operand must already be a DNDarray" guard is replaced by a
#: "the callee must resolve into heat_tpu_torch" guard
_CREATION_KINDS = {"factory"}

_MAX_CALL_DEPTH = 24

#: the package whose factories create arrays for this analysis
_PACKAGE = "heat_tpu_torch"


@dataclass
class CommEvent:
    """One :class:`OpFact` stamped with where it happened."""

    ctx: FileContext
    node: ast.AST
    qualname: str
    fact: OpFact

    @property
    def line(self) -> int:
        return getattr(self.node, "lineno", 0)

    def site(self) -> str:
        return f"{self.ctx.relpath}::{self.qualname}"


def _fmt_split(s) -> str:
    if s is TOP:
        return "⊤"
    if s is None:
        return "None"
    if isinstance(s, tuple):
        return "(" + ", ".join(_fmt_split(g) for g in s) + ")"
    return str(s)


class Program:
    """Whole-analysis view handed to program-scope rules.

    Attributes of interest:

    ``events``
        every :class:`CommEvent` the interpreter derived, deduplicated by
        (file, AST site, fact identity);
    ``fn_specs`` / ``fn_envs``
        per-function return Spec and final local environment from the
        open-world pass, keyed ``(module, qualname)`` — what the oracle
        lane compares against runtime metadata;
    ``module_envs``
        final module-scope environment per context.
    """

    def __init__(self, contexts: Sequence[FileContext]):
        self.contexts = list(contexts)
        self.by_module: Dict[str, FileContext] = {}
        for ctx in self.contexts:
            self.by_module.setdefault(ctx.module, ctx)
        self.registry: Dict[str, StaticSem] = static_registry(
            ctx.tree for ctx in self.contexts
        )
        self.events: List[CommEvent] = []
        self._event_keys: set = set()
        self.module_envs: Dict[FileContext, Dict[str, object]] = {}
        self.fn_specs: Dict[Tuple[str, str], object] = {}
        self.fn_envs: Dict[Tuple[str, str], Dict[str, object]] = {}
        self._summaries: Dict[Tuple[int, tuple], object] = {}
        self._in_progress: set = set()
        self._load_counts: Dict[int, Counter] = {}
        self._run()

    # ------------------------------------------------------------------ #
    # top-level passes                                                    #
    # ------------------------------------------------------------------ #
    def _run(self) -> None:
        for ctx in self.contexts:
            interp = _Interp(self, ctx, fn=None, env={})
            interp.exec_block(ctx.tree.body)
            self.module_envs[ctx] = interp.env
        for ctx in self.contexts:
            for node in ast.walk(ctx.tree):
                if isinstance(node, ast.FunctionDef):
                    self._open_world(ctx, node)

    def _open_world(self, ctx: FileContext, fn: ast.FunctionDef) -> None:
        env: Dict[str, object] = {}
        args = fn.args
        names = [a.arg for a in args.posonlyargs + args.args + args.kwonlyargs]
        for i, name in enumerate(names):
            # `self`/`cls` in a method position is the estimator, not data
            if i == 0 and name in ("self", "cls") and isinstance(
                    ctx.parents.get(fn), ast.ClassDef):
                env[name] = NOT_ARRAY
            else:
                env[name] = UNKNOWN
        if args.vararg:
            env[args.vararg.arg] = NOT_ARRAY
        if args.kwarg:
            env[args.kwarg.arg] = NOT_ARRAY
        interp = _Interp(self, ctx, fn=fn, env=env)
        interp.exec_block(fn.body)
        qual = self._qual_of_def(ctx, fn)
        self.fn_specs[(ctx.module, qual)] = interp.return_spec()
        self.fn_envs[(ctx.module, qual)] = interp.env

    @staticmethod
    def _qual_of_def(ctx: FileContext, fn: ast.FunctionDef) -> str:
        names = [fn.name]
        cur = ctx.parents.get(fn)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                names.append(cur.name)
            elif isinstance(cur, ast.ClassDef):
                names.append(cur.name)
            cur = ctx.parents.get(cur)
        return ".".join(reversed(names))

    # ------------------------------------------------------------------ #
    # events                                                              #
    # ------------------------------------------------------------------ #
    def record(self, ctx: FileContext, node: ast.AST, fact: OpFact) -> None:
        key = (
            ctx.relpath, getattr(node, "lineno", 0),
            getattr(node, "col_offset", 0), fact.op,
            _fmt_split(fact.src), _fmt_split(fact.dst), fact.shape,
        )
        if key in self._event_keys:
            return
        self._event_keys.add(key)
        self.events.append(CommEvent(ctx, node, ctx.qualname(node), fact))

    # ------------------------------------------------------------------ #
    # interprocedural resolution                                          #
    # ------------------------------------------------------------------ #
    def resolve_def(
        self, dotted: str, depth: int = 0
    ) -> Optional[Tuple[FileContext, ast.FunctionDef]]:
        """Find the analyzed def a dotted name ultimately refers to,
        chasing re-export chains (``heat_tpu_torch.comm.plan`` →
        ``comm/__init__`` alias → ``heat_tpu_torch.comm.redistribute.plan``)
        and star-exports."""
        if depth > 8 or not dotted:
            return None
        parts = dotted.split(".")
        for cut in range(len(parts) - 1, 0, -1):
            mod = ".".join(parts[:cut])
            ctx = self.by_module.get(mod)
            if ctx is None:
                continue
            rest = parts[cut:]
            leaf = rest[0]
            if len(rest) == 1:
                fn = ctx.module_function(leaf)
                if fn is not None:
                    return ctx, fn
            target = ctx.aliases.get(leaf)
            if target is not None and target != dotted:
                return self.resolve_def(".".join([target] + rest[1:]), depth + 1)
            if leaf not in ctx.module_names:
                for star in ctx.star_imports:
                    hit = self.resolve_def(".".join([star] + rest), depth + 1)
                    if hit is not None:
                        return hit
            return None
        return None

    def resolve_class(self, dotted: str, depth: int = 0) -> bool:
        """True when the dotted name refers to an analyzed class (its
        constructor yields an estimator, not an array)."""
        if depth > 8 or not dotted:
            return False
        parts = dotted.split(".")
        for cut in range(len(parts) - 1, 0, -1):
            ctx = self.by_module.get(".".join(parts[:cut]))
            if ctx is None:
                continue
            rest = parts[cut:]
            leaf = rest[0]
            if len(rest) == 1:
                for st in ctx.tree.body:
                    if isinstance(st, ast.ClassDef) and st.name == leaf:
                        return True
            target = ctx.aliases.get(leaf)
            if target is not None and target != dotted:
                return self.resolve_class(".".join([target] + rest[1:]), depth + 1)
            return False
        return False

    # ------------------------------------------------------------------ #
    # summaries                                                           #
    # ------------------------------------------------------------------ #
    @staticmethod
    def _arg_key(spec) -> object:
        if isinstance(spec, tuple):
            return tuple(Program._arg_key(s) for s in spec)
        if not isinstance(spec, Spec):
            return "?"
        return (
            "A" if spec.is_array else "O",
            _fmt_split(spec.split), spec.shape, spec.dtype,
        )

    def summarize(
        self,
        ctx: FileContext,
        fn: ast.AST,
        argspecs: Sequence[object],
        kwargspecs: Optional[Dict[str, object]] = None,
        depth: int = 0,
    ) -> object:
        """Return Spec of ``fn`` under the given argument layouts."""
        key = (id(fn), tuple(self._arg_key(a) for a in argspecs),
               tuple(sorted(
                   (k, self._arg_key(v)) for k, v in (kwargspecs or {}).items()
               )))
        if key in self._summaries:
            return self._summaries[key]
        if key in self._in_progress or depth > _MAX_CALL_DEPTH:
            return UNKNOWN
        self._in_progress.add(key)
        try:
            env: Dict[str, object] = {}
            args = getattr(fn, "args", None)
            if args is not None:
                pos = [a.arg for a in args.posonlyargs + args.args]
                for name, spec in zip(pos, argspecs):
                    env[name] = spec
                for name in pos[len(argspecs):]:
                    env[name] = (kwargspecs or {}).get(name, NOT_ARRAY)
                for a in args.kwonlyargs:
                    env[a.arg] = (kwargspecs or {}).get(a.arg, NOT_ARRAY)
                if args.vararg:
                    env[args.vararg.arg] = NOT_ARRAY
                if args.kwarg:
                    env[args.kwarg.arg] = NOT_ARRAY
            interp = _Interp(self, ctx, fn=fn, env=env, depth=depth + 1)
            if isinstance(fn, ast.Lambda):
                result = interp.eval(fn.body)
            else:
                interp.exec_block(fn.body)
                result = interp.return_spec()
            self._summaries[key] = result
            return result
        finally:
            self._in_progress.discard(key)

    def load_count(self, ctx: FileContext, fn: Optional[ast.AST], name: str) -> int:
        """How many times ``name`` is LOADED inside ``fn`` (for the
        single-use leg of resplit-chain detection)."""
        scope = fn if fn is not None else ctx.tree
        counts = self._load_counts.get(id(scope))
        if counts is None:
            counts = Counter()
            for node in ast.walk(scope):
                if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
                    counts[node.id] += 1
            self._load_counts[id(scope)] = counts
        return counts[name]


class _Interp:
    """Abstract interpreter for one function (or module) body."""

    def __init__(self, program: Program, ctx: FileContext, fn, env, depth=0):
        self.program = program
        self.ctx = ctx
        self.fn = fn
        self.env: Dict[str, object] = env
        self.depth = depth
        self.returns: List[object] = []
        #: name -> resplit Call node that produced its current value
        #: (provenance for SPMD502 chain detection)
        self.resplit_origin: Dict[str, ast.Call] = {}

    # ------------------------------------------------------------------ #
    # statements                                                          #
    # ------------------------------------------------------------------ #
    def exec_block(self, stmts: Sequence[ast.stmt]) -> None:
        for st in stmts:
            self.exec_stmt(st)

    def exec_stmt(self, st: ast.stmt) -> None:
        if isinstance(st, ast.Assign):
            val = self.eval(st.value)
            for tgt in st.targets:
                self._bind(tgt, val, st.value)
        elif isinstance(st, ast.AnnAssign):
            if st.value is not None:
                self._bind(st.target, self.eval(st.value), st.value)
        elif isinstance(st, ast.AugAssign):
            cur = self.eval(st.target) if isinstance(st.target, ast.Name) else UNKNOWN
            rhs = self.eval(st.value)
            out, facts = apply_kind("binary", [_as_spec(cur), _as_spec(rhs)])
            self._emit(st, facts)
            self._bind(st.target, out, st)
        elif isinstance(st, ast.Expr):
            self.eval(st.value)
        elif isinstance(st, ast.Return):
            self.returns.append(
                self.eval(st.value) if st.value is not None else NOT_ARRAY
            )
        elif isinstance(st, ast.If):
            self.eval(st.test)
            then_env, then_org = dict(self.env), dict(self.resplit_origin)
            self.exec_block(st.body)
            then_env, self.env = self.env, then_env
            then_org, self.resplit_origin = self.resplit_origin, then_org
            self.exec_block(st.orelse)
            self.env = _join_envs(self.env, then_env)
            self.resplit_origin = {
                k: v for k, v in self.resplit_origin.items()
                if then_org.get(k) is v
            }
        elif isinstance(st, (ast.For, ast.AsyncFor)):
            self.eval(st.iter)
            self._bind(st.target, UNKNOWN, st.iter)
            self._fixpoint(st.body)
            self.exec_block(st.orelse)
        elif isinstance(st, ast.While):
            self.eval(st.test)
            self._fixpoint(st.body)
            self.exec_block(st.orelse)
        elif isinstance(st, (ast.With, ast.AsyncWith)):
            for item in st.items:
                val = self.eval(item.context_expr)
                if item.optional_vars is not None:
                    self._bind(item.optional_vars, val, item.context_expr)
            self.exec_block(st.body)
        elif isinstance(st, ast.Try):
            pre = dict(self.env)
            self.exec_block(st.body)
            merged = self.env
            for handler in st.handlers:
                self.env = dict(pre)
                self.exec_block(handler.body)
                merged = _join_envs(merged, self.env)
            self.env = merged
            self.exec_block(st.orelse)
            self.exec_block(st.finalbody)
        elif isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            self.env[st.name] = NOT_ARRAY
        elif isinstance(st, (ast.Import, ast.ImportFrom)):
            pass  # alias resolution rides FileContext
        elif isinstance(st, (ast.Assert, ast.Raise, ast.Delete, ast.Global,
                             ast.Nonlocal, ast.Pass, ast.Break, ast.Continue)):
            pass

    def _fixpoint(self, body: Sequence[ast.stmt]) -> None:
        # lattice height 2: two joined passes reach the loop fixpoint
        for _ in range(2):
            before = dict(self.env)
            self.exec_block(body)
            self.env = _join_envs(before, self.env)
        self.resplit_origin.clear()

    def _bind(self, tgt: ast.AST, val: object, value_node: ast.AST) -> None:
        if isinstance(tgt, ast.Name):
            self.env[tgt.id] = val
            self.resplit_origin.pop(tgt.id, None)
            if isinstance(value_node, ast.Call) and self._call_kind(
                    value_node) == "resplit":
                self.resplit_origin[tgt.id] = value_node
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            elts = tgt.elts
            vals = val if isinstance(val, tuple) and len(val) == len(elts) \
                else [UNKNOWN] * len(elts)
            for t, v in zip(elts, vals):
                self._bind(t, v, value_node)
        elif isinstance(tgt, ast.Starred):
            self._bind(tgt.value, NOT_ARRAY, value_node)
        # attribute/subscript targets: no tracked binding

    def return_spec(self) -> object:
        if not self.returns:
            return NOT_ARRAY
        out = self.returns[0]
        for r in self.returns[1:]:
            if isinstance(out, tuple) and isinstance(r, tuple) \
                    and len(out) == len(r):
                out = tuple(join(_as_spec(a), _as_spec(b))
                            for a, b in zip(out, r))
            else:
                out = join(_as_spec(out), _as_spec(r))
        return out

    # ------------------------------------------------------------------ #
    # expressions                                                         #
    # ------------------------------------------------------------------ #
    def eval(self, node: Optional[ast.AST]) -> object:
        if node is None:
            return NOT_ARRAY
        if isinstance(node, ast.Name):
            val = self.env.get(node.id)
            if val is not None:
                return val
            menv = self.program.module_envs.get(self.ctx)
            if menv is not None and node.id in menv and menv is not self.env:
                return menv[node.id]
            return NOT_ARRAY
        if isinstance(node, ast.Constant):
            return NOT_ARRAY
        if isinstance(node, (ast.Tuple, ast.List)):
            return tuple(self.eval(e) for e in node.elts)
        if isinstance(node, ast.Starred):
            return self.eval(node.value)
        if isinstance(node, ast.BinOp):
            a, b = self.eval(node.left), self.eval(node.right)
            kind = "matmul" if isinstance(node.op, ast.MatMult) else "binary"
            out, facts = apply_kind(kind, [_as_spec(a), _as_spec(b)])
            self._emit(node, facts)
            return out
        if isinstance(node, ast.Compare):
            a = self.eval(node.left)
            b = self.eval(node.comparators[0]) if node.comparators else NOT_ARRAY
            out, facts = apply_kind("binary", [_as_spec(a), _as_spec(b)])
            self._emit(node, facts)
            return out
        if isinstance(node, ast.BoolOp):
            specs = [_as_spec(self.eval(v)) for v in node.values]
            out = specs[0]
            for s in specs[1:]:
                out = join(out, s)
            return out
        if isinstance(node, ast.UnaryOp):
            return self.eval(node.operand)
        if isinstance(node, ast.IfExp):
            self.eval(node.test)
            return join(_as_spec(self.eval(node.body)),
                        _as_spec(self.eval(node.orelse)))
        if isinstance(node, ast.Attribute):
            return self._eval_attribute(node)
        if isinstance(node, ast.Subscript):
            base = self.eval(node.value)
            if isinstance(base, tuple):
                idx = node.slice
                if isinstance(idx, ast.Constant) and isinstance(idx.value, int) \
                        and -len(base) <= idx.value < len(base):
                    return base[idx.value]
                return UNKNOWN
            if isinstance(base, Spec) and base.is_array:
                # DNDarray indexing changes shape/layout in data-dependent
                # ways the static model does not track
                return UNKNOWN
            return NOT_ARRAY
        if isinstance(node, ast.Call):
            return self.eval_call(node)
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                             ast.GeneratorExp)):
            for gen in node.generators:
                self.eval(gen.iter)
            return NOT_ARRAY
        if isinstance(node, ast.NamedExpr):
            val = self.eval(node.value)
            self._bind(node.target, val, node.value)
            return val
        return NOT_ARRAY

    def _eval_attribute(self, node: ast.Attribute) -> object:
        val = self.eval(node.value)
        if isinstance(val, tuple):
            if node.attr in ("U", "S", "V") and len(val) == 3:
                return val[("U", "S", "V").index(node.attr)]
            return NOT_ARRAY
        if isinstance(val, Spec) and val.is_array:
            if node.attr == "T":
                out, facts = apply_kind("transpose", [val], axis=None)
                self._emit(node, facts)
                return out
            return NOT_ARRAY  # .larray/.split/.shape/.comm/...
        return NOT_ARRAY

    # ------------------------------------------------------------------ #
    # calls                                                               #
    # ------------------------------------------------------------------ #
    def _call_kind(self, call: ast.Call) -> Optional[str]:
        leaf = call.func.attr if isinstance(call.func, ast.Attribute) else (
            call.func.id if isinstance(call.func, ast.Name) else None)
        sem = self.program.registry.get(leaf) if leaf else None
        return sem.kind if sem else None

    def eval_call(self, node: ast.Call) -> object:
        func = node.func
        receiver: object = None
        if isinstance(func, ast.Attribute):
            receiver = self.eval(func.value)
            leaf = func.attr
        elif isinstance(func, ast.Name):
            leaf = func.id
        else:
            for a in node.args:
                self.eval(a)
            return NOT_ARRAY

        arg_vals = [self.eval(a) for a in node.args]
        kw_vals = {kw.arg: self.eval(kw.value) for kw in node.keywords
                   if kw.arg is not None}

        sem = self.program.registry.get(leaf)
        receiver_is_array = isinstance(receiver, Spec) and receiver.is_array
        dotted = self.ctx.resolve(func) or ""

        if sem is not None and self._sem_applies(
                sem, receiver, arg_vals, kw_vals, dotted):
            result = self._apply_sem(sem, node, receiver, arg_vals, kw_vals)
            # in-place layout mutation (`x.resplit_(axis)`) rebinds the
            # receiver — without this the next resplit_ looks like a no-op
            if sem.kind == "resplit" and leaf.endswith("_") \
                    and isinstance(func, ast.Attribute) \
                    and isinstance(func.value, ast.Name) \
                    and isinstance(result, Spec):
                self.env[func.value.id] = result
                self.resplit_origin.pop(func.value.id, None)
            return result

        # interprocedural: the callee is an analyzed def
        if not receiver_is_array:
            target = None
            if isinstance(func, ast.Name):
                fn = self.ctx.local_function(leaf, node)
                if fn is not None:
                    target = (self.ctx, fn)
            if target is None and dotted:
                target = self.program.resolve_def(dotted)
            if target is not None:
                return self.program.summarize(
                    target[0], target[1], arg_vals, kw_vals, depth=self.depth
                )
            if dotted and self.program.resolve_class(dotted):
                return NOT_ARRAY
        # unknown callee over array data: stay sound, assume an array of
        # unknown layout when any operand was one
        operands = ([receiver] if receiver is not None else []) + arg_vals \
            + list(kw_vals.values())
        if any(isinstance(v, Spec) and v.is_array for v in operands):
            return UNKNOWN
        return NOT_ARRAY

    def _sem_applies(self, sem, receiver, arg_vals, kw_vals, dotted) -> bool:
        if sem.kind in _CREATION_KINDS:
            # this package only: a prefix test would also take the
            # reference's ``heat_tpu.`` factories
            return dotted.split(".", 1)[0] == _PACKAGE
        operands = ([receiver] if receiver is not None else []) \
            + arg_vals + list(kw_vals.values())
        flat = []
        for v in operands:
            flat.extend(v if isinstance(v, tuple) else (v,))
        return any(isinstance(v, Spec) and v.is_array for v in flat)

    def _apply_sem(self, sem, node, receiver, arg_vals, kw_vals) -> object:
        # positional extras = the call arguments after the array operand
        # (method form: all of them; module form: everything past the
        # first array-valued argument)
        extras = list(node.args)
        if not (isinstance(receiver, Spec) and receiver.is_array):
            for i, v in enumerate(arg_vals):
                if isinstance(v, Spec) and v.is_array or isinstance(v, tuple):
                    extras = list(node.args[i + 1:])
                    break
        lit_extras = [_literal_of(a) for a in extras]
        kw_lits = {kw.arg: _literal_of(kw.value) for kw in node.keywords
                   if kw.arg is not None}

        operands = []
        if isinstance(receiver, Spec) and receiver.is_array:
            operands.append(receiver)
        for v in arg_vals:
            if isinstance(v, tuple):
                operands.extend(_as_spec(x) for x in v)
            elif isinstance(v, Spec):
                operands.append(v)
        for v in kw_vals.values():
            if isinstance(v, Spec) and v.is_array:
                operands.append(v)

        params: Dict[str, object] = {}
        kind = sem.kind
        if kind == "reduction":
            # the runtime default is axis=None — a FULL reduction
            params["axis"] = kw_lits.get(
                "axis", lit_extras[0] if lit_extras else None)
            params["keepdims"] = kw_lits.get("keepdims", MISSING)
        elif kind in ("cumulative", "expand_dims", "squeeze"):
            params["axis"] = kw_lits.get(
                "axis", lit_extras[0] if lit_extras else MISSING)
        elif kind == "transpose":
            ax = kw_lits.get("axes", MISSING)
            if ax is MISSING and lit_extras:
                if len(lit_extras) == 1 and isinstance(
                        lit_extras[0], (tuple, list, type(None))):
                    ax = lit_extras[0]
                elif all(isinstance(x, int) for x in lit_extras):
                    ax = tuple(lit_extras)
                else:
                    ax = NONLIT
            elif ax is MISSING and not extras:
                ax = None  # full reverse, the runtime default
            params["axis"] = ax
        elif kind == "reshape":
            shp = kw_lits.get("shape", kw_lits.get("newshape", MISSING))
            if shp is MISSING and lit_extras:
                if len(lit_extras) == 1 and isinstance(
                        lit_extras[0], (tuple, list, int)):
                    shp = lit_extras[0]
                elif all(isinstance(x, int) for x in lit_extras):
                    shp = tuple(lit_extras)
                else:
                    shp = NONLIT
            if isinstance(shp, int):
                shp = (shp,)
            params["shape"] = shp
        elif kind in ("concat", "stack"):
            params["axis"] = kw_lits.get(
                "axis", lit_extras[0] if lit_extras else 0)
            first = arg_vals[0] if arg_vals else NOT_ARRAY
            if isinstance(first, tuple):
                params["arrays"] = tuple(_as_spec(v) for v in first)
        elif kind == "resplit":
            params["split"] = kw_lits.get("axis", kw_lits.get(
                "split", lit_extras[0] if lit_extras else MISSING))
        elif kind == "factory":
            params["shape"] = self._factory_shape(sem.name, node, kw_lits)
            params["split"] = kw_lits.get("split", MISSING)
            params["splits"] = kw_lits.get("splits", MISSING)
            params["has_comm"] = any(
                kw.arg == "comm" for kw in node.keywords)
            params["dtype"] = self._dtype_of(node, sem.name)
        elif kind == "factory_like":
            params["split"] = kw_lits.get("split", MISSING)
        elif kind == "entry_svd":
            params["compute_uv"] = kw_lits.get("compute_uv", MISSING)
        elif kind == "entry_qr":
            # calc_q is the third positional after tiles_per_proc
            params["calc_q"] = kw_lits.get(
                "calc_q", lit_extras[1] if len(lit_extras) > 1 else MISSING)

        result, facts = apply_kind(kind, operands, **params)
        self._emit(node, facts)
        if kind == "resplit" and any(
                f.op in ("resplit", "noop_collective") for f in facts):
            self._check_chain(node)
        return result

    def _dtype_of(self, node: ast.Call, leaf: str = "") -> Optional[str]:
        for kw in node.keywords:
            if kw.arg == "dtype":
                dotted = self.ctx.resolve(kw.value) or ""
                name = dotted.rsplit(".", 1)[-1]
                if name in _DTYPE_NAMES:
                    return name
                lit = _literal_of(kw.value)
                if isinstance(lit, str) and lit in _DTYPE_NAMES:
                    return lit
                return None
        # data-driven factories infer dtype from their input; everything
        # else defaults to the canonical float32
        return None if leaf in ("array", "arange") else "float32"

    def _factory_shape(self, leaf: str, node: ast.Call, kw_lits) -> object:
        """Global result shape of a factory call, respecting each
        factory's actual signature (``array`` takes DATA, ``arange`` a
        range, ``eye`` row/col counts, the rest a shape)."""
        pos = [_literal_of(a) for a in node.args]
        if leaf == "array":
            data = kw_lits.get("obj", pos[0] if pos else MISSING)
            shp = _data_shape(data) if data not in (MISSING, NONLIT) else None
            if shp is None:
                return NONLIT
            ndmin = kw_lits.get("ndmin", 0)
            if isinstance(ndmin, int) and ndmin > len(shp):
                shp = (1,) * (ndmin - len(shp)) + shp
            return shp
        if leaf == "arange":
            if pos and all(isinstance(p, int) for p in pos):
                try:
                    n = len(range(*pos[:3]))
                except (TypeError, ValueError):
                    return NONLIT
                return (n,)
            return NONLIT
        if leaf in ("linspace", "logspace"):
            num = kw_lits.get("num", pos[2] if len(pos) > 2 else 50)
            return (num,) if isinstance(num, int) and num >= 0 else NONLIT
        if leaf == "eye":
            n = pos[0] if pos else kw_lits.get("n", MISSING)
            m = kw_lits.get("m", pos[1] if len(pos) > 1 else n)
            if isinstance(n, int) and isinstance(m, int):
                return (n, m)
            return NONLIT
        shp = kw_lits.get("shape", MISSING)
        if shp is MISSING and node.args:
            shp = pos[0]
        return shp

    def _check_chain(self, node: ast.Call) -> None:
        """SPMD502: the value being resplit is ITSELF a fresh resplit
        result nobody else uses — the intermediate layout is dead."""
        func = node.func
        operand_expr = None
        if isinstance(func, ast.Attribute):
            operand_expr = func.value
        elif node.args:
            operand_expr = node.args[0]
        if operand_expr is None:
            return
        inner: Optional[ast.Call] = None
        if isinstance(operand_expr, ast.Call) and self._call_kind(
                operand_expr) == "resplit":
            inner = operand_expr
        elif isinstance(operand_expr, ast.Name):
            origin = self.resplit_origin.get(operand_expr.id)
            if origin is not None and self.program.load_count(
                    self.ctx, self.fn, operand_expr.id) == 1:
                inner = origin
        if inner is not None:
            self.program.record(self.ctx, node, OpFact(
                "resplit_chain",
                note="intermediate layout from the inner resplit is never "
                     "used; go to the final split in one step",
            ))

    def _emit(self, node: ast.AST, facts: Sequence[OpFact]) -> None:
        for fact in facts:
            self.program.record(self.ctx, node, fact)


def _as_spec(val: object) -> Spec:
    if isinstance(val, Spec):
        return val
    if isinstance(val, tuple):
        out = NOT_ARRAY
        for v in val:
            out = join(out, _as_spec(v))
        return out
    return NOT_ARRAY


def _join_envs(a: Dict[str, object], b: Dict[str, object]) -> Dict[str, object]:
    out: Dict[str, object] = {}
    for k in set(a) | set(b):
        va, vb = a.get(k), b.get(k)
        if va is None:
            out[k] = _widen(vb)
        elif vb is None:
            out[k] = _widen(va)
        elif isinstance(va, tuple) and isinstance(vb, tuple) \
                and len(va) == len(vb):
            out[k] = tuple(join(_as_spec(x), _as_spec(y))
                           for x, y in zip(va, vb))
        else:
            out[k] = join(_as_spec(va), _as_spec(vb))
    return out


def _widen(val: object) -> object:
    # bound on one path only: the binding may not exist afterwards, so
    # nothing layout-specific may be concluded from it
    if isinstance(val, Spec) and val.is_array:
        return val.widened()
    if isinstance(val, tuple):
        return tuple(_widen(v) for v in val)
    return val


def _data_shape(x) -> Optional[tuple]:
    """np-style shape of nested literal sequences (``ht.array`` data)."""
    if isinstance(x, (list, tuple)):
        if not x:
            return (0,)
        sub = _data_shape(x[0])
        if sub is None or any(_data_shape(e) != sub for e in x[1:]):
            return None
        return (len(x),) + sub
    if isinstance(x, (bool, int, float, complex)):
        return ()
    return None


def _literal_of(node: ast.AST) -> object:
    try:
        return ast.literal_eval(node)
    except (ValueError, SyntaxError, TypeError):
        return NONLIT


def build_program(contexts: Sequence[FileContext]) -> Program:
    """Run the splitflow analysis over pre-built file contexts."""
    return Program(contexts)
