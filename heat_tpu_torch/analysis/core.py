"""AST walker core: per-file model shared by every checker.

Port of ``heat_tpu/analysis/core.py``, stdlib-only as there.
``FileContext`` parses one Python source file and precomputes what the
rules need:

- an import-alias map so ``htt.resplit`` / ``comm.plan`` / ``fuse``
  resolve to dotted names regardless of import spelling (relative imports
  are resolved against the file's package position on disk);
- a parent map (child → parent AST node) for enclosing-statement and
  enclosing-function queries;
- per-scope assignment tables (including tuple-unpacking, the
  ``mesh, name = comm.mesh, comm.axis_name`` idiom);
- the set of TRACED regions, the code the port captures: functions
  passed to ``htt.fuse`` or decorated with ``fuse`` (bare or called),
  and the bodies of ``with torch.cuda.graph(...)`` blocks (the op engine's
  ``jitted`` runs its functions eagerly, so it traces nothing).  A
  function passed to or decorated with ``jax.jit`` counts as traced too,
  so that the rules that do not depend on the framework give the
  reference's findings on JAX code;
- inline-suppression handling (``# spmdlint: disable=SPMD101`` on the
  finding's line or its statement's first line, ``# spmdlint: skip-file``
  in the header).

Checkers receive a context and call :meth:`FileContext.finding`, which
applies inline suppressions and stamps the line-insensitive baseline
fingerprint.  Findings' paths and fingerprints are the reference's for
the same file.
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

from .rules import RULES, Finding, all_rules

__all__ = [
    "FileContext", "analyze_contexts", "analyze_file", "analyze_paths",
    "iter_py_files", "norm_relpath", "repo_root_for",
]

#: ``# spmdlint: disable=SPMD101,SPMD202`` with an optional human reason
#: after a ``--`` separator (``disable=SPMD204 -- guards off by design``).
#: Group 1 = the comma-separated rule ids, group 2 = the reason (None when
#: absent, "" when the separator is present but empty).
_SUPPRESS_RE = re.compile(
    r"#\s*spmdlint:\s*disable="
    r"([A-Za-z0-9_]+(?:\s*,\s*[A-Za-z0-9_]+)*)"
    r"(?:\s*--\s*(.*?))?\s*$"
)
_SKIP_FILE_RE = re.compile(r"#\s*spmdlint:\s*skip-file")

#: entry points whose function argument (by position) gets traced:
#: ``htt.fuse`` traces its function into one program and captures it as a
#: CUDA graph on the card (core/fuse.py), so host effects and host syncs
#: inside it are bugs.  The op engine's ``jitted`` (core/_compile.py) is
#: not here: it calls ``make_fn()`` once and runs the function it returns
#: eagerly, every call
_TRACING_CALLS = {
    "fuse": (0,),
    "jit": (0,),  # jax.jit only
}
#: the context manager whose body is captured into a CUDA graph: it runs
#: once, at capture, and each replay repeats only the kernels it launched
_CAPTURE_CONTEXT = "torch.cuda.graph"

FuncNode = Union[ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda]
_FUNC_TYPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def repo_root_for(path: str) -> Optional[str]:
    """Nearest enclosing repo root of ``path``: the first ancestor holding
    a ``.git`` directory, ``pyproject.toml``, or committed spmdlint
    baseline outside a package (the port keeps its own baseline in
    ``heat_tpu_torch/``, which is a package, not a root).  None when
    ``path`` is outside any recognizable repo."""
    d = os.path.dirname(os.path.abspath(path))
    while True:
        if (
            os.path.isdir(os.path.join(d, ".git"))
            or os.path.isfile(os.path.join(d, "pyproject.toml"))
            or (os.path.isfile(os.path.join(d, "spmdlint-baseline.json"))
                and not os.path.isfile(os.path.join(d, "__init__.py")))
        ):
            return d
        parent = os.path.dirname(d)
        if parent == d:
            return None
        d = parent


def norm_relpath(path: str, root: Optional[str] = None) -> str:
    """Canonical finding path: relative to ``root`` (or the file's repo
    root), always ``/``-separated.  ``heat_tpu_torch``,
    ``./heat_tpu_torch``, and the absolute spelling — from any working
    directory — all map a file to the SAME relpath, so baseline
    fingerprints are path-spelling- and cwd-insensitive."""
    ap = os.path.abspath(path)
    anchor = root or repo_root_for(ap)
    rel = os.path.relpath(ap, anchor) if anchor else os.path.relpath(ap)
    return rel.replace(os.sep, "/")


def _module_name_for(path: str) -> str:
    """Dotted module name from the file's package position on disk (walk
    up while ``__init__.py`` exists).  Fixture files outside any package
    just get their stem."""
    path = os.path.abspath(path)
    parts = [os.path.splitext(os.path.basename(path))[0]]
    d = os.path.dirname(path)
    while os.path.isfile(os.path.join(d, "__init__.py")):
        parts.append(os.path.basename(d))
        d = os.path.dirname(d)
    name = ".".join(reversed(parts))
    return name[: -len(".__init__")] if name.endswith(".__init__") else name


class FileContext:
    def __init__(self, path: str, source: Optional[str] = None, relpath: Optional[str] = None):
        self.path = path
        self.relpath = (relpath or norm_relpath(path)).replace(os.sep, "/")
        if source is None:
            with open(path, "r", encoding="utf-8") as f:
                source = f.read()
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        if os.path.exists(path):
            self.module = _module_name_for(path)
        else:
            # fixture context (source supplied): derive the module from
            # the declared relpath so synthetic multi-file programs still
            # resolve cross-module imports
            name = self.relpath[:-3] if self.relpath.endswith(".py") else self.relpath
            name = name.replace("/", ".")
            if name.endswith(".__init__"):
                name = name[: -len(".__init__")]
            self.module = name or "<fixture>"

        self.parents: Dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent

        self.aliases = self._collect_aliases()
        self.module_names = self._collect_module_names()
        self._scope_assigns: Dict[ast.AST, Dict[str, Tuple]] = {}
        self.traced_fns = self._collect_traced()
        self.captured_blocks = self._collect_captured()
        self.skip_file = any(
            _SKIP_FILE_RE.search(ln) for ln in self.lines[:5]
        )

    # ------------------------------------------------------------------ #
    # imports / name resolution                                           #
    # ------------------------------------------------------------------ #
    def _collect_aliases(self) -> Dict[str, str]:
        """local name -> dotted origin (``htt`` -> ``heat_tpu_torch``).

        ``from x import *`` contributes no aliases directly (the imported
        names are unknowable per-file) but IS recorded in
        :attr:`star_imports` so :meth:`resolve` can fall back to the star
        module for otherwise-unknown names, and the splitflow Program can
        resolve them exactly against the exporting file.  Imports inside
        ``if TYPE_CHECKING:`` blocks are collected like any other — they
        bind the names rules match on, even though they never execute."""
        out: Dict[str, str] = {}
        self.star_imports: List[str] = []
        pkg_parts = self.module.split(".")
        if self.relpath.rsplit("/", 1)[-1] == "__init__.py":
            # a package __init__'s module IS the package: `from . import x`
            # (level 1) must resolve to the package itself, so give the
            # path a synthetic leaf for the level arithmetic to strip
            pkg_parts = pkg_parts + ["__init__"]
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    out[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0]
                    )
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                if node.level:
                    # resolve `from ..core import x` against this module
                    base = pkg_parts[: max(len(pkg_parts) - node.level, 0)]
                    mod = ".".join(base + ([mod] if mod else []))
                for a in node.names:
                    if a.name == "*":
                        if mod:
                            self.star_imports.append(mod)
                        continue
                    out[a.asname or a.name] = f"{mod}.{a.name}" if mod else a.name
        return out

    def _collect_module_names(self) -> set:
        """Names bound at module scope by defs/classes/assignments (NOT
        imports) — the names a star-import fallback must never shadow."""
        names: set = set()
        for st in self.tree.body:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                names.add(st.name)
            elif isinstance(st, ast.Assign):
                for tgt in st.targets:
                    for n in ast.walk(tgt):
                        if isinstance(n, ast.Name):
                            names.add(n.id)
            elif isinstance(st, ast.AnnAssign) and isinstance(st.target, ast.Name):
                names.add(st.target.id)
        return names

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Dotted name of a Name/Attribute chain with import aliases
        substituted; None for anything else.

        A name with no alias and no module-scope binding in a file with
        exactly ONE ``from x import *`` resolves through that star module
        (the only place it can have come from); with several star imports
        the origin is ambiguous and the bare name is kept."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        root = self.aliases.get(node.id)
        if root is None:
            if (
                len(self.star_imports) == 1
                and node.id not in self.module_names
            ):
                root = f"{self.star_imports[0]}.{node.id}"
            else:
                root = node.id
        parts.append(root)
        return ".".join(reversed(parts))

    def resolves_to(self, node: ast.AST, *names: str) -> bool:
        """True when ``node`` resolves to any of ``names`` (matched on the
        full dotted path or any dotted-boundary suffix)."""
        dotted = self.resolve(node)
        if dotted is None:
            return False
        for n in names:
            if dotted == n or dotted.endswith("." + n):
                return True
        return False

    # ------------------------------------------------------------------ #
    # structure queries                                                   #
    # ------------------------------------------------------------------ #
    def enclosing_functions(self, node: ast.AST) -> List[FuncNode]:
        """Function nodes containing ``node``, innermost first."""
        out: List[FuncNode] = []
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, _FUNC_TYPES):
                out.append(cur)
            cur = self.parents.get(cur)
        return out

    def enclosing_statement(self, node: ast.AST) -> ast.AST:
        cur = node
        while cur is not None and not isinstance(cur, ast.stmt):
            cur = self.parents.get(cur)
        return cur if cur is not None else node

    def qualname(self, node: ast.AST) -> str:
        names = []
        for fn in self.enclosing_functions(node):
            names.append(getattr(fn, "name", "<lambda>"))
        return ".".join(reversed(names)) or "<module>"

    def scope_assignments(self, scope: ast.AST) -> Dict[str, Tuple]:
        """name -> ("expr", value_node) | ("unpack", call_node, index) for
        assignments made DIRECTLY in ``scope`` (nested defs excluded)."""
        cached = self._scope_assigns.get(scope)
        if cached is not None:
            return cached
        table: Dict[str, Tuple] = {}

        def visit(stmts):
            for st in stmts:
                if isinstance(st, _FUNC_TYPES + (ast.ClassDef,)):
                    continue
                if isinstance(st, ast.Assign):
                    self._record_assign(table, st.targets, st.value)
                elif isinstance(st, ast.AnnAssign) and st.value is not None:
                    self._record_assign(table, [st.target], st.value)
                for field in ("body", "orelse", "finalbody"):
                    sub = getattr(st, field, None)
                    if sub:
                        visit(sub)
                for h in getattr(st, "handlers", []) or []:
                    visit(h.body)

        body = getattr(scope, "body", [])
        visit(body if isinstance(body, list) else [])
        self._scope_assigns[scope] = table
        return table

    @staticmethod
    def _record_assign(table, targets, value):
        for tgt in targets:
            if isinstance(tgt, ast.Name):
                table[tgt.id] = ("expr", value)
            elif isinstance(tgt, (ast.Tuple, ast.List)):
                elts = tgt.elts
                if isinstance(value, (ast.Tuple, ast.List)) and len(value.elts) == len(elts):
                    for t, v in zip(elts, value.elts):
                        if isinstance(t, ast.Name):
                            table[t.id] = ("expr", v)
                elif isinstance(value, ast.Call):
                    for i, t in enumerate(elts):
                        if isinstance(t, ast.Name):
                            table[t.id] = ("unpack", value, i)

    def lookup(self, name: str, node: ast.AST) -> Optional[Tuple]:
        """Nearest-scope assignment record for ``name`` visible at
        ``node``: enclosing functions innermost-out, then module level."""
        for scope in self.enclosing_functions(node) + [self.tree]:
            rec = self.scope_assignments(scope).get(name)
            if rec is not None:
                return rec
        return None

    def module_function(self, name: str) -> Optional[ast.FunctionDef]:
        for st in self.tree.body:
            if isinstance(st, ast.FunctionDef) and st.name == name:
                return st
        return None

    def local_function(self, name: str, at: ast.AST) -> Optional[FuncNode]:
        """A def or name-bound lambda named ``name`` visible at ``at``."""
        for scope in self.enclosing_functions(at) + [self.tree]:
            for st in ast.walk(scope) if scope is not self.tree else self.tree.body:
                if isinstance(st, ast.FunctionDef) and st.name == name:
                    return st
            rec = self.scope_assignments(scope).get(name)
            if rec and rec[0] == "expr" and isinstance(rec[1], ast.Lambda):
                return rec[1]
        return None

    # ------------------------------------------------------------------ #
    # traced-function discovery                                           #
    # ------------------------------------------------------------------ #
    def _fn_node_of(self, expr: ast.AST, at: ast.AST) -> Optional[FuncNode]:
        """Resolve a function-valued expression to its def/lambda node."""
        if isinstance(expr, ast.Lambda):
            return expr
        if isinstance(expr, ast.Call):
            # functools.partial(kernel, ...) and decorator-style wrappers
            if self.resolves_to(expr.func, "functools.partial", "partial") and expr.args:
                return self._fn_node_of(expr.args[0], at)
            return None
        if isinstance(expr, ast.Name):
            return self.local_function(expr.id, at)
        return None

    def _collect_traced(self) -> set:
        traced: set = set()

        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call):
                dotted = self.resolve(node.func) or ""
                leaf = dotted.rsplit(".", 1)[-1]
                if leaf in _TRACING_CALLS and (leaf != "jit" or "jax" in dotted):
                    for idx in _TRACING_CALLS[leaf]:
                        if idx < len(node.args):
                            fn = self._fn_node_of(node.args[idx], node)
                            if fn is not None:
                                traced.add(fn)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    target = dec.func if isinstance(dec, ast.Call) else dec
                    if self.resolves_to(target, "fuse", "jax.jit"):
                        traced.add(node)
        return traced

    def _collect_captured(self) -> set:
        """``with`` statements one of whose items enters
        ``torch.cuda.graph(...)``: their bodies are captured regions."""
        captured: set = set()
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    expr = item.context_expr
                    target = expr.func if isinstance(expr, ast.Call) else expr
                    if self.resolves_to(target, _CAPTURE_CONTEXT):
                        captured.add(node)
                        break
        return captured

    def in_traced_context(self, node: ast.AST) -> bool:
        """True when ``node`` executes at trace time: some enclosing
        function is (or is nested in) a traced function, or ``node`` lies
        in the body of a ``with torch.cuda.graph(...)`` block."""
        child, cur = node, self.parents.get(node)
        while cur is not None:
            if isinstance(cur, _FUNC_TYPES) and cur in self.traced_fns:
                return True
            if cur in self.captured_blocks and any(child is st for st in cur.body):
                return True
            child, cur = cur, self.parents.get(cur)
        return False

    # ------------------------------------------------------------------ #
    # findings / suppression                                              #
    # ------------------------------------------------------------------ #
    def _suppressed(self, rule_id: str, node: ast.AST) -> bool:
        stmt = self.enclosing_statement(node)
        lines = {getattr(node, "lineno", 0), getattr(stmt, "lineno", 0)}
        # for multiline simple statements (a jitted() call with its key on
        # its own line) accept the pragma anywhere in the span; defs and
        # classes stay first-line-only so a nested suppression cannot
        # accidentally silence a finding anchored at the def itself
        if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            start = getattr(stmt, "lineno", 0)
            end = getattr(stmt, "end_lineno", start) or start
            lines.update(range(start, end + 1))
        for ln in lines:
            if 1 <= ln <= len(self.lines):
                m = _SUPPRESS_RE.search(self.lines[ln - 1])
                if m and rule_id in [s.strip() for s in m.group(1).split(",")]:
                    return True
        return False

    def suppressions(self) -> List[Tuple[int, List[str], Optional[str]]]:
        """Every inline suppression comment in the file as
        ``(lineno, rule_ids, reason)`` — ``reason`` is None when no ``--``
        separator is present and the (stripped) free text after it
        otherwise.  SPMD001 audits this list for reason-required rules.

        Unlike the fast line-scan in :meth:`_suppressed`, this walks real
        COMMENT tokens, so pragma look-alikes inside string literals
        (lint-test fixtures quoting suppressions) are not reported."""
        out: List[Tuple[int, List[str], Optional[str]]] = []
        try:
            tokens = tokenize.generate_tokens(io.StringIO(self.source).readline)
            comments = [
                (tok.start[0], tok.string)
                for tok in tokens
                if tok.type == tokenize.COMMENT
            ]
        except (tokenize.TokenError, IndentationError, SyntaxError):
            comments = list(enumerate(self.lines, 1))
        for i, text in comments:
            m = _SUPPRESS_RE.search(text)
            if m:
                ids = [s.strip() for s in m.group(1).split(",")]
                reason = m.group(2)
                out.append((i, ids, reason.strip() if reason is not None else None))
        return out

    def finding(
        self, rule_id: str, node: ast.AST, message: str, hint: str = ""
    ) -> Optional[Finding]:
        """Build a Finding at ``node``, honoring inline suppressions."""
        if self.skip_file or self._suppressed(rule_id, node):
            return None
        line = getattr(node, "lineno", 0)
        snippet = self.lines[line - 1].strip() if 1 <= line <= len(self.lines) else ""
        context = f"{self.qualname(node)}::{' '.join(snippet.split())}"
        return Finding(
            rule=rule_id,
            path=self.relpath,
            line=line,
            message=message,
            hint=hint,
            context=context,
        )


def iter_py_files(paths: Sequence[str]) -> Iterable[str]:
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs if not d.startswith((".", "__pycache__")))
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)
        elif p.endswith(".py"):
            yield p


def _register_all_rules() -> None:
    # imports for the side effect of registering every rule: the per-file
    # checkers and the program-scope splitflow rules (SPMD501-505)
    from . import checkers  # noqa: F401
    from .splitflow import checkers as _sf_checkers  # noqa: F401


def _wanted(r, dynamic: bool, rules: Optional[Sequence[str]]) -> bool:
    if rules is not None and r.id not in rules:
        return False
    return dynamic or not r.dynamic


def analyze_contexts(
    contexts: Sequence[FileContext],
    dynamic: bool = True,
    cache=None,
    rules: Optional[Sequence[str]] = None,
) -> List[Finding]:
    """Run every registered rule over pre-built contexts: file-scope
    rules per context, then the program-scope (splitflow) rules once over
    the whole set.  ``cache`` is an optional
    :class:`heat_tpu_torch.analysis.cache.FindingsCache`; per-file results
    hit it, program-scope results are interprocedural and always
    recompute."""
    _register_all_rules()
    findings: List[Finding] = []
    live = [ctx for ctx in contexts if not ctx.skip_file]
    file_rules = [r for r in all_rules() if r.scope == "file"]
    for ctx in live:
        cached = cache.get(ctx, dynamic, rules) if cache is not None else None
        if cached is not None:
            findings.extend(cached)
            continue
        per_file: List[Finding] = []
        for r in file_rules:
            if _wanted(r, dynamic, rules):
                per_file.extend(f for f in r.check(ctx) if f is not None)
        if cache is not None:
            cache.put(ctx, dynamic, rules, per_file)
        findings.extend(per_file)
    program_rules = [
        r for r in all_rules()
        if r.scope == "program" and _wanted(r, dynamic, rules)
    ]
    if program_rules and live:
        from .splitflow import build_program

        program = build_program(live)
        for r in program_rules:
            findings.extend(f for f in r.check(program) if f is not None)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def analyze_file(
    path: str,
    source: Optional[str] = None,
    dynamic: bool = True,
    relpath: Optional[str] = None,
    rules: Optional[Sequence[str]] = None,
) -> List[Finding]:
    ctx = FileContext(path, source=source, relpath=relpath)
    return analyze_contexts([ctx], dynamic=dynamic, rules=rules)


def analyze_paths(
    paths: Sequence[str],
    dynamic: bool = True,
    root: Optional[str] = None,
    cache=None,
    rules: Optional[Sequence[str]] = None,
) -> List[Finding]:
    """Analyze every ``.py`` under ``paths``; ``root`` anchors the
    relative paths used in findings and baseline fingerprints (defaulting
    to each file's repo root, so fingerprints do not depend on how the
    path was spelled or where the linter was launched from)."""
    contexts = [
        FileContext(f, relpath=norm_relpath(f, root)) for f in iter_py_files(paths)
    ]
    return analyze_contexts(contexts, dynamic=dynamic, cache=cache, rules=rules)
