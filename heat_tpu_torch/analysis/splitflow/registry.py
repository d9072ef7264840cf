"""Static view of the split-semantics registry.

The runtime registry (:mod:`heat_tpu_torch.core._split_semantics`) is built by
executing the op modules; this module recovers the SAME declarations by
**parsing** them — plain ``ast`` over the package source on disk, no
torch, no package import (port of ``heat_tpu/analysis/splitflow/
registry.py``; it parses the port's own declarations).  That is only possible because the declaration forms
were designed for it: ``declare_split_semantics_table`` takes a literal
dict, and the ``@split_semantics("kind", ...)`` decorator takes literal
arguments.  The oracle lane imports the runtime registry in-process and
asserts it equals this parse, so the two views cannot drift.

Analyzed fixture files may carry their own declarations (same forms);
those are merged on top of the package's.
"""

from __future__ import annotations

import ast
import functools
import os
from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Tuple

__all__ = ["StaticSem", "package_registry", "parse_declarations", "static_registry"]

_DECL_TABLE = "declare_split_semantics_table"
_DECL_ONE = "declare_split_semantics"
_DECORATOR = "split_semantics"


@dataclass(frozen=True)
class StaticSem:
    """One statically-recovered declaration: op leaf name → op kind."""

    name: str
    kind: str
    params: Tuple[Tuple[str, object], ...] = ()

    def param(self, key: str, default=None):
        for k, v in self.params:
            if k == key:
                return v
        return default


def _literal(node: ast.AST):
    try:
        return ast.literal_eval(node)
    except (ValueError, SyntaxError):
        return None


def _decorator_name(dec: ast.AST) -> Optional[str]:
    target = dec.func if isinstance(dec, ast.Call) else dec
    while isinstance(target, ast.Attribute):
        target = target.attr if isinstance(target.attr, str) else target.value
        if isinstance(target, str):
            return target
    if isinstance(target, ast.Name):
        return target.id
    return None


def _params_from_call(call: ast.Call, skip: int) -> Tuple[Tuple[str, object], ...]:
    out = []
    for kw in call.keywords:
        if kw.arg is not None and kw.arg != "module":
            out.append((kw.arg, _literal(kw.value)))
    return tuple(sorted(out))


def parse_declarations(tree: ast.AST) -> Dict[str, StaticSem]:
    """Extract every split-semantics declaration from one parsed module."""
    out: Dict[str, StaticSem] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            fname = _decorator_name(node)
            if fname == _DECL_TABLE and len(node.args) >= 2:
                table = node.args[1]
                if isinstance(table, ast.Dict):
                    for k, v in zip(table.keys, table.values):
                        kind = _literal(k)
                        names = _literal(v)
                        if isinstance(kind, str) and isinstance(names, (tuple, list)):
                            for n in names:
                                if isinstance(n, str):
                                    out[n] = StaticSem(n, kind)
            elif fname == _DECL_ONE and len(node.args) >= 2:
                name, kind = _literal(node.args[0]), _literal(node.args[1])
                if isinstance(name, str) and isinstance(kind, str):
                    out[name] = StaticSem(name, kind, _params_from_call(node, 2))
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                if not isinstance(dec, ast.Call):
                    continue
                dname = _decorator_name(dec) or ""
                if dname == _DECORATOR or dname.endswith("_" + _DECORATOR):
                    kind = _literal(dec.args[0]) if dec.args else None
                    if isinstance(kind, str):
                        out[node.name] = StaticSem(
                            node.name, kind, _params_from_call(dec, 1)
                        )
    return out


def _package_root() -> str:
    # heat_tpu_torch/analysis/splitflow/registry.py -> the package dir
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@functools.lru_cache(maxsize=1)
def package_registry() -> Dict[str, StaticSem]:
    """The full static registry parsed from the heat_tpu_torch source.

    Walks every ``.py`` under the package (skipping this analysis
    subpackage — its fixtures would pollute the table) and merges the
    declarations.  Cached: the parse is pure and the package source does
    not change within a process."""
    root = _package_root()
    out: Dict[str, StaticSem] = {}
    skip = os.path.join(root, "analysis")
    for base, dirs, files in os.walk(root):
        if base.startswith(skip):
            dirs[:] = []
            continue
        dirs[:] = sorted(d for d in dirs if not d.startswith((".", "__pycache__")))
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            path = os.path.join(base, f)
            try:
                with open(path, "r", encoding="utf-8") as fh:
                    src = fh.read()
                if "split_semantics" not in src:
                    continue
                out.update(parse_declarations(ast.parse(src, filename=path)))
            except (OSError, SyntaxError):  # spmdlint: disable=SPMD207 -- a transiently unreadable or unparsable file must degrade to "no declarations", not kill the whole lint run
                continue
    return out


def static_registry(trees: Iterable[ast.AST] = ()) -> Dict[str, StaticSem]:
    """Package registry plus declarations found in ``trees`` (analyzed
    fixture files may declare semantics for their own test ops)."""
    out = dict(package_registry())
    for tree in trees:
        out.update(parse_declarations(tree))
    return out
