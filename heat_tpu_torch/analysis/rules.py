"""Rule registry and the Finding record.

Port of ``heat_tpu/analysis/rules.py`` (stdlib-only).  The registry
holds the rules the port checks, in the reference's ids: the file-scope
rules of :mod:`heat_tpu_torch.analysis.checkers` and the program-scope
rules SPMD501-505 (:mod:`heat_tpu_torch.analysis.splitflow.checkers`).

A rule is a function ``check(ctx) -> Iterable[Finding]`` registered under a
stable id.  Ids are grouped by family so suppressions and docs stay legible:

=========  ===============================================================
SPMD001    inline suppression of a reason-required rule needs a reason
SPMD101    ``_permute`` permutations and the ring/zig-zag schedule builders
           must be valid (partial) bijections
SPMD201    capture purity: no host effects inside fused / graph-captured fns
SPMD202    no host syncs (.item()/.cpu()/float()/np.asarray) of captured values
SPMD203    quantized collectives must not carry integer/exact-dtype payloads
SPMD204    quantized collectives in guard-disabled regions need suppression
SPMD205    host timing (time.*, telemetry.span) inside captured functions
SPMD206    monolithic split→split resplit inside a loop body
SPMD207    silent broad except around dispatch/collective/io sites
SPMD208    unbucketed dynamic batch shape entering a fused program in a loop
SPMD210    request-scoped observability inside captured functions
SPMD211    retry loop without a deadline around a compiled/guarded call
SPMD212    blocking host read inside a loop that dispatches programs
SPMD213    blocking socket/pipe I/O inside a loop that dispatches programs
SPMD214    unbounded wait/recv inside a ``while True`` worker loop
SPMD401    jitted() cache keys: hashable, identity-stable parts only
SPMD501    implicit resplit: binary operand splits disagree (hidden wire)
SPMD502    redundant resplit chain: intermediate layout is never used
SPMD503    split axis statically out of range (guaranteed runtime error)
SPMD504    layout collective on a value inferred replicated (no-op)
SPMD505    hand-placed resplit inside an autoshard-wrapped function
=========  ===============================================================

The reference's SPMD102 (named-axis collectives against ``shard_map``),
SPMD209 (``fori_loop``/``scan`` ring bodies) and SPMD301/302 (Pallas tiles
and grids) check constructs the port does not have (ROADMAP, "Not ported
on purpose" and A3b).

SPMD501–505 are **program-scope** rules (``Rule.scope == "program"``):
they run once over the whole analyzed tree on the splitflow
interprocedural sharding-dataflow engine
(:mod:`heat_tpu_torch.analysis.splitflow`) instead of per file.

Each checker's docstring is the source of truth for its exact
conditions.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List

__all__ = [
    "Finding", "REASON_REQUIRED", "Rule", "RULES", "rule", "all_rules",
]

#: rule ids whose inline suppression must carry a ``-- reason`` tail
#: (``# spmdlint: disable=SPMD204 -- bench harness, guards off by design``):
#: both silence checks that exist to make a risky pattern *deliberate*, so
#: a bare suppression defeats the purpose.  Enforced by SPMD001.
REASON_REQUIRED = frozenset({"SPMD204", "SPMD207"})


@dataclass(frozen=True)
class Finding:
    """One analyzer hit: ``path:line  rule  message`` plus a fix hint."""

    rule: str
    path: str  # repo/package-relative where possible
    line: int
    message: str
    hint: str = ""
    #: stable identity for the baseline: deliberately line-insensitive
    #: (enclosing def + normalized source snippet), so findings survive
    #: unrelated edits above them
    context: str = ""

    def fingerprint(self) -> str:
        return f"{self.rule}::{self.path}::{self.context}"

    def to_dict(self) -> dict:
        return {
            "rule": self.rule, "path": self.path, "line": self.line,
            "message": self.message, "hint": self.hint,
            "context": self.context, "fingerprint": self.fingerprint(),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Finding":
        return cls(
            rule=d["rule"], path=d["path"], line=d["line"],
            message=d["message"], hint=d.get("hint", ""),
            context=d.get("context", ""),
        )

    def render(self) -> str:
        out = f"{self.path}:{self.line}: {self.rule} {self.message}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out


@dataclass
class Rule:
    id: str
    title: str
    check: Callable  # (FileContext) -> Iterable[Finding]  [file scope]
    #: rules that execute snippets of the analyzed source (perm builders)
    #: are skipped under --no-dynamic
    dynamic: bool = False
    #: "file" rules get one FileContext per call; "program" rules run ONCE
    #: per analysis over the splitflow Program (every FileContext plus the
    #: interprocedural sharding-dataflow results)
    scope: str = "file"


RULES: Dict[str, Rule] = {}


def rule(rule_id: str, title: str, dynamic: bool = False, scope: str = "file"):
    """Register a checker under ``rule_id``."""

    def deco(fn):
        RULES[rule_id] = Rule(rule_id, title, fn, dynamic=dynamic, scope=scope)
        return fn

    return deco


def all_rules() -> List[Rule]:
    return [RULES[k] for k in sorted(RULES)]
