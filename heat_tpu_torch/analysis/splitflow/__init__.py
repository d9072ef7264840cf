"""splitflow: interprocedural sharding dataflow analysis.

An abstract interpreter over DNDarray split metadata (:mod:`domain`),
driven by a statically-parsed view of the runtime split-semantics
registry (:mod:`registry`), with per-op-kind transfer functions
(:mod:`transfer`) and an interprocedural engine (:mod:`engine`).  Powers
the program-scope rules SPMD501–504 (:mod:`checkers`) and the static
comm-cost report (:mod:`report`) — both fed by the same
:class:`CommEvent` stream, both importable without torch.  Port of
``heat_tpu/analysis/splitflow``; its layout summaries feed
``htt.autoshard``.
"""

from .domain import NOT_ARRAY, Spec, TOP, UNKNOWN, join
from .engine import CommEvent, Program, build_program
from .registry import package_registry, static_registry
from .report import cost_report, render_table
from .summary import layout_summary
from .transfer import OpFact, apply_kind

__all__ = [
    "CommEvent", "NOT_ARRAY", "OpFact", "Program", "Spec", "TOP", "UNKNOWN",
    "apply_kind", "build_program", "cost_report", "join", "layout_summary",
    "package_registry", "render_table", "static_registry",
]
