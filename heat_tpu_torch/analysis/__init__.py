"""spmdlint's analysis core and the splitflow engine on the port's tree.

Port of ``heat_tpu/analysis``: the per-file model
(:mod:`~heat_tpu_torch.analysis.core`), the rule registry
(:mod:`~heat_tpu_torch.analysis.rules`) and the interprocedural
sharding-dataflow engine (:mod:`~heat_tpu_torch.analysis.splitflow`) with
its program-scope rules SPMD501-505, its cost report and the layout
summaries ``htt.autoshard`` solves::

    from heat_tpu_torch.analysis import analyze_file, analyze_paths, all_rules

Stdlib-only, as the reference's: nothing here imports torch.  The
reference's file-scope rules, its baseline file and its findings cache
(``load_baseline``, ``partition``, ``write_baseline``) are ROADMAP A18b.
"""

from .core import FileContext, analyze_file, analyze_paths, iter_py_files
from .rules import RULES, Finding, Rule, all_rules

__all__ = [
    "FileContext",
    "Finding",
    "RULES",
    "Rule",
    "all_rules",
    "analyze_file",
    "analyze_paths",
    "iter_py_files",
]
