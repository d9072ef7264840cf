"""spmdlint on the port's tree: the file-scope linter and splitflow.

Port of ``heat_tpu/analysis``: the per-file model
(:mod:`~heat_tpu_torch.analysis.core`), the rule registry
(:mod:`~heat_tpu_torch.analysis.rules`), the file-scope rules in the
port's terms (:mod:`~heat_tpu_torch.analysis.checkers`), the committed
baseline (:mod:`~heat_tpu_torch.analysis.baseline`), the findings cache
(:mod:`~heat_tpu_torch.analysis.cache`) and the interprocedural
sharding-dataflow engine (:mod:`~heat_tpu_torch.analysis.splitflow`) with
its program-scope rules SPMD501-505, its cost report and the layout
summaries ``htt.autoshard`` solves::

    from heat_tpu_torch.analysis import analyze_file, analyze_paths, all_rules

The CLI is :mod:`heat_tpu_torch.analysis.cli`
(``python -m heat_tpu_torch.analysis.cli --baseline``).  Stdlib-only, as
the reference's: nothing here imports torch.
"""

from .baseline import load_baseline, partition, write_baseline
from .core import FileContext, analyze_file, analyze_paths, iter_py_files
from .rules import RULES, Finding, Rule, all_rules

# importing checkers registers every file-scope rule in RULES
from . import checkers  # noqa: E402,F401

__all__ = [
    "FileContext",
    "Finding",
    "RULES",
    "Rule",
    "all_rules",
    "analyze_file",
    "analyze_paths",
    "iter_py_files",
    "load_baseline",
    "partition",
    "write_baseline",
]
