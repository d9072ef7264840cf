"""Command-line front end of the port's linter.

Port of ``heat_tpu/analysis/cli.py``; run from the repo root as::

    python -m heat_tpu_torch.analysis.cli --baseline

Without paths it analyzes the ``heat_tpu_torch`` package.  The baseline is
``heat_tpu_torch/spmdlint-baseline.json`` and the findings cache
``.spmdlint-torch-cache/`` at the repo root (the reference's linter keeps
its own of each).

Exit codes: 0 clean (or baseline-covered), 1 new findings, 2 bad usage.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

from .baseline import DEFAULT_BASELINE, load_baseline, partition, write_baseline
from .cache import DEFAULT_CACHE_DIR, FindingsCache
from .core import analyze_paths
from .rules import Finding, all_rules


def _repo_root() -> str:
    # heat_tpu_torch/analysis/cli.py -> repo root two levels above the package
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m heat_tpu_torch.analysis.cli",
        description="Static SPMD-correctness analyzer for heat_tpu_torch "
        "(permutation schedules, capture purity, quantized-collective "
        "payloads, jitted keys, interprocedural sharding dataflow).",
    )
    p.add_argument(
        "paths", nargs="*", default=None,
        help="files/directories to analyze (default: the heat_tpu_torch package)",
    )
    p.add_argument(
        "--baseline", nargs="?", const=True, default=None, metavar="FILE",
        help="compare against the committed baseline (optionally at FILE; "
        f"default {DEFAULT_BASELINE} under the repo root) and fail only on "
        "NEW findings",
    )
    p.add_argument(
        "--update-baseline", action="store_true",
        help="rewrite the baseline file from the current findings and exit 0",
    )
    p.add_argument(
        "--no-dynamic", action="store_true",
        help="skip rules that evaluate perm-builder source (SPMD101)",
    )
    p.add_argument(
        "--rule", action="append", default=None, metavar="ID",
        help="run only this rule id (repeatable)",
    )
    p.add_argument(
        "--format", choices=("text", "json", "github"), default="text",
        help="finding output format: human text (default), a JSON "
        "document, or GitHub workflow annotations",
    )
    p.add_argument(
        "--cost-report", action="store_true",
        help="print the static comm-cost report (splitflow-derived layout "
        "traffic priced with the runtime cost model) instead of findings; "
        "--format=json emits the machine-readable document",
    )
    p.add_argument(
        "--mesh", type=int, default=8, metavar="N",
        help="positions the cost report prices collectives at (default 8)",
    )
    p.add_argument(
        "--precision", default="f32", metavar="MODE",
        help="redistribution wire precision for the cost report: f32 "
        "(default), auto, int8_block, or bf16",
    )
    p.add_argument(
        "--no-cache", action="store_true",
        help="always re-analyze; skip the per-file findings cache",
    )
    p.add_argument(
        "--cache-dir", default=None, metavar="DIR",
        help=f"findings cache location (default {DEFAULT_CACHE_DIR} at the "
        "repo root)",
    )
    p.add_argument("--list-rules", action="store_true", help="print the rule catalog")
    p.add_argument("-q", "--quiet", action="store_true", help="counts only, no per-finding output")
    return p


def _emit(findings: List[Finding], fmt: str, quiet: bool) -> None:
    if fmt == "json":
        print(json.dumps(
            {"findings": [f.to_dict() for f in findings],
             "count": len(findings)},
            indent=2, sort_keys=True,
        ))
        return
    if fmt == "github":
        # workflow-command annotations; one line per finding, grep-stable
        for f in findings:
            msg = f.message + (f" (hint: {f.hint})" if f.hint else "")
            # commas/newlines terminate workflow-command properties
            msg = msg.replace("\n", " ").replace(",", ";")
            print(
                f"::error file={f.path},line={f.line},"
                f"title={f.rule}::{msg}"
            )
        return
    if not quiet:
        for f in findings:
            print(f.render())


def _run_cost_report(args, paths: List[str], root: str) -> int:
    from .core import FileContext, iter_py_files, norm_relpath
    from .splitflow import build_program, cost_report, render_table

    contexts = [
        FileContext(f, relpath=norm_relpath(f, root))
        for f in iter_py_files(paths)
    ]
    program = build_program([c for c in contexts if not c.skip_file])
    precision = None if args.precision in ("f32", "none") else args.precision
    report = cost_report(program, mesh=args.mesh, precision=precision or "f32")
    if args.format == "json":
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        print(render_table(report))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    root = _repo_root()

    if args.list_rules:
        from .core import _register_all_rules

        _register_all_rules()
        for r in all_rules():
            dyn = " [dynamic]" if r.dynamic else ""
            scope = " [program]" if r.scope == "program" else ""
            print(f"{r.id}  {r.title}{dyn}{scope}")
        return 0

    paths = args.paths or [os.path.join(root, "heat_tpu_torch")]
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        print(f"spmdlint: no such path: {', '.join(missing)}", file=sys.stderr)
        return 2

    if args.cost_report:
        return _run_cost_report(args, paths, root)

    cache = None
    if not args.no_cache:
        cache = FindingsCache(
            args.cache_dir or os.path.join(root, DEFAULT_CACHE_DIR)
        )

    t0 = time.monotonic()
    findings = analyze_paths(
        paths, dynamic=not args.no_dynamic, root=root, cache=cache,
        rules=args.rule,
    )
    elapsed = time.monotonic() - t0
    timing = f"{elapsed:.2f}s" + (
        f", cache {cache.stats()}" if cache is not None else ", cache off"
    )

    baseline_path = None
    if args.baseline is not None or args.update_baseline:
        baseline_path = (
            args.baseline
            if isinstance(args.baseline, str)
            else os.path.join(root, DEFAULT_BASELINE)
        )

    if args.update_baseline:
        write_baseline(baseline_path, findings)
        print(f"spmdlint: baseline written to {baseline_path} ({len(findings)} findings)")
        return 0

    if baseline_path is not None:
        new, old, stale = partition(findings, load_baseline(baseline_path))
        _emit(new, args.format, args.quiet)
        if args.format == "text" and not args.quiet:
            for fp in stale:
                print(f"stale baseline entry (fix it and update the baseline): {fp}")
        if args.format != "json":
            print(
                f"spmdlint: {len(new)} new, {len(old)} baselined, "
                f"{len(stale)} stale baseline entries  [{timing}]"
            )
        return 1 if new else 0

    _emit(findings, args.format, args.quiet)
    if args.format != "json":
        print(f"spmdlint: {len(findings)} finding(s)  [{timing}]")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
