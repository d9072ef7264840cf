"""Committed-baseline handling: the gate is *incremental*.

Port of ``heat_tpu/analysis/baseline.py``.  The baseline is a JSON file of
finding fingerprints (rule + path + line-insensitive context).  A lint run
fails only on findings NOT in the baseline, so adopting a new rule never
blocks unrelated changes: the baseline is committed with the rule and
burnt down separately.  Stale entries (baselined findings that no longer
fire) are reported so the file shrinks monotonically;
``--update-baseline`` rewrites it from the current tree.

The port's baseline is its own file, ``heat_tpu_torch/spmdlint-baseline.json``
(committed empty), never the reference's at the repo root.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Tuple

from .rules import Finding

__all__ = ["load_baseline", "write_baseline", "partition"]

#: relative to the repo root
DEFAULT_BASELINE = os.path.join("heat_tpu_torch", "spmdlint-baseline.json")


def load_baseline(path: str) -> Dict[str, dict]:
    """fingerprint -> entry metadata.  Missing file = empty baseline."""
    if not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    return {e["fingerprint"]: e for e in data.get("findings", [])}


def write_baseline(path: str, findings: Sequence[Finding]) -> None:
    entries = [
        {
            "fingerprint": f.fingerprint(),
            "rule": f.rule,
            "path": f.path,
            "message": f.message,
        }
        for f in sorted(findings, key=lambda f: f.fingerprint())
    ]
    # dedupe while keeping order (two hits of one rule on one normalized
    # line share a fingerprint on purpose)
    seen = set()
    unique = []
    for e in entries:
        if e["fingerprint"] not in seen:
            seen.add(e["fingerprint"])
            unique.append(e)
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"version": 1, "findings": unique}, f, indent=2, sort_keys=True)
        f.write("\n")


def partition(
    findings: Sequence[Finding], baseline: Dict[str, dict]
) -> Tuple[List[Finding], List[Finding], List[str]]:
    """Split into (new, baselined, stale-fingerprints)."""
    new: List[Finding] = []
    old: List[Finding] = []
    hit = set()
    for f in findings:
        fp = f.fingerprint()
        if fp in baseline:
            old.append(f)
            hit.add(fp)
        else:
            new.append(f)
    stale = sorted(fp for fp in baseline if fp not in hit)
    return new, old, stale
