"""Findings cache: skip re-analyzing files that have not changed.

Port of ``heat_tpu/analysis/cache.py``.  One JSON entry per analyzed file
under ``.spmdlint-torch-cache/`` (repo root by default; the reference's
``.spmdlint-cache/`` is never read, so the two linters cannot hand each
other entries), keyed on ``(absolute path, mtime_ns, size)`` plus
everything that changes what a run would produce: the dynamic flag, the
requested rule subset, the registered file-scope rules, a digest of the
linter's own sources (an edited checker recomputes every file) and a
format version.  A stale key is simply recomputed: the cache never needs
invalidation tooling, deleting the directory is always safe.

Only FILE-scope findings are cached.  Program-scope (splitflow) rules
are interprocedural (editing one file can change findings in another),
so :func:`~heat_tpu_torch.analysis.core.analyze_contexts` always
recomputes them; they cost one pass over already-parsed trees.

``hits``/``misses`` counters feed the cold/warm wall-time report.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
from typing import List, Optional, Sequence

from .rules import RULES, Finding

__all__ = ["DEFAULT_CACHE_DIR", "FindingsCache"]

DEFAULT_CACHE_DIR = ".spmdlint-torch-cache"

_FORMAT_VERSION = 1

#: the sources whose text decides a file-scope finding
_LINTER_SOURCES = ("core.py", "rules.py", "checkers.py")


@functools.lru_cache(maxsize=1)
def _linter_digest() -> str:
    h = hashlib.sha256(b"heat_tpu_torch.analysis")
    here = os.path.dirname(os.path.abspath(__file__))
    for name in _LINTER_SOURCES:
        with open(os.path.join(here, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


class FindingsCache:
    def __init__(self, cache_dir: str = DEFAULT_CACHE_DIR):
        self.cache_dir = cache_dir
        self.hits = 0
        self.misses = 0

    # ------------------------------------------------------------------ #
    def _entry_path(self, ctx) -> str:
        digest = hashlib.sha256(
            os.path.abspath(ctx.path).encode("utf-8")
        ).hexdigest()[:24]
        return os.path.join(self.cache_dir, f"{digest}.json")

    @staticmethod
    def _key(ctx, dynamic: bool, rules: Optional[Sequence[str]]) -> Optional[list]:
        try:
            st = os.stat(ctx.path)
        except OSError:
            return None
        file_rules = sorted(r.id for r in RULES.values() if r.scope == "file")
        return [
            _FORMAT_VERSION,
            _linter_digest(),
            os.path.abspath(ctx.path),
            st.st_mtime_ns,
            st.st_size,
            bool(dynamic),
            sorted(rules) if rules is not None else None,
            file_rules,
        ]

    # ------------------------------------------------------------------ #
    def get(self, ctx, dynamic: bool, rules: Optional[Sequence[str]]
            ) -> Optional[List[Finding]]:
        key = self._key(ctx, dynamic, rules)
        if key is None:
            self.misses += 1
            return None
        try:
            with open(self._entry_path(ctx), "r", encoding="utf-8") as f:
                entry = json.load(f)
        except (OSError, ValueError):  # spmdlint: disable=SPMD207 -- unreadable or corrupt cache entries ARE misses; analysis recomputes and overwrites them
            self.misses += 1
            return None
        if entry.get("key") != key:
            self.misses += 1
            return None
        self.hits += 1
        return [Finding.from_dict(d) for d in entry.get("findings", [])]

    def put(self, ctx, dynamic: bool, rules: Optional[Sequence[str]],
            findings: Sequence[Finding]) -> None:
        key = self._key(ctx, dynamic, rules)
        if key is None:
            return
        try:
            os.makedirs(self.cache_dir, exist_ok=True)
            tmp = self._entry_path(ctx) + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(
                    {"key": key, "findings": [x.to_dict() for x in findings]},
                    f,
                )
            os.replace(tmp, self._entry_path(ctx))
        except OSError:  # spmdlint: disable=SPMD207 -- a cache that cannot write is just a cache that always misses; linting must not fail over it
            pass

    def stats(self) -> str:
        return f"{self.hits} hit, {self.misses} miss"
