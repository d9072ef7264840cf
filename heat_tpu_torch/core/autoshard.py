"""Cost-driven auto-layout: ``htt.autoshard``.

Port of ``heat_tpu/core/autoshard.py``.  ``autoshard(fn)`` is a layer over
:func:`heat_tpu_torch.fuse` that stops treating the hand-written resplit
placements as law.  It statically summarizes ``fn``'s layout traffic
(:func:`heat_tpu_torch.analysis.splitflow.layout_summary` — per-seam
shapes, dtypes, hand layouts, and dead-chain provenance), searches the
declared placement space against the comm layer's own cost model
(:class:`heat_tpu_torch.comm._costs.LayoutSolver` — wire bytes, then
:func:`~heat_tpu_torch.comm._costs.critical_path_ms` under the active
overlap policy, then a deterministic layout-rank tie-break), and compiles
the argmin plan into ONE cached program per (arguments × comm × policy)
signature, exactly like ``fuse`` — the plan fingerprint joins the cache
key.

Because a chain's final placement stays pinned to the hand layout, the
solved pipeline is a drop-in: identical output metadata,
bitwise-identical values, at most the hand plan's wire bytes (the solver
may elide or reroute interior hops, never add mandatory ones).

Fallback ladder, the reference's:

1. summary incomplete (control flow around seams, in-place ``resplit_``,
   helper traffic, unknown shapes) or a grid (>1-D) comm → plain
   ``fuse(fn)``, hand layout untouched;
2. summary complete → ``fuse(fn, layout_plan=plan)``: resplits inside
   the trace consult the plan (:func:`heat_tpu_torch.core._tracing.
   applying_layout_plan`), one dispatch per call (on the card one
   CUDA-graph replay), and each call credits the plan's modeled bytes to
   the telemetry wire ledger (a traced resplit has no collective of its
   own to account, and the model IS the runtime's own arithmetic, so
   ledger and plan agree byte for byte);
3. ``fn`` cannot trace (:class:`FuseTraceError` — value-forcing host
   code, such as an estimator's fit) → eager execution under the same
   plan: each resplit consumes its override at the call site and
   self-accounts as usual.

Only :class:`FuseTraceError` takes rung 3.  A capture the card refuses
for another reason raises ``RuntimeError`` from ``fuse``, and that error
reaches the caller: ``autoshard`` never runs a pipeline eagerly behind
its back.

The plan is policy-keyed: changing collective precision, redistribution
policy, or the overlap switch re-solves (and re-prices) rather than
replaying a plan optimized for a different cost surface.
"""

from __future__ import annotations

import functools
import inspect
from typing import Any, Callable, Dict, Optional, Tuple

from ..telemetry import _core as _tel
from ._tracing import FuseTraceError, applying_layout_plan
from .communication import TorchCommunication
from .dndarray import DNDarray
from .fuse import _FusedFunction, _flatten

__all__ = ["autoshard"]

#: summary sentinel: "not computed yet" (None is a valid failure result)
_UNSET = object()


def _policy_key(comm) -> Tuple:
    """Everything that changes the cost surface a plan was solved on."""
    from ..comm import (
        get_collective_precision,
        get_collective_threshold,
        get_overlap,
        get_redistribution,
        get_redistribution_threshold,
    )

    return (
        comm,
        get_collective_precision(),
        get_collective_threshold(),
        get_redistribution(),
        get_redistribution_threshold(),
        get_overlap(),
    )


class _AutoshardFunction:
    """The callable returned by :func:`autoshard`."""

    def __init__(self, fn: Callable, donate: bool = False):
        self._fn = fn
        self._donate = bool(donate)
        self._summary: Any = _UNSET
        #: policy key -> ["fused"|"eager"|"plain", plan, fused callable or None]
        self._programs: Dict[Tuple, list] = {}
        self._plain: Optional[_FusedFunction] = None
        functools.update_wrapper(self, fn)

    # ------------------------------------------------------------------ #
    # static side                                                         #
    # ------------------------------------------------------------------ #
    def _summarize(self):
        """The pipeline's layout-transfer summary, computed once.

        Any static-analysis failure (no retrievable source, dynamically
        built function) degrades to ``None`` — the plain-fuse rung of the
        fallback ladder — never to an exception at call time.
        """
        if self._summary is not _UNSET:
            return self._summary
        summary = None
        try:
            from ..analysis.core import FileContext
            from ..analysis.splitflow import build_program, layout_summary

            path = inspect.getsourcefile(self._fn)
            if path is not None:
                ctx = FileContext(path)
                if not ctx.skip_file:
                    program = build_program([ctx])
                    qualname = self._fn.__qualname__.replace(".<locals>", "")
                    summary = layout_summary(program, qualname)
        except Exception:  # static analysis must never break execution
            summary = None
        if summary is not None and not summary.get("complete"):
            if _tel.enabled:
                _tel.record_event(
                    "autoshard.fallback",
                    site=f"autoshard:{getattr(self._fn, '__name__', '?')}",
                    reason="incomplete-summary",
                    notes=tuple(summary.get("notes", ()))[:4],
                )
            summary = None
        self._summary = summary
        return summary

    def _program(self, comm):
        """The (mode, plan, callable) entry for the active policy."""
        key = _policy_key(comm)
        entry = self._programs.get(key)
        if entry is not None:
            return entry
        summary = self._summarize()
        if summary is None or getattr(comm, "mesh_ndim", 1) > 1:
            # the runtime override seam is 1-D: a grid comm still gets
            # whole-program compilation, just with the hand layout
            entry = ["plain", None, self._plain_fused()]
            self._programs[key] = entry
            return entry

        from ..comm import (
            get_collective_precision,
            get_collective_threshold,
            get_overlap,
        )
        from ..comm._costs import LayoutSolver

        solver = LayoutSolver(
            comm.size,
            precision=get_collective_precision(),
            threshold=get_collective_threshold(),
            overlap=(get_overlap() == "on"),
        )
        plan = solver.solve(summary)
        if _tel.enabled:
            _tel.record_event(
                "autoshard.plan",
                site=f"autoshard:{getattr(self._fn, '__name__', '?')}",
                fingerprint=plan["fingerprint"],
                mesh=plan["mesh"],
                seams=len(plan["decisions"]),
                elided=sum(1 for d in plan["decisions"] if d["elide"]),
                modeled_wire_bytes=plan["modeled_wire_bytes"],
                hand_wire_bytes=plan["hand_wire_bytes"],
            )
            _tel.inc("autoshard.plans.solved")
        fused = _FusedFunction(self._fn, donate=self._donate, layout_plan=plan)
        entry = ["fused", plan, fused]
        self._programs[key] = entry
        return entry

    def _plain_fused(self) -> _FusedFunction:
        if self._plain is None:
            self._plain = _FusedFunction(self._fn, donate=self._donate)
        return self._plain

    def plan(self, comm=None) -> Optional[dict]:
        """The solved plan for ``comm`` (default communicator when
        ``None``) under the CURRENT comm policies — introspection for
        tests, benches, and docs.  ``None`` on the plain-fuse fallback."""
        from .communication import sanitize_comm

        return self._program(sanitize_comm(comm))[1]

    # ------------------------------------------------------------------ #
    # runtime side                                                        #
    # ------------------------------------------------------------------ #
    def __call__(self, *args, **kwargs):
        from . import _xproc
        from .communication import sanitize_comm

        _xproc.refuse_across("htt.autoshard", None, *[a for a in (*args, *kwargs.values())
                                                      if isinstance(a, DNDarray)])

        # the communicator: the first DNDarray's, else the first one passed
        leaves: list = []
        _flatten((args, kwargs), leaves)
        comm = None
        for leaf in leaves:
            if isinstance(leaf, DNDarray):
                comm = leaf.comm
                break
            if comm is None and isinstance(leaf, TorchCommunication):
                comm = leaf
        comm = sanitize_comm(comm)

        entry = self._program(comm)
        mode, plan, fused = entry
        if mode == "plain":
            return fused(*args, **kwargs)
        if mode == "eager":
            with applying_layout_plan(plan["decisions"]):
                return self._fn(*args, **kwargs)

        # fused-with-plan: one dispatch, then credit the plan's modeled
        # bytes to the wire ledger (nothing inside the program can: its
        # resplits were folded in at trace time)
        try:
            result = fused(*args, **kwargs)
        except FuseTraceError:
            # value-forcing host code (iterative fits, data-dependent
            # Python control flow) cannot trace — run the pipeline
            # eagerly under the same plan; each resplit consumes its
            # override at the call site and self-accounts as usual
            entry[0] = "eager"
            entry[2] = None
            if _tel.enabled:
                _tel.record_event(
                    "autoshard.fallback",
                    site=f"autoshard:{getattr(self._fn, '__name__', '?')}",
                    reason="untraceable",
                )
            with applying_layout_plan(plan["decisions"]):
                return self._fn(*args, **kwargs)
        if _tel.enabled:
            self._credit(plan)
        return result

    @staticmethod
    def _credit(plan: dict) -> None:
        for d in plan["decisions"]:
            if d["wire_bytes"] <= 0:
                continue  # elided or zero-traffic seam: nothing shipped
            _tel.account_bytes(
                "resplit", d["mode"] or "f32", d["exact_bytes"], d["wire_bytes"]
            )
            _tel.inc("comm.resplit.autoshard")


def autoshard(fn: Optional[Callable] = None, *, donate: bool = False):
    """Solve the cheapest sharding plan for a pipeline, then compile it.

    Use as a decorator (``@htt.autoshard``) or inline
    (``solved = htt.autoshard(my_pipeline)``).  Output metadata and values
    are identical to the hand-written pipeline; interior layout hops may
    be elided or rerouted when the cost model prices them cheaper.  See
    the module docstring for the fallback ladder.
    """
    if fn is None:
        return functools.partial(autoshard, donate=donate)
    return _AutoshardFunction(fn, donate=donate)
