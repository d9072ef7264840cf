"""Split-semantics declarations: the op layer's transfer-function registry.

Port of ``heat_tpu/core/_split_semantics.py``, copied (it imports only
the standard library).  Every public op declares how it transforms
sharding metadata — its *transfer function* over split specs — next to
its definition, via :func:`declare_split_semantics_table` tables at the
bottom of each op module or the :func:`split_semantics` decorator on
methods.  :data:`REGISTRY` holds the declarations; the tests hold each
declared op's result ``split`` to the rule, and a static analysis reads
the same tables from source (hence each table stays a LITERAL dict).

This module is deliberately dependency-free (no torch, no numpy).

Kinds (the transfer-function families; ``params`` refine them):

=================  =====================================================
``elementwise``    unary map — splits, shape, raggedness preserved
``binary``         broadcast binary — the ``__binary_op`` anchor rules:
                   result carries the non-None split (re-anchored from
                   the right under broadcasting); operands split along
                   DIFFERENT axes force an implicit resplit of the
                   second operand onto the first's layout
``reduction``      axis reduction — reducing across the split axis
                   yields split=None, otherwise the split index shifts
                   down past removed axes (``__reduce_op``)
``cumulative``     split and shape preserved (``__cum_op``)
``matmul``         ``_result_split_matmul``: split-0 @ anything → row
                   split, anything @ col-split → col split, contraction
                   over the split axis → replicated
``transpose``      split follows its axis through the permutation
``reshape``        split preserved when the axis index survives, else
                   re-split at 0 (``manipulations.reshape``)
``concat``         first non-None operand split, along any axis
``stack``          split shifts past the new axis
``expand_dims``    split shifts past the inserted axis
``squeeze``        split drops with its axis or shifts down
``flatten``        any split → 0, replicated stays replicated
``resplit``        explicit layout change to the ``axis`` argument —
                   the one declared COMM op (costed by the
                   redistribution plan model).  ``axis`` may also be a
                   splits TUPLE (the N-D mesh spelling): facts stay
                   tuple-valued and the 1-D int form promotes to its
                   one-hot tuple automatically
``factory``        new array, split from the ``split=`` keyword, or a
                   splits tuple from ``splits=`` — tuple entries name
                   MESH axes and validate against the target comm's
                   mesh rank (the default comm's mesh is 1-D)
``factory_like``   new array mirroring the input's layout
``entry_fit``      estimator entry point returning the estimator itself
``entry_split0``   library entry point whose result is row-split iff
                   the data argument is row-split (predict family and
                   its shared input gate ``sanitize_predict_in``,
                   cdist, the U factor of svd).  The gate is also the
                   transfer fact serve pipelines are priced on:
                   replicated and row-split inputs pass through with
                   ZERO layout traffic (no resplit event to cost);
                   only a feature-split input re-splits onto rows
``entry_svd``      ``SVD(U, S, V)`` namedtuple: U per ``entry_split0``,
                   S and V replicated; grid ``(0, 1)``/``(1, 0)``
                   operands pin U to ``(0, 1)`` with S and V replicated
                   (wide grid inputs transpose-and-swap, so V lands on
                   the grid instead of U)
``entry_qr``       ``QR(Q, R)`` namedtuple: grid ``(0, 1)`` operands
                   pin Q to ``(0, 1)`` and R to ``(None, 1)``; 1-D Q
                   follows the operand split, R is sharded only down
                   the split-1 chain (``split == 1`` keeps R on 1,
                   everything else replicates R)
=================  =====================================================
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

__all__ = [
    "KINDS",
    "KIND_LAYOUT_FREEDOM",
    "REGISTRY",
    "Semantics",
    "declare_split_semantics",
    "declare_split_semantics_table",
    "layout_alternatives",
    "split_semantics",
]

KINDS = frozenset(
    {
        "elementwise",
        "binary",
        "reduction",
        "cumulative",
        "matmul",
        "transpose",
        "reshape",
        "concat",
        "stack",
        "expand_dims",
        "squeeze",
        "flatten",
        "resplit",
        "factory",
        "factory_like",
        "entry_fit",
        "entry_split0",
        "entry_svd",
        "entry_qr",
    }
)


@dataclass(frozen=True)
class Semantics:
    """One op's declared transfer function.

    ``name`` is the public leaf name call sites resolve to (module
    function or method — the DNDarray methods delegate to the module
    functions of the same name, so one declaration covers both
    spellings).  ``module`` records where the declaration lives, for
    drift diagnostics.  ``params`` is a frozen extras tuple.
    """

    name: str
    kind: str
    module: str
    params: Tuple[Tuple[str, object], ...] = ()

    def param(self, key: str, default=None):
        for k, v in self.params:
            if k == key:
                return v
        return default


#: leaf name -> declared semantics.  One namespace on purpose: the public
#: API is flat (``htt.*`` mirrors the reference) and method names shadow
#: their module functions.
REGISTRY: Dict[str, Semantics] = {}


#: Layout freedom of each kind's RESULT — the op layer's declaration of
#: which placements the auto-layout solver (autoshard) may choose,
#: sitting next to the transfer facts exactly like the kinds table above:
#:
#: ``free``
#:     the result may legally rest at ANY split (``resplit``: the target
#:     layout is the op's entire purpose, so the solver owns it);
#: ``declared``
#:     the layout comes from an explicit keyword (``split=``/``splits=``)
#:     and any value is legal — the solver may re-place it, but v1 keeps
#:     user-declared factory layouts (they are inputs to the search, not
#:     seams in it);
#: ``follows``
#:     the result layout is a function of the operand layouts (the
#:     transfer function above); the solver influences it only through
#:     the operands;
#: ``fixed``
#:     the entry point pins its own contract (e.g. ``entry_svd``'s S and
#:     V are replicated by construction) — never a search dimension.
KIND_LAYOUT_FREEDOM: Dict[str, str] = {
    "elementwise": "follows",
    "binary": "follows",
    "reduction": "follows",
    "cumulative": "follows",
    "matmul": "follows",
    "transpose": "follows",
    "reshape": "follows",
    "concat": "follows",
    "stack": "follows",
    "expand_dims": "follows",
    "squeeze": "follows",
    "flatten": "follows",
    "resplit": "free",
    "factory": "declared",
    "factory_like": "follows",
    "entry_fit": "fixed",
    "entry_split0": "fixed",
    "entry_svd": "fixed",
    "entry_qr": "fixed",
}


def layout_alternatives(kind: str, ndim: int, mesh_ndim: int = 1) -> Tuple:
    """Legal layout placements for the result of an op of ``kind`` on an
    ``ndim``-dimensional value over a ``mesh_ndim``-axis mesh.

    The enumeration the auto-layout solver searches: on a 1-D mesh the
    compat int spelling (``None`` first, then each array axis); on an N-D
    mesh the splits-tuple spelling (every assignment of mesh axes to
    array dims, each mesh axis at most once, fully-replicated first).
    Deterministic canonical order — the solver's tie-break depends on it.
    Kinds whose layout is not a search dimension return ``()``.
    """
    if KIND_LAYOUT_FREEDOM.get(kind, "fixed") not in ("free", "declared"):
        return ()
    ndim = int(ndim)
    if mesh_ndim <= 1:
        return (None,) + tuple(range(ndim))
    out = []

    def _extend(prefix, used):
        if len(prefix) == ndim:
            out.append(tuple(prefix))
            return
        for g in (None,) + tuple(range(mesh_ndim)):
            if g is not None and g in used:
                continue
            _extend(prefix + [g], used | ({g} if g is not None else set()))

    _extend([], set())
    # replicated-first canonical order: rank None below every mesh axis
    out.sort(key=lambda t: tuple(-1 if g is None else g for g in t))
    return tuple(out)


def declare_split_semantics(name: str, kind: str, *, module: str = "", **params) -> Semantics:
    """Declare the transfer function of op ``name`` (table form — call at
    the bottom of the module defining the op)."""
    if kind not in KINDS:
        raise ValueError(f"unknown split-semantics kind {kind!r} for {name!r}")
    prev = REGISTRY.get(name)
    sem = Semantics(name, kind, module, tuple(sorted(params.items())))
    if prev is not None and (prev.kind, prev.params) != (sem.kind, sem.params):
        raise ValueError(
            f"conflicting split semantics for {name!r}: "
            f"{prev.kind} from {prev.module} vs {kind} from {module}"
        )
    REGISTRY[name] = sem
    return sem


def declare_split_semantics_table(module: str, table: Dict[str, Tuple[str, ...]]) -> None:
    """Bulk table form: ``{kind: (op names...)}``.  Keep the argument a
    LITERAL dict — the static analyzer re-reads these declarations from
    source, and only literal tables parse without execution."""
    for kind, names in table.items():
        for name in names:
            declare_split_semantics(name, kind, module=module)


def split_semantics(kind: str, name: Optional[str] = None, **params):
    """Decorator form of :func:`declare_split_semantics` — registers the
    function under its own name and returns it UNCHANGED (no wrapper, so
    tracing, pickling, and ``cache_stable`` identity are unaffected)."""

    def deco(fn):
        declare_split_semantics(
            name or fn.__name__, kind, module=getattr(fn, "__module__", ""), **params
        )
        fn.__split_semantics__ = REGISTRY[name or fn.__name__]
        return fn

    return deco
