"""Transfer functions: op kind × operand specs → result spec + comm facts.

Port of ``heat_tpu/analysis/splitflow/transfer.py``, copied (stdlib-only).

One function per declared op kind (see
:mod:`heat_tpu_torch.core._split_semantics` for the authoritative kind
catalog).  Each mirrors the runtime's split bookkeeping exactly:

- ``binary`` follows ``core/_operations.__binary_op``: the non-None-split
  operand anchors, and two operands split along DIFFERENT axes force a
  hidden ``t2.resplit(t1.split)`` — the implicit-resplit fact SPMD501
  reports.
- ``reduction`` follows ``__reduce_op``: reducing the split axis
  replicates the result, reducing below it shifts the split down.
- ``matmul`` follows ``linalg.basics._result_split_matmul``.
- ``resplit`` IS the layout change; the fact records src → dst so the
  cost report can price it with :mod:`heat_tpu_torch.comm._costs`.

Transfer functions return ``(result, facts)`` where ``result`` is a
:class:`~heat_tpu_torch.analysis.splitflow.domain.Spec` (or a tuple of Specs
for multi-output ops) and each fact is an :class:`OpFact` the engine
stamps with its AST location.  Facts are emitted only on *known* layout
components — ⊤ never produces one (no guessing).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from .domain import NOT_ARRAY, Spec, TOP, UNKNOWN, join_split

__all__ = ["MISSING", "NONLIT", "OpFact", "apply_kind"]


@dataclass
class OpFact:
    """One statically-derived communication/layout fact.

    ``op`` ∈ ``implicit_resplit`` (SPMD501), ``resplit_chain`` (SPMD502),
    ``split_oob`` (SPMD503), ``noop_collective`` (SPMD504), ``resplit``
    (explicit, priced by the cost report), ``reduce`` (collective combine
    of a sharded reduction; recorded, not priced).
    """

    op: str
    src: object = None
    dst: object = None
    shape: Optional[Tuple[int, ...]] = None
    dtype: Optional[str] = None
    note: str = ""


#: argument not present in the call — kind defaults apply (a bare
#: ``x.resplit()`` means axis=None, exactly like the runtime signature)
_MISSING = MISSING = object()

#: argument present but not a static literal — the value is unknown and
#: anything derived from it goes to ⊤ (never to a default)
NONLIT = object()


def _first_array(operands: Sequence[Spec]) -> Spec:
    for s in operands:
        if isinstance(s, Spec) and s.is_array:
            return s
    return NOT_ARRAY


def _is_splits_tuple(v) -> bool:
    return isinstance(v, (tuple, list)) and all(
        g is None or isinstance(g, int) for g in v)


def _promote_split(split, ndim):
    """Canonical form for layout comparison: a 1-D int split promotes to
    its one-hot splits tuple when the rank is known (mirrors
    ``normalize_splits`` in the runtime)."""
    if isinstance(split, int) and ndim is not None:
        tup = [None] * ndim
        tup[split % ndim] = 0
        return tuple(tup)
    if _is_splits_tuple(split):
        return tuple(split)
    return split


def _splits_tuple_issues(tup, ndim, *, mesh_ndim=None) -> List[str]:
    """Static validity problems of a literal splits tuple (SPMD503 fuel).

    ``mesh_ndim`` is the mesh rank to validate entries against; ``None``
    means the target mesh is unknown (a ``comm=`` argument is present)
    and entry values are not checked.
    """
    issues: List[str] = []
    if ndim is not None and len(tup) != ndim:
        issues.append(
            f"splits tuple has {len(tup)} entries for a {ndim}-d array")
    seen = {}
    for d, g in enumerate(tup):
        if g is None:
            continue
        if mesh_ndim is not None and not (-mesh_ndim <= g < mesh_ndim):
            issues.append(
                f"splits[{d}]={g} out of range for a {mesh_ndim}-d mesh")
        if g in seen:
            issues.append(
                f"mesh axis {g} shards both dims {seen[g]} and {d}")
        else:
            seen[g] = d
    return issues


def _shape_after_reduce(shape, axes, keepdims):
    if shape is None or axes is _MISSING:
        return None
    if axes is None:
        return () if not keepdims else tuple(1 for _ in shape)
    axes = {a % len(shape) for a in axes}
    if keepdims:
        return tuple(1 if i in axes else s for i, s in enumerate(shape))
    return tuple(s for i, s in enumerate(shape) if i not in axes)


def _elementwise(x: Spec) -> Tuple[Spec, List[OpFact]]:
    return x, []


def _binary(a: Spec, b: Spec) -> Tuple[Spec, List[OpFact]]:
    if not a.is_array:
        return b, []
    if not b.is_array:
        return a, []
    facts: List[OpFact] = []
    if isinstance(a.split, int):
        out = a.split
        if isinstance(b.split, int) and b.split != a.split:
            # __binary_op auto-reshards t2 to t1's split (hidden traffic)
            facts.append(OpFact(
                "implicit_resplit", src=b.split, dst=a.split,
                shape=b.shape, dtype=b.dtype,
                note="operand splits disagree; right operand is resharded",
            ))
    elif a.split is None:
        out = b.split
    else:  # a ⊤
        out = TOP
    shape = a.shape if a.shape == b.shape else None
    dtype = a.dtype if a.dtype == b.dtype else None
    return Spec(split=out, shape=shape, dtype=dtype,
                ragged=a.ragged or b.ragged), facts


def _reduction(x: Spec, axes, keepdims) -> Tuple[Spec, List[OpFact]]:
    if not x.is_array:
        return NOT_ARRAY, []
    facts: List[OpFact] = []
    keep = keepdims is True
    shape = _shape_after_reduce(x.shape, axes, keep)
    if x.split is TOP:
        return Spec(split=TOP, shape=shape, dtype=x.dtype), facts
    if x.split is None:
        return Spec(split=None, shape=shape, dtype=x.dtype), facts
    if axes is _MISSING:  # axis not statically known
        return Spec(split=TOP, shape=shape, dtype=x.dtype), facts
    if axes is None:
        facts.append(OpFact("reduce", src=x.split, dst=None,
                            shape=x.shape, dtype=x.dtype,
                            note="full reduction of a sharded operand"))
        return Spec(split=None, shape=shape, dtype=x.dtype), facts
    norm = {a % len(x.shape) if x.shape else a for a in axes}
    if x.split in norm:
        facts.append(OpFact("reduce", src=x.split, dst=None,
                            shape=x.shape, dtype=x.dtype,
                            note="reduction along the split axis"))
        split = x.split if keep else None
        return Spec(split=split, shape=shape, dtype=x.dtype), facts
    shift = 0 if keep else sum(1 for a in norm if a < x.split)
    return Spec(split=x.split - shift, shape=shape, dtype=x.dtype), facts


def _matmul(a: Spec, b: Spec) -> Tuple[Spec, List[OpFact]]:
    if not a.is_array or not b.is_array:
        return UNKNOWN, []
    shape = None
    if a.shape is not None and b.shape is not None \
            and len(a.shape) == 2 and len(b.shape) == 2:
        shape = (a.shape[0], b.shape[1])
    dtype = a.dtype if a.dtype == b.dtype else None
    if a.split is TOP or b.split is TOP:
        return Spec(split=TOP, shape=shape, dtype=dtype), []
    if _is_splits_tuple(a.split) or _is_splits_tuple(b.split):
        # grid SUMMA path: two fully 2-D-sharded operands keep the grid
        # layout, and the rank-local schedules — rows-by-r times
        # cols-by-c ("rowcol") and its mirror ("colrow") — commit their
        # product onto the grid without redistributing either operand;
        # anything else over a splits tuple is left unknown
        if a.split == (0, 1) and b.split == (0, 1):
            return Spec(split=(0, 1), shape=shape, dtype=dtype), []
        if a.split == (0, None) and b.split == (None, 1):
            return Spec(split=(0, 1), shape=shape, dtype=dtype), []
        if a.split == (None, 1) and b.split == (0, None):
            return Spec(split=(0, 1), shape=shape, dtype=dtype), []
        return Spec(split=TOP, shape=shape, dtype=dtype), []
    if a.split == 0:
        return Spec(split=0, shape=shape, dtype=dtype), []
    if isinstance(b.split, int):
        if b.shape is not None and b.split == len(b.shape) - 1:
            return Spec(split=b.split, shape=shape, dtype=dtype), []
        if b.shape is None:
            return Spec(split=TOP, shape=shape, dtype=dtype), []
    facts = []
    if a.split == 1 or b.split == 0:
        facts.append(OpFact("reduce", src=a.split if a.split == 1 else b.split,
                            dst=None, shape=shape, dtype=dtype,
                            note="sharded contraction combines partials"))
    return Spec(split=None, shape=shape, dtype=dtype), facts


def _transpose(x: Spec, axes) -> Tuple[Spec, List[OpFact]]:
    if not x.is_array:
        return NOT_ARRAY, []
    shape = None
    if x.shape is not None:
        order = axes if axes not in (None, _MISSING) else tuple(
            reversed(range(len(x.shape)))
        )
        if isinstance(order, (tuple, list)) and len(order) == len(x.shape):
            shape = tuple(x.shape[a] for a in order)
    if not isinstance(x.split, int):
        return Spec(split=x.split, shape=shape, dtype=x.dtype), []
    if axes is _MISSING:
        return Spec(split=TOP, shape=shape, dtype=x.dtype), []
    if axes is None:
        if x.ndim is None:
            return Spec(split=TOP, shape=shape, dtype=x.dtype), []
        return Spec(split=x.ndim - 1 - x.split, shape=shape, dtype=x.dtype), []
    try:
        return Spec(split=list(axes).index(x.split), shape=shape,
                    dtype=x.dtype), []
    except ValueError:
        return Spec(split=TOP, shape=shape, dtype=x.dtype), []


def _reshape(x: Spec, newshape) -> Tuple[Spec, List[OpFact]]:
    if not x.is_array:
        return NOT_ARRAY, []
    shape = tuple(newshape) if isinstance(newshape, (tuple, list)) and all(
        isinstance(s, int) for s in newshape) else None
    if isinstance(x.split, int):
        split = x.split if shape is not None and x.split < len(shape) else (
            0 if shape is not None else TOP)
    else:
        split = x.split
    return Spec(split=split, shape=shape, dtype=x.dtype), []


def _concat(arrays: Sequence[Spec], axis) -> Tuple[Spec, List[OpFact]]:
    splits = [a.split for a in arrays if a.is_array]
    if not splits:
        return UNKNOWN, []
    if any(s is TOP for s in splits):
        split = TOP
    else:
        split = next((s for s in splits if s is not None), None)
    shape = None
    shapes = [a.shape for a in arrays if a.is_array]
    if axis not in (None, _MISSING) and all(s is not None for s in shapes) \
            and shapes and len({s[:axis] + s[axis + 1:] for s in shapes}) == 1:
        cat = sum(s[axis] for s in shapes)
        s0 = list(shapes[0])
        s0[axis] = cat
        shape = tuple(s0)
    dtypes = {a.dtype for a in arrays if a.is_array}
    return Spec(split=split, shape=shape,
                dtype=dtypes.pop() if len(dtypes) == 1 else None), []


def _axis_shift_in(x: Spec, axis) -> Tuple[Spec, List[OpFact]]:
    """stack/expand_dims: a new axis at ``axis`` shifts splits at or
    above it up by one."""
    if not x.is_array:
        return NOT_ARRAY, []
    shape = None
    if x.shape is not None and axis is not _MISSING and axis is not None:
        a = axis % (len(x.shape) + 1)
        shape = x.shape[:a] + (1,) + x.shape[a:]
    if not isinstance(x.split, int):
        return Spec(split=x.split, shape=shape, dtype=x.dtype), []
    if axis is _MISSING or axis is None:
        return Spec(split=TOP, shape=shape, dtype=x.dtype), []
    a = axis if axis >= 0 else (axis % ((x.ndim or 0) + 1))
    return Spec(split=x.split + 1 if a <= x.split else x.split,
                shape=shape, dtype=x.dtype), []


def _squeeze(x: Spec, axis) -> Tuple[Spec, List[OpFact]]:
    if not x.is_array:
        return NOT_ARRAY, []
    if not isinstance(x.split, int):
        return Spec(split=x.split, shape=None, dtype=x.dtype), []
    if axis is _MISSING or axis is None:
        return Spec(split=TOP, shape=None, dtype=x.dtype), []
    a = axis % len(x.shape) if x.shape else axis
    return Spec(split=x.split - 1 if a < x.split else x.split,
                shape=None, dtype=x.dtype), []


def _flatten(x: Spec) -> Tuple[Spec, List[OpFact]]:
    if not x.is_array:
        return NOT_ARRAY, []
    shape = None
    if x.shape is not None:
        n = 1
        for s in x.shape:
            n *= s
        shape = (n,)
    if isinstance(x.split, int):
        split = 0
    else:
        split = x.split
    return Spec(split=split, shape=shape, dtype=x.dtype), []


def _resplit(x: Spec, dst) -> Tuple[Spec, List[OpFact]]:
    if not x.is_array:
        return NOT_ARRAY, []
    facts: List[OpFact] = []
    if dst is _MISSING or dst is NONLIT:
        return Spec(split=TOP, shape=x.shape, dtype=x.dtype), facts
    if isinstance(dst, (tuple, list)):
        if not _is_splits_tuple(dst):
            return Spec(split=TOP, shape=x.shape, dtype=x.dtype), facts
        dst = tuple(dst)
        # the target mesh rank is the comm's, which is not statically
        # known here — check only the mesh-independent invariants
        issues = _splits_tuple_issues(dst, x.ndim, mesh_ndim=None)
        if issues:
            facts.append(OpFact(
                "split_oob", src=x.split, dst=dst,
                shape=x.shape, dtype=x.dtype, note="; ".join(issues),
            ))
            return Spec(split=TOP, shape=x.shape, dtype=x.dtype), facts
        if x.split is not TOP and _promote_split(x.split, x.ndim) == \
                _promote_split(dst, x.ndim):
            facts.append(OpFact(
                "noop_collective", src=x.split, dst=dst,
                shape=x.shape, dtype=x.dtype,
                note="resplit to the layout the value already has",
            ))
        elif x.split is not TOP:
            facts.append(OpFact("resplit", src=x.split, dst=dst,
                                shape=x.shape, dtype=x.dtype))
        return Spec(split=dst, shape=x.shape, dtype=x.dtype,
                    ragged=x.ragged), facts
    if isinstance(dst, int) and x.ndim is not None \
            and not (-x.ndim <= dst < x.ndim):
        facts.append(OpFact(
            "split_oob", src=x.split, dst=dst, shape=x.shape, dtype=x.dtype,
            note=f"axis {dst} out of range for {x.ndim}-d shape {x.shape}",
        ))
        return Spec(split=TOP, shape=x.shape, dtype=x.dtype), facts
    if isinstance(dst, int) and x.ndim is not None:
        dst = dst % x.ndim
    if x.split is not TOP and _promote_split(x.split, x.ndim) == \
            _promote_split(dst, x.ndim):
        facts.append(OpFact(
            "noop_collective", src=x.split, dst=dst,
            shape=x.shape, dtype=x.dtype,
            note="resplit to the layout the value already has",
        ))
    elif x.split is not TOP:
        facts.append(OpFact("resplit", src=x.split, dst=dst,
                            shape=x.shape, dtype=x.dtype))
    return Spec(split=dst, shape=x.shape, dtype=x.dtype,
                ragged=x.ragged), facts


def _factory(shape, split, dtype, splits=_MISSING,
             has_comm=False) -> Tuple[Spec, List[OpFact]]:
    facts: List[OpFact] = []
    shp = None
    if isinstance(shape, int):
        shp = (shape,)
    elif isinstance(shape, (tuple, list)) and all(
            isinstance(s, int) for s in shape):
        shp = tuple(shape)
    if splits is not _MISSING:
        # N-D mesh spelling.  Entries name MESH axes: without an explicit
        # ``comm=`` the array lands on the default 1-D mesh, so any entry
        # other than 0/None is statically out of range (SPMD503).
        if splits is NONLIT or not _is_splits_tuple(splits):
            return Spec(split=TOP, shape=shp, dtype=dtype), facts
        tup = tuple(splits)
        issues = _splits_tuple_issues(
            tup, len(shp) if shp is not None else None,
            mesh_ndim=None if has_comm else 1)
        if issues:
            facts.append(OpFact(
                "split_oob", src=None, dst=tup, shape=shp, dtype=dtype,
                note="; ".join(issues),
            ))
            return Spec(split=TOP, shape=shp, dtype=dtype), facts
        return Spec(split=tup, shape=shp, dtype=dtype), facts
    if split is NONLIT:
        return Spec(split=TOP, shape=shp, dtype=dtype), facts
    sp = split if split is not _MISSING else None
    if isinstance(sp, int) and shp is not None and not (-len(shp) <= sp < len(shp)):
        facts.append(OpFact(
            "split_oob", src=None, dst=sp, shape=shp, dtype=dtype,
            note=f"split={sp} out of range for shape {shp}",
        ))
        sp = TOP
    elif isinstance(sp, int) and shp is not None:
        sp = sp % len(shp)
    return Spec(split=sp, shape=shp, dtype=dtype), facts


def _entry_split0(x: Spec) -> Tuple[Spec, List[OpFact]]:
    """predict-family contract: output rides the input's row sharding
    when the input is row-split, else comes back replicated."""
    if not x.is_array or x.split is TOP:
        return Spec(split=TOP), []
    return Spec(split=0 if x.split == 0 else None, dtype=None), []


def _entry_svd(a: Spec, compute_uv) -> Tuple[object, List[OpFact]]:
    if not a.is_array:
        return UNKNOWN, []
    if compute_uv is False:
        return Spec(split=None, dtype=a.dtype), []
    s_spec = Spec(split=None, dtype=a.dtype)
    if a.split is None:
        return (Spec(split=None, dtype=a.dtype), s_spec,
                Spec(split=None, dtype=a.dtype)), []
    tall = None
    if a.shape is not None and len(a.shape) == 2:
        tall = a.shape[0] >= a.shape[1]
    if _is_splits_tuple(a.split):
        # grid QDWH path: a fully 2-D-sharded tall operand keeps U on
        # the grid with S and V replicated; wide grid inputs factor the
        # transpose and swap, landing V on the grid instead
        if a.split in ((0, 1), (1, 0)):
            if tall is None:
                return (Spec(split=TOP, dtype=a.dtype), s_spec,
                        Spec(split=TOP, dtype=a.dtype)), []
            if tall:
                return (Spec(split=(0, 1), dtype=a.dtype), s_spec,
                        Spec(split=None, dtype=a.dtype)), []
            return (Spec(split=None, dtype=a.dtype), s_spec,
                    Spec(split=(0, 1), dtype=a.dtype)), []
        return (Spec(split=TOP, dtype=a.dtype), s_spec,
                Spec(split=TOP, dtype=a.dtype)), []
    if a.split is TOP or tall is None:
        return (Spec(split=TOP, dtype=a.dtype), s_spec,
                Spec(split=TOP, dtype=a.dtype)), []
    if tall:
        u = Spec(split=0 if a.split == 0 else None, dtype=a.dtype)
        return (u, s_spec, Spec(split=None, dtype=a.dtype)), []
    # wide: factor the transpose and swap U/V
    v = Spec(split=0 if a.split == 1 else None, dtype=a.dtype)
    return (Spec(split=None, dtype=a.dtype), s_spec, v), []


def _entry_qr(a: Spec, calc_q) -> Tuple[object, List[OpFact]]:
    """qr contract: grid ``(0, 1)`` operands pin ``Q`` to ``(0, 1)`` and
    ``R`` to ``(None, 1)`` (each row of the panel hierarchy owns its R
    stripe); on a 1-D mesh Q follows the operand split while R is only
    sharded down the split-1 chain."""
    if not a.is_array:
        return UNKNOWN, []
    if a.split is TOP:
        top = Spec(split=TOP, dtype=a.dtype)
        return (top, top) if calc_q is not False else (NOT_ARRAY, top), []
    if _is_splits_tuple(a.split):
        if a.split == (0, 1):
            q = Spec(split=(0, 1), dtype=a.dtype)
            r = Spec(split=(None, 1), dtype=a.dtype)
        else:
            q = Spec(split=TOP, dtype=a.dtype)
            r = Spec(split=TOP, dtype=a.dtype)
    else:
        q = Spec(split=a.split, dtype=a.dtype)
        r = Spec(split=1 if a.split == 1 else None, dtype=a.dtype)
    if calc_q is False:
        # the runtime returns QR(None, R); R's layout does not depend on
        # whether Q was materialized
        return (NOT_ARRAY, r), []
    return (q, r), []


def apply_kind(kind: str, operands: Sequence[Spec], *,
               axis=_MISSING, shape=_MISSING, split=_MISSING,
               dtype: Optional[str] = None, keepdims=_MISSING,
               compute_uv=_MISSING, calc_q=_MISSING,
               arrays: Sequence[Spec] = (),
               splits=_MISSING, has_comm=False,
               ) -> Tuple[object, List[OpFact]]:
    """Dispatch one op kind over evaluated operand specs.

    ``operands`` are the array-valued operands in call order;
    ``axis``/``shape``/``split`` are statically-extracted literals
    (``_MISSING`` when the argument is absent or not a literal).
    """
    # present-but-dynamic arguments behave like unknown (⊤), never like
    # the kind's default; ``split`` keeps NONLIT so resplit/factory can
    # distinguish "dynamic axis" from "axis omitted"
    if axis is NONLIT:
        axis = _MISSING
    if shape is NONLIT:
        shape = _MISSING
    if keepdims is NONLIT:
        keepdims = _MISSING
    if compute_uv is NONLIT:
        compute_uv = _MISSING
    if calc_q is NONLIT:
        calc_q = _MISSING
    x = _first_array(operands)
    if kind == "elementwise":
        return _elementwise(x)
    if kind == "binary":
        arr = [s for s in operands if isinstance(s, Spec)]
        a = arr[0] if arr else NOT_ARRAY
        b = arr[1] if len(arr) > 1 else NOT_ARRAY
        return _binary(a, b)
    if kind == "reduction":
        ax = axis
        if isinstance(ax, int):
            ax = (ax,)
        elif isinstance(ax, (tuple, list)):
            ax = tuple(ax)
        elif ax is not None and ax is not _MISSING:
            ax = _MISSING
        return _reduction(x, ax, keepdims)
    if kind == "cumulative":
        return x, []
    if kind == "matmul":
        arr = [s for s in operands if isinstance(s, Spec) and s.is_array]
        if len(arr) < 2:
            return UNKNOWN, []
        return _matmul(arr[0], arr[1])
    if kind == "transpose":
        return _transpose(x, axis)
    if kind == "reshape":
        return _reshape(x, shape if shape is not _MISSING else None)
    if kind == "concat":
        ax = axis if isinstance(axis, int) else (0 if axis is _MISSING else axis)
        return _concat(list(arrays) or list(operands), ax)
    if kind == "stack":
        specs = list(arrays) or list(operands)
        joined = _first_array(specs)
        ax = axis if isinstance(axis, int) else 0
        out, facts = _axis_shift_in(joined, ax)
        for s in specs[1:]:
            if s.is_array:
                out = out.with_split(join_split(out.split, _axis_shift_in(s, ax)[0].split))
        return out, facts
    if kind == "expand_dims":
        return _axis_shift_in(x, axis)
    if kind == "squeeze":
        return _squeeze(x, axis)
    if kind == "flatten":
        return _flatten(x)
    if kind == "resplit":
        return _resplit(x, split if split is not _MISSING else (
            axis if axis is not _MISSING else None))
    if kind == "factory":
        return _factory(shape if shape is not _MISSING else None,
                        split, dtype or "float32",
                        splits=splits, has_comm=has_comm)
    if kind == "factory_like":
        if not x.is_array:
            return UNKNOWN, []
        if split is NONLIT:
            return x.widened(), []
        if split is not _MISSING and (split is None or isinstance(split, int)):
            # explicit layout override; allocates in place, no traffic
            return Spec(split=split, shape=x.shape, dtype=x.dtype), []
        return x, []
    if kind == "entry_fit":
        return NOT_ARRAY, []
    if kind == "entry_split0":
        return _entry_split0(x)
    if kind == "entry_svd":
        return _entry_svd(x, compute_uv if compute_uv is not _MISSING else True)
    if kind == "entry_qr":
        return _entry_qr(x, calc_q if calc_q is not _MISSING else True)
    return UNKNOWN, []
