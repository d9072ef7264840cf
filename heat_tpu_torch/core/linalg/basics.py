"""Linear algebra basics: ``matmul``, ``dot``, the norms, ``outer``,
``projection``, ``transpose``, ``tril`` and ``triu``.

Port of ``heat_tpu/core/linalg/basics.py``.  Every position lives on one
device, so a product in any split combination is one ``torch.matmul`` over
the true-shape operands (no pad value reaches the k-sum), laid out at the
reference's result split.  On a 2-D position grid the three layouts the
reference's grid SUMMA serves, ``(0, 1) x (0, 1)``, ``(0, None) x (None,
1)`` and ``(None, 1) x (0, None)``, give a product at ``splits=(0, 1)``.
The reference's ring and grid SUMMA schedules (panels broadcast over the
positions, one block product per panel) bound memory per device and come
back with positions on several cards (ROADMAP A3b); on one card they give
the same values at extra copies.

Matrix products run at the precision :func:`set_matmul_precision` names,
mapped onto ``torch.set_float32_matmul_precision`` for the duration of each
call and restored after it: ``'highest'`` (the default) keeps TF32 off,
``'float32'`` is torch's ``'high'`` (TF32), ``'default'`` torch's
``'medium'``.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional

import torch

from .. import types
from .._compile import jitted
from .._operations import _out
from .._tracing import in_trace, record_dispatch
from ...telemetry import _core as _tel
from ..dndarray import DNDarray
from ..sanitation import sanitize_axis, sanitize_in

__all__ = [
    "dot",
    "get_matmul_precision",
    "matmul",
    "matrix_norm",
    "norm",
    "outer",
    "projection",
    "set_matmul_precision",
    "transpose",
    "tril",
    "triu",
    "vector_norm",
]

#: heat precision name -> torch float32 matmul precision
_TORCH_PRECISION = {"highest": "highest", "float32": "high", "default": "medium"}
_MATMUL_PRECISION = "highest"


def set_matmul_precision(precision: str) -> None:
    """Set the precision of every linalg matrix product: ``'default'``,
    ``'float32'`` or ``'highest'``."""
    global _MATMUL_PRECISION
    if precision not in _TORCH_PRECISION:
        raise ValueError(f"invalid precision {precision!r}")
    _MATMUL_PRECISION = precision


def get_matmul_precision() -> str:
    """The precision of linalg matrix products."""
    return _MATMUL_PRECISION


@contextlib.contextmanager
def _matmul_precision(precision: Optional[str] = None):
    """Run the body at ``precision`` (None: the module's), setting torch's
    process-wide float32 matmul precision and restoring it on exit, also
    when the body raises."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(_TORCH_PRECISION[precision or _MATMUL_PRECISION])
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


#: bytes of the transients of an integer or bool product's k-chunk: the
#: (..., m, kc, n) broadcast buffer and its (..., m, n) sum.  cuBLAS has
#: no integer GEMM, so such a product is summed chunk by chunk over k;
#: 256 MiB keeps a 2048^3 int64 product (a 68.7 GB buffer unchunked) to
#: eight k-columns a chunk.
INT_MATMUL_BUDGET = 1 << 28


def _mm(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``torch.matmul``; integer and bool operands (of one dtype), which
    cuBLAS has no product for, multiply exactly by broadcast products
    summed over k in chunks whose transients stay under
    :data:`INT_MATMUL_BUDGET`.  Integer sums wrap as the reference's
    integer dot does."""
    if x.is_floating_point():
        return torch.matmul(x, y)
    x2 = x.unsqueeze(0) if x.ndim == 1 else x
    y2 = y.unsqueeze(-1) if y.ndim == 1 else y
    k = int(x2.shape[-1])
    outer = torch.broadcast_shapes(x2.shape[:-2], y2.shape[:-2]) + (x2.shape[-2], y2.shape[-1])
    cells = max(1, math.prod(outer))
    kc = max(1, (INT_MATMUL_BUDGET - 8 * cells) // (x.element_size() * cells))
    acc = torch.zeros(outer, dtype=torch.int64, device=x.device)
    for c0 in range(0, k, kc):
        xs, ys = x2[..., c0:c0 + kc], y2[..., c0:c0 + kc, :]
        acc += (xs.unsqueeze(-1) * ys.unsqueeze(-3)).sum(-2, dtype=torch.int64)
    out = acc.to(x.dtype)
    if y.ndim == 1:
        out = out.squeeze(-1)
    if x.ndim == 1:
        out = out.squeeze(-2 if y.ndim > 1 else -1)
    return out


#: the operand layouts of the reference's grid SUMMA schedules
_GRID_LAYOUTS = {
    ((0, 1), (0, 1)): "grid",
    ((0, None), (None, 1)): "rowcol",
    ((None, 1), (0, None)): "colrow",
}


def _grid_layout(a: DNDarray, b: DNDarray) -> Optional[str]:
    """The grid SUMMA schedule the reference runs for ``a @ b``, or None."""
    comm = a.comm
    if a.ndim != 2 or b.ndim != 2 or comm.mesh_ndim != 2 or comm.size == 1:
        return None
    return _GRID_LAYOUTS.get((a.splits, b.splits))


def _result_split_matmul(a: DNDarray, b: DNDarray, out_ndim: int) -> Optional[int]:
    """Split of a product: split 0 of a matrix ``a`` gives a row-split
    result, a ``b`` split on its last axis a column-split one; a product
    that contracts the split axis (or of vectors) is replicated."""
    if out_ndim == 0:
        return None
    if a.split == 0 and a.ndim > 1:
        return 0
    if b.split is not None and b.ndim > 1 and b.split == b.ndim - 1:
        return out_ndim - 1
    return None


def _grid_dispatch(op: str, model, overlapped: bool, launch, **span):
    """``launch()``, one grid call, as the reference dispatches its grid
    programs (``basics.py:415-430``, ``qr.py:636-676``, ``svd.py:350-385``):
    with telemetry on, the byte ledger credited under ``op`` from
    ``model()`` (a wire model of :mod:`heat_tpu_torch.comm._costs`), a
    ``comm:<op>`` span with ``span``'s fields and the ``<op>`` dispatch
    span pair."""
    from ...comm.overlap import timed_dispatch

    if _tel.enabled:
        wm = model()
        _tel.account_bytes(op, "f32", wm["exact_wire_bytes"], wm["wire_bytes"])
        with _tel.span(f"comm:{op}", **span):
            return timed_dispatch(op, overlapped, launch)
    return timed_dispatch(op, overlapped, launch)


def _summa_grid(a: DNDarray, b: DNDarray, layout: str, product):
    """``product()``, the grid SUMMA of ``a @ b`` in ``layout``: one
    program, credited from :func:`~heat_tpu_torch.comm._costs.summa_grid_model`."""
    from ...comm import _costs
    from ...comm.overlap import overlap_enabled

    r, c = a.comm.mesh_shape
    ov = overlap_enabled(r * c) if layout != "rowcol" else False
    if in_trace():
        return product()
    record_dispatch()  # the grid SUMMA is one program (reference basics.py:422)
    return _grid_dispatch(
        "summa2d",
        lambda: _costs.summa_grid_model(a.shape[0], a.shape[1], b.shape[1], (r, c), overlap=ov, layout=layout),
        ov, product, mesh=f"{r}x{c}", panels=r * c, layout=layout,
    )


def matmul(
    a: DNDarray, b: DNDarray, out: Optional[DNDarray] = None, precision: Optional[str] = None
) -> DNDarray:
    """Matrix product of two DNDarrays, numpy's ``matmul`` semantics
    (vectors, batched operands), in every split combination.  ``out``
    receives the result; ``precision`` overrides :func:`get_matmul_precision`
    for this call."""
    sanitize_in(a)
    sanitize_in(b)
    if precision is not None and precision not in _TORCH_PRECISION:
        raise ValueError(f"invalid precision {precision!r}")
    if a.ndim == 0 or b.ndim == 0:
        raise ValueError("matmul does not accept 0-d operands (use mul)")
    k_a = a.shape[-1]
    k_b = b.shape[-2] if b.ndim >= 2 else b.shape[0]
    if k_a != k_b:
        raise ValueError(f"matmul shape mismatch: {a.shape} @ {b.shape} (contracting {k_a} vs {k_b})")
    if a.ndim > 2 or b.ndim > 2:
        batch_a = a.shape[:-2] if a.ndim > 2 else ()
        batch_b = b.shape[:-2] if b.ndim > 2 else ()
        for da, db in zip(reversed(batch_a), reversed(batch_b)):
            if da != db and da != 1 and db != 1:
                raise ValueError(
                    f"matmul batch dimensions do not broadcast: {a.shape} @ {b.shape} ({da} vs {db})"
                )
    promoted = types.promote_types(a.dtype, b.dtype)
    dtype = promoted.torch_type()
    grid = _grid_layout(a, b)

    def product():
        with _matmul_precision(precision):
            return _mm(a.larray.to(dtype), b.larray.to(dtype))

    garr = _summa_grid(a, b, grid, product) if grid else product()
    split = (0, 1) if grid else _result_split_matmul(a, b, garr.ndim)
    return _out(out, DNDarray(garr, tuple(garr.shape), promoted, split, a.device, a.comm))


def dot(a, b, out: Optional[DNDarray] = None):
    """Dot product: two vectors give a 0-d result, 0-d operands multiply,
    everything else is :func:`matmul`."""
    from .. import arithmetics

    if not (isinstance(a, DNDarray) and isinstance(b, DNDarray)) or a.ndim == 0 or b.ndim == 0:
        return arithmetics.mul(a, b)
    if a.ndim == 1 and b.ndim == 1:
        promoted = types.promote_types(a.dtype, b.dtype)
        dtype = promoted.torch_type()
        with _matmul_precision():
            res = _mm(a.larray.to(dtype), b.larray.to(dtype))
        return _out(out, DNDarray(res, (), promoted, None, a.device, a.comm))
    return matmul(a, b, out=out)


def _inexact(a: DNDarray) -> torch.Tensor:
    """``a``'s values, exact types cast to float32."""
    return a.larray.to(torch.float32) if types.heat_type_is_exact(a.dtype) else a.larray


def _scalar(a: DNDarray, res: torch.Tensor) -> DNDarray:
    return DNDarray(res, (), types.canonical_heat_type(res.dtype), None, a.device, a.comm)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x))


def norm(a: DNDarray) -> DNDarray:
    """The 2-norm of the whole array, ``sqrt(sum(a * a))``, as a 0-d
    DNDarray (``float()`` of it is the caller's host sync), in every
    layout: the sum runs over the true view, so no pad enters it."""
    sanitize_in(a)
    x = _inexact(a)
    comm, splits = a.comm, a.splits
    key = ("linalg.norm", comm, splits, tuple(x.shape), str(x.dtype))
    return _scalar(a, jitted(key, lambda: _norm)(x))


def vector_norm(a: DNDarray, ord=2) -> DNDarray:
    """The ``ord``-norm of the flattened array."""
    sanitize_in(a)
    return _scalar(a, torch.linalg.vector_norm(_inexact(a).reshape(-1), ord))


def matrix_norm(a: DNDarray, ord=None) -> DNDarray:
    """numpy's ``linalg.norm(a, ord)`` (Frobenius for a matrix and None)."""
    sanitize_in(a)
    return _scalar(a, torch.linalg.norm(_inexact(a), ord))


def outer(a: DNDarray, b: DNDarray, out: Optional[DNDarray] = None, split: Optional[int] = None) -> DNDarray:
    """Outer product of two (flattened) vectors, laid out at ``split``
    (default: rows when either input is split)."""
    sanitize_in(a)
    sanitize_in(b)
    promoted = types.promote_types(a.dtype, b.dtype)
    dtype = promoted.torch_type()
    garr = torch.outer(a.larray.reshape(-1).to(dtype), b.larray.reshape(-1).to(dtype))
    if split is None:
        split = 0 if (a.split is not None or b.split is not None) else None
    split = sanitize_axis(tuple(garr.shape), split)
    return _out(out, DNDarray(garr, tuple(garr.shape), promoted, split, a.device, a.comm))


def projection(a: DNDarray, b: DNDarray) -> DNDarray:
    """Projection of vector ``a`` onto vector ``b``."""
    from .. import arithmetics

    sanitize_in(a)
    sanitize_in(b)
    if a.ndim != 1 or b.ndim != 1:
        raise RuntimeError(f"projection requires 1-D vectors, got {a.ndim}-d and {b.ndim}-d")
    return arithmetics.mul(b, dot(a, b).item() / dot(b, b).item())


def transpose(a: DNDarray, axes: Optional[List[int]] = None) -> DNDarray:
    """Permute the axes (default: reverse them); the split follows its axis."""
    sanitize_in(a)
    if axes is None:
        axes = tuple(reversed(range(a.ndim)))
    else:
        axes = tuple(int(ax) % a.ndim for ax in axes)
        if len(axes) != a.ndim or len(set(axes)) != a.ndim:
            raise ValueError("axes do not match array")
    garr = a.larray.permute(axes).contiguous()
    split = axes.index(a.split) if a.split is not None else None
    return DNDarray(garr, tuple(garr.shape), a.dtype, split, a.device, a.comm)


def __tri_op(m: DNDarray, k: int, op) -> DNDarray:
    """tril/triu of the last two axes; a vector first becomes the square
    matrix whose rows are all that vector (numpy's rule)."""
    sanitize_in(m)
    arr = m.larray
    if m.ndim < 2:
        arr = arr.expand(m.shape[0], m.shape[0])
    garr = op(arr, diagonal=k)
    return DNDarray(garr, tuple(garr.shape), m.dtype, m.split, m.device, m.comm)


def tril(m: DNDarray, k: int = 0) -> DNDarray:
    """Lower-triangular part (on and below diagonal ``k``)."""
    return __tri_op(m, k, torch.tril)


def triu(m: DNDarray, k: int = 0) -> DNDarray:
    """Upper-triangular part (on and above diagonal ``k``)."""
    return __tri_op(m, k, torch.triu)


# split semantics (see core/_split_semantics.py); the table stays a literal dict
from .._split_semantics import declare_split_semantics_table  # noqa: E402

declare_split_semantics_table(
    __name__,
    {
        "matmul": ("matmul", "dot"),
        "transpose": ("transpose",),
        "elementwise": ("tril", "triu"),
    },
)
