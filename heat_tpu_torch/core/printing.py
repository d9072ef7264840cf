"""Global string representations of DNDarrays.

Port of ``heat_tpu/core/printing.py``: numpy formatting of the global
array, with the reference's print options and profiles.  bfloat16 values,
which numpy has no type for, are printed as the reference prints its
ml_dtypes values: each one as ``"%g"`` of its value, unpadded.
"""

from __future__ import annotations

import numpy as np

__all__ = ["get_printoptions", "set_printoptions"]

__PRINT_OPTIONS = {
    "precision": 4,
    "threshold": 1000,
    "edgeitems": 3,
    "linewidth": 120,
    "sci_mode": None,
}


def get_printoptions() -> dict:
    """A copy of the current print options."""
    return dict(__PRINT_OPTIONS)


def set_printoptions(
    precision=None, threshold=None, edgeitems=None, linewidth=None, profile=None, sci_mode=None
):
    """Set print options; ``profile`` is ``"default"``, ``"short"`` or
    ``"full"``, and explicit options override it."""
    if profile == "default":
        __PRINT_OPTIONS.update(precision=4, threshold=1000, edgeitems=3, linewidth=120)
    elif profile == "short":
        __PRINT_OPTIONS.update(precision=2, threshold=1000, edgeitems=2, linewidth=120)
    elif profile == "full":
        __PRINT_OPTIONS.update(precision=4, threshold=float("inf"), edgeitems=3, linewidth=120)
    for key, val in (
        ("precision", precision),
        ("threshold", threshold),
        ("edgeitems", edgeitems),
        ("linewidth", linewidth),
        ("sci_mode", sci_mode),
    ):
        if val is not None:
            __PRINT_OPTIONS[key] = val


def _shown(x, threshold, edgeitems):
    """``(values, threshold)`` for ``np.array2string``: the whole array on
    the host, or, where numpy would summarize it, only what it shows.  Each
    axis longer than ``2 * edgeitems`` keeps its leading and trailing
    ``edgeitems`` entries and one entry between them, which numpy elides;
    the threshold becomes 0 so the cut array is summarized alike.  The cut
    is taken on the device, so a large array is never copied whole.  With
    ``edgeitems`` 0 numpy's own slicing (``a[-0:]``) reads whole axes, so
    the array is not cut."""
    import torch

    t = x.larray.detach()
    if x.size > threshold and edgeitems >= 1:
        e = int(edgeitems)
        for axis, n in enumerate(t.shape):
            if n > 2 * e:
                keep = torch.cat([torch.arange(e + 1), torch.arange(n - e, n)]).to(t.device)
                t = t.index_select(axis, keep)
        threshold = 0
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy(), threshold


def __str__(x) -> str:
    """``DNDarray(<values>, dtype=ht.<type>, device=<device>, split=<split>)``."""
    from . import types

    opts = __PRINT_OPTIONS
    formatter = {"float_kind": lambda v: "%g" % v} if x.dtype is types.bfloat16 else None
    values, threshold = _shown(x, opts["threshold"], opts["edgeitems"])
    body = np.array2string(
        values,
        precision=opts["precision"],
        threshold=threshold,
        edgeitems=opts["edgeitems"],
        max_line_width=opts["linewidth"],
        separator=", ",
        formatter=formatter,
    )
    tail = [f"dtype=ht.{x.dtype.__name__}", f"device={x.device}", f"split={x.split}"]
    return f"DNDarray({body}, {', '.join(tail)})"
