"""Input validation helpers.

Port of ``sanitize_in``, ``sanitize_predict_in`` and ``merge_keepdims``
(``heat_tpu/core/sanitation.py``) and of ``sanitize_axis``
(``heat_tpu/core/stride_tricks.py``).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple, Union

__all__ = ["as_tensors", "merge_keepdims", "sanitize_axis", "sanitize_in", "sanitize_predict_in"]


def as_tensors(*operands) -> tuple:
    """The operands as tensors: a DNDarray's values, anything else (a
    number, a numpy array) put on the device of the first DNDarray among
    them, so a comparison with host data runs where the array lives."""
    import torch

    from .dndarray import DNDarray

    dev = next((t.larray.device for t in operands if isinstance(t, DNDarray)), None)
    return tuple(t.larray if isinstance(t, DNDarray) else torch.as_tensor(t, device=dev) for t in operands)


def merge_keepdims(keepdims, keepdim) -> bool:
    """An explicit ``keepdims`` wins, else ``keepdim``, else False."""
    if keepdims is None:
        keepdims = keepdim
    return bool(keepdims) if keepdims is not None else False


def sanitize_axis(
    shape: Sequence[int], axis: Union[None, int, Sequence[int]]
) -> Union[None, int, Tuple[int, ...]]:
    """Normalize ``axis`` (None, int or tuple) against ``shape``: negative
    axes count from the end, out-of-range axes raise."""
    if axis is None:
        return None
    ndim = len(shape)
    if isinstance(axis, (tuple, list)):
        out = tuple(sanitize_axis(shape, int(a)) for a in axis)
        if len(set(out)) != len(out):
            raise ValueError(f"repeated axis in {axis}")
        return out
    if not isinstance(axis, int):
        raise TypeError(f"axis must be None, an int or a tuple of ints, got {type(axis)}")
    if ndim == 0 and axis in (0, -1):
        return None
    if not -ndim <= axis < ndim:
        raise ValueError(f"axis {axis} is out of bounds for shape {tuple(shape)}")
    return axis % ndim


def sanitize_in(x: Any) -> None:
    """Verify ``x`` is a DNDarray."""
    from .dndarray import DNDarray

    if not isinstance(x, DNDarray):
        raise TypeError(f"input needs to be a DNDarray, but was {type(x)}")


def sanitize_predict_in(x: Any, n_features: Optional[int] = None, op: str = "predict"):
    """The input gate of every predict path: a 2-D DNDarray (with exactly
    ``n_features`` columns when given).  Replicated and row-split inputs
    pass through untouched; a feature-split input is re-split onto rows."""
    sanitize_in(x)
    if x.ndim != 2:
        raise ValueError(f"{op} expects a 2-D (n_samples, n_features) input, got {x.ndim}-D")
    if n_features is not None and int(x.shape[1]) != int(n_features):
        raise ValueError(
            f"{op} expects {int(n_features)} features, got {int(x.shape[1])} "
            f"(input shape {tuple(x.shape)})"
        )
    if x.split in (None, 0):
        return x
    return x.resplit(0)
