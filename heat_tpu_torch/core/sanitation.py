"""Input and output validation helpers.

Port of ``heat_tpu/core/sanitation.py``.  ``sanitize_axis`` is
:func:`.stride_tricks.sanitize_axis`, re-exported here for the modules
that import it from this one.  ``out=`` follows the reference's contract:
the output DNDarray is rebound to the result, after its shape and device
are checked.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Union

import numpy as np

from .stride_tricks import sanitize_axis  # noqa: F401 -- one definition
from ._split_semantics import split_semantics as _split_semantics

__all__ = [
    "merge_keepdims",
    "sanitize_in",
    "sanitize_infinity",
    "sanitize_in_tensor",
    "sanitize_lshape",
    "sanitize_out",
    "sanitize_predict_in",
    "sanitize_sequence",
    "scalar_to_1d",
]


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


def sanitize_in(x: Any) -> None:
    """Verify ``x`` is a DNDarray."""
    from .dndarray import DNDarray

    if not isinstance(x, DNDarray):
        raise TypeError(f"input needs to be a DNDarray, but was {type(x)}")


@_split_semantics("entry_split0")
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


def sanitize_in_tensor(x: Any):
    """A DNDarray's global tensor, anything else as a tensor."""
    import torch

    from .dndarray import DNDarray

    if isinstance(x, DNDarray):
        return x.larray
    return torch.as_tensor(x)


def sanitize_infinity(x) -> Union[int, float]:
    """The largest value of ``x``'s type: ``iinfo.max`` for exact types,
    ``inf`` for floating ones."""
    from . import types

    dt = x.dtype if hasattr(x, "dtype") else types.heat_type_of(x)
    dt = types.canonical_heat_type(dt)
    if types.heat_type_is_exact(dt):
        return types.iinfo(dt).max
    return float("inf")


def sanitize_lshape(array, tensor) -> None:
    """Verify ``tensor`` may stand for ``array``'s local shard: its axes
    other than the split axis must match the global shape."""
    tshape = tuple(tensor.shape)
    if tshape == tuple(array.lshape):
        return
    gshape = tuple(array.gshape)
    split = array.split
    if split is None:
        non_zero = [i for i in range(len(tshape)) if tshape[i] != 0]
        if all(tshape[i] == gshape[i] for i in non_zero):
            return
        raise ValueError(
            f"Shape of local tensor is inconsistent with global DNDarray: "
            f"tensor.shape is {tshape}, should be {gshape}"
        )
    if tshape[:split] + tshape[split + 1:] == gshape[:split] + gshape[split + 1:]:
        return
    raise ValueError(
        f"Shape of local tensor along non-split axes is inconsistent with global "
        f"DNDarray: tensor.shape is {tshape}, DNDarray is {gshape}"
    )


def sanitize_out(out: Any, output_shape, output_split, output_device, output_comm=None) -> None:
    """Validate an ``out=`` target against the result's shape and
    device."""
    from .dndarray import DNDarray

    if not isinstance(out, DNDarray):
        raise TypeError(f"expected out to be None or a DNDarray, but was {type(out)}")
    if tuple(out.shape) != tuple(output_shape):
        raise ValueError(f"Expecting output buffer of shape {tuple(output_shape)}, got {out.shape}")
    if output_device is not None and out.device != output_device:
        raise ValueError(f"Expecting output buffer on device {output_device}, got {out.device}")


def sanitize_sequence(seq: Union[Sequence, "np.ndarray"]) -> List:
    """A list, tuple, numpy array or DNDarray as a Python list."""
    from .dndarray import DNDarray

    if isinstance(seq, list):
        return seq
    if isinstance(seq, tuple):
        return list(seq)
    if isinstance(seq, np.ndarray):
        return seq.tolist()
    if isinstance(seq, DNDarray):
        return seq.numpy().tolist()
    raise TypeError(f"seq must be a list, tuple, numpy.ndarray or DNDarray, got {type(seq)}")


def scalar_to_1d(x):
    """A 0-d DNDarray as a replicated 1-element 1-D one (a 1-D input comes
    back as it is)."""
    from .dndarray import DNDarray

    if x.ndim == 1:
        return x
    return DNDarray(x.larray.reshape(1), (1,), x.dtype, None, x.device, x.comm)
