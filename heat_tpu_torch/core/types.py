"""The heat dtype lattice, on torch dtypes.

Port of the part of ``heat_tpu/core/types.py`` the analytics path touches:
the type classes ``bool``, ``int32``, ``int64``, ``float32``, ``float64``,
``bfloat16`` and ``float16`` under the ``generic`` hierarchy, plus
:func:`canonical_heat_type`, :func:`heat_type_is_exact` and
:func:`promote_types`.  Promotion is torch's, which agrees with the
reference's lattice on every pair of these seven types (int + float32 ->
float32, int + bfloat16 -> bfloat16, bfloat16 + float32 -> float32,
float16 + float32 -> float32).
"""

from __future__ import annotations

import builtins
from typing import Any

import numpy as np
import torch

__all__ = [
    "generic",
    "number",
    "integer",
    "signedinteger",
    "floating",
    "bool",
    "int32",
    "int64",
    "float32",
    "float64",
    "bfloat16",
    "float16",
    "canonical_heat_type",
    "heat_type_is_exact",
    "heat_type_is_inexact",
    "promote_types",
]


class generic:
    """Root of the heat type hierarchy (abstract: backs no array)."""

    _torch_type = None

    @classmethod
    def torch_type(cls) -> torch.dtype:
        """The torch dtype arrays of this type are stored in."""
        return cls._torch_type


class bool(generic):
    _torch_type = torch.bool


class number(generic):
    pass


class integer(number):
    pass


class signedinteger(integer):
    pass


class int32(signedinteger):
    _torch_type = torch.int32


class int64(signedinteger):
    _torch_type = torch.int64


class floating(number):
    pass


class float32(floating):
    _torch_type = torch.float32


class float64(floating):
    _torch_type = torch.float64


class bfloat16(floating):
    _torch_type = torch.bfloat16


class float16(floating):
    _torch_type = torch.float16


_CONCRETE = (bool, int32, int64, float32, float64, bfloat16, float16)
_BY_TORCH = {t._torch_type: t for t in _CONCRETE}
_BY_NAME = {t.__name__: t for t in _CONCRETE}
_BY_NAME.update({
    "bool_": bool, "b": bool, "int": int32, "i4": int32, "long": int64,
    "i8": int64, "float": float32, "f4": float32, "double": float64, "f8": float64,
    "half": float16, "f2": float16,
})


def canonical_heat_type(a_type: Any) -> type:
    """Normalize a heat class, python type, torch dtype, numpy dtype or
    dtype name to its heat class."""
    if isinstance(a_type, type) and issubclass(a_type, generic):
        if a_type._torch_type is None:
            raise TypeError(f"data type {a_type!r} is abstract and cannot back an array")
        return a_type
    if a_type is builtins.bool:
        return bool
    if a_type is builtins.int:
        return int32
    if a_type is builtins.float:
        return float32
    if isinstance(a_type, torch.dtype):
        if a_type in _BY_TORCH:
            return _BY_TORCH[a_type]
        raise TypeError(f"data type {a_type!r} not understood")
    if isinstance(a_type, str):
        key = a_type.strip().lower().removeprefix("torch.")
        if key in _BY_NAME:
            return _BY_NAME[key]
    try:
        name = np.dtype(a_type).name
    except TypeError:
        raise TypeError(f"data type {a_type!r} not understood") from None
    if name in _BY_NAME:
        return _BY_NAME[name]
    raise TypeError(f"data type {a_type!r} not understood")


def heat_type_is_exact(ht_dtype: Any) -> builtins.bool:
    """True for integer and bool types."""
    t = canonical_heat_type(ht_dtype)
    return issubclass(t, integer) or t is bool


def heat_type_is_inexact(ht_dtype: Any) -> builtins.bool:
    """True for floating types."""
    return issubclass(canonical_heat_type(ht_dtype), floating)


def promote_types(type1: Any, type2: Any) -> type:
    """Smallest type both inputs safely cast to."""
    t1 = canonical_heat_type(type1)
    t2 = canonical_heat_type(type2)
    return canonical_heat_type(torch.promote_types(t1.torch_type(), t2.torch_type()))
