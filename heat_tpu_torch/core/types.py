"""The heat dtype lattice, on torch dtypes.

Port of ``heat_tpu/core/types.py``: the type classes under ``generic``
(each concrete class callable as a cast: ``float32([1, 2])`` is a float32
DNDarray), their aliases, :func:`canonical_heat_type`,
:func:`heat_type_of`, :func:`issubdtype`, :func:`can_cast` with the
"intuitive" rule, :func:`promote_types`, :func:`result_type`,
:class:`finfo` and :class:`iinfo`.  Promotion is torch's, which agrees
with the reference's lattice on every pair of these ten types (uint8 +
int8 -> int16, int + float32 -> float32, int + bfloat16 -> bfloat16,
bfloat16 + float32 -> float32, float16 + float32 -> float32).

The op engine needs one rule more, the reference's weak typing of Python
scalars (:func:`_weak_result_type`): an ``int`` scalar takes the array's
type (int64 beside a bool array), a ``float`` scalar the array's float
type or, beside an exact array, float64; numpy scalars are typed.
"""

from __future__ import annotations

import builtins
import numbers
from typing import Any, Tuple

import numpy as np
import torch

__all__ = [
    "generic",
    "number",
    "integer",
    "signedinteger",
    "unsignedinteger",
    "floating",
    "bool",
    "bool_",
    "uint8",
    "ubyte",
    "int8",
    "byte",
    "int16",
    "short",
    "int32",
    "int",
    "int_",
    "int64",
    "long",
    "float16",
    "half",
    "bfloat16",
    "float32",
    "float",
    "float_",
    "float64",
    "double",
    "flexible",
    "canonical_heat_type",
    "heat_type_of",
    "heat_type_is_exact",
    "heat_type_is_inexact",
    "issubdtype",
    "can_cast",
    "promote_types",
    "result_type",
    "finfo",
    "iinfo",
]


class generic:
    """Root of the heat type hierarchy.  Calling a concrete subclass casts
    its argument: ``float32([1, 2])`` is a float32 DNDarray."""

    _torch_type = None
    _np_type = None

    def __new__(cls, *value, device=None, comm=None):
        if cls._torch_type is None:
            raise TypeError(f"cannot create '{cls.__name__}' instances — abstract dtype")
        from . import factories

        if len(value) == 0:
            value = (0,)
        if len(value) == 1:
            value = value[0]
        return factories.array(value, dtype=cls, device=device, comm=comm)

    @classmethod
    def torch_type(cls) -> torch.dtype:
        """The torch dtype arrays of this type are stored in."""
        return cls._torch_type

    @classmethod
    def char(cls) -> str:
        """numpy's one-character code of the type (``"E"`` for bfloat16,
        as ml_dtypes has it)."""
        return np.dtype(cls._np_type).char if cls._np_type is not None else "E"


class bool(generic):  # noqa: A001 -- the reference's name
    _torch_type = torch.bool
    _np_type = np.bool_


bool_ = bool


class number(generic):
    pass


class integer(number):
    pass


class signedinteger(integer):
    pass


class unsignedinteger(integer):
    pass


class floating(number):
    pass


class flexible(generic):
    """Branch kept for the hierarchy's shape; no type derives from it."""


class uint8(unsignedinteger):
    _torch_type = torch.uint8
    _np_type = np.uint8


class int8(signedinteger):
    _torch_type = torch.int8
    _np_type = np.int8


class int16(signedinteger):
    _torch_type = torch.int16
    _np_type = np.int16


class int32(signedinteger):
    _torch_type = torch.int32
    _np_type = np.int32


class int64(signedinteger):
    _torch_type = torch.int64
    _np_type = np.int64


class float16(floating):
    _torch_type = torch.float16
    _np_type = np.float16


class bfloat16(floating):
    """bfloat16 (numpy has no such type: ``numpy()`` hands it back as
    float32)."""

    _torch_type = torch.bfloat16


class float32(floating):
    _torch_type = torch.float32
    _np_type = np.float32


class float64(floating):
    _torch_type = torch.float64
    _np_type = np.float64


ubyte = uint8
byte = int8
short = int16
int = int32  # noqa: A001
int_ = int32
long = int64
half = float16
float = float32  # noqa: A001
float_ = float32
double = float64

_CONCRETE: Tuple[type, ...] = (bool, uint8, int8, int16, int32, int64, float16, bfloat16, float32, float64)
_BY_TORCH = {t._torch_type: t for t in _CONCRETE}
_BY_NAME = {t.__name__: t for t in _CONCRETE}
_BY_NAME.update({
    "bool_": bool, "b": bool, "ubyte": uint8, "u1": uint8, "byte": int8, "i1": int8,
    "short": int16, "i2": int16, "int": int32, "int_": int32, "i4": int32, "long": int64,
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


def heat_type_of(obj: Any) -> type:
    """The heat type of an array, tensor, scalar or (nested) list."""
    from .dndarray import DNDarray

    if isinstance(obj, DNDarray):
        return obj.dtype
    if isinstance(obj, (torch.Tensor, np.ndarray)) or hasattr(obj, "dtype"):
        return canonical_heat_type(obj.dtype)
    if isinstance(obj, builtins.bool):
        return bool
    if isinstance(obj, numbers.Integral):
        return int32
    if isinstance(obj, numbers.Real):
        return float32
    if isinstance(obj, (list, tuple)):
        if len(obj) == 0:
            return float32
        arr = np.asarray(obj)
        if arr.dtype == object:
            raise TypeError(f"cannot determine heat type of ragged/object {type(obj)}")
        return _infer_list_type(obj, arr)
    raise TypeError(f"cannot determine heat type of {type(obj)}")


def _float_fits(arr: np.ndarray, ht_type: type) -> builtins.bool:
    """True when every finite value of float64 ``arr`` survives a cast to
    the float type ``ht_type``: no finite value overflows to inf and no
    nonzero one flushes to zero."""
    info = torch.finfo(ht_type.torch_type())
    finite = arr[np.isfinite(arr)]
    if not finite.size:
        return True
    mags = np.abs(finite)
    if builtins.float(mags.max()) > builtins.float(info.max):
        return False
    nonzero = mags[mags > 0]
    # the smallest subnormal: tiny * eps for every IEEE-style type here
    return not (nonzero.size and builtins.float(nonzero.min()) < info.tiny * info.eps)


def _infer_list_type(obj, arr: np.ndarray) -> type:
    """Heat type of a list or tuple whose numpy image is ``arr``: Python
    scalar leaves keep the 32-bit default unless their values need 64
    bits (2**40, 1e-300); numpy leaves keep their dtype; mixed leaves
    promote one representative per distinct leaf type."""
    if arr.dtype not in (np.int64, np.float64):
        return canonical_heat_type(arr.dtype)
    reps: dict = {}
    stack = [obj]
    while stack:
        for el in stack.pop():
            if isinstance(el, (list, tuple)):
                stack.append(el)
            else:
                reps.setdefault((type(el), getattr(el, "dtype", None)), el)
    typed = lambda v: isinstance(v, (np.generic, np.ndarray)) or hasattr(v, "dtype")  # noqa: E731
    if any(typed(v) for v in reps.values()):
        result = None
        for v in reps.values():
            t = canonical_heat_type(v.dtype) if typed(v) else heat_type_of(v)
            result = t if result is None else promote_types(result, t)
        if issubclass(result, integer) and arr.dtype == np.int64 and arr.size:
            info = iinfo(result)
            lo, hi = builtins.int(arr.min()), builtins.int(arr.max())
            if lo < info.min or hi > info.max:
                result = promote_types(result, int64)
        elif (
            issubclass(result, floating)
            and result is not float64
            and arr.dtype == np.float64
            and arr.size
            and not _float_fits(arr, result)
        ):
            result = float32 if result is not float32 and _float_fits(arr, float32) else float64
        return result
    if not arr.size:
        return int32 if arr.dtype == np.int64 else float32
    if arr.dtype == np.int64:
        lo, hi = builtins.int(arr.min()), builtins.int(arr.max())
        return int64 if lo < -(2**31) or hi >= 2**31 else int32
    return float32 if _float_fits(arr, float32) else float64


def heat_type_is_exact(ht_dtype: Any) -> builtins.bool:
    """True for integer and bool types."""
    t = canonical_heat_type(ht_dtype)
    return issubclass(t, integer) or t is bool


def heat_type_is_inexact(ht_dtype: Any) -> builtins.bool:
    """True for floating types."""
    return issubclass(canonical_heat_type(ht_dtype), floating)


def issubdtype(arg1: Any, arg2: type) -> builtins.bool:
    """Hierarchy test, e.g. ``issubdtype(int32, integer)``."""
    try:
        t1 = canonical_heat_type(arg1)
    except TypeError:
        t1 = arg1
    if not (isinstance(t1, type) and issubclass(t1, generic)):
        raise TypeError(f"{arg1!r} is not a heat type")
    return issubclass(t1, arg2)


def _width(t: type) -> builtins.int:
    return t.torch_type().itemsize * 8


def can_cast(from_: Any, to: Any, casting: str = "intuitive") -> builtins.bool:
    """Whether ``from_`` casts to ``to`` under a rule: ``"no"``,
    ``"safe"``, ``"same_kind"`` and ``"unsafe"`` as numpy has them; the
    default ``"intuitive"`` is safe plus integer to floating of at least
    the same width (int32 -> float32)."""
    if not isinstance(casting, str):
        raise TypeError(f"expected casting to be str, found {type(casting)}")
    if casting not in ("no", "safe", "same_kind", "unsafe", "intuitive"):
        raise ValueError(f"invalid casting rule {casting!r}")
    if not isinstance(from_, type):
        from_ = heat_type_of(from_)
    src = canonical_heat_type(from_)
    dst = canonical_heat_type(to)
    if casting == "no":
        return src is dst
    if casting == "unsafe":
        return True
    if casting == "same_kind":
        if src is bfloat16 or dst is bfloat16:
            return issubclass(dst, floating)
        return builtins.bool(np.can_cast(np.dtype(src._np_type), np.dtype(dst._np_type), casting="same_kind"))
    if src is bfloat16:
        safe = dst in (bfloat16, float32, float64)
    elif dst is bfloat16:
        # 8 significand bits hold every integer only up to 256
        safe = src in (bool, uint8, int8)
    else:
        safe = builtins.bool(np.can_cast(np.dtype(src._np_type), np.dtype(dst._np_type), casting="safe"))
    if safe or casting == "safe":
        return safe
    if (issubclass(src, integer) or src is bool) and issubclass(dst, floating):
        return _width(dst) >= min(_width(src), 32) or dst in (float32, float64)
    return False


def promote_types(type1: Any, type2: Any) -> type:
    """Smallest type both inputs safely cast to."""
    t1 = canonical_heat_type(type1)
    t2 = canonical_heat_type(type2)
    return canonical_heat_type(torch.promote_types(t1.torch_type(), t2.torch_type()))


def result_type(*operands) -> type:
    """The promoted type of any number of operands: arrays, tensors, heat
    types, scalars (a Python ``int`` counts as int32, a ``float`` as
    float32)."""
    t = None
    for op in operands:
        ot = op if isinstance(op, type) and issubclass(op, generic) else heat_type_of(op)
        t = ot if t is None else promote_types(t, ot)
    return t


def _weak_result_type(*operands) -> type:
    """The type an elementwise op of ``operands`` computes in, with the
    reference's weak Python scalars: a Python ``int`` defers to the other
    operands' type (int64 when they are all bool), a Python ``float`` to
    their float type (float64 when they are all exact); Python bools,
    numpy scalars, arrays and tensors are typed."""
    strong, weak_int, weak_float = None, False, False
    for op in operands:
        if isinstance(op, builtins.bool):
            t = bool
        elif isinstance(op, builtins.int):
            weak_int = True
            continue
        elif isinstance(op, builtins.float):
            weak_float = True
            continue
        else:
            t = op if isinstance(op, type) and issubclass(op, generic) else heat_type_of(op)
        strong = t if strong is None else promote_types(strong, t)
    if weak_float and (strong is None or heat_type_is_exact(strong)):
        return float64
    if weak_int and (strong is None or strong is bool):
        return int64
    return strong


def _cast(t: torch.Tensor, dtype: torch.dtype, **kwargs) -> torch.Tensor:
    """``t.to(dtype, **kwargs)`` with the reference's roundings: float64 to
    float16 rounded once (torch converts through float32 and rounds twice:
    ``1 + 2^-11 + 2^-40`` becomes 1 where 1 + 2^-10 is nearest; the float32
    step rounds to odd, which the second rounding cannot mistake for a
    tie), and a NaN into bfloat16 or float16 the reference's NaN on any
    device: the quiet NaN of its sign in bfloat16, and in float16 the sign,
    the quiet bit and the payload's top bits (torch gives bfloat16 0xFFFF
    from float32, drops a float64 NaN's sign, and the card writes 0x7FFF)."""
    src = t
    if t.dtype == torch.float64 and dtype == torch.float16:
        f = t.to(torch.float32)
        wide = f.to(torch.float64)
        inexact = (wide != t) & torch.isfinite(f)
        even = (f.view(torch.int32) & 1) == 0
        toward = torch.where(t > wide, torch.inf, -torch.inf).to(torch.float32)
        t = torch.where(inexact & even, torch.nextafter(f, toward), f)
    out = t.to(dtype, **kwargs)
    if dtype in (torch.float16, torch.bfloat16) and src.dtype in (torch.float32, torch.float64):
        sign = torch.signbit(src).to(torch.int32) << 15
        if dtype == torch.bfloat16:
            bits = sign | 0x7FC0
        else:
            wide = src.view(torch.int64) if src.dtype == torch.float64 else src.view(torch.int32).to(torch.int64)
            payload = (wide >> (42 if src.dtype == torch.float64 else 13)) & 0x1FF
            bits = sign | 0x7E00 | payload.to(torch.int32)
        bits = (bits - ((bits >> 15) << 16)).to(torch.int16).view(dtype)
        out = torch.where(torch.isnan(src), bits, out)
    return out


def _cast_scalar(value, dtype: torch.dtype):
    """A Python float bound for a float16 tensor, rounded once to float16
    (:func:`_cast`), so torch's own conversion of it is exact; any other
    value as it is."""
    if dtype == torch.float16 and isinstance(value, builtins.float):
        return _cast(torch.tensor(value, dtype=torch.float64), dtype).item()
    return value


class finfo:
    """Machine limits of a floating type: ``bits``, ``eps``, ``max``,
    ``min``, ``tiny`` (from ``torch.finfo``)."""

    def __new__(cls, dtype):
        t = canonical_heat_type(dtype)
        if not issubclass(t, floating):
            raise TypeError(f"data type {t.__name__} not inexact")
        info = torch.finfo(t.torch_type())
        obj = object.__new__(cls)
        obj.bits = info.bits
        obj.eps = builtins.float(info.eps)
        obj.max = builtins.float(info.max)
        obj.min = builtins.float(info.min)
        obj.tiny = builtins.float(info.tiny)
        obj.dtype = t
        return obj

    def __repr__(self):
        return f"finfo(dtype={self.dtype.__name__}, eps={self.eps}, max={self.max})"


class iinfo:
    """Machine limits of an integer (or bool) type: ``bits``, ``min``,
    ``max``."""

    def __new__(cls, dtype):
        t = canonical_heat_type(dtype)
        if not (issubclass(t, integer) or t is bool):
            raise TypeError(f"data type {t.__name__} not an integer type")
        obj = object.__new__(cls)
        if t is bool:
            obj.bits, obj.min, obj.max = 8, 0, 1
        else:
            info = torch.iinfo(t.torch_type())
            obj.bits, obj.min, obj.max = info.bits, builtins.int(info.min), builtins.int(info.max)
        obj.dtype = t
        return obj

    def __repr__(self):
        return f"iinfo(dtype={self.dtype.__name__}, min={self.min}, max={self.max})"
