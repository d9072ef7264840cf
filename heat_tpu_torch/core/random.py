"""Reproducible counter-based random numbers: the reference's threefry
streams, bit for bit.

Port of ``heat_tpu/core/random.py``.  The global state is a ``(seed,
counter)`` pair; every draw folds the counter into the key
``PRNGKey(seed)`` and advances it by the number of elements drawn, so a
stream does not depend on the number of positions.  The reference draws
through ``jax.random`` with ``jax_threefry_partitionable`` on and x64 on;
this module keeps its own copy of those rules:

* the Threefry-2x32 hash (20 rounds, key schedule ``k1 ^ k2 ^
  0x1BD11BDA``), ``PRNGKey``, ``fold_in`` and the two-way ``split``;
* random bits: element ``i`` of a draw hashes the counter pair ``(i >>
  32, i & 0xffffffff)`` into ``(b1, b2)``; 32-bit draws are ``b1 ^ b2``
  (8 and 16 bits its low bits), 64-bit draws ``b1 << 32 | b2``;
* ``uniform``: the top mantissa bits under the exponent of 1.0, minus 1;
* ``randint``: two draws after a split, combined by the multiply-mod
  ``span`` rule in the sampling width's unsigned arithmetic;
* ``permutation``: ``ceil(3 ln n / ln(2^32 - 1))`` rounds, each a split
  and a stable sort on fresh 32-bit keys;
* ``normal``: ``sqrt(2) erf_inv(u)`` with ``u`` uniform in (-1, 1), the
  inverse error function by Giles' polynomials, as XLA evaluates them.

The hash runs in int64 lanes masked to 32 bits (torch has no uint32 add
or shift), on the device the result lives on, the same code on the CPU and
on the card.  Every stream but ``randn``'s equals the reference's bit for
bit; ``randn`` goes through ``log1p``, whose last bit XLA's and torch's
implementations may round differently (``tests/test_torch_random.py``
states the bound).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from . import types
from .dndarray import DNDarray
from .factories import _setup
from .sanitation import sanitize_axis

__all__ = [
    "get_state",
    "permutation",
    "rand",
    "randint",
    "randn",
    "random",
    "random_sample",
    "randperm",
    "ranf",
    "sample",
    "seed",
    "set_state",
    "uniform",
]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

# the global generator state (seed, counter), as the reference's
__seed: int = 0
__counter: int = 0


def seed(seed: Optional[int] = None) -> None:
    """(Re-)seed the global generator; ``None`` draws a seed from the
    operating system's entropy."""
    global __seed, __counter
    if seed is None:
        seed = int(np.random.SeedSequence().entropy % (2**63))
    __seed = int(seed)
    __counter = 0


def get_state() -> Tuple[str, int, int, int, float]:
    """The state tuple ``("Threefry", seed, counter, 0, 0.0)``, the
    reference's, so a state carries across the two packages."""
    return ("Threefry", __seed, __counter, 0, 0.0)


def set_state(state: Tuple) -> None:
    """Restore a 3- or 5-tuple from :func:`get_state`."""
    global __seed, __counter
    if not isinstance(state, tuple) or len(state) not in (3, 5):
        raise ValueError("state needs to be a 3- or 5-tuple")
    if state[0] != "Threefry":
        raise ValueError("algorithm must be 'Threefry'")
    __seed = int(state[1])
    __counter = int(state[2])


# --------------------------------------------------------------------- #
# threefry-2x32                                                           #
# --------------------------------------------------------------------- #
def _threefry(key: Tuple[int, int], x1, x2):
    """The Threefry-2x32 hash of the counter pairs ``(x1, x2)`` under
    ``key``: Python ints or int64 tensors holding values in [0, 2^32)."""
    ks = (key[0], key[1], key[0] ^ key[1] ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = (((x2 << r) & _M32) | (x2 >> (32 - r))) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M32
    return x1, x2


def _split(key: Tuple[int, int]) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """``jax.random.split(key)``: the hashes of the counters 0 and 1."""
    return _threefry(key, 0, 0), _threefry(key, 0, 1)


def _consume(n: int) -> Tuple[int, int]:
    """``fold_in(PRNGKey(seed), counter mod 2^31)``, then advance the
    counter by ``n`` elements."""
    global __counter
    key = ((__seed >> 32) & _M32, __seed & _M32)  # the seed's two 32-bit words
    data = __counter % (2**31)
    __counter += int(n)
    return _threefry(key, 0, data)


def _bits(key: Tuple[int, int], width: int, shape, device) -> torch.Tensor:
    """``width`` random bits per element of ``shape``, as int64 (a 64-bit
    draw holds the unsigned pattern)."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    b1, b2 = _threefry(key, idx >> 32, idx & _M32)
    bits = (b1 << 32) | b2 if width == 64 else (b1 ^ b2) & ((1 << width) - 1)
    return bits.reshape(shape)


def _uniform01(key, shape, dtype: torch.dtype, device) -> torch.Tensor:
    """Uniform [0, 1) in ``dtype``: random mantissa bits under the
    exponent of 1.0, minus 1 (bfloat16 draws 8 bits, the others their
    width)."""
    nbits, nmant, view, one = {
        torch.float32: (32, 23, torch.int32, 0x3F800000),
        torch.float64: (64, 52, torch.int64, 0x3FF0000000000000),
        torch.float16: (16, 10, torch.int16, 0x3C00),
        torch.bfloat16: (8, 7, torch.int16, 0x3F80),
    }[dtype]
    bits = _bits(key, nbits, shape, device)
    mant = (bits >> (nbits - nmant)) & ((1 << nmant) - 1)  # logical shift
    return (mant | one).to(view).view(dtype) - 1.0


#: Giles' inverse error function ("Approximating the erfinv function"),
#: as XLA evaluates it: float32 in two branches of w = -log1p(-x^2)
#: (below 5 in w - 2.5, else in sqrt(w) - 3), float64 in three (below 6.25
#: in w - 3.125, below 16 in sqrt(w) - 3.25, else in sqrt(w) - 5).  Each
#: row lists a branch's Horner coefficients, highest degree first.
_ERFINV32 = (
    (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
     -0.00125372503, -0.00417768164, 0.246640727, 1.50140941),
    (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
     -0.0076224613, 0.00943887047, 1.00167406, 2.83297682),
)
_ERFINV64 = (
    (-3.6444120640178196996e-21, -1.685059138182016589e-19, 1.2858480715256400167e-18,
     1.115787767802518096e-17, -1.333171662854620906e-16, 2.0972767875968561637e-17,
     6.6376381343583238325e-15, -4.0545662729752068639e-14, -8.1519341976054721522e-14,
     2.6335093153082322977e-12, -1.2975133253453532498e-11, -5.4154120542946279317e-11,
     1.051212273321532285e-09, -4.1126339803469836976e-09, -2.9070369957882005086e-08,
     4.2347877827932403518e-07, -1.3654692000834678645e-06, -1.3882523362786468719e-05,
     0.0001867342080340571352, -0.00074070253416626697512, -0.0060336708714301490533,
     0.24015818242558961693, 1.6536545626831027356),
    (2.2137376921775787049e-09, 9.0756561938885390979e-08, -2.7517406297064545428e-07,
     1.8239629214389227755e-08, 1.5027403968909827627e-06, -4.013867526981545969e-06,
     2.9234449089955446044e-06, 1.2475304481671778723e-05, -4.7318229009055733981e-05,
     6.8284851459573175448e-05, 2.4031110387097893999e-05, -0.0003550375203628474796,
     0.00095328937973738049703, -0.0016882755560235047313, 0.0024914420961078508066,
     -0.0037512085075692412107, 0.005370914553590063617, 1.0052589676941592334,
     3.0838856104922207635),
    (-2.7109920616438573243e-11, -2.5556418169965252055e-10, 1.5076572693500548083e-09,
     -3.7894654401267369937e-09, 7.6157012080783393804e-09, -1.4960026627149240478e-08,
     2.9147953450901080826e-08, -6.7711997758452339498e-08, 2.2900482228026654717e-07,
     -9.9298272942317002539e-07, 4.5260625972231537039e-06, -1.9681778105531670567e-05,
     7.5995277030017761139e-05, -0.00021503011930044477347, -0.00013871931833623122026,
     1.0103004648645343977, 4.8499064014085844221),
)


def _horner(coeffs, w: torch.Tensor) -> torch.Tensor:
    p = torch.full_like(w, coeffs[0])
    for c in coeffs[1:]:
        p = c + p * w
    return p


def _erfinv(x: torch.Tensor) -> torch.Tensor:
    """The inverse error function of :data:`_ERFINV32` (float64:
    :data:`_ERFINV64`; the half types in float32, rounded back); +-inf at
    +-1."""
    xf = x if x.dtype == torch.float64 else x.to(torch.float32)
    w = -torch.log1p(xf * -xf)
    if x.dtype == torch.float64:
        lt6, lt16 = w < 6.25, w < 16.0
        sw = torch.sqrt(w)
        p = torch.where(lt6, _horner(_ERFINV64[0], w - 3.125),
                        torch.where(lt16, _horner(_ERFINV64[1], sw - 3.25), _horner(_ERFINV64[2], sw - 5.0)))
    else:
        lt = w < 5.0
        p = torch.where(lt, _horner(_ERFINV32[0], w - 2.5), _horner(_ERFINV32[1], torch.sqrt(w) - 3.0))
    return torch.where(xf.abs() == 1.0, xf * float("inf"), p * xf).to(x.dtype)


def _shape(args) -> Tuple[int, ...]:
    out = []
    for s in args:
        if not isinstance(s, (int, np.integer)):
            raise TypeError(f"expected int dimensions, got {type(s)}")
        if int(s) < 0:
            raise ValueError(f"negative dimensions are not allowed, got {int(s)}")
        out.append(int(s))
    return tuple(out)


def _size(shape) -> Tuple[int, ...]:
    if isinstance(shape, (int, np.integer)):
        return _shape((shape,))
    if isinstance(shape, (list, tuple, np.ndarray)):
        return _shape(tuple(shape))
    raise TypeError(f"expected sequence object or single int, got {type(shape)}")


def _finalize(garr: torch.Tensor, dtype, split, device, comm) -> DNDarray:
    split = sanitize_axis(tuple(garr.shape), split) if garr.ndim else None
    return DNDarray(garr, tuple(garr.shape), dtype, split, device, comm)


# --------------------------------------------------------------------- #
# the draws                                                               #
# --------------------------------------------------------------------- #
def rand(*args, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Uniform samples in [0, 1) of shape ``args``."""
    shape = _shape(args)
    dtype = types.canonical_heat_type(dtype)
    if dtype not in (types.float32, types.float64, types.bfloat16, types.float16):
        raise ValueError(f"Unsupported dtype {dtype.__name__} for rand")
    sanitize_axis(shape, split)
    device, comm = _setup(device, comm)
    key = _consume(math.prod(shape))
    return _finalize(_uniform01(key, shape, dtype.torch_type(), comm.device), dtype, split, device, comm)


def random_sample(shape=None, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Uniform [0, 1) samples of ``shape``; no shape (``None``, ``()``,
    ``0``) draws one sample of shape (1,), as the reference does."""
    if not shape:
        shape = (1,)
    return rand(*_size(shape), dtype=dtype, split=split, device=device, comm=comm)


random = ranf = sample = random_sample


def uniform(low=0.0, high=1.0, size=None, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Uniform samples in [low, high): ``rand() * (high - low) + low``."""
    size = () if size is None else _size(size)
    r = rand(*size, dtype=dtype, split=split, device=device, comm=comm)
    if low != 0.0 or high != 1.0:
        from . import arithmetics

        r = arithmetics.add(arithmetics.mul(r, high - low), low)
    return r


def _umod(x: torch.Tensor, span: int) -> torch.Tensor:
    """``x mod span`` of unsigned 64-bit patterns held in int64, for a
    Python int ``span`` in [0, 2^64] (0 leaves ``x``, as XLA's unsigned
    remainder by zero does)."""
    if span == 0:
        return x
    hi, lo = (x >> 32) & _M32, x & _M32
    if span < 2**31:  # every product below stays under 2^62
        return ((hi % span) * ((1 << 32) % span) + lo % span) % span
    # long division, one bit at a time; a set top bit of r means 2r >= 2^64 > span
    sign = -(2**63)
    s = span - 2**64 if span >= 2**63 else span
    r = torch.zeros_like(x)
    for bit in range(63, -1, -1):
        carry = r < 0
        r = (r << 1) | ((x >> bit) & 1)
        r = torch.where(carry | ((r ^ sign) >= (s ^ sign)), r - s, r)
    return r


def randint(low, high=None, size=None, dtype=types.int32, split=None, device=None, comm=None) -> DNDarray:
    """Uniform integers in [low, high) (``[0, low)`` without ``high``)."""
    if high is None:
        low, high = 0, low
    if size is None:
        size = ()
    elif isinstance(size, (int, np.integer)):
        size = (int(size),)
    size = _size(size)
    if low >= high:
        raise ValueError(f"low >= high ({low} >= {high})")
    dtype = types.canonical_heat_type(dtype)
    if dtype not in (types.int64, types.int32, types.int16, types.int8, types.uint8):
        raise ValueError(f"Unsupported dtype {dtype.__name__} for randint")
    sanitize_axis(size, split)
    device, comm = _setup(device, comm)
    key = _consume(math.prod(size))

    # the reference's clip of the bounds: under 32 bits sample in int32
    info = torch.iinfo(dtype.torch_type())
    low, high = int(low), int(high)
    if info.bits < 32:
        wrap = lambda v: (v + 2**31) % 2**32 - 2**31  # noqa: E731  (astype int32)
        low = min(max(wrap(low), info.min), info.max)
        high = min(max(wrap(high), info.min), info.max + 1)
        info = torch.iinfo(torch.int32)
    nbits = info.bits
    lo_c = min(max(low, info.min), info.max)
    hi_c = min(max(high, info.min), info.max)
    span = (hi_c - lo_c) % 2**nbits
    if hi_c <= lo_c:
        span = 1
    elif high > info.max:
        span = (span + 1) % 2**nbits
    # 2^nbits mod span as (2^(nbits/2) mod span)^2 mod span, the square
    # wrapping in the unsigned width as it does there
    half = 2 ** (nbits // 2) % span if span else 2 ** (nbits // 2)
    mult = half * half % 2**nbits
    mult = mult % span if span else mult
    k1, k2 = _split(key)
    higher, lower = _bits(k1, nbits, size, comm.device), _bits(k2, nbits, size, comm.device)
    if nbits == 64:
        off = _umod(_umod(higher, span) * mult + _umod(lower, span), span)
    else:
        off = ((higher % span) * mult + lower % span) & _M32
        off = off % span if span else off
    garr = (off + lo_c).to(dtype.torch_type())
    return _finalize(garr, dtype, split, device, comm)


def randn(*args, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Standard-normal samples of shape ``args``: ``sqrt(2) erf_inv(u)``
    with ``u`` uniform in (-1, 1)."""
    shape = _shape(args)
    dtype = types.canonical_heat_type(dtype)
    tdt = dtype.torch_type()
    sanitize_axis(shape, split)
    device, comm = _setup(device, comm)
    key = _consume(math.prod(shape))
    lo = torch.nextafter(torch.tensor(-1.0, dtype=tdt), torch.tensor(0.0, dtype=tdt)).item()
    span = (torch.tensor(1.0, dtype=tdt) - lo).item()  # rounds to 2.0, as in the reference
    u = _uniform01(key, shape, tdt, comm.device) * span + lo
    u = torch.clamp_min(u, lo)
    garr = _erfinv(u) * torch.tensor(np.sqrt(2.0), dtype=tdt).item()
    return _finalize(garr.to(tdt), dtype, split, device, comm)


def _shuffle(key, n: int, device) -> torch.Tensor:
    """The reference's sort-based permutation of ``arange(n)``: rounds of
    a split and a stable sort on fresh 32-bit keys."""
    perm = torch.arange(n, dtype=torch.int64, device=device)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = _split(key)
        order = torch.sort(_bits(sub, 32, (n,), device), stable=True).indices
        perm = perm[order]
    return perm


def randperm(n: int, dtype=types.int64, split=None, device=None, comm=None) -> DNDarray:
    """A random permutation of ``arange(n)``."""
    if not isinstance(n, (int, np.integer)):
        raise TypeError(f"n must be an integer, got {type(n)}")
    dtype = types.canonical_heat_type(dtype)
    sanitize_axis((int(n),), split)
    device, comm = _setup(device, comm)
    key = _consume(int(n))
    garr = _shuffle(key, int(n), comm.device).to(dtype.torch_type())
    return _finalize(garr, dtype, split, device, comm)


def permutation(x, split=None, device=None, comm=None) -> DNDarray:
    """``randperm(x)`` for an integer; else a copy of ``x`` (a DNDarray or
    host data) with its rows (axis 0) shuffled."""
    if isinstance(x, (int, np.integer)):
        return randperm(int(x), split=split, device=device, comm=comm)
    if isinstance(x, DNDarray):
        device, comm = _setup(device or x.device, comm or x.comm)
        arr, dtype = x.larray.to(comm.device), x.dtype
        split = x.split if split is None else split
    else:
        device, comm = _setup(device, comm)
        arr = torch.as_tensor(np.asarray(x), device=comm.device)
        dtype = types.canonical_heat_type(arr.dtype)
    if arr.ndim == 0:
        raise TypeError("x must be an integer or at least 1-dimensional")
    key = _consume(int(arr.shape[0]))
    garr = arr[_shuffle(key, int(arr.shape[0]), comm.device)]
    return _finalize(garr, dtype, split, device, comm)
