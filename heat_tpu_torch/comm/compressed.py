"""Compressed collectives: block-scaled int8 (or bf16) ring allreduce and
allgather over the communicator's positions.

Port of ``heat_tpu/comm/compressed.py``.  Wire format (``int8_block``): a
payload of n f32 values is padded to a multiple of :data:`BLOCK` = 128
and sent as ``(rows, 128) int8`` plus ``(rows, 1) float32`` scales,
``scale = max|block| / 127``, ``q = round(x / scale)``.  Per-element
round-trip error is at most ``max|block| / 254``; across a p-position
ring the documented bound on the reduced value is ``p * sum_i absmax_i /
254`` per element.  A block with a NaN or Inf ships its non-finite absmax
as the scale (with q == 1), so it decodes to that value throughout.

The quantize/dequantize pair are hand-written CUDA kernels
(``csrc/blockquant.cu``) on a CUDA tensor, and their plain PyTorch
versions (:func:`quantize_blocks_plain`, :func:`dequantize_blocks_plain`)
on a CPU tensor.  A third kernel, :func:`dequantize_fma_blocks`, fuses a
decode with the addition after it into one fused multiply-add, because
the reference's compiled ring contracts those two operations.  A fourth,
:func:`dequantize_add_quantize_blocks`, is one whole reduce-scatter hop:
that fused decode-add, then the quantize of its sum for the next hop, in
one launch, with the f32 sum never written.  The plain versions flush
subnormals, saturate and fuse explicitly, as the reference does (see the
kernel source), so kernel and plain agree bit for bit on every input.

Rings run on the stacked position axis: a ``(p, ...)`` tensor holds one
block per position, a hop is a roll of the encoded payload along that
axis, and each hop encodes or decodes every position's chunk in ONE
kernel launch (quantization is row-independent, so this equals p
separate launches bit for bit).  An ``int8_block`` allreduce at p
positions launches 1 quantize, p - 1 hops and 1 dequantize.  The serial
ring body of the reference is ported; its overlapped two-stream body is
bitwise equal to it and is not.

Precision policy: a process-wide mode (``"f32"`` | ``"bf16"`` |
``"int8_block"`` | ``"auto"``) consulted by the communicator's allreduce
and the reductions; ``"f32"`` (the default) keeps every collective exact.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.communication import sanitize_comm
from . import _costs

__all__ = [
    "BLOCK",
    "allgather_q",
    "allreduce_q",
    "class_moments_q",
    "collective_precision",
    "dequantize_add_quantize_blocks",
    "dequantize_add_quantize_blocks_plain",
    "dequantize_blocks",
    "dequantize_blocks_plain",
    "dequantize_fma_blocks",
    "dequantize_fma_blocks_plain",
    "get_collective_precision",
    "get_collective_threshold",
    "moments_q",
    "quantize_blocks",
    "quantize_blocks_plain",
    "reduce_mode",
    "reduce_q",
    "ring_allgather_q",
    "ring_allreduce_q",
    "ring_allreduce_q_ef",
    "set_collective_precision",
    "set_collective_threshold",
    "wire_model",
]

BLOCK = _costs.BLOCK

_MODES = ("f32", "bf16", "int8_block", "auto")
_PRECISION = "f32"
#: "auto" compresses only payloads of at least this many bytes.
_AUTO_THRESHOLD = 1 << 16


# --------------------------------------------------------------------- #
# precision policy                                                       #
# --------------------------------------------------------------------- #
def set_collective_precision(precision: str) -> None:
    """Set the process-wide collective compression mode: ``"f32"`` (exact,
    the default), ``"bf16"``, ``"int8_block"``, or ``"auto"``
    (``int8_block`` for payloads of at least :func:`get_collective_threshold`
    bytes).  Only float32/bfloat16 payloads ever compress."""
    global _PRECISION
    if precision not in _MODES:
        raise ValueError(
            f"unknown collective precision {precision!r}: expected one of {_MODES}"
        )
    _PRECISION = precision


def get_collective_precision() -> str:
    """The current process-wide collective compression mode."""
    return _PRECISION


@contextlib.contextmanager
def collective_precision(precision: str):
    """Context manager form of :func:`set_collective_precision`."""
    prev = _PRECISION
    set_collective_precision(precision)
    try:
        yield
    finally:
        set_collective_precision(prev)


def set_collective_threshold(nbytes: int) -> None:
    """Minimum payload size (bytes) that ``"auto"`` mode compresses."""
    global _AUTO_THRESHOLD
    nbytes = int(nbytes)
    if nbytes < 0:
        raise ValueError("threshold must be non-negative")
    _AUTO_THRESHOLD = nbytes


def get_collective_threshold() -> int:
    """Current ``"auto"``-mode payload-size threshold in bytes."""
    return _AUTO_THRESHOLD


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    from ..core import types

    return types.canonical_heat_type(dtype).__name__


def reduce_mode(dtype, payload_nbytes: int, precision: Optional[str] = None):
    """The wire mode of a payload: ``"bf16"`` / ``"int8_block"``, or
    ``None`` when the collective stays exact (the ``"f32"`` policy,
    ``"auto"`` payloads under the threshold, exact dtypes).  An EXPLICIT
    compressed ``precision`` on an exact dtype raises ``TypeError``
    (SPMD203)."""
    p = precision if precision is not None else _PRECISION
    if p not in _MODES:
        raise ValueError(
            f"unknown collective precision {p!r}: expected one of {_MODES}"
        )
    name = _dtype_name(dtype)
    if p != "f32" and name not in _costs._COMPRESSIBLE and precision is not None:
        raise TypeError(
            f"quantized collective requested on exact dtype {name}: only "
            "float32/bfloat16 payloads compress (SPMD203)"
        )
    return _costs.resolve_mode(name, payload_nbytes, p, _AUTO_THRESHOLD)


# --------------------------------------------------------------------- #
# block-scaled quantization: CUDA kernels, plain PyTorch versions        #
# --------------------------------------------------------------------- #
_FLT_MIN = torch.finfo(torch.float32).tiny
#: 1/127 rounded to float32.  The reference's compiled programs scale by
#: this product: XLA rewrites the division by the constant 127 into a
#: multiplication by its reciprocal (only eager, uncompiled calls divide).
_INV127 = float(torch.tensor(1.0, dtype=torch.float32) / 127.0)


def _flush(t: torch.Tensor) -> torch.Tensor:
    """Subnormals to signed zero (the reference's flush-to-zero)."""
    return torch.where(t.abs() < _FLT_MIN, t * 0.0, t)


def _canon(t: torch.Tensor) -> torch.Tensor:
    """Every NaN as the quiet NaN 0x7fc00000: what the reference produces,
    where the GPU's arithmetic would write 0x7fffffff."""
    return torch.where(torch.isnan(t), torch.full_like(t, float("nan")), t)


def quantize_blocks_plain(x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the quantize kernel on ``(rows, block)``
    f32 rows: ``(q int8, scale (rows, 1) f32)``, with the flush,
    saturation and NaN -> 0 rules spelled out (torch keeps subnormals, and
    its int8 cast of an out-of-range float is undefined)."""
    x2 = _flush(x2)
    absmax = x2.abs().amax(dim=1, keepdim=True)
    finite = torch.isfinite(absmax)
    one = torch.ones_like(absmax)
    scale = torch.where(
        finite & (absmax > 0), _flush(absmax * _INV127), torch.where(finite, one, absmax)
    )
    scale = _canon(scale)
    v = x2 / scale
    q = torch.where(torch.isnan(v), torch.zeros_like(v), v.round().clamp(-128.0, 127.0))
    q = torch.where(finite, q, one)
    return q.to(torch.int8), scale


def dequantize_blocks_plain(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the dequantize kernel: flat f32
    ``float(q) * scale`` (a subnormal scale counts as zero)."""
    return _canon(q.to(torch.float32) * _flush(scales)).reshape(-1)


def dequantize_fma_blocks_plain(
    q: torch.Tensor, scales: torch.Tensor, addend: torch.Tensor, negate: bool = False
) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel: flat f32
    ``addend +- float(q) * scale`` rounded ONCE, as a float32 fused
    multiply-add.  torch has no float32 FMA it guarantees, so the exact
    product (int8 times float32 fits a float64) and the sum are taken in
    float64, rounded to odd (TwoSum gives the rounding error; an inexact
    sum moves to its odd neighbour), then to float32 — which equals the
    single rounding of the exact value."""
    s = _flush(scales).to(torch.float64)
    prod = q.to(torch.float64) * s
    if negate:
        prod = -prod
    c = _flush(addend.reshape(q.shape)).to(torch.float64)
    tot = prod + c
    bb = tot - prod
    err = (prod - (tot - bb)) + (c - bb)
    even = (tot.view(torch.int64) & 1) == 0
    fix = (err != 0) & even & torch.isfinite(tot)
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(torch.float64)
    tot = torch.where(fix, torch.nextafter(tot, toward), tot)
    return _canon(_flush(tot.to(torch.float32))).reshape(-1)


def dequantize_add_quantize_blocks_plain(
    q: torch.Tensor, scales: torch.Tensor, addend: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the hop kernel: the fused decode-add of
    :func:`dequantize_fma_blocks_plain`, then :func:`quantize_blocks_plain`
    of its sum."""
    return quantize_blocks_plain(dequantize_fma_blocks_plain(q, scales, addend).reshape(q.shape))


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a block-quantization library."""
    ptr = ctypes.c_void_p
    for fn in (lib.blockquant_quantize, lib.blockquant_dequantize):
        fn.argtypes = [ptr, ptr, ptr, ctypes.c_int64, ptr]
    lib.blockquant_dequantize_fma.argtypes = [ptr, ptr, ptr, ctypes.c_float, ptr, ctypes.c_int64, ptr]
    lib.blockquant_dequantize_add_quantize.argtypes = [ptr, ptr, ptr, ptr, ptr, ctypes.c_int64, ptr]
    lib.blockquant_grid.argtypes = [ctypes.c_int64, ctypes.c_int, ptr, ptr]
    for fn in (lib.blockquant_quantize, lib.blockquant_dequantize, lib.blockquant_dequantize_fma,
               lib.blockquant_dequantize_add_quantize, lib.blockquant_grid):
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    """The block-quantization library, built on first use, with its C
    signatures declared."""
    from .. import kernels

    return _declare(kernels.library("blockquant"))


def _quantize_grid(rows: int, fused: bool = False) -> Tuple[int, int]:
    """The launch shape of the quantize kernel (``fused``: of the hop
    kernel) over ``rows`` rows on the current CUDA device: ``(CTAs, rows
    a CTA takes per step of its loop)``.  The grid is capped at the CTAs
    the card holds at once, so a CTA walks ``ceil(rows / step / CTAs)``
    steps."""
    ctas, step = ctypes.c_int64(0), ctypes.c_int(0)
    _check(_lib().blockquant_grid(int(rows), int(fused), ctypes.addressof(ctas),
                                  ctypes.addressof(step)), "blockquant_grid")
    return ctas.value, step.value


def _aligned(t: torch.Tensor, nbytes: int) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % nbytes == 0 else t.clone()


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")


def quantize_blocks(x: torch.Tensor, block: int = BLOCK) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-scale a flat f32 payload (length a multiple of ``block``):
    ``(rows, block) int8`` + ``(rows, 1) float32`` scales.  A CUDA tensor
    runs the ``blockquant_quantize`` kernel, a CPU tensor the plain
    version; any other device raises."""
    if x.ndim != 1 or x.dtype != torch.float32:
        raise ValueError(f"quantize_blocks takes a flat float32 tensor, got {x.dtype} {tuple(x.shape)}")
    if x.numel() % block:
        raise ValueError(f"payload length {x.numel()} is not a multiple of block={block}")
    rows = x.numel() // block
    if x.device.type == "cpu":
        return quantize_blocks_plain(x.reshape(rows, block))
    if x.device.type != "cuda":
        raise ValueError(f"quantize_blocks runs on CUDA or CPU tensors, not {x.device}")
    if block != BLOCK:
        raise ValueError(f"the CUDA kernel takes block={BLOCK}, got {block}")
    q = torch.empty((rows, block), dtype=torch.int8, device=x.device)
    s = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    if rows == 0:
        return q, s
    x = _aligned(x, 16)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().blockquant_quantize(x.data_ptr(), q.data_ptr(), s.data_ptr(), rows, stream)
    _check(rc, "blockquant_quantize")
    quantize_blocks.launches += 1
    return q, s


def dequantize_blocks(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_blocks`: flat f32 payload of length
    ``q.numel()``.  A CUDA tensor runs the ``blockquant_dequantize``
    kernel, a CPU tensor the plain version; any other device raises."""
    rows, block = q.shape
    if q.dtype != torch.int8 or scales.dtype != torch.float32 or tuple(scales.shape) != (rows, 1):
        raise ValueError(
            f"dequantize_blocks takes (rows, block) int8 and (rows, 1) float32, got "
            f"{q.dtype} {tuple(q.shape)} and {scales.dtype} {tuple(scales.shape)}"
        )
    if q.device.type == "cpu":
        return dequantize_blocks_plain(q, scales)
    if q.device.type != "cuda" or scales.device != q.device:
        raise ValueError(f"dequantize_blocks runs on CUDA or CPU tensors, not {q.device}/{scales.device}")
    if block != BLOCK:
        raise ValueError(f"the CUDA kernel takes block={BLOCK}, got {block}")
    out = torch.empty(rows * block, dtype=torch.float32, device=q.device)
    if rows == 0:
        return out
    q = _aligned(q, 4)
    scales = scales.contiguous()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().blockquant_dequantize(q.data_ptr(), scales.data_ptr(), out.data_ptr(), rows, stream)
    _check(rc, "blockquant_dequantize")
    dequantize_blocks.launches += 1
    return out


def dequantize_fma_blocks(
    q: torch.Tensor, scales: torch.Tensor, addend: torch.Tensor, negate: bool = False
) -> torch.Tensor:
    """Decode fused with the addition that follows it: flat f32
    ``addend + float(q) * scale`` (``negate``: ``addend - float(q) *
    scale``), rounded once.  This is what the reference's compiled ring
    computes for a reduce-scatter hop's decode-and-accumulate and for the
    error-feedback residual.  ``addend`` is flat f32 of ``q.numel()``
    values.  A CUDA tensor runs the ``blockquant_dequantize_fma`` kernel,
    a CPU tensor the plain version; any other device raises."""
    rows, block = q.shape
    if q.dtype != torch.int8 or scales.dtype != torch.float32 or tuple(scales.shape) != (rows, 1):
        raise ValueError(
            f"dequantize_fma_blocks takes (rows, block) int8 and (rows, 1) float32, got "
            f"{q.dtype} {tuple(q.shape)} and {scales.dtype} {tuple(scales.shape)}"
        )
    if addend.dtype != torch.float32 or addend.numel() != q.numel():
        raise ValueError(f"addend must be float32 with {q.numel()} values")
    if q.device.type == "cpu":
        return dequantize_fma_blocks_plain(q, scales, addend, negate)
    if q.device.type != "cuda" or scales.device != q.device or addend.device != q.device:
        raise ValueError(f"dequantize_fma_blocks runs on CUDA or CPU tensors, not {q.device}")
    if block != BLOCK:
        raise ValueError(f"the CUDA kernel takes block={BLOCK}, got {block}")
    out = torch.empty(rows * block, dtype=torch.float32, device=q.device)
    if rows == 0:
        return out
    q = _aligned(q, 4)
    addend = _aligned(addend.reshape(-1), 16)
    scales = scales.contiguous()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().blockquant_dequantize_fma(
            q.data_ptr(), scales.data_ptr(), addend.data_ptr(), -1.0 if negate else 1.0,
            out.data_ptr(), rows, stream,
        )
    _check(rc, "blockquant_dequantize_fma")
    dequantize_fma_blocks.launches += 1
    return out


def dequantize_add_quantize_blocks(
    q: torch.Tensor, scales: torch.Tensor, addend: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One reduce-scatter hop: decode the incoming payload ``(q, scales)``,
    add ``addend`` (flat f32 of ``q.numel()`` values) with one rounding,
    and quantize the sum: the next hop's ``(q', scales')``.  Bit for bit
    ``quantize_blocks(dequantize_fma_blocks(q, scales, addend))``, without
    writing the f32 sum.  A CUDA tensor runs the
    ``blockquant_dequantize_add_quantize`` kernel, a CPU tensor the plain
    version; any other device raises."""
    if (q.ndim != 2 or q.dtype != torch.int8 or scales.dtype != torch.float32
            or tuple(scales.shape) != (q.shape[0], 1)):
        raise ValueError(
            f"dequantize_add_quantize_blocks takes (rows, block) int8 and (rows, 1) float32, "
            f"got {q.dtype} {tuple(q.shape)} and {scales.dtype} {tuple(scales.shape)}"
        )
    rows, block = q.shape
    if addend.dtype != torch.float32 or addend.numel() != q.numel():
        raise ValueError(f"addend must be float32 with {q.numel()} values")
    if q.device.type == "cpu" and scales.device == q.device and addend.device == q.device:
        return dequantize_add_quantize_blocks_plain(q, scales, addend)
    if q.device.type != "cuda" or scales.device != q.device or addend.device != q.device:
        raise ValueError(
            f"dequantize_add_quantize_blocks runs on CUDA or CPU tensors, not "
            f"{q.device}/{scales.device}/{addend.device}"
        )
    if block != BLOCK:
        raise ValueError(f"the CUDA kernel takes block={BLOCK}, got {block}")
    q_out = torch.empty((rows, block), dtype=torch.int8, device=q.device)
    s_out = torch.empty((rows, 1), dtype=torch.float32, device=q.device)
    if rows == 0:
        return q_out, s_out
    q = _aligned(q, 16)
    addend = _aligned(addend.reshape(-1), 16)
    scales = scales.contiguous()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().blockquant_dequantize_add_quantize(
            q.data_ptr(), scales.data_ptr(), addend.data_ptr(), q_out.data_ptr(),
            s_out.data_ptr(), rows, stream,
        )
    _check(rc, "blockquant_dequantize_add_quantize")
    dequantize_add_quantize_blocks.launches += 1
    return q_out, s_out


#: launches of each kernel since the count was last set to 0
quantize_blocks.launches = 0
dequantize_blocks.launches = 0
dequantize_fma_blocks.launches = 0
dequantize_add_quantize_blocks.launches = 0


def _encode(flat: torch.Tensor, mode: str, block: int) -> Tuple[torch.Tensor, ...]:
    """Flat f32 (length a multiple of ``block``) -> tuple of wire leaves."""
    if mode == "bf16":
        return (flat.to(torch.bfloat16),)
    return quantize_blocks(flat, block)


def _decode(payload: Tuple[torch.Tensor, ...], mode: str) -> torch.Tensor:
    """Wire leaves -> flat f32."""
    if mode == "bf16":
        return payload[0].to(torch.float32)
    return dequantize_blocks(*payload)


def _roundtrip(flat: torch.Tensor, mode: str, block: int) -> torch.Tensor:
    """``deQ(Q(flat))``: what a hop actually transmits."""
    return _decode(_encode(flat, mode, block), mode)


def _decode_add(payload: Tuple[torch.Tensor, ...], mode: str, addend: torch.Tensor,
                negate: bool = False) -> torch.Tensor:
    """``addend +- decode(payload)``, flat f32; fused (one rounding) for
    int8 payloads, as the reference's compiled programs compute it."""
    if mode == "bf16":
        dec = payload[0].to(torch.float32)
        return addend.reshape(-1) - dec if negate else dec + addend.reshape(-1)
    return dequantize_fma_blocks(*payload, addend.reshape(-1), negate=negate)


def _decode_add_encode(payload: Tuple[torch.Tensor, ...], mode: str, addend: torch.Tensor,
                       block: int) -> Tuple[torch.Tensor, ...]:
    """``encode(addend + decode(payload))``: a reduce-scatter hop's
    accumulate and re-encode; one kernel for int8 payloads."""
    if mode == "bf16":
        return _encode(_decode_add(payload, mode, addend), mode, block)
    return dequantize_add_quantize_blocks(*payload, addend.reshape(-1))


def _hop(payload: Tuple[torch.Tensor, ...], size: int) -> Tuple[torch.Tensor, ...]:
    """One ring hop of a stacked payload: position i's leaves move to
    position i + 1 (every leaf's leading rows split evenly by position)."""
    out = []
    for leaf in payload:
        stacked = leaf.reshape((size, -1) + tuple(leaf.shape[1:]))
        out.append(torch.roll(stacked, shifts=1, dims=0).reshape(leaf.shape))
    return tuple(out)


def _padded_len(n: int, block: int) -> int:
    return max(block, -(-n // block) * block)


# --------------------------------------------------------------------- #
# ring primitives on the stacked position axis                           #
# --------------------------------------------------------------------- #
def ring_allreduce_q(stacked: torch.Tensor, *, size: int, mode: str, block: int = BLOCK) -> torch.Tensor:
    """Compressed ring all-reduce (sum) over the position axis.

    ``stacked`` has shape ``(size,) + shape``: row i is position i's
    contribution.  Two stages of ``size - 1`` hops: a reduce-scatter in
    which every hop re-quantizes the running partial sum of one chunk,
    then an all-gather in which each reduced chunk is quantized exactly
    once and the same bytes travel the ring.  Every position decodes the
    identical bytes, so the result is one replicated tensor of ``shape``.
    The reduce-scatter's partial sums stay encoded: each hop decodes,
    adds and re-encodes in one step (:func:`_decode_add_encode`), the
    same operations in the same order as the reference's
    ``encode(decode(payload) + chunk)``.
    """
    if size == 1:
        return stacked[0]
    shape, dtype = tuple(stacked.shape[1:]), stacked.dtype
    n = math.prod(shape)
    flat = stacked.reshape(size, n).to(torch.float32)
    chunk = _padded_len(-(-n // size), block)
    total = size * chunk
    chunks = F.pad(flat, (0, total - n)).reshape(size, size, chunk)
    pos = torch.arange(size, device=stacked.device)

    # stage 1 - reduce-scatter: position i ends holding chunk (i+1) mod
    # size, encoded: the payload of the all-gather
    payload = _encode(chunks[pos, pos].reshape(-1), mode, block)
    for s in range(size - 1):
        add = chunks[pos, (pos - s - 1) % size]
        payload = _decode_add_encode(_hop(payload, size), mode, add, block)

    # stage 2 - all-gather: each reduced chunk quantized once, its bytes
    # forwarded verbatim; chunk j is decoded from position j-1's payload
    out = _decode(_hop(payload, size), mode)
    return out[:n].reshape(shape).to(dtype)


def ring_allreduce_q_ef(
    stacked: torch.Tensor, error: torch.Tensor, *, size: int, mode: str, block: int = BLOCK
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback form: returns ``(reduced, new_error)``.

    The ring input is ``x + e`` per position; the new residual
    ``(x + e) - deQ(Q(x + e))`` (stacked like ``error``) is the part the
    first quantization drops, for the caller to feed back next round."""
    xc = stacked.to(torch.float32) + error.to(torch.float32)
    if size == 1:
        return xc[0].to(stacked.dtype), torch.zeros_like(error)
    n = math.prod(xc.shape[1:])
    padded = _padded_len(n, block)
    flat = F.pad(xc.reshape(size, n), (0, padded - n)).reshape(-1)
    resid = _decode_add(_encode(flat, mode, block), mode, flat, negate=True)
    resid = resid.reshape(size, padded)[:, :n].reshape(xc.shape)
    reduced = ring_allreduce_q(xc, size=size, mode=mode, block=block)
    return reduced.to(stacked.dtype), resid.to(error.dtype)


def ring_allgather_q(stacked: torch.Tensor, *, size: int, mode: str, block: int = BLOCK) -> torch.Tensor:
    """Compressed ring all-gather: each position's value (row i of
    ``stacked``) is quantized once and its bytes make ``size - 1`` hops;
    every position decodes the identical bytes, so the stacked result is
    the same everywhere."""
    if size == 1:
        return stacked
    shape, dtype = tuple(stacked.shape[1:]), stacked.dtype
    n = math.prod(shape)
    padded = _padded_len(n, block)
    flat = F.pad(stacked.reshape(size, n).to(torch.float32), (0, padded - n))
    out = _roundtrip(flat.reshape(-1), mode, block).reshape(size, padded)
    return out[:, :n].reshape((size,) + shape).to(dtype)


# --------------------------------------------------------------------- #
# host-level collectives                                                 #
# --------------------------------------------------------------------- #
def _payload_nbytes(array: torch.Tensor, stacked: bool) -> int:
    nbytes = array.numel() * array.element_size()
    if stacked and array.ndim:
        nbytes //= max(int(array.shape[0]), 1)
    return nbytes


def allreduce_q(
    array: torch.Tensor,
    op: str = "sum",
    comm=None,
    precision: Optional[str] = None,
    error: Optional[torch.Tensor] = None,
    block: Optional[int] = None,
):
    """Compressed twin of ``TorchCommunication.allreduce``: ``array`` has
    shape ``(comm.size, ...)``, one block per position; returns the sum,
    shape ``(...)``.  ``error`` (same shape as ``array``) switches on error
    feedback and the call returns ``(result, new_error)``.  Only
    ``op="sum"`` compresses; other ops, and payloads the policy leaves
    exact, take the exact collective."""
    mode = reduce_mode(array.dtype, _payload_nbytes(array, stacked=True), precision)
    comm = sanitize_comm(comm)
    if op != "sum":
        if error is not None:
            raise ValueError(f"error feedback requires op='sum', got {op!r}")
        return comm.allreduce(array, op)
    if mode is None and error is None:
        with collective_precision("f32"):
            return comm.allreduce(array, op)
    p = comm.size
    if int(array.shape[0]) != p:
        raise ValueError(
            f"allreduce_q expects one block per mesh position: leading axis "
            f"{array.shape[0]} != mesh size {p}"
        )
    blk = int(block or BLOCK)
    if p == 1:
        if error is None:
            return array[0]
        return array[0] + error[0].to(array.dtype), torch.zeros_like(error)
    if error is None:
        return ring_allreduce_q(array, size=p, mode=mode, block=blk)
    if mode is None:
        return (array + error.to(array.dtype)).sum(dim=0), torch.zeros_like(error)
    return ring_allreduce_q_ef(array, error, size=p, mode=mode, block=blk)


def allgather_q(
    array: torch.Tensor,
    axis: int = 0,
    comm=None,
    precision: Optional[str] = None,
    block: Optional[int] = None,
) -> torch.Tensor:
    """Compressed twin of ``TorchCommunication.allgather``: replicate a
    global tensor split at ``axis``, each position's shard quantized once.
    Payloads the policy leaves exact, and ragged axes, stay exact."""
    comm = sanitize_comm(comm)
    p = comm.size
    mode = reduce_mode(array.dtype, _payload_nbytes(array, stacked=False), precision)
    if mode is None or p == 1 or array.ndim == 0:
        return array
    axis = int(axis) % array.ndim
    if int(array.shape[axis]) % p:
        return array
    moved = array.movedim(axis, 0)
    blocks = moved.reshape((p, moved.shape[0] // p) + tuple(moved.shape[1:]))
    full = ring_allgather_q(blocks, size=p, mode=mode, block=int(block or BLOCK))
    return full.reshape(moved.shape).movedim(0, axis)


def wire_model(n_elems: int, size: int, mode: Optional[str], *,
               block: int = BLOCK, op: str = "allreduce") -> dict:
    """Bytes-moved model for one ring collective, per position."""
    return _costs.ring_wire_model(n_elems, size, mode, block=block, op=op)


# --------------------------------------------------------------------- #
# reduction engines behind sum / mean / var / std                        #
# --------------------------------------------------------------------- #
def _partials(comm, buffer: torch.Tensor, split: int, axes: Tuple[int, ...], keepdims: bool, fn):
    """Per-position partial reductions ``fn(block)`` of a padded buffer:
    shape ``(p,) + reduced shape``."""
    blocks = comm.blocks(buffer, split).to(torch.float32)
    dims = tuple(a + 1 for a in axes)
    return torch.sum(fn(blocks), dim=dims, keepdim=keepdims)


def reduce_q(
    buffer: torch.Tensor,
    *,
    comm,
    split: int,
    axes: Tuple[int, ...],
    keepdims: bool,
    mode: str,
    mean_n: Optional[int] = None,
    out_dtype=None,
    block: Optional[int] = None,
) -> torch.Tensor:
    """Compressed ``sum`` (or, with ``mean_n``, mean) over axes covering
    the split axis of the padded buffer: exact local partials (pad rows
    are zeros), combined on the quantized ring; the result is replicated."""
    blk = int(block or BLOCK)
    part = _partials(comm, buffer, split, axes, keepdims, lambda b: b)
    red = ring_allreduce_q(part, size=comm.size, mode=mode, block=blk)
    if mean_n is not None:
        red = red / float(mean_n)
    return red.to(out_dtype or buffer.dtype)


def moments_q(
    buffer: torch.Tensor,
    *,
    comm,
    split: int,
    axes: Tuple[int, ...],
    keepdims: bool,
    mode: str,
    true_n: int,
    split_valid: int,
    ddof: int = 0,
    finalize: str = "var",
    out_dtype=None,
    block: Optional[int] = None,
) -> torch.Tensor:
    """Compressed var/std with CENTERED second moments.

    The first moment combines exactly (it also centers the data); only
    the centered sum of squared deviations rides the quantized ring,
    computed per position through

        sum_local (x - mu)^2 = sum x^2 - 2 mu sum_local x + c_local mu^2

    with ``c_local`` the position's count of real (un-padded) elements, so
    the ring payload is ``~ var * n`` rather than ``~ mu^2 * n``."""
    p = comm.size
    blk = int(block or BLOCK)
    other = true_n // max(int(split_valid), 1)
    s1 = _partials(comm, buffer, split, axes, keepdims, lambda b: b)
    s2 = _partials(comm, buffer, split, axes, keepdims, lambda b: b * b)
    mu = s1.sum(dim=0) / float(true_n)
    counts = torch.tensor(
        [c * other for c in comm.valid_counts(split_valid)],
        dtype=torch.float32, device=buffer.device,
    ).reshape((p,) + (1,) * (s1.ndim - 1))
    ssd_local = s2 - 2.0 * mu * s1 + counts * mu * mu
    ssd = ring_allreduce_q(ssd_local, size=p, mode=mode, block=blk)
    var = torch.clamp_min(ssd, 0.0) / float(true_n - ddof)
    out = torch.sqrt(var) if finalize == "std" else var
    return out.to(out_dtype or buffer.dtype)


def class_moments_q(arr: torch.Tensor, member: torch.Tensor, *, comm, mode: str,
                    block: Optional[int] = None):
    """Per-class ``(counts, sums, ssd)`` for GaussianNB's ``partial_fit``.

    ``arr`` is ``(n, f)`` and ``member`` ``(n, k)`` (class weights), both
    split over rows with ``n`` divisible by the positions.  Counts and
    first moments combine exactly: they divide every statistic and center
    the second moments, and ``sqsum / n - mu^2`` cancels catastrophically
    on uncentered data.  Only the centered sums of squared deviations
    ride the quantized ring, each position's partial taken through

        sum_i m_ik (x_i - mu_k)^2 = sq_k - 2 mu_k s_k + (sum_i m_ik) mu_k^2

    in float32, so the payload is ``~ var_k n_k`` rather than ``~ mu_k^2
    n_k``.  Returns replicated float32 ``(k,)`` counts, ``(k, f)`` sums
    and ``(k, f)`` ssd (clamped at 0)."""
    p = comm.size
    blk = int(block or BLOCK)
    n, f = int(arr.shape[0]), int(arr.shape[1])
    k = int(member.shape[1])
    a = arr.to(torch.float32).reshape(p, n // p, f)
    m = member.to(torch.float32).reshape(p, n // p, k)
    c_local = torch.sum(m, dim=1)  # (p, k)
    # one product per position: on an H100 the batched (4, 8, 125 000) x
    # (4, 125 000, 32) product takes 4.1 ms, each product alone 30 us
    # (its long k-sum split over the card; scripts/profile_torch_slice.py)
    s_local = torch.stack([m[i].T @ a[i] for i in range(p)])  # (p, k, f)
    sq_local = torch.stack([m[i].T @ (a[i] * a[i]) for i in range(p)])
    counts, sums = c_local.sum(dim=0), s_local.sum(dim=0)
    mu = sums / torch.clamp_min(counts, 1.0)[:, None]
    ssd_local = sq_local - 2.0 * mu * s_local + c_local[:, :, None] * mu * mu
    ssd = ring_allreduce_q(ssd_local, size=p, mode=mode, block=blk)
    return counts, sums, torch.clamp_min(ssd, 0.0)
