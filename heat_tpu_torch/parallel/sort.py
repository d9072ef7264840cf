"""Distributed stable sort over the communicator's positions.

Port of ``heat_tpu/parallel/sort.py``.  Two formulations, picked by
:func:`sort_axis0` on the shape, as in the reference:

**1-D and narrow n-D (ring rank sort).**  Every value maps onto one int64
*order key* (an order-preserving encoding for every dtype: a 32-bit
dtype's unsigned order word, or a 64-bit dtype's ``(hi, lo)`` words as
``((hi << 32) | lo) - 2**63``), with NaN above every number and the
canonical padding rows above everything.  The total order is (key,
real-before-pad, position, local position), which gives numpy's stable
semantics.  Each position stable-sorts its keys locally; then p - 1 ring
rounds each count, for every element, how many elements of the visiting
block precede it (``searchsorted`` on the key, a pad-prefix lookup for
the tie-break).  Own-block positions seed the count; the sum is the exact
global rank, and one scatter puts values and original indices in place.
On one card the p positions' blocks are the stacked ``(p, b, w)`` tensor:
a round's hop is a roll of it and its counts are batched over positions.
A narrow array (1 < b < p columns) keeps its column axis through the
rounds.

Signed zeros: the key maps ``-0.0`` to ``+0.0`` before the bit fold, as
``numpy`` and ``jnp.argsort`` compare them, so equal zeros keep their
index order (the reference's fold ranks every ``-0.0`` first).

**n-D with b >= p columns (resplit sort).**  One all-to-all re-splits the
array onto its columns, each position sorts its own columns with a
batched stable argsort, and a second all-to-all restores the row split.

Values travel verbatim (NaN payloads and signed zeros survive); sort
indices are int32, as in the reference.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..core.communication import TorchCommunication, sanitize_comm
from .primitives import all_to_all_resplit

__all__ = [
    "ring_rank_sort",
    "sort_axis0",
    "supports",
    "supports_axis",
    "supports_axis0",
    "ORDERABLE_32BIT",
    "ORDERABLE_64BIT",
]

#: dtypes whose order key is one 32-bit word
ORDERABLE_32BIT = frozenset(
    {torch.float32, torch.bfloat16, torch.float16, torch.int32, torch.int16, torch.int8,
     torch.uint8, torch.bool}
)
#: dtypes whose order key is the ``(hi, lo)`` pair of 32-bit words
ORDERABLE_64BIT = frozenset({torch.float64, torch.int64})

_WORD = 0xFFFFFFFF
#: the 32-bit NaN and padding words: NaN above every number, below padding
_NAN_WORD, _PAD_WORD = 0xFFFFFFFE, 0xFFFFFFFF
#: the same words in the 64-bit key: ``((hi << 32) | lo) - 2**63``
_NAN_KEY64 = (0xFFFFFFFE << 32) - (1 << 63)
_PAD_KEY64 = (1 << 63) - 1
_INT32_MAX = 2**31 - 1


def supports(dtype, n: int, comm: TorchCommunication) -> bool:
    """True when :func:`ring_rank_sort` applies: several positions, an
    orderable dtype, and a padded length the int32 indices can address."""
    return (
        comm.size > 1
        and dtype in ORDERABLE_32BIT | ORDERABLE_64BIT
        and 0 < n
        and comm.padded_size(n) <= _INT32_MAX
    )


def supports_axis0(dtype, shape, comm: TorchCommunication) -> bool:
    """True when :func:`sort_axis0` has a distributed plan for sorting
    along axis 0 of ``shape``."""
    if comm.size <= 1 or len(shape) == 0 or shape[0] <= 0:
        return False
    b = math.prod(shape[1:]) if len(shape) > 1 else 1
    if b == 0:
        return False
    if len(shape) > 1 and b >= comm.size:
        # the resplit path sorts any real dtype; its indices are int32
        return not dtype.is_complex and shape[0] <= _INT32_MAX
    return supports(dtype, shape[0], comm)


def supports_axis(dtype, shape, axis: int, comm: TorchCommunication) -> bool:
    """:func:`supports_axis0` after moving ``axis`` to the front."""
    moved = (shape[axis],) + tuple(s for i, s in enumerate(shape) if i != axis)
    return supports_axis0(dtype, moved, comm)


def _float_bits(vals: torch.Tensor) -> torch.Tensor:
    """The IEEE bits of float32 (or float64) values with ``-0.0`` mapped
    to ``+0.0``, as int32 (int64)."""
    zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
    vals = torch.where(vals == 0, zero, vals)
    return vals.view(torch.int64 if vals.dtype == torch.float64 else torch.int32)


def order_key(vals: torch.Tensor, descending: bool = False) -> torch.Tensor:
    """The int64 order key of ``vals``: ``a`` sorts before ``b`` exactly
    when ``key(a) < key(b)``, NaN greatest in both directions (numpy's
    NaN-last rule; descending matches ``argsort(-x)``).  Floats fold the
    sign of their bits (``-0.0`` first made ``+0.0``), signed integers
    flip their sign bit, unsigned and bool widen.  Integer keys may equal
    the NaN or padding words: the tie-break (real before pad, then
    position, then local position) keeps the order total."""
    dt = vals.dtype
    if dt in ORDERABLE_64BIT:
        if dt == torch.float64:
            bits = _float_bits(vals)
            key = torch.where(bits < 0, bits ^ 0x7FFFFFFFFFFFFFFF, bits)
        else:
            key = vals.to(torch.int64)
        if descending:
            key = ~key
        if dt == torch.float64:
            key = torch.where(torch.isnan(vals), torch.full_like(key, _NAN_KEY64), key)
        return key
    if dt == torch.bool or dt == torch.uint8:
        u = vals.to(torch.int64)
    elif not dt.is_floating_point:
        u = vals.to(torch.int64) + (1 << 31)
    else:
        f = vals.to(torch.float32)
        bits = _float_bits(f).to(torch.int64) & _WORD
        u = torch.where(bits >= (1 << 31), bits ^ _WORD, bits | (1 << 31))
    if descending:
        u = u ^ _WORD
    if dt.is_floating_point:
        u = torch.where(torch.isnan(vals), torch.full_like(u, _NAN_WORD), u)
    return u


_INT_OF_WIDTH = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def as_bits(t: torch.Tensor) -> torch.Tensor:
    """A float tensor's bits as the integer type of its width (other types
    as they are).  Values move through gathers and scatters as bits:
    torch's CPU scatter (and some gathers) of bfloat16 rewrite a NaN's
    payload, where the reference moves every value verbatim."""
    return t.view(_INT_OF_WIDTH[t.element_size()]) if t.dtype.is_floating_point else t


def from_bits(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The inverse of :func:`as_bits`."""
    return t.view(dtype) if dtype.is_floating_point else t


def _pad_key(dtype) -> int:
    return _PAD_KEY64 if dtype in ORDERABLE_64BIT else _PAD_WORD


def ring_rank_sort(
    arr: torch.Tensor,
    n: int,
    comm: Optional[TorchCommunication] = None,
    descending: bool = False,
    want_indices: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Stable distributed sort of a 1-D tensor of true length ``n``
    (``arr`` may be canonically padded past it).  Returns ``(values,
    original_indices)`` of length ``n``, indices int32;
    ``want_indices=False`` returns ``(values, None)``."""
    comm = sanitize_comm(comm)
    if arr.dtype not in ORDERABLE_32BIT | ORDERABLE_64BIT:
        raise TypeError(f"ring_rank_sort does not support dtype {arr.dtype}")
    if comm.padded_size(n) > _INT32_MAX:
        raise ValueError("padded axis length exceeds int32 rank arithmetic")
    vals, idx = _rrs_batched(arr[:, None], n, comm, descending, want_indices)
    return vals[:, 0], (idx[:, 0] if idx is not None else None)


def _rrs_batched(
    arr: torch.Tensor, n: int, comm: TorchCommunication, descending: bool, want_indices: bool = True
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Ring rank sort with a column axis: ``arr`` is ``(rows, b)``, rows
    ``>= n`` (true length or padded), each column an independent 1-D sort
    of length ``n``.  One p - 1 round traversal ranks every column."""
    p, b = comm.size, int(arr.shape[1])
    arr = comm.pad_to_shards(arr[:n], axis=0)
    w = int(arr.shape[0]) // p
    dev = arr.device
    # (p, b, w): each position's rows of every column, keys along the last axis
    blocks = arr.reshape(p, w, b).transpose(1, 2)
    gidx = torch.arange(p * w, device=dev).reshape(p, 1, w)
    is_pad = (gidx >= n).expand(p, b, w)
    key = torch.where(is_pad, _pad_key(arr.dtype), order_key(blocks, descending))
    blocks = as_bits(blocks)
    # the local stable sort: pads (largest key, last local rows) stay behind
    # any real row of an equal key
    key, perm = torch.sort(key.contiguous(), dim=-1, stable=True)
    key = key.contiguous()
    svals = torch.gather(blocks, -1, perm)
    spad = torch.gather(is_pad, -1, perm)
    # pads carry the largest key and the last local rows, so the stable
    # sort leaves them at the end: the count of pads among the first j
    # sorted rows is max(0, j - reals), with no scan
    reals = w - is_pad.sum(dim=-1, keepdim=True)
    padp = (torch.arange(w + 1, device=dev) - reals).clamp(min=0)  # (p, b, w + 1)
    ranks = torch.arange(w, device=dev).expand(p, b, w).clone()
    position = torch.arange(p, device=dev).reshape(p, 1, 1)
    vis_key, vis_padp = key, padp
    for r in range(1, p):
        # one hop: position s now holds the block of position (s - r) % p
        vis_key, vis_padp = torch.roll(vis_key, 1, dims=0), torch.roll(vis_padp, 1, dims=0)
        a = torch.searchsorted(vis_key, key, right=False)
        bb = torch.searchsorted(vis_key, key, right=True)
        eq_pad = torch.gather(vis_padp, -1, bb) - torch.gather(vis_padp, -1, a)
        eq_real = (bb - a) - eq_pad
        earlier = position >= r  # the visiting block's position is below s
        tie = torch.where(
            spad,
            eq_real + torch.where(earlier, eq_pad, 0),
            torch.where(earlier, eq_real, 0),
        )
        ranks += a + tie
    # the ranks are a permutation of every row, pads past n: one scatter
    ranks = ranks.transpose(1, 2).reshape(p * w, b)
    out_v = torch.empty_like(svals).reshape(p * w, b).scatter_(0, ranks, svals.transpose(1, 2).reshape(p * w, b))
    out_v = from_bits(out_v[:n], arr.dtype)
    if not want_indices:
        return out_v, None
    sgidx = torch.gather(gidx.expand(p, b, w), -1, perm).transpose(1, 2).reshape(p * w, b)
    out_i = torch.empty_like(sgidx).scatter_(0, ranks, sgidx)[:n]
    return out_v, out_i.to(torch.int32)


def descending_key(arr: torch.Tensor) -> torch.Tensor:
    """Order-inverting sort key with ties still by ascending index: ``-x``
    for floats (NaN stays NaN, so last), ``~x`` for integers and bool
    (negation would wrap the minimum and unsigned values)."""
    return -arr if arr.dtype.is_floating_point else ~arr


def stable_argsort(key: torch.Tensor, dim: int) -> torch.Tensor:
    """Stable ascending argsort of ``key`` along ``dim`` (NaN last, ``-0.0``
    equal to ``+0.0``), int64; bool sorts as uint8."""
    if key.dtype == torch.bool:
        key = key.to(torch.uint8)
    return torch.sort(key, dim=dim, stable=True)[1]


def _resplit_sort(
    arr: torch.Tensor, comm: TorchCommunication, descending: bool, want_indices: bool = True
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Sort a row-split ``(n, b)`` tensor along axis 0 by making the sort
    axis local: all-to-all onto the columns, a batched stable argsort of
    each position's column block, all-to-all back onto the rows."""
    p, (n, b) = comm.size, arr.shape
    # the all-to-all onto columns, exact: the reference's transpose runs
    # inside its compiled program, never at the eager redistribution seam
    cols = comm.pad_to_shards(arr, axis=1)  # (n, padded b)
    blocks = cols.reshape(n, p, -1).permute(1, 0, 2)  # (p, n, b/p): each position's columns
    # each position's columns sorted as rows of a transposed copy: 1.60
    # against 1.78 ms along the column axis (500 000 x 32 at 4 positions,
    # device time in a CUDA graph on an H100 80GB HBM3 at 700 W,
    # chip_smoke.py phase 10)
    key = (descending_key(blocks) if descending else blocks).transpose(1, 2).contiguous()
    idx = stable_argsort(key, dim=-1)  # (p, b/p, n)
    vals = from_bits(torch.gather(as_bits(blocks).transpose(1, 2), -1, idx), blocks.dtype)
    back = lambda t: all_to_all_resplit(  # noqa: E731
        t.permute(2, 0, 1).reshape(n, -1), from_axis=1, to_axis=0, comm=comm)[:, :b]
    if not want_indices:
        return back(vals), None
    return back(vals), back(idx.to(torch.int32))


def sort_axis0(
    arr: torch.Tensor,
    n: int,
    comm: Optional[TorchCommunication] = None,
    descending: bool = False,
    want_indices: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Distributed stable sort along axis 0 (the split axis) of a tensor
    of any rank and true length ``n`` along axis 0: ``(values, indices)``
    shaped like the true array, indices along axis 0 (numpy ``argsort``
    semantics).  Callers gate on :func:`supports_axis0`."""
    comm = sanitize_comm(comm)
    if arr.ndim == 1:
        return ring_rank_sort(arr, n, comm=comm, descending=descending, want_indices=want_indices)
    trailing = tuple(arr.shape[1:])
    flat = arr[:n].reshape(n, -1)
    if flat.shape[1] >= comm.size:
        vals, idx = _resplit_sort(flat, comm, descending, want_indices)
    else:
        # fewer columns than positions: an all-to-all would idle p - b of
        # them; the ring rank sort keeps the column axis instead
        vals, idx = _rrs_batched(flat, n, comm, descending, want_indices)
    return (
        vals.reshape((n,) + trailing),
        idx.reshape((n,) + trailing) if idx is not None else None,
    )
