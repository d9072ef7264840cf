"""Sequence/context-parallel communication primitives, on positions.

Port of ``heat_tpu/parallel/primitives.py``.  The reference runs each
primitive as a ``shard_map`` program whose ``ppermute``s move blocks
between devices.  Here a DNDarray is one global, canonically padded tensor
and the communicator a list of positions (``core/communication.py``): a
position's block is a slice of the stacked ``(p, ...)`` view, and a
``ppermute`` is a gather of whole blocks along that axis — a ring hop is a
roll.  Every function accepts a DNDarray (its communicator is used) or a
torch tensor (the default communicator, unless one is given).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..core._compile import cache_stable, jitted
from ..core.communication import TorchCommunication, sanitize_comm
from ..core.dndarray import DNDarray

__all__ = [
    "all_to_all_resplit",
    "halo_exchange",
    "local_scan",
    "prefix_scan",
    "prefix_sum",
    "ring_map",
    "ring_source",
    "zigzag_chunk_owner",
    "zigzag_inverse_perms",
    "zigzag_merge",
    "zigzag_perms",
    "zigzag_split",
]


def _unpack(x, comm: Optional[TorchCommunication]):
    if isinstance(x, DNDarray):
        return x.larray, (comm or x.comm)
    return x, sanitize_comm(comm)


def _stacked(arr: torch.Tensor, size: int) -> torch.Tensor:
    """``(p, c, ...)`` position blocks of an axis-0 padded tensor (a view)."""
    return arr.reshape((size, -1) + tuple(arr.shape[1:]))


def ring_source(position: int, round: int, size: int) -> int:
    """Origin of the rotating block seen by ``position`` at ``round``:
    after ``round`` hops of the +1 rotation, the block at position p
    started at ``(p - round) % size``."""
    return (position - round) % size


def ring_map(fn: Callable, x, comm: Optional[TorchCommunication] = None, axis: int = 0):
    """Apply ``fn(stationary_block, rotating_block, round)`` over a full
    ring rotation and stack the per-round results.

    Each position keeps its stationary block while the rotating copy moves
    one hop per round (``comm.ring_permute``); after ``size`` rounds every
    position has seen every block.  Returns ``(size, size * r0, ...)`` for
    a per-position result of shape ``(r0, ...)`` (the reference's global
    layout: round-major, positions concatenated), or ``(size, size)`` for
    a scalar result.  A non-divisible axis is zero-padded first, so ``fn``
    sees equal ``shard_width``-row blocks whose trailing rows may be
    padding (mask with ``comm.valid_counts`` and :func:`ring_source`)."""
    arr, comm = _unpack(x, comm)
    size = comm.size
    if axis != 0:
        arr = arr.movedim(axis, 0)
    if size == 1:
        return torch.as_tensor(fn(arr, arr, 0))[None]
    if cache_stable(fn):
        # one program per (comm, fn), as the reference's; an unstable fn
        # runs uncounted, as its transient program does there
        return jitted(("ring_map", comm, fn), lambda: _ring_rounds)(fn, arr, comm)  # spmdlint: disable=SPMD401 -- fn passed cache_stable() just above
    return _ring_rounds(fn, arr, comm)


def _ring_rounds(fn: Callable, arr: torch.Tensor, comm: TorchCommunication) -> torch.Tensor:
    size = comm.size
    arr = comm.pad_to_shards(arr, axis=0)
    stationary = _stacked(arr, size)
    rotating = arr
    rounds = []
    for r in range(size):
        blocks = _stacked(rotating, size)
        rounds.append(torch.stack(
            [torch.as_tensor(fn(stationary[i], blocks[i], r)) for i in range(size)]
        ))
        if r < size - 1:
            rotating = comm.ring_permute(rotating, 1)
    out = torch.stack(rounds)  # (rounds, positions, *result)
    if out.ndim == 2:
        return out
    return out.reshape((size, -1) + tuple(out.shape[3:]))


def halo_exchange(x, halo_size: int, comm: Optional[TorchCommunication] = None):
    """Each shard's neighbour boundary strips: ``(prev_halos, next_halos)``,
    each laid out like ``x`` with ``halo_size`` rows per position — the
    tail of position i-1 and the head of position i+1, zeros where there
    is no neighbour.  Any axis-0 length is accepted via canonical
    zero-padding; requires ``halo_size <= shard_width``."""
    arr, comm = _unpack(x, comm)
    size = comm.size
    if halo_size < 0:
        raise ValueError(f"halo_size needs to be non-negative, got {halo_size}")
    if halo_size and comm.shard_width(arr.shape[0]) < halo_size:
        raise ValueError(
            f"halo_size ({halo_size}) exceeds the shard width "
            f"({comm.shard_width(arr.shape[0])})"
        )
    if size == 1 or halo_size == 0:
        z = torch.zeros((halo_size,) + tuple(arr.shape[1:]), dtype=arr.dtype, device=arr.device)
        return z, z
    return jitted(("halo_exchange", comm, halo_size), lambda: _halos)(arr, comm, halo_size)


def _halos(arr: torch.Tensor, comm: TorchCommunication, halo_size: int):
    size = comm.size
    blocks = _stacked(comm.pad_to_shards(arr, axis=0), size)
    tails, heads = blocks[:, -halo_size:], blocks[:, :halo_size]
    prev = torch.zeros_like(tails)
    prev[1:] = tails[:-1]
    nxt = torch.zeros_like(heads)
    nxt[:-1] = heads[1:]
    flat = (size * halo_size,) + tuple(arr.shape[1:])
    return prev.reshape(flat), nxt.reshape(flat)


#: op name -> (local cumulative fn, identity, axis reduction)
_SCAN_OPS = {
    "sum": (torch.cumsum, 0, torch.sum),
    "prod": (torch.cumprod, 1, torch.prod),
}
#: rows of a block of :func:`local_scan`.  torch's CUDA scan along an outer
#: axis gives each column one thread: 32 columns of 500 000 rows took 182
#: ms on an H100 (80GB HBM3, 700 W); in blocks of 64 rows 0.227 ms, of
#: 1 024 rows 0.607 ms (``scripts/scan_variants.py``)
SCAN_BLOCK = 64


def local_scan(arr: torch.Tensor, op: str = "sum", axis: int = 0) -> torch.Tensor:
    """Cumulative ``op`` of a tensor along ``axis``.  An axis longer than
    two blocks runs as a two-level scan: each block of ``SCAN_BLOCK`` rows
    (the tail padded with the op's identity) scans on its own, then each
    block combines the scanned totals of the blocks before it.  The
    result has torch's type for the op (int64 for integer inputs)."""
    cum, ident, _ = _SCAN_OPS[op]
    n = int(arr.shape[axis])
    if n <= 2 * SCAN_BLOCK:
        return cum(arr, dim=axis)
    x = arr.movedim(axis, 0)
    nb = -(-n // SCAN_BLOCK)
    if nb * SCAN_BLOCK != n:
        pad = torch.full((nb * SCAN_BLOCK - n,) + tuple(x.shape[1:]), ident, dtype=x.dtype, device=x.device)
        x = torch.cat([x, pad])
    local = cum(x.reshape((nb, SCAN_BLOCK) + tuple(x.shape[1:])), dim=1)
    before = local_scan(local[:, -1], op, 0)
    before = torch.cat([torch.full_like(before[:1], ident), before[:-1]])[:, None]
    out = (local + before) if op == "sum" else (local * before)
    return out.reshape((-1,) + tuple(out.shape[2:]))[:n].movedim(0, axis)


def prefix_scan(x, op: str = "sum", comm: Optional[TorchCommunication] = None, axis: int = 0):
    """Element-wise cumulative ``op`` along a split axis as a two-level
    scan: a local cumulative op per position, then each position combines
    the totals of the positions before it.  The canonical padding is
    filled with the op's identity, so any axis length works."""
    if op not in _SCAN_OPS:
        raise ValueError(f"unsupported prefix_scan op {op!r}")
    cum, ident, reduce_fn = _SCAN_OPS[op]
    arr, comm = _unpack(x, comm)
    size = comm.size
    if size == 1 or arr.shape[axis] == 0:
        return local_scan(arr, op, axis)
    if axis != 0:
        arr = arr.movedim(axis, 0)
    n = int(arr.shape[0])
    padded = comm.pad_to_shards(arr, axis=0)
    if ident != 0 and padded.shape[0] != n:
        padded = padded.clone()
        padded[n:] = ident
    local = local_scan(_stacked(padded, size), op, 1)
    totals = local[:, -1]  # (p, ...)
    before = torch.arange(size, device=arr.device)
    mask = (before[None, :] < before[:, None]).reshape((size, size) + (1,) * (totals.ndim - 1))
    offsets = reduce_fn(torch.where(mask, totals[None], torch.full_like(totals, ident)[None]), dim=1)
    offsets = offsets.to(local.dtype)[:, None]
    out = (local + offsets) if op == "sum" else (local * offsets)
    out = comm.unpad(out.reshape((-1,) + tuple(out.shape[2:])), n, axis=0)
    return out.movedim(0, axis) if axis != 0 else out


def xp_prefix_scan(slab: torch.Tensor, op: str, comm: TorchCommunication, axis: int, n: int):
    """:func:`prefix_scan` across processes, on this process's slab of an
    axis of length ``n`` split over ``comm``: the same two levels, the
    totals of every position gathered, so each element is the one-process
    scan's bit for bit.  Returns the slab's true rows."""
    from ..core import _xproc

    cum, ident, reduce_fn = _SCAN_OPS[op]
    arr = slab.movedim(axis, 0) if axis != 0 else slab
    a, b = comm.process_rows(n)
    if ident != 0 and b - a != int(arr.shape[0]):
        arr = arr.clone()
        arr[b - a:] = ident
    pl, size, first = comm.local_size, comm.size, comm.local_position()
    local = local_scan(_stacked(arr, pl), op, 1)
    totals = torch.cat(_xproc.all_gather(local[:, -1]))  # (p, ...)
    before = torch.arange(size, device=arr.device)
    mine = before[first:first + pl]
    mask = (before[None, :] < mine[:, None]).reshape((pl, size) + (1,) * (totals.ndim - 1))
    offsets = reduce_fn(torch.where(mask, totals[None], torch.full_like(totals, ident)[None]), dim=1)
    offsets = offsets.to(local.dtype)[:, None]
    out = (local + offsets) if op == "sum" else (local * offsets)
    out = out.reshape((-1,) + tuple(out.shape[2:]))[: b - a]
    return out.movedim(0, axis) if axis != 0 else out


def prefix_sum(x, comm: Optional[TorchCommunication] = None, axis: int = 0):
    """Cumulative sum along a split axis — ``prefix_scan(x, "sum")``."""
    return prefix_scan(x, "sum", comm=comm, axis=axis)


def all_to_all_resplit(x, from_axis: int, to_axis: int, comm: Optional[TorchCommunication] = None):
    """Swap the split axis: split at ``from_axis`` -> split at ``to_axis``
    (the Ulysses sequence<->head swap) through the communicator's
    all-to-all.  The global tensor comes back with its true shape."""
    arr, comm = _unpack(x, comm)
    # the all-to-all, exact: the reference's primitive is its monolithic
    # relayout (``apply_sharding``), never the eager redistribution seam
    out = comm.pad_to_shards(arr, axis=to_axis)
    return comm.unpad(out, arr.shape[to_axis], axis=to_axis)


def zigzag_chunk_owner(c: int, size: int) -> int:
    """Zig-zag home position of sequence half-chunk ``c`` (0 <= c <
    2*size): position ``i`` holds the mirrored pair ``(i, 2*size-1-i)``,
    which gives every position the same causal attention work per ring
    round."""
    return c if c < size else 2 * size - 1 - c


def zigzag_perms(size: int):
    """Forward resplit schedule, contiguous -> zig-zag, as two
    permutations of ``(source, destination)`` pairs: contiguous position
    ``i`` holds half-chunks (2i, 2i+1); the first stream carries every
    position's first half, the second its second half, each to the
    chunk's zig-zag home."""
    first = [(i, zigzag_chunk_owner(2 * i, size)) for i in range(size)]
    second = [(i, zigzag_chunk_owner(2 * i + 1, size)) for i in range(size)]
    return first, second


def zigzag_inverse_perms(size: int):
    """Inverse resplit schedule, zig-zag -> contiguous: zig-zag position
    ``d`` holds chunks (d, 2*size-1-d), one even and one odd; the even
    stream lands as its receiver's first half, the odd as its second."""
    even = [(d, (d if d % 2 == 0 else 2 * size - 1 - d) // 2) for d in range(size)]
    odd = [(d, ((2 * size - 1 - d) if d % 2 == 0 else d) // 2) for d in range(size)]
    return even, odd


def _permute(blocks: torch.Tensor, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """The ``ppermute`` of stacked position blocks: block ``src`` lands at
    ``dst`` for every pair of the (bijective) permutation."""
    src_of: List[int] = [0] * blocks.shape[0]
    for src, dst in perm:
        src_of[dst] = src
    return blocks.index_select(0, torch.tensor(src_of, device=blocks.device))


def _even_positions(size: int, ndim: int, device) -> torch.Tensor:
    return (torch.arange(size, device=device) % 2 == 0).reshape((size,) + (1,) * (ndim - 1))


def zigzag_split(x: torch.Tensor, axis: int, size: int):
    """Contiguous stacked blocks -> zig-zag ``(lo, hi)`` half-chunks.

    ``x`` is ``(size, ...)``: block ``i`` covers global rows [i*L, (i+1)*L)
    along ``axis`` (an axis of ``x``, not 0).  Returns the stacked pairs:
    ``lo[i]`` is half-chunk ``i``, ``hi[i]`` half-chunk ``2*size-1-i``,
    moved by two permutations, one per local half."""
    L = x.shape[axis]
    lh = L // 2
    first, second = x.narrow(axis, 0, lh), x.narrow(axis, lh, lh)
    pf, ps = zigzag_perms(size)
    a, b = _permute(first, pf), _permute(second, ps)
    # chunk i arrived on the stream of its parity
    even = _even_positions(size, x.ndim, x.device)
    return torch.where(even, a, b), torch.where(even, b, a)


def zigzag_merge(lo: torch.Tensor, hi: torch.Tensor, axis: int, size: int) -> torch.Tensor:
    """Inverse of :func:`zigzag_split`: the stacked zig-zag pairs back to
    contiguous stacked blocks."""
    even = _even_positions(size, lo.ndim, lo.device)
    even_chunk, odd_chunk = torch.where(even, lo, hi), torch.where(even, hi, lo)
    pe, po = zigzag_inverse_perms(size)
    return torch.cat([_permute(even_chunk, pe), _permute(odd_chunk, po)], dim=axis)
