"""Distributed take/put: gather or scatter rows of an axis-0 split tensor
by GLOBAL indices, one position's block at a time.

Port of ``heat_tpu/parallel/take.py``.  **Ring take**: in round r each
position sees the block of position ``(s - r) % p`` and answers the
queries that land in its rows with a local gather; after p rounds every
query has met its row.  **Ring put** is the dual: the output blocks
visit the positions, and each position writes the values whose
destination lies in the visiting block.

On one card the visiting block of position s in round r is addressed in
place, as block ``(s - r) % p`` of the stacked ``(p, w, ...)`` tensor:
the hop moves no bytes, and ring put writes into one new buffer built
from ``base`` (one copy a call, not one a round).

Indices are sanitized before torch sees them (torch raises for an
out-of-range index on the CPU and fires a device-side assert on CUDA):
negatives wrap once, numpy-style; what is still out of range reads
``fill`` (or clamps, ``oob="clip"``) in a take and is dropped in a put.

Duplicate destinations in a put: the last write in ring order wins.  A
destination in block o is written by position o in round 0, by position
o + 1 in round 1, and so on; within one position the later query wins.
(The reference leaves the order unspecified; its callers pass
permutations.)
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..core.communication import TorchCommunication, sanitize_comm
from .sort import as_bits, from_bits

__all__ = ["ring_take", "ring_put", "xp_take", "xp_put"]

_INT32_MAX = 2**31 - 1


def _sanitize_index(idx: torch.Tensor, n: int, clip: bool = False) -> torch.Tensor:
    """int64 indices into an axis of length ``n``: negatives wrapped once,
    anything still outside ``[0, n)`` the drop sentinel ``n``, or clamped
    into range with ``clip=True``.  The range logic runs after widening,
    so no narrow type wraps."""
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    if clip:
        return idx.clamp(0, max(n - 1, 0))
    return torch.where((idx < 0) | (idx >= n), n, idx)


def _blocks(t: torch.Tensor, comm: TorchCommunication) -> torch.Tensor:
    """``(p, w, ...)`` position blocks of an axis-0 tensor, zero-padded."""
    t = comm.pad_to_shards(t, axis=0)
    return t.reshape((comm.size, -1) + tuple(t.shape[1:]))


def _check_range(name: str, comm: TorchCommunication, n: int, m: int) -> None:
    if max(comm.padded_size(n), comm.padded_size(m)) > _INT32_MAX:
        raise ValueError(f"{name}: axis length exceeds int32 index range")


def ring_take(
    arr: torch.Tensor,
    idx: torch.Tensor,
    comm: Optional[TorchCommunication] = None,
    fill=0,
    n: Optional[int] = None,
    padded_out: bool = False,
    oob: str = "fill",
) -> torch.Tensor:
    """``out[i] = arr[idx[i]]`` over the positions: ``arr`` (N, ...) and
    ``idx`` (M,) split along axis 0; the result is (M, ...).  ``arr`` may
    be the canonically padded buffer of an axis of true length ``n``
    (pad rows are never read).  Negative indices wrap; out-of-range ones
    give ``fill``, or clamp into range with ``oob='clip'`` (what
    ``DNDarray.__getitem__`` uses).  ``padded_out=True`` returns the
    padded ``(padded_size(M), ...)`` at-rest form, pad rows zero."""
    comm = sanitize_comm(comm)
    if n is None:
        n = int(arr.shape[0])
    m = int(idx.shape[0])
    _check_range("ring_take", comm, n, m)
    if oob not in ("fill", "clip"):
        raise ValueError(f"ring_take: oob must be 'fill' or 'clip', got {oob!r}")
    p = comm.size
    idx = _sanitize_index(idx.to(arr.device), n, clip=(oob == "clip"))
    src = _blocks(as_bits(arr[:n]), comm)  # (p, w, ...)
    q = _blocks(idx, comm)  # (p, wq)
    w, wq = int(src.shape[1]), int(q.shape[1])
    trail = (1,) * (arr.ndim - 1)
    real = (torch.arange(p * wq, device=arr.device) < m).reshape(p, wq)
    out = as_bits(torch.full((p, wq) + tuple(arr.shape[1:]), fill, dtype=arr.dtype, device=arr.device))
    position = torch.arange(p, device=arr.device)
    for r in range(p):
        owner = (position - r) % p  # whose rows visit each position
        base = (owner * w)[:, None]
        hit = (q >= base) & (q < base + w) & (q < n)
        local = (q - base).clamp(0, max(w - 1, 0))
        vals = src[owner[:, None], local]  # (p, wq, ...): the local gather
        out = torch.where(hit.reshape(hit.shape + trail), vals, out)
    # pad queries answer zero: the at-rest pad invariant
    out = torch.where(real.reshape(real.shape + trail), out, torch.zeros((), dtype=out.dtype, device=out.device))
    out = from_bits(out.reshape((p * wq,) + tuple(arr.shape[1:])), arr.dtype)
    return out if padded_out else comm.unpad(out, m, 0)


def ring_put(
    n: int,
    idx: torch.Tensor,
    vals: torch.Tensor,
    comm: Optional[TorchCommunication] = None,
    base: Optional[torch.Tensor] = None,
    padded_out: bool = False,
) -> torch.Tensor:
    """``out[idx[i]] = vals[i]`` over the positions; ``idx`` (M,) and
    ``vals`` (M, ...) split along axis 0, the result is (n, ...).  Without
    ``base`` the destination starts as zeros; with ``base`` (an (n, ...)
    tensor, true-length or canonically padded) the rows not written keep
    its values.  Negative indices wrap; out-of-range ones drop; the last
    write in ring order wins on a duplicate destination (module
    docstring).  ``padded_out=True`` returns the padded at-rest form."""
    comm = sanitize_comm(comm)
    m = int(idx.shape[0])
    _check_range("ring_put", comm, n, m)
    p = comm.size
    dev = vals.device
    if base is not None:
        if base.shape[0] not in (n, comm.padded_size(n)):
            raise ValueError(
                f"ring_put: base axis 0 is {base.shape[0]}, expected {n} or "
                f"the padded {comm.padded_size(n)}"
            )
        vals = vals.to(base.dtype)
        dev = base.device
    trail, dtype = tuple(vals.shape[1:]), vals.dtype
    vals = as_bits(vals)
    idx = _sanitize_index(idx.to(dev), n)
    q = _blocks(idx, comm)  # (p, wq)
    width = math.prod(trail)
    v = _blocks(vals[:m].to(dev), comm).reshape(p * int(q.shape[1]), width)  # a query's values a row
    wq, wo = int(q.shape[1]), comm.shard_width(n)
    rows = wo + wq
    # the one new buffer: base's blocks (or zeros) and a scratch row for
    # each query, where its write lands when it is dropped or superseded
    out = torch.zeros((p, rows) + trail, dtype=v.dtype, device=dev)
    if base is not None:
        out[:, :wo] = _blocks(as_bits(base[:n]), comm)
    flat = out.view(p * rows, width)
    real = (torch.arange(p * wq, device=dev) < m).reshape(p, wq)
    position = torch.arange(p, device=dev)
    order = torch.arange(wq, device=dev).expand(p, wq)
    scratch = wo + order
    for r in range(p):
        owner = (position - r) % p  # whose block visits each position
        base_row = (owner * wo)[:, None]
        hit = real & (q >= base_row) & (q < base_row + wo) & (q < n)
        dest = torch.where(hit, q - base_row, scratch)
        # among a position's queries for one row, the last one writes
        last = torch.full((p, rows), -1, dtype=torch.int64, device=dev)
        last.scatter_reduce_(1, dest, torch.where(hit, order, -1), "amax")
        dest = torch.where(hit & (torch.gather(last, 1, dest) == order), dest, scratch)
        row = (owner[:, None] * rows + dest).reshape(-1, 1).expand(-1, width)
        flat.scatter_(0, row, v)
    out = from_bits(out[:, :wo].reshape((p * wo,) + trail), dtype)
    return out if padded_out else comm.unpad(out, n, 0)


# --------------------------------------------------------------------- #
# across processes                                                        #
# --------------------------------------------------------------------- #
def xp_take(local: torch.Tensor, idx: torch.Tensor, comm: TorchCommunication, n: int) -> torch.Tensor:
    """The ring take across processes, clamping: ``local`` is this
    process's true rows of an (n, ...) tensor split along axis 0, ``idx``
    (m,) is whole in every process; returns this process's true rows of
    the (m, ...) result.  Every process knows which of its rows each other
    process's output rows need, so each pair of processes exchanges one
    message, and nothing asks first."""
    from ..core import _xproc

    m, rank = int(idx.shape[0]), comm.rank
    idx = _sanitize_index(idx.to(local.device), n, clip=True)
    src = [comm.process_rows(n, k) for k in range(comm.nprocs)]
    dst = [comm.process_rows(m, k) for k in range(comm.nprocs)]
    a, b = src[rank]
    sends, recvs, masks = {}, {}, {}
    oa, ob = dst[rank]
    mine = idx[oa:ob]
    for j in range(comm.nprocs):
        q = idx[dst[j][0]:dst[j][1]]
        sends[j] = local[q[(q >= a) & (q < b)] - a]
        masks[j] = (mine >= src[j][0]) & (mine < src[j][1])
        recvs[j] = ((int(masks[j].sum()),) + tuple(local.shape[1:]), local.dtype)
    got = _xproc.exchange(sends, recvs, local.device)
    out = torch.empty((ob - oa,) + tuple(local.shape[1:]), dtype=local.dtype, device=local.device)
    for j in range(comm.nprocs):
        out[masks[j]] = got[j]
    return out


def xp_put(n: int, idx: torch.Tensor, vals: torch.Tensor, comm: TorchCommunication,
           base: torch.Tensor, split_vals: bool) -> torch.Tensor:
    """The ring put across processes: ``out[idx[i]] = vals[i]`` over this
    process's true rows ``base`` of the (n, ...) destination; ``idx`` (m,)
    is whole in every process, ``vals`` this process's rows of the values
    when ``split_vals`` (split like the index), else all m rows.
    Out-of-range indices drop.  A duplicate destination takes the last
    write in the one-process ring's order (the module docstring), so the
    result is the one-process ring put's."""
    from ..core import _xproc

    m, rank, p = int(idx.shape[0]), comm.rank, comm.size
    dev = base.device
    idx = _sanitize_index(idx.to(dev), n)
    wq, wo = comm.shard_width(m), comm.shard_width(n)
    # the ring order: a destination in block o is written by position o,
    # then o + 1, ...; within a position the later query wins
    i = torch.arange(m, device=dev)
    order = ((i // max(wq, 1) - idx // max(wo, 1)) % p) * max(wq, 1) + i % max(wq, 1)
    dst = [comm.process_rows(n, k) for k in range(comm.nprocs)]
    a, b = dst[rank]
    hit = (idx >= a) & (idx < b)
    if split_vals:
        qs = [comm.process_rows(m, k) for k in range(comm.nprocs)]
        qa, qb = qs[rank]
        sends, recvs = {}, {}
        for j in range(comm.nprocs):
            q = idx[qa:qb]
            sends[j] = vals[(q >= dst[j][0]) & (q < dst[j][1])]
            recvs[j] = ((int(hit[qs[j][0]:qs[j][1]].sum()),) + tuple(vals.shape[1:]), vals.dtype)
        got = _xproc.exchange(sends, recvs, dev)
        v = torch.cat([got[j] for j in range(comm.nprocs)])
    else:
        v = vals[hit]
    d, o = idx[hit] - a, order[hit]
    out = base.clone()
    if d.numel():
        # the last write of each destination, in ring order
        key = d * (p * max(wq, 1) + 1) + o
        srt = torch.argsort(key)
        d, v = d[srt], v[srt]
        last = torch.ones_like(d, dtype=torch.bool)
        last[:-1] = d[1:] != d[:-1]
        bits = as_bits(out)
        bits[d[last]] = as_bits(v[last])
        out = from_bits(bits, out.dtype)
    return out
