"""Ring attention: exact blockwise attention over sequence-sharded inputs.

Port of ``heat_tpu/parallel/ring_attention.py`` on the positions model.
The sequence axis is split over the communicator's positions; each
position keeps its query block while the key/value blocks rotate one hop
per round (``comm.ring_permute``, a roll of the stacked position blocks),
and every round folds the visiting block into the running softmax, so the
result is exact attention.

Each round is ONE call for all positions: the flash engine hands every
position's query rows, visiting K/V block and per-position offsets to
:func:`flash_attention_partial` (one kernel launch on the card), the XLA
engine runs :func:`_blockwise_update` on the stacked ``(p, ...)`` blocks.
Causal attention runs on the zig-zag layout whenever ``S % (2*size) ==
0``: position ``i`` holds half-chunks ``i`` and ``2*size-1-i``, so every
position does two wholly unmasked half-chunk folds per round and only the
round-0 diagonal folds are masked.

Only the serial ring bodies are ported.  On one card a hop is a roll that
moves no bytes between chips, so the reference's double-buffered bodies
(``comm/overlap.py``) wait for positions on several cards.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from ..core._compile import jitted
from ..core.communication import TorchCommunication, sanitize_comm
from ..core.dndarray import DNDarray
from .flash_attention import (
    _acc_dtype,
    _dense_attention,
    conforms,
    flash_attention,
    flash_attention_partial,
)
from .primitives import zigzag_merge, zigzag_split

__all__ = ["ring_attention", "ring_self_attention"]

def _blockwise_update(q, k, v, m, num, den, scale, mask=None):
    """One streaming-softmax accumulation step (flash-attention algebra).
    Scores and accumulators stay in the accumulator dtype (``num.dtype``,
    float32 for float32/bf16 inputs): operands are widened to it, so the
    products of bf16 operands are exact and the sums float32."""
    acc = num.dtype
    scores = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    if mask is not None:
        scores = scores.masked_fill(~mask, -math.inf)
    m_new = torch.maximum(m, scores.amax(dim=-1))
    # guard fully-masked rows (all -inf): keep them neutral
    safe_m = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
    p = torch.exp(scores - safe_m[..., None])
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    correction = torch.where(torch.isfinite(m), torch.exp(m - safe_m), torch.zeros_like(m))
    num = num * correction[..., None] + torch.matmul(p, v.to(acc))
    den = den * correction + p.sum(dim=-1)
    return m_new, num, den


def _per_position(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """A (p,) tensor shaped to broadcast over stacked ``ndim``-d blocks."""
    return x.reshape((-1,) + (1,) * (ndim - 1))


def _select(sel, a, b):
    """Per position: ``a`` where ``sel``, else ``b`` (stacked ``(p, ...)``)."""
    return torch.where(_per_position(sel, a.ndim), a, b)


def ring_attention(
    q,
    k,
    v,
    causal: bool = False,
    comm: Optional[TorchCommunication] = None,
    local_kernel: str = "auto",
) -> torch.Tensor:
    """Exact attention over a sequence-split (seq, heads, dim) — or (batch,
    seq, heads, dim) — input: tensors holding the global sequence, or
    DNDarrays (their ``larray`` and ``comm``).

    The sequence must divide over the positions for the ring; otherwise
    (or at one position) the single-block branch runs.  ``causal=True``
    masks with global positions, on the zig-zag layout when ``S %
    (2*size) == 0`` and the half-chunks conform, else on the contiguous
    layout, where fully masked rounds cost no folds in the flash engine.

    ``local_kernel`` picks the per-round engine:
    - ``"auto"``: the flash engine on a CUDA tensor whose local block
      conforms (:func:`conforms`), else the XLA engine;
    - ``"flash"``: force :func:`flash_attention_partial` (the kernel on the
      card, its plain version on the CPU); a non-conforming block raises
      ``ValueError``;
    - ``"xla"``: force the plain blockwise update.
    """
    if local_kernel not in ("auto", "flash", "xla"):
        raise ValueError(f"local_kernel must be auto|flash|xla, got {local_kernel!r}")
    if isinstance(q, DNDarray):
        comm = comm or q.comm
        q, k, v = q.larray, k.larray, v.larray
    comm = sanitize_comm(comm)
    size = comm.size

    batched = q.ndim == 4
    if not batched:
        q, k, v = q[None], k[None], v[None]
    B, S, H, D = q.shape

    if size == 1 or S % size != 0:
        # single block; the local_kernel contract holds here too
        if local_kernel == "flash" and (size > 1 or not conforms(S, D, q.dtype)):
            raise ValueError(
                "local_kernel='flash' needs a position-divisible sequence "
                f"(S={S}, {size} positions) and a conforming shape "
                "(128-multiple, f32/bf16/f16, D a multiple of 8 up to 128); use "
                "'auto' for the silent fallback"
            )
        if size == 1 and local_kernel != "xla":
            out = flash_attention(q, k, v, causal=causal)
        else:
            key = ("ring_attention.single_xla", causal, B, S, H, D, q.dtype)
            out = jitted(key, lambda: _dense_attention)(q, k, v, causal)
        return out if batched else out[0]

    L = S // size
    zigzag = causal and S % (2 * size) == 0
    conforming = conforms(L, D, q.dtype)
    if local_kernel == "flash" and not conforming:
        raise ValueError(
            f"local_kernel='flash' needs a conforming local block (L={L} must be a "
            "multiple of 128, dtype f32/bf16/f16, D a multiple of 8 up to 128); use "
            "'auto' for the silent fallback"
        )
    use_flash = local_kernel == "flash" or (
        local_kernel == "auto" and q.device.type == "cuda" and conforming
    )
    if use_flash:
        if zigzag and conforms(L // 2, D, q.dtype):
            out = jitted(("ring_attention.flash_zz", comm, B, S, H, D, q.dtype), lambda: _flash_zigzag)(
                q, k, v, comm)
        else:
            out = jitted(("ring_attention.flash", comm, causal, B, S, H, D, q.dtype),
                         lambda: _flash_contiguous)(q, k, v, causal, comm)
    elif zigzag:
        out = jitted(("ring_attention.xla_zz", comm, B, S, H, D, q.dtype), lambda: _xla_zigzag)(q, k, v, comm)
    else:
        out = jitted(("ring_attention.xla", comm, causal, B, S, H, D, q.dtype), lambda: _xla_contiguous)(
            q, k, v, causal, comm)
    return out if batched else out[0]


# --------------------------------------------------------------------- #
# layouts                                                                  #
# --------------------------------------------------------------------- #
def _to_rows(t: torch.Tensor, size: int) -> torch.Tensor:
    """(B, S, H, D) -> (p*B*H, L, D): position-major rows of the partial
    kernel, position ``i`` owning rows [i*B*H, (i+1)*B*H)."""
    B, S, H, D = t.shape
    return t.reshape(B, size, S // size, H, D).permute(1, 0, 3, 2, 4).reshape(-1, S // size, D)


def _from_rows(t: torch.Tensor, B: int, H: int, size: int) -> torch.Tensor:
    """Inverse of :func:`_to_rows`."""
    L, D = t.shape[-2:]
    return t.reshape(size, B, H, L, D).permute(1, 0, 3, 2, 4).reshape(B, size * L, H, D)


def _normalize(acc: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    return acc / torch.clamp_min(l, 1e-30)[..., None]


# --------------------------------------------------------------------- #
# flash engine: one flash_attention_partial launch per fold                #
# --------------------------------------------------------------------- #
def _init_state(lead: tuple, length: int, d: int, device):
    return (
        torch.full(lead + (length,), -math.inf, dtype=torch.float32, device=device),
        torch.zeros(lead + (length,), dtype=torch.float32, device=device),
        torch.zeros(lead + (length, d), dtype=torch.float32, device=device),
    )


def _flash_contiguous(q, k, v, causal: bool, comm: TorchCommunication) -> torch.Tensor:
    """Contiguous layout: round ``r`` folds the block that started at
    position ``(i - r) % p`` into position ``i``'s state; under causal the
    kernel's trip counts skip the masked tiles (fully masked rounds cost
    no folds)."""
    B, S, H, D = q.shape
    size = comm.size
    L = S // size
    qf, kf, vf = (_to_rows(t, size) for t in (q, k, v))
    m, l, acc = _init_state((qf.shape[0],), L, D, q.device)
    pos = torch.arange(size, device=q.device)
    for r in range(size):
        if causal:
            q_base, k_base = pos * L, ((pos - r) % size) * L
        else:
            q_base = k_base = 0
        m, l, acc = flash_attention_partial(qf, kf, vf, m, l, acc, q_base, k_base, causal=causal)
        if r < size - 1:
            kf, vf = comm.ring_permute(kf), comm.ring_permute(vf)
    return _from_rows(_normalize(acc, l).to(q.dtype), B, H, size)


def _flash_zigzag(q, k, v, comm: TorchCommunication) -> torch.Tensor:
    """Zig-zag causal layout: round 0 folds the two diagonal half-chunks
    (the only masked folds) and the always-full (high q, low k) pair; each
    later round folds two wholly unmasked pairs, (q_hi, chunk j) and, per
    position, (q_lo, chunk j) when j < i, else (q_hi, chunk 2p-1-j).
    Operands and state are stacked ``(p, BH, ...)``; each fold is one
    kernel launch over all positions."""
    B, S, H, D = q.shape
    size = comm.size
    bh = B * H
    Lh = S // size // 2
    blocks = lambda t: _to_rows(t, size).reshape(size, bh, 2 * Lh, D)  # noqa: E731
    q_lo, q_hi = zigzag_split(blocks(q), 2, size)  # (p, BH, Lh, D)
    k_lo, k_hi = zigzag_split(blocks(k), 2, size)
    v_lo, v_hi = zigzag_split(blocks(v), 2, size)
    kz = torch.cat([k_lo, k_hi], dim=2)  # the pair rotates as one buffer
    vz = torch.cat([v_lo, v_hi], dim=2)
    pos = torch.arange(size, device=q.device)
    base_lo, base_hi = pos * Lh, (2 * size - 1 - pos) * Lh

    def fold(qh, kseg, vseg, st, diag, q_base=0, k_base=0):
        rows = lambda t: t.reshape((size * bh,) + tuple(t.shape[2:]))  # noqa: E731
        out = flash_attention_partial(rows(qh), rows(kseg), rows(vseg), *map(rows, st),
                                      q_base, k_base, causal=diag)
        return tuple(t.reshape((size, bh) + tuple(t.shape[1:])) for t in out)

    init = lambda: _init_state((size, bh), Lh, D, q.device)  # noqa: E731
    st_lo = fold(q_lo, kz[:, :, :Lh], vz[:, :, :Lh], init(), True, base_lo, base_lo)
    st_hi = fold(q_hi, kz[:, :, :Lh], vz[:, :, :Lh], init(), False)
    st_hi = fold(q_hi, kz[:, :, Lh:], vz[:, :, Lh:], st_hi, True, base_hi, base_hi)
    for r in range(1, size):
        kz, vz = comm.ring_permute(kz), comm.ring_permute(vz)
        j = (pos - r) % size
        ks, vs, kh, vh = kz[:, :, :Lh], vz[:, :, :Lh], kz[:, :, Lh:], vz[:, :, Lh:]
        st_hi = fold(q_hi, ks, vs, st_hi, False)
        sel = j < pos
        st2 = tuple(_select(sel, a, b) for a, b in zip(st_lo, st_hi))
        new = fold(_select(sel, q_lo, q_hi), _select(sel, ks, kh), _select(sel, vs, vh), st2, False)
        st_lo = tuple(_select(sel, n, o) for n, o in zip(new, st_lo))
        st_hi = tuple(_select(sel, o, n) for n, o in zip(new, st_hi))
    out = zigzag_merge(_normalize(st_lo[2], st_lo[1]), _normalize(st_hi[2], st_hi[1]), 2, size)
    return _from_rows(out.to(q.dtype), B, H, size)


# --------------------------------------------------------------------- #
# XLA engine: the plain blockwise update on stacked position blocks        #
# --------------------------------------------------------------------- #
def _xla_contiguous(q, k, v, causal: bool, comm: TorchCommunication) -> torch.Tensor:
    B, S, H, D = q.shape
    size = comm.size
    L = S // size
    acc_dt = _acc_dtype(q.dtype)
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=acc_dt, device=q.device)
    qb, kb, vb = (_to_rows(t, size).reshape(size, B * H, L, D) for t in (q, k, v))
    pos = torch.arange(size, device=q.device)
    ar = torch.arange(L, device=q.device)
    q_pos = pos[:, None] * L + ar  # (p, L)
    m = torch.full((size, B * H, L), -math.inf, dtype=acc_dt, device=q.device)
    num = torch.zeros((size, B * H, L, D), dtype=acc_dt, device=q.device)
    den = torch.zeros((size, B * H, L), dtype=acc_dt, device=q.device)
    for r in range(size):
        mask = None
        if causal:
            k_pos = ((pos - r) % size)[:, None] * L + ar
            mask = (q_pos[:, :, None] >= k_pos[:, None, :])[:, None]
        m, num, den = _blockwise_update(qb, kb, vb, m, num, den, scale, mask)
        if r < size - 1:
            kb, vb = comm.ring_permute(kb), comm.ring_permute(vb)
    return _from_rows(_normalize(num, den).to(q.dtype), B, H, size)


def _xla_zigzag(q, k, v, comm: TorchCommunication) -> torch.Tensor:
    B, S, H, D = q.shape
    size = comm.size
    Lh = S // size // 2
    acc_dt = _acc_dtype(q.dtype)
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=acc_dt, device=q.device)
    blocks = lambda t: _to_rows(t, size).reshape(size, B * H, 2 * Lh, D)  # noqa: E731
    q_lo, q_hi = zigzag_split(blocks(q), 2, size)  # (p, BH, Lh, D)
    k_lo, k_hi = zigzag_split(blocks(k), 2, size)
    v_lo, v_hi = zigzag_split(blocks(v), 2, size)
    kz = torch.cat([k_lo, k_hi], dim=2)
    vz = torch.cat([v_lo, v_hi], dim=2)
    # the only masked tiles: the two round-0 diagonal triangles (their
    # global offsets cancel, so one triangular mask serves both)
    ar = torch.arange(Lh, device=q.device)
    tri = ar[:, None] >= ar[None, :]

    def init():
        return (
            torch.full((size, B * H, Lh), -math.inf, dtype=acc_dt, device=q.device),
            torch.zeros((size, B * H, Lh, D), dtype=acc_dt, device=q.device),
            torch.zeros((size, B * H, Lh), dtype=acc_dt, device=q.device),
        )

    st_lo = _blockwise_update(q_lo, kz[..., :Lh, :], vz[..., :Lh, :], *init(), scale, mask=tri)
    st_hi = _blockwise_update(q_hi, kz[..., :Lh, :], vz[..., :Lh, :], *init(), scale)
    st_hi = _blockwise_update(q_hi, kz[..., Lh:, :], vz[..., Lh:, :], *st_hi, scale, mask=tri)
    pos = torch.arange(size, device=q.device)
    for r in range(1, size):
        kz, vz = comm.ring_permute(kz), comm.ring_permute(vz)
        j = (pos - r) % size
        ks, vs, kh, vh = kz[..., :Lh, :], vz[..., :Lh, :], kz[..., Lh:, :], vz[..., Lh:, :]
        st_hi = _blockwise_update(q_hi, ks, vs, *st_hi, scale)
        sel = j < pos
        st2 = tuple(_select(sel, a, b) for a, b in zip(st_lo, st_hi))
        new = _blockwise_update(
            _select(sel, q_lo, q_hi), _select(sel, ks, kh), _select(sel, vs, vh), *st2, scale
        )
        st_lo = tuple(_select(sel, n, o) for n, o in zip(new, st_lo))
        st_hi = tuple(_select(sel, o, n) for n, o in zip(new, st_hi))
    out = zigzag_merge(_normalize(st_lo[1], st_lo[2]), _normalize(st_hi[1], st_hi[2]), 2, size)
    return _from_rows(out.to(q.dtype), B, H, size)


def ring_self_attention(x, wq, wk, wv, causal: bool = False,
                        comm: Optional[TorchCommunication] = None) -> torch.Tensor:
    """Project ``x`` with (wq, wk, wv), then ring-attend.  ``x``: (S, E) or
    (B, S, E), sequence-split; weights (E, D), one head.  The projections
    are plain matrix products (``torch.matmul``); any argument may be a
    DNDarray."""
    if isinstance(x, DNDarray):
        comm = comm or x.comm
        x = x.larray
    wq, wk, wv = (w.larray if isinstance(w, DNDarray) else w for w in (wq, wk, wv))
    dt = functools.reduce(torch.promote_types, (wq.dtype, wk.dtype, wv.dtype), x.dtype)
    q, k, v = (torch.matmul(x.to(dt), w.to(dt))[..., None, :] for w in (wq, wk, wv))
    return ring_attention(q, k, v, causal=causal, comm=comm)[..., 0, :]
