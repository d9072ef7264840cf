"""Exact (flash) attention, forward only: kernels B3 and B4 and their plain
versions.

Port of ``heat_tpu/parallel/flash_attention.py``.  :func:`flash_attention`
computes softmax attention on (B, S, H, D) or (S, H, D) inputs without
materializing the S x Sk score matrix; :func:`flash_attention_partial`
folds one K/V segment into a running streaming-softmax state (m, l, acc)
and returns it un-normalized, the per-round engine of ring attention.

On a CUDA tensor both launch the hand-written kernel of
``csrc/flash_attention.cu`` (one block per (bh, 128-row query tile), a loop
over K/V tiles of :func:`kernel_blocks` rows inside it, fed by TMA through
a shared-memory ring) and raise if the launch fails; on a CPU
tensor they run the plain PyTorch versions, :func:`flash_attention_plain`
and :func:`flash_attention_partial_plain`, which fold the same chunks in
the same order as the reference's ``_stream_kv`` at the caller's
``block_q``/``block_k``.  A shape the kernel does not take (see
:func:`conforms`) runs :func:`_dense_attention` in :func:`flash_attention`,
as the reference's fallback does.

Numerics (the reference's ``_matmul_precision``): float32 inputs run both
products at float32 accuracy (the kernel splits each operand into two TF32
parts and sums three tensor-core products, 3xTF32, as the reference's
HIGHEST runs several bf16 passes on the TPU), bfloat16/float16 operands run
as themselves with a float32 accumulator; the softmax state is float32, the
scale is ``float32(1/sqrt(D))``, and ``p`` drops to the input dtype before
the PV product while ``l`` sums the float32 ``p``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

__all__ = [
    "conforms",
    "flash_attention",
    "flash_attention_partial",
    "flash_attention_partial_plain",
    "flash_attention_plain",
    "kernel_blocks",
]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

Bases = Union[int, Sequence[int], torch.Tensor]


def _causal_chunk_bounds(q_lo, k_lo, bq: int, block_k: int, nk: int):
    """Triangular trip counts for one q block against an ``nk``-chunk K
    span: chunk ``j`` covers k positions [k_lo + j*bk, k_lo + (j+1)*bk).
    Returns ``(full, total)`` as int64 tensors: chunks [0, full) are wholly
    unmasked, [full, total) straddle the diagonal (element mask), and
    [total, nk) are wholly masked and never visited.  Floor division
    clamps negative offsets to 0 (q entirely before k: total = 0).  The
    CUDA kernel applies the same rule at its own tile sizes."""
    q_lo = torch.as_tensor(q_lo, dtype=torch.int64)
    k_lo = torch.as_tensor(k_lo, dtype=torch.int64)
    full = torch.clamp(torch.div(q_lo - k_lo + 1, block_k, rounding_mode="floor"), 0, nk)
    total = torch.clamp(
        torch.div(q_lo + bq - 1 - k_lo, block_k, rounding_mode="floor") + 1, 0, nk
    )
    return full, total


def _pick_block(s: int, target: int) -> int:
    """Largest power-of-two block <= target dividing s (s is a multiple
    of 128 when this is called)."""
    b = target
    while b > 128 and s % b:
        b //= 2
    return b if s % b == 0 else 128


def kernel_blocks(dtype: torch.dtype) -> Tuple[int, int]:
    """The CUDA kernel's ``(block_q, block_k)`` for this dtype: 128-row query
    tiles, and K/V tiles of 128 rows in bfloat16 and float16, 64 in float32
    (two stages of 128 float32 rows at D = 128 do not fit in shared memory).
    The kernel folds at these tiles whatever ``block_q``/``block_k`` its
    caller passes; hold it to the plain versions at these.  The library
    reports its own tiles, and :func:`_declare` checks them against these."""
    return (128, 64) if dtype == torch.float32 else (128, 128)


def conforms(seq_len: int, d: int, dtype: torch.dtype) -> bool:
    """True when the CUDA kernel takes a local block of this shape: a
    sequence that is a positive multiple of 128, a floating dtype that
    promotes to float32 (float32, bfloat16, float16), and a head width
    ``d`` that is a multiple of 8 up to 128.  The one conformance
    predicate: ring and Ulysses gate their ``local_kernel`` dispatch on
    it.  (The reference's VMEM-residency term has no meaning on this card;
    the kernel streams K/V through shared memory at any length.)"""
    return (
        seq_len > 0
        and seq_len % 128 == 0
        and dtype in _DTYPE_CODE
        and d % 8 == 0
        and 8 <= d <= 128
    )


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulator dtype: float32 for float32/bf16/f16 (and integer)
    inputs, float64 for float64."""
    return torch.promote_types(dtype, torch.float32)


def _scale(d: int) -> float:
    """``float32(1/sqrt(D))`` as a Python float (exact in float32)."""
    return float(np.float32(1.0 / np.sqrt(d)))


def _dense_attention(q, k, v, causal: bool, q_base: int = 0) -> torch.Tensor:
    """Plain attention on (B, S, H, D), the counterpart of the reference's
    ``_jnp_fallback``: honours ``q_base`` and K/V longer than Q.  Products
    and softmax run in the accumulator dtype (float64 stays float64); the
    scale lives in that dtype from the start."""
    acc_dt = _acc_dtype(q.dtype)
    scale = torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=acc_dt)
    qt, kt, vt = (t.movedim(2, 1).to(acc_dt) for t in (q, k, v))
    scores = torch.matmul(qt, kt.transpose(-1, -2)) * scale.to(qt.device)
    if causal:
        s, sk = q.shape[1], k.shape[1]
        q_pos = q_base + torch.arange(s, device=q.device)[:, None]
        keep = q_pos >= torch.arange(sk, device=q.device)[None, :]
        scores = scores.masked_fill(~keep, -math.inf)
    out = torch.matmul(torch.softmax(scores, dim=-1), vt)
    return out.movedim(1, 2).to(q.dtype)


# --------------------------------------------------------------------- #
# plain versions: the reference's streaming algebra, chunk by chunk        #
# --------------------------------------------------------------------- #
def _fold(q, k, v, m, l, acc, scale: float, keep=None):
    """One streaming-softmax step of the reference's ``_stream_kv`` on
    (BH, rows, D) q and (BH, bk, D) k/v; state float32."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if keep is not None:
        s = s.masked_fill(~keep, -math.inf)
    m_new = torch.maximum(m, s.amax(dim=-1))
    safe_m = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
    p = torch.exp(s - safe_m[..., None])
    if keep is not None:
        p = p.masked_fill(~keep, 0.0)
    corr = torch.where(torch.isfinite(m), torch.exp(m - safe_m), torch.zeros_like(m))
    acc = acc * corr[..., None] + torch.matmul(p.to(v.dtype).float(), v.float())
    l = l * corr + p.sum(dim=-1)
    return m_new, l, acc


def _stream_plain(q, k, v, m, l, acc, *, scale, causal, q_base, k_base, bq, bk):
    """Fold every K/V chunk of ``k``/``v`` into (m, l, acc) — in place —
    the chunks in order, each against the query rows whose block visits
    it.  Rows are independent, so chunk ``c`` folds all rows of the q
    blocks with ``total > c`` at once (a contiguous tail: the bounds grow
    with the block index), masked when any of them straddles it."""
    lq, lk = q.shape[1], k.shape[1]
    if lq % bq or lk % bk:
        raise ValueError(f"blocks ({bq}, {bk}) must divide the lengths ({lq}, {lk})")
    nq, nk = lq // bq, lk // bk
    bounds = [
        tuple(int(x) for x in _causal_chunk_bounds(q_base + qi * bq, k_base, bq, bk, nk))
        for qi in range(nq)
    ] if causal else [(nk, nk)] * nq
    for c in range(nk):
        first = next((qi for qi in range(nq) if bounds[qi][1] > c), None)
        if first is None:
            continue
        r0 = first * bq
        keep = None
        if c >= bounds[first][0]:
            q_pos = q_base + torch.arange(r0, lq, device=q.device)[:, None]
            k_pos = k_base + c * bk + torch.arange(bk, device=q.device)[None, :]
            keep = q_pos >= k_pos
        ks, vs = k[:, c * bk:(c + 1) * bk], v[:, c * bk:(c + 1) * bk]
        m[:, r0:], l[:, r0:], acc[:, r0:] = _fold(
            q[:, r0:], ks, vs, m[:, r0:], l[:, r0:], acc[:, r0:], scale, keep
        )


def flash_attention_plain(
    q, k, v, causal: bool = False, q_base: int = 0, block_q: int = 512, block_k: int = 2048
) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_attention` on a conforming
    (B, S, H, D) or (S, H, D) input: the reference's streaming algebra at
    its block sizes (``block_k`` clamped to the q block under causal)."""
    batched = q.ndim == 4
    if not batched:
        q, k, v = q[None], k[None], v[None]
    B, S, H, D = q.shape
    Sk = k.shape[1]
    bq = _pick_block(S, block_q)
    bk = _pick_block(Sk, min(block_k, bq) if causal else block_k)
    qf, kf, vf = (t.movedim(2, 1).reshape(B * H, -1, D) for t in (q, k, v))
    m = torch.full((B * H, S), -math.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((B * H, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B * H, S, D), dtype=torch.float32, device=q.device)
    _stream_plain(qf, kf, vf, m, l, acc, scale=_scale(D), causal=causal,
                  q_base=q_base, k_base=0, bq=bq, bk=bk)
    out = (acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)
    out = out.reshape(B, H, S, D).movedim(1, 2)
    return out if batched else out[0]


def _position_bases(q_base: Bases, k_base: Bases, bh: int):
    """Per-position ``(q_base, k_base)`` as a list of int pairs; a scalar
    base is one position, a length-P sequence or tensor P positions, each
    owning ``bh / P`` consecutive rows of the (BH, L, D) operands."""
    qb = torch.as_tensor(q_base).reshape(-1).tolist()
    kb = torch.as_tensor(k_base).reshape(-1).tolist()
    if len(qb) == 1 and len(kb) > 1:
        qb = qb * len(kb)
    if len(kb) == 1 and len(qb) > 1:
        kb = kb * len(qb)
    if len(qb) != len(kb) or bh % len(qb):
        raise ValueError(
            f"bases for {len(qb)} and {len(kb)} positions do not split {bh} rows evenly"
        )
    return list(zip(qb, kb))


def flash_attention_partial_plain(
    q, k, v, m, l, acc, q_base: Bases, k_base: Bases,
    causal: bool = False, block_q: int = 512, block_k: int = 2048,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`flash_attention_partial`: returns
    the new ``(m, l, acc)``, leaving the inputs untouched."""
    bh, lq, d = q.shape
    bq = _pick_block(lq, block_q)
    bk = _pick_block(k.shape[1], block_k)
    m, l, acc = m.clone(), l.clone(), acc.clone()
    bases = _position_bases(q_base, k_base, bh)
    per = bh // len(bases)
    for z, (qb, kb) in enumerate(bases):
        sl = slice(z * per, (z + 1) * per)
        mz, lz, az = m[sl], l[sl], acc[sl]  # views: updated in place
        _stream_plain(q[sl], k[sl], v[sl], mz, lz, az, scale=_scale(d), causal=causal,
                      q_base=qb, k_base=kb, bq=bq, bk=bk)
    return m, l, acc


# --------------------------------------------------------------------- #
# the CUDA kernel                                                          #
# --------------------------------------------------------------------- #
def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a flash-attention library and check that
    its tiles are :func:`kernel_blocks`'."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = (
        [i32, i32, i32] + [ptr] * 11 + [i32, ctypes.POINTER(ctypes.c_int64)]
        + [i32] * 5 + [ctypes.c_float, ptr]
    )
    lib.flash_attention_launch.restype = i32
    lib.flash_attention_tiles.argtypes = [i32, ctypes.POINTER(i32), ctypes.POINTER(i32)]
    lib.flash_attention_tiles.restype = i32
    for dtype, code in _DTYPE_CODE.items():
        bq, bk = i32(), i32()
        lib.flash_attention_tiles(code, ctypes.byref(bq), ctypes.byref(bk))
        if (bq.value, bk.value) != kernel_blocks(dtype):
            raise RuntimeError(f"flash_attention library tiles ({bq.value}, {bk.value}) for "
                               f"{dtype} differ from kernel_blocks {kernel_blocks(dtype)}")
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    """The flash-attention library, built on first use, declared."""
    from .. import kernels

    return _declare(kernels.library("flash_attention"))


def _rows_aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` as TMA takes it: unit stride on its last axis, every other
    stride a whole, nonzero number of 16-byte vectors (an axis of extent 1
    excepted) and a 16-byte aligned start."""
    vec = 16 // t.element_size()
    bad = any(st % vec or (st == 0 and n > 1) for st, n in zip(t.stride()[:-1], t.shape[:-1]))
    if t.stride(-1) != 1 or bad or t.data_ptr() % 16:
        t = t.contiguous()
        if t.data_ptr() % 16:
            t = t.clone()
    return t


def _launch(name, *, dtype, partial, causal, q, k, v, o, state_in, state_out, bases,
            q_base, layouts, outer, h, lq, lk, d):
    """One kernel launch; ``layouts`` are the (outer, h, row) element
    strides of q, k, v and o, each viewed as (outer, h, rows, d)."""
    strides = (ctypes.c_int64 * 12)(*[int(x) for lay in layouts for x in lay])
    m_in, l_in, acc_in = state_in if state_in else (None, None, None)
    m_out, l_out, acc_out = state_out if state_out else (None, None, None)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().flash_attention_launch(
            _DTYPE_CODE[dtype], int(partial), int(causal), ptr(q), ptr(k), ptr(v), ptr(o),
            ptr(m_in), ptr(l_in), ptr(acc_in), ptr(m_out), ptr(l_out), ptr(acc_out),
            ptr(bases), int(q_base), strides, outer, h, lq, lk, d, _scale(d), stream,
        )
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")


def _bshd_layout(t: torch.Tensor):
    """(outer, h, row) element strides of a (B, S, H, D) tensor."""
    sb, ss, sh, _ = t.stride()
    return (sb, sh, ss)


def flash_attention(
    q, k, v, causal: bool = False, q_base: int = 0, block_q: int = 512, block_k: int = 2048
) -> torch.Tensor:
    """Exact attention on (B, S, H, D) or (S, H, D) inputs, the output in
    the input dtype.

    ``q_base`` offsets the causal mask's query positions (a sequence-sharded
    local block; K/V may be longer than Q).  A CUDA tensor launches the
    ``flash_attention`` kernel (at :func:`kernel_blocks`, whatever
    ``block_q`` and ``block_k`` say) and raises if the launch fails; a CPU
    tensor runs :func:`flash_attention_plain` at ``block_q``/``block_k``; a
    shape or dtype the kernel does not take (:func:`conforms`) runs
    :func:`_dense_attention`."""
    batched = q.ndim == 4
    if not batched:
        q, k, v = q[None], k[None], v[None]
    B, S, H, D = q.shape
    Sk = k.shape[1]
    if not (conforms(S, D, q.dtype) and conforms(Sk, D, q.dtype)
            and k.dtype == q.dtype and v.dtype == q.dtype):
        out = _dense_attention(q, k, v, causal, q_base=q_base)
    elif q.device.type == "cpu":
        out = flash_attention_plain(q, k, v, causal, q_base, block_q, block_k)
    elif q.device.type == "cuda" and k.device == q.device and v.device == q.device:
        q, k, v = (_rows_aligned(t) for t in (q, k, v))
        out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
        _launch(
            "flash_attention", dtype=q.dtype, partial=False, causal=causal, q=q, k=k, v=v,
            o=out, state_in=None, state_out=None, bases=None, q_base=q_base,
            layouts=[_bshd_layout(t) for t in (q, k, v, out)],
            outer=B, h=H, lq=S, lk=Sk, d=D,
        )
        flash_attention.launches += 1
    else:
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, not {q.device}")
    return out if batched else out[0]


def _bases_tensor(q_base: Bases, k_base: Bases, bh: int, device) -> torch.Tensor:
    """(P, 2) int32 bases on ``device``; device tensors stay there (no host
    sync)."""
    if isinstance(q_base, torch.Tensor) or isinstance(k_base, torch.Tensor):
        qb = torch.as_tensor(q_base, device=device).reshape(-1)
        kb = torch.as_tensor(k_base, device=device).reshape(-1)
        n = max(qb.numel(), kb.numel())
        bases = torch.stack([qb.expand(n), kb.expand(n)], dim=1)
    else:
        bases = torch.tensor(_position_bases(q_base, k_base, bh), device=device)
    bases = bases.to(torch.int32).contiguous()
    if bh % bases.shape[0]:
        raise ValueError(f"bases for {bases.shape[0]} positions do not split {bh} rows evenly")
    return bases


def flash_attention_partial(
    q, k, v, m, l, acc, q_base: Bases, k_base: Bases,
    causal: bool = False, block_q: int = 512, block_k: int = 2048,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fold one K/V segment into the running streaming-softmax state and
    return the new ``(m, l, acc)``, un-normalized.

    Shapes: ``q`` (BH, Lq, D) in the input dtype; ``k``/``v`` (BH, Lk, D);
    ``m``/``l`` (BH, Lq) float32 and ``acc`` (BH, Lq, D) float32.  Start
    from ``m = -inf, l = 0, acc = 0``; after the last segment the caller
    computes ``acc / max(l, 1e-30)``.  ``q_base``/``k_base`` are the global
    positions of q row 0 and k row 0: ints, or one per position (a
    sequence or a device tensor of length P; position ``i`` owns rows
    ``[i*BH/P, (i+1)*BH/P)``), so one call folds a whole ring round.

    A CUDA tensor launches the ``flash_attention_partial`` kernel (a
    non-conforming shape raises: callers gate on :func:`conforms`); a CPU
    tensor runs :func:`flash_attention_partial_plain`."""
    bh, lq, d = q.shape
    lk = k.shape[1]
    if tuple(m.shape) != (bh, lq) or tuple(l.shape) != (bh, lq) or tuple(acc.shape) != (bh, lq, d):
        raise ValueError(
            f"state shapes {tuple(m.shape)}, {tuple(l.shape)}, {tuple(acc.shape)} do not "
            f"match q {tuple(q.shape)}"
        )
    if any(t.dtype != torch.float32 for t in (m, l, acc)):
        raise ValueError("the softmax state (m, l, acc) is float32")
    if q.device.type == "cpu":
        return flash_attention_partial_plain(
            q, k, v, m, l, acc, q_base, k_base, causal, block_q, block_k
        )
    if q.device.type != "cuda" or any(t.device != q.device for t in (k, v, m, l, acc)):
        raise ValueError(f"flash_attention_partial runs on CUDA or CPU tensors, not {q.device}")
    if not (conforms(lq, d, q.dtype) and conforms(lk, d, q.dtype)
            and k.dtype == q.dtype and v.dtype == q.dtype):
        raise ValueError(
            f"flash_attention_partial: the kernel does not take Lq={lq}, Lk={lk}, D={d}, "
            f"{q.dtype} (see conforms)"
        )
    bases = _bases_tensor(q_base, k_base, bh, q.device)
    positions = bases.shape[0]
    heads = bh // positions
    q, k, v = (_rows_aligned(t) for t in (q, k, v))
    m, l, acc = m.contiguous(), l.contiguous(), acc.contiguous()
    if acc.data_ptr() % 16:  # TMA moves the state: a 16-byte aligned start
        acc = acc.clone()
    m_out, l_out, acc_out = torch.empty_like(m), torch.empty_like(l), torch.empty_like(acc)
    layouts = [(t.stride(0) * heads, t.stride(0), t.stride(1)) for t in (q, k, v)]
    _launch(
        "flash_attention_partial", dtype=q.dtype, partial=True, causal=causal, q=q, k=k, v=v,
        o=None, state_in=(m, l, acc), state_out=(m_out, l_out, acc_out), bases=bases,
        q_base=0, layouts=layouts + [(0, 0, 0)], outer=positions, h=heads,
        lq=lq, lk=lk, d=d,
    )
    flash_attention_partial.launches += 1
    return m_out, l_out, acc_out


#: launches of each kernel since the count was last set to 0
flash_attention.launches = 0
flash_attention_partial.launches = 0
