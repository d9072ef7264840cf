"""Ulysses (DeepSpeed-style) sequence parallelism: all-to-all attention.

Port of ``heat_tpu/parallel/ulysses.py`` on the positions model.  The
input arrives split over the sequence; an all-to-all moves the split from
the sequence to the heads, every position computes full-sequence
attention for its own heads with no communication, and a second
all-to-all moves the split back.  Here each swap pads the new split axis
of the global tensor (the exchange is an identity on it), and every
position's heads run through ONE
:func:`flash_attention` call whose grid covers all of them.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core._compile import jitted
from ..core.communication import TorchCommunication, sanitize_comm
from ..core.dndarray import DNDarray
from .flash_attention import _dense_attention, conforms, flash_attention

__all__ = ["ulysses_attention"]


def ulysses_attention(
    q,
    k,
    v,
    causal: bool = False,
    comm: Optional[TorchCommunication] = None,
    local_kernel: str = "auto",
) -> torch.Tensor:
    """Exact attention over sequence-split (seq, heads, dim) — or (batch,
    seq, heads, dim) — inputs via the head<->sequence all-to-all.

    Needs ``heads`` and ``seq`` divisible by the number of positions;
    otherwise (or at one position) plain attention runs.  ``local_kernel``
    picks the full-sequence engine after the swap: ``"auto"`` the flash
    kernel on a CUDA tensor whose sequence conforms (:func:`conforms`),
    else plain attention; ``"flash"`` forces :func:`flash_attention` (the
    kernel on the card, its plain version on the CPU) and raises
    ``ValueError`` on a non-conforming shape; ``"xla"`` forces plain
    attention."""
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

    if size == 1 or H % size != 0 or S % size != 0:
        if local_kernel == "flash" and (size > 1 or not conforms(S, D, q.dtype)):
            raise ValueError(
                "local_kernel='flash' needs heads and sequence divisible by the "
                f"positions (H={H}, S={S}, {size} positions) and a conforming "
                "sequence (128-multiple, f32/bf16/f16, D a multiple of 8 up to 128); "
                "use 'auto' for the silent fallback"
            )
        if size == 1 and local_kernel != "xla":
            out = flash_attention(q, k, v, causal=causal)
        else:
            out = jitted(("ulysses.fallback", causal, B, S, H, D, q.dtype), lambda: _dense_attention)(
                q, k, v, causal)
        return out if batched else out[0]

    conforming = conforms(S, D, q.dtype)
    if local_kernel == "flash" and not conforming:
        raise ValueError(
            f"local_kernel='flash' needs a conforming sequence (S={S} must be a "
            "multiple of 128, dtype f32/bf16/f16, D a multiple of 8 up to 128); use "
            "'auto' for the silent fallback"
        )
    use_flash = local_kernel == "flash" or (
        local_kernel == "auto" and q.device.type == "cuda" and conforming
    )
    if use_flash:
        key = ("ulysses.flash", comm, causal, B, S, H, D, q.dtype)
    else:
        key = ("ulysses.xla", comm, causal, B, S, H, D, q.dtype)
    out = jitted(key, lambda: _ulysses)(q, k, v, causal, comm, use_flash)
    return out if batched else out[0]


def _ulysses(q, k, v, causal: bool, comm, use_flash: bool) -> torch.Tensor:
    """The two all-to-alls around the per-position attention."""
    # sequence -> heads: each position now holds the full sequence of H/p heads
    # exact: the reference's swap runs inside its compiled program, never
    # at the eager redistribution seam; the global tensor already holds
    # every shard, so the all-to-all pads the new split axis
    qh, kh, vh = (comm.pad_to_shards(t, axis=2) for t in (q, k, v))
    if use_flash:
        out = flash_attention(qh, kh, vh, causal=causal)
    else:
        out = _dense_attention(qh, kh, vh, causal)
    # heads -> sequence, the caller's layout
    return comm.pad_to_shards(out, axis=1)
