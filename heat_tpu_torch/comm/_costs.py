"""Wire-cost arithmetic of the compressed collectives (stdlib only).

The port's own copy of the pieces of ``heat_tpu/comm/_costs.py`` the
collective-precision policy and the grid QR need: :data:`BLOCK`,
:func:`resolve_mode`, :func:`ring_wire_model` and
:func:`grid_panel_bounds`.  Kept verbatim in meaning so a payload resolves
to the same wire mode, a ring to the same byte count, and a grid QR to the
same panels in both packages.
"""

from __future__ import annotations

from typing import Optional, Tuple

__all__ = ["BLOCK", "grid_panel_bounds", "resolve_mode", "ring_wire_model"]

#: Quantization block length: one f32 scale per this many payload values.
#: One block is one warp-row of the Hopper kernels (32 lanes x 4 values).
BLOCK = 128

#: dtype names the collective-precision policy may compress; everything
#: else always rides the wire exact.
_COMPRESSIBLE = ("float32", "bfloat16")


def resolve_mode(
    dtype_name: str,
    payload_nbytes: int,
    precision: str = "f32",
    threshold: int = 1 << 16,
) -> Optional[str]:
    """Wire mode a payload rides under the given precision policy:
    ``"bf16"`` / ``"int8_block"``, or ``None`` for exact transmission."""
    if precision == "f32" or precision is None:
        return None
    if str(dtype_name) not in _COMPRESSIBLE:
        return None
    if precision == "auto":
        return "int8_block" if int(payload_nbytes) >= int(threshold) else None
    return precision


def ring_wire_model(n_elems: int, size: int, mode: Optional[str], *,
                    block: int = BLOCK, op: str = "allreduce") -> dict:
    """Bytes-moved model for one ring collective, per position.

    Exact f32 ships 4 B/element, ``int8_block`` 1 B/element plus one f32
    scale per ``block`` elements, ``bf16`` 2 B/element.  ``op="allreduce"``
    models the reduce-scatter + all-gather ring (``2*(size-1)`` hops of
    ``ceil(n/size)`` elements padded to the block grid); ``op="allgather"``
    the one-way ring (``size-1`` hops of the ``n_elems``-element shard).
    """
    p = max(int(size), 1)
    if op == "allreduce":
        chunk = -(-int(n_elems) // p)
        hops = 2 * (p - 1)
    elif op == "allgather":
        chunk = int(n_elems)
        hops = p - 1
    else:
        raise ValueError(f"unknown ring op {op!r}")
    chunk_p = -(-chunk // int(block)) * int(block)
    exact = hops * chunk_p * 4
    if mode == "int8_block":
        wire = hops * (chunk_p + (chunk_p // int(block)) * 4)
    elif mode == "bf16":
        wire = hops * chunk_p * 2
    else:
        wire = exact
    return {
        "ring_hops_per_device": hops,
        "chunk_elems_padded": chunk_p,
        "exact_wire_bytes": exact,
        "wire_bytes": wire,
        "bytes_ratio": round(wire / exact, 4) if exact else None,
    }


def grid_panel_bounds(n: int, c: int, tiles_per_proc: int = 1) -> Tuple[Tuple[int, int, int], ...]:
    """The column-panel schedule of the grid blocked QR: one ``(owner mesh
    column, local column offset, width)`` triple per panel.  Columns lie in
    chunks of ``nloc = ceil(n / c)`` over the ``c`` mesh columns; each
    chunk's real width is cut into ``tiles_per_proc`` tiles, and pad
    columns are in no panel."""
    c = max(int(c), 1)
    nloc = -(-int(n) // c)
    out = []
    for jc in range(c):
        vc = min(nloc, max(0, int(n) - jc * nloc))
        if vc <= 0:
            continue
        nb = -(-vc // max(int(tiles_per_proc), 1))
        lo = 0
        while lo < vc:
            out.append((jc, lo, min(nb, vc - lo)))
            lo += nb
    return tuple(out)
