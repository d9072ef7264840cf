"""Wire-cost arithmetic of the compressed collectives (stdlib only).

The port's own copy of the pieces of ``heat_tpu/comm/_costs.py`` the
collective-precision policy, the grid QR and the streaming fits need:
:data:`BLOCK`, :func:`resolve_mode`, :func:`ring_wire_model`,
:func:`grid_panel_bounds` and :func:`stream_model`.  Kept verbatim in
meaning so a payload resolves to the same wire mode, a ring to the same
byte count, and a grid QR to the same panels in both packages; the
streaming model's two default rates are the card host's own.
"""

from __future__ import annotations

from typing import Optional, Tuple

__all__ = ["BLOCK", "grid_panel_bounds", "resolve_mode", "ring_wire_model", "stream_model"]

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


#: Host read rate (GB/s) of one NetCDF-3 read (scipy's reader, the file
#: mapped, the rows copied out) of a 25.6 MB slab, 200 000 x 32 float32,
#: in the page cache: 2.76 GB/s, the median of 5 that ``chip_smoke.py``
#: phase 13 measured on the host of an NVIDIA H100 80GB HBM3 (700.00 W
#: power limit).  A planning constant: every run pairs it with a measured
#: twin.
DEFAULT_HOST_READ_GBPS = 2.76

#: Host-to-device rate (GB/s) of one ``copy_(non_blocking=True)`` of the
#: same slab from pinned memory to the card: 37.9 GB/s, the median of 5
#: ``chip_smoke.py`` phase 13 measured on an NVIDIA H100 80GB HBM3 (700.00
#: W power limit).
DEFAULT_H2D_GBPS = 37.9


def stream_model(
    chunk_bytes: int,
    chunks: int,
    compute_ms_per_chunk: float = 0.0,
    *,
    read_gbps: float = DEFAULT_HOST_READ_GBPS,
    h2d_gbps: float = DEFAULT_H2D_GBPS,
    prefetch: bool = True,
) -> dict:
    """Modeled time of an out-of-core streaming fit: ``chunks`` slabs of
    ``chunk_bytes`` each read from storage, copied host to device, and
    consumed by one chunk update of ``compute_ms_per_chunk``.

    Serial is ``h (read + copy + compute)``; the double-buffered schedule
    hides the ingest stage behind compute after one warm-up slab,
    ``(read + copy) + h max(read + copy, compute)``.  ``peak_host_slabs``
    is the schedule's host-memory bound (two live slabs overlapped, one
    serial), which :func:`heat_tpu_torch.io.stream.slab_peak` is held
    against.  ``bound`` names the side the overlapped schedule sits on:
    ``"ingest"`` when read + copy > compute, else ``"compute"``.
    """
    h = max(int(chunks), 1)
    cb = int(chunk_bytes)
    read_ms = cb / (float(read_gbps) * 1e6)
    h2d_ms = cb / (float(h2d_gbps) * 1e6)
    stage_ms = read_ms + h2d_ms
    compute_ms = float(compute_ms_per_chunk)
    serial_ms = h * (stage_ms + compute_ms)
    overlapped_ms = stage_ms + h * max(stage_ms, compute_ms)
    best_ms = overlapped_ms if prefetch else serial_ms
    return {
        "chunks": h,
        "chunk_bytes": cb,
        "read_ms_per_chunk": read_ms,
        "h2d_ms_per_chunk": h2d_ms,
        "compute_ms_per_chunk": compute_ms,
        "serial_ms": serial_ms,
        "overlapped_ms": overlapped_ms,
        "speedup": serial_ms / overlapped_ms if overlapped_ms > 0.0 else 1.0,
        "prefetch": bool(prefetch),
        "peak_host_slabs": 2 if prefetch else 1,
        "bound": "ingest" if stage_ms >= compute_ms else "compute",
        "modeled_ms": best_ms,
    }
