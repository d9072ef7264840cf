"""Length-prefixed framing for the replica RPC.

Port of ``heat_tpu/net/wire.py``: the codec is numpy and the standard
library only, so a frame either package encodes is byte for byte the
frame the other encodes, and each decodes the other's.

One frame on the wire is::

    u32 total_len | u32 header_len | header_json | blob_0 | ... | u32 crc

(lengths big-endian, ``total_len`` counts everything after itself —
trailer included).  The header is UTF-8 JSON with sorted keys::

    {"msg": {...},                            # arbitrary JSON payload
     "blobs": [["key", "dtype", [shape], nbytes], ...]}

and each blob is the raw C-order bytes of one ndarray, concatenated in
header order.  No pickle anywhere: frames are deterministic for a given
message (sorted keys, raw bytes), safe to hash into reply ledgers, and a
test can byte-parse them without importing this module.

The trailer is ``crc32`` over everything between ``total_len`` and the
trailer itself.  A mismatch raises ``WireError`` whose message starts
with ``corrupt-frame`` — a *distinct* failure class from truncation
(``mid-frame``/``mid-prefix``): a dead pipe means re-queue to a
survivor, a corrupt frame means the bytes that DID arrive are lies and
the connection's framing state cannot be trusted.  The ``corrupt_frame``
fault kind (:mod:`heat_tpu_torch.resilience.faults`) targets exactly this
seam: a seeded single-bit flip on the received body, detection asserted
by the trailer check.

``MAX_FRAME`` bounds a single frame at 256 MiB — a corrupt or hostile
length prefix fails fast instead of allocating unbounded memory.

Both flavors share the codec: blocking ``send_frame``/``recv_frame``
over a ``socket`` (the replica side — plain threads, no event loop) and
asyncio ``write_frame``/``read_frame`` over stream pairs (the ingress
side).  ``recv_frame``/``read_frame`` return ``None`` on clean EOF at a
frame boundary; EOF mid-frame raises ``WireError`` (a dead pipe — the
procfleet's kill -9 detection hangs off exactly this distinction).
"""

from __future__ import annotations

import json
import socket
import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = [
    "MAX_FRAME",
    "WireError",
    "encode_frame",
    "decode_frame",
    "send_frame",
    "recv_frame",
    "write_frame",
    "read_frame",
]

MAX_FRAME = 256 * 1024 * 1024
_U32 = struct.Struct(">I")


class WireError(ConnectionError):
    """A framing violation or a pipe that died mid-frame."""


def encode_frame(msg: dict, blobs: Optional[Dict[str, np.ndarray]] = None) -> bytes:
    """Serialize one frame.  ``blobs`` maps key -> ndarray; arrays are
    shipped as raw C-order bytes with dtype/shape carried in the header.
    The returned bytes end with the crc32 trailer (module docs)."""
    manifest = []
    parts = []
    for key in sorted(blobs or ()):
        arr = np.asarray(blobs[key])
        raw = arr.tobytes()  # always C-order, regardless of input layout
        manifest.append([key, arr.dtype.str, list(arr.shape), len(raw)])
        parts.append(raw)
    header = json.dumps({"msg": msg, "blobs": manifest}, sort_keys=True).encode("utf-8")
    inner = b"".join([_U32.pack(len(header)), header] + parts)
    body = inner + _U32.pack(zlib.crc32(inner))
    if len(body) + 4 > MAX_FRAME:
        raise WireError(f"frame too large: {len(body) + 4} > {MAX_FRAME}")
    return _U32.pack(len(body)) + body


def decode_frame(body: bytes) -> Tuple[dict, Dict[str, np.ndarray]]:
    """Inverse of ``encode_frame`` given the body (everything after the
    ``total_len`` prefix, crc trailer included).  Verifies the trailer
    first — every byte below is checked before any is parsed — then
    returns ``(msg, blobs)``."""
    if len(body) < 8:
        raise WireError(f"truncated frame: {len(body)} bytes")
    (want,) = _U32.unpack_from(body, len(body) - 4)
    body = body[:-4]
    got = zlib.crc32(body)
    if got != want:
        raise WireError(
            f"corrupt-frame: crc32 mismatch (got {got:08x}, "
            f"trailer says {want:08x}, {len(body)} bytes)"
        )
    (header_len,) = _U32.unpack_from(body, 0)
    if 4 + header_len > len(body):
        raise WireError(f"header overruns frame: {header_len} > {len(body) - 4}")
    try:
        header = json.loads(body[4 : 4 + header_len].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise WireError(f"bad frame header: {e}") from e
    blobs: Dict[str, np.ndarray] = {}
    off = 4 + header_len
    for key, dtype, shape, nbytes in header.get("blobs", ()):
        if off + nbytes > len(body):
            raise WireError(f"blob {key!r} overruns frame")
        dt = np.dtype(dtype)
        flat = np.frombuffer(body, dtype=dt, count=nbytes // dt.itemsize, offset=off)
        blobs[key] = flat.reshape(shape).copy()
        off += nbytes
    return header.get("msg", {}), blobs


def _check_total(total: int) -> int:
    if total > MAX_FRAME:
        raise WireError(f"frame length {total} exceeds MAX_FRAME={MAX_FRAME}")
    return total


def _arrived(body: bytes, site: str) -> bytes:
    """Receive-side fault seam: an armed ``corrupt_frame`` plan lands its
    seeded bit flip HERE, on the received body before the trailer check,
    so the detection the chaos lane asserts is this module's own crc
    path — not a mock.  No-op (one bool check) when nothing is armed."""
    from ..resilience import faults

    if not faults.any_active():
        return body
    return faults.wire_bytes(site, body)


# ---------------------------------------------------------------- blocking

def send_frame(sock: socket.socket, msg: dict,
               blobs: Optional[Dict[str, np.ndarray]] = None) -> None:
    sock.sendall(encode_frame(msg, blobs))


def _recv_exact(sock: socket.socket, n: int, *, at_boundary: bool) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            if at_boundary and not buf:
                return None
            raise WireError(f"pipe died mid-frame ({len(buf)}/{n} bytes)")
        buf += chunk
    return bytes(buf)


def recv_frame(sock: socket.socket) -> Optional[Tuple[dict, Dict[str, np.ndarray]]]:
    """Blocking read of one frame; ``None`` on clean EOF at a boundary."""
    prefix = _recv_exact(sock, 4, at_boundary=True)
    if prefix is None:
        return None
    (total,) = _U32.unpack(prefix)
    body = _recv_exact(sock, _check_total(total), at_boundary=False)
    return decode_frame(_arrived(body, "wire.recv"))


# ----------------------------------------------------------------- asyncio

async def write_frame(writer, msg: dict,
                      blobs: Optional[Dict[str, np.ndarray]] = None) -> None:
    writer.write(encode_frame(msg, blobs))
    await writer.drain()


async def read_frame(reader) -> Optional[Tuple[dict, Dict[str, np.ndarray]]]:
    """Asyncio read of one frame; ``None`` on clean EOF at a boundary."""
    import asyncio

    try:
        prefix = await reader.readexactly(4)
    except asyncio.IncompleteReadError as e:
        if not e.partial:
            return None
        raise WireError(f"pipe died mid-prefix ({len(e.partial)}/4 bytes)") from e
    (total,) = _U32.unpack(prefix)
    try:
        body = await reader.readexactly(_check_total(total))
    except asyncio.IncompleteReadError as e:
        raise WireError(f"pipe died mid-frame ({len(e.partial)}/{total} bytes)") from e
    return decode_frame(_arrived(body, "wire.read"))
