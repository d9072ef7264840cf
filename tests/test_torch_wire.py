"""``heat_tpu_torch.net.wire`` against ``heat_tpu.net.wire``: the replica
RPC frames, both ways and byte for byte.

A frame the port encodes is the bytes the reference encodes for the same
message and blobs, and each package decodes the other's frames, blobs
bitwise (dtype, shape and bytes); the same holds over a
``socket.socketpair()`` and over asyncio streams.  Truncated, oversized
and corrupt frames raise ``WireError`` with the same message class in
both (``corrupt-frame``, ``mid-frame``, ``mid-prefix``, ``truncated``),
and the seeded ``corrupt_frame`` fault flips the same byte in both.  No
replica process is spawned.
"""

import asyncio
import socket
import struct
import threading

import numpy as np
import pytest

from heat_tpu.net import wire as rwire
from heat_tpu.resilience import faults as rfaults
from test_torch_reference_state import reference_state  # noqa: F401  (restores the JAX package's state)

from heat_tpu_torch.net import wire
from heat_tpu_torch.resilience import faults

RNG = np.random.default_rng(5)

#: (message, blobs): the shapes of the replica RPC -- a predict request
#: with its payload, a reply with values and latency, a hello with no
#: blobs, and every dtype the engine's replies take
FRAMES = [
    ({"op": "predict", "tenant": "acme", "model": "km", "rid": "acme#1"},
     {"x": RNG.normal(size=(5, 4)).astype(np.float32)}),
    ({"op": "reply", "seq": 3, "degraded": False, "lat": 0.25},
     {"value": np.arange(7, dtype=np.int64), "hist": RNG.normal(size=(3, 2))}),
    ({"op": "hello", "replica": 0, "compiles": 0, "nested": {"b": [1, 2.5, None], "a": "x"}}, None),
    ({}, {"z": np.zeros((0, 3), np.float32), "s": np.array(7, np.int32),
          "b": np.array([True, False]), "u": np.arange(6, dtype=np.uint8).reshape(2, 3),
          "h": np.array([1.5, -2.0], np.float16)}),
    ({"t": "transposed"}, {"x": np.asfortranarray(RNG.normal(size=(3, 5)).astype(np.float32))}),
]


def _same(got, want):
    msg, blobs = got
    assert msg == want[0]
    assert sorted(blobs) == sorted(want[1] or {})
    for k, v in (want[1] or {}).items():
        v = np.asarray(v)
        assert blobs[k].dtype == v.dtype and blobs[k].shape == v.shape, k
        assert blobs[k].tobytes() == np.ascontiguousarray(v).tobytes(), k


def test_surface_and_constants_equal_the_references():
    assert wire.__all__ == rwire.__all__
    assert wire.MAX_FRAME == rwire.MAX_FRAME
    assert issubclass(wire.WireError, ConnectionError)


@pytest.mark.parametrize("i", range(len(FRAMES)))
def test_frames_are_byte_identical_and_decode_both_ways(i):
    msg, blobs = FRAMES[i]
    mine, ref = wire.encode_frame(msg, blobs), rwire.encode_frame(msg, blobs)
    assert mine == ref
    (total,) = struct.unpack(">I", mine[:4])
    assert total == len(mine) - 4
    _same(wire.decode_frame(ref[4:]), FRAMES[i])
    _same(rwire.decode_frame(mine[4:]), FRAMES[i])


def _pump(send, recv, frames):
    """Send every frame on one end of a socketpair from a thread, receive
    on the other; returns what arrived, then the EOF marker."""
    a, b = socket.socketpair()
    try:
        def writer():
            for msg, blobs in frames:
                send(a, msg, blobs)
            a.shutdown(socket.SHUT_WR)

        t = threading.Thread(target=writer)
        t.start()
        got = [recv(b) for _ in frames]
        eof = recv(b)
        t.join()
    finally:
        a.close()
        b.close()
    return got, eof


@pytest.mark.parametrize("direction", ["port_to_reference", "reference_to_port"])
def test_socketpair_both_ways(direction):
    send, recv = ((wire.send_frame, rwire.recv_frame) if direction == "port_to_reference"
                  else (rwire.send_frame, wire.recv_frame))
    got, eof = _pump(send, recv, FRAMES)
    for g, w in zip(got, FRAMES):
        _same(g, w)
    assert eof is None  # clean EOF at a frame boundary


@pytest.mark.parametrize("direction", ["port_to_reference", "reference_to_port"])
def test_asyncio_streams_both_ways(direction):
    write, read = ((wire.write_frame, rwire.read_frame) if direction == "port_to_reference"
                   else (rwire.write_frame, wire.read_frame))

    async def main():
        got = []
        done = asyncio.Event()

        async def serve(reader, writer):
            for _ in FRAMES:
                got.append(await read(reader))
            got.append(await read(reader))
            writer.close()
            done.set()

        server = await asyncio.start_server(serve, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        for msg, blobs in FRAMES:
            await write(writer, msg, blobs)
        writer.close()
        await writer.wait_closed()
        await asyncio.wait_for(done.wait(), 10)
        server.close()
        await server.wait_closed()
        return got

    got = asyncio.run(main())
    for g, w in zip(got, FRAMES):
        _same(g, w)
    assert got[-1] is None


def _raises_alike(fn_mine, fn_ref, prefix):
    with pytest.raises(wire.WireError) as mine:
        fn_mine()
    with pytest.raises(rwire.WireError) as ref:
        fn_ref()
    assert str(mine.value) == str(ref.value)
    assert str(mine.value).startswith(prefix)


@pytest.mark.parametrize("flip", [4, 9, -1, -6])
def test_corrupt_frames_raise_the_same_error(flip):
    frame = bytearray(wire.encode_frame(*FRAMES[0]))
    frame[flip] ^= 0x10
    body = bytes(frame[4:])
    _raises_alike(lambda: wire.decode_frame(body), lambda: rwire.decode_frame(body), "corrupt-frame")


def test_short_and_malformed_bodies_raise_the_same_error():
    _raises_alike(lambda: wire.decode_frame(b"abc"), lambda: rwire.decode_frame(b"abc"),
                  "truncated frame")
    import zlib

    inner = struct.pack(">I", 99) + b"{}"
    body = inner + struct.pack(">I", zlib.crc32(inner))
    _raises_alike(lambda: wire.decode_frame(body), lambda: rwire.decode_frame(body),
                  "header overruns frame")
    inner = struct.pack(">I", 2) + b"{x"
    body = inner + struct.pack(">I", zlib.crc32(inner))
    _raises_alike(lambda: wire.decode_frame(body), lambda: rwire.decode_frame(body),
                  "bad frame header")


@pytest.mark.parametrize("cut", [2, 10, -3])
def test_truncated_pipes_raise_the_same_error(cut):
    frame = wire.encode_frame(*FRAMES[1])[:cut]

    def over_pipe(recv):
        a, b = socket.socketpair()
        try:
            a.sendall(frame)
            a.shutdown(socket.SHUT_WR)
            return recv(b)
        finally:
            a.close()
            b.close()

    prefix = "pipe died mid-frame"
    _raises_alike(lambda: over_pipe(wire.recv_frame), lambda: over_pipe(rwire.recv_frame), prefix)

    async def over_stream(read):
        reader = asyncio.StreamReader()
        reader.feed_data(frame)
        reader.feed_eof()
        return await read(reader)

    prefix = "pipe died mid-prefix" if cut < 4 and cut > 0 else "pipe died mid-frame"
    _raises_alike(lambda: asyncio.run(over_stream(wire.read_frame)),
                  lambda: asyncio.run(over_stream(rwire.read_frame)), prefix)


def test_oversized_length_prefix_fails_fast_alike():
    frame = struct.pack(">I", wire.MAX_FRAME + 1) + b"\0" * 8

    def over_pipe(recv):
        a, b = socket.socketpair()
        try:
            a.sendall(frame)
            return recv(b)
        finally:
            a.close()
            b.close()

    _raises_alike(lambda: over_pipe(wire.recv_frame), lambda: over_pipe(rwire.recv_frame),
                  "frame length")


def test_seeded_corrupt_frame_fault_flips_the_same_byte():
    """The ``corrupt_frame`` plan lands its seeded flip on the received
    body in both packages: the same byte, then the crc trailer catches
    it with the same message."""
    frame = wire.encode_frame(*FRAMES[1])

    def received(recv, inject):
        a, b = socket.socketpair()
        try:
            a.sendall(frame)
            with inject("corrupt_frame", seed=11, nth=1):
                return recv(b)
        finally:
            a.close()
            b.close()

    _raises_alike(lambda: received(wire.recv_frame, faults.inject),
                  lambda: received(rwire.recv_frame, rfaults.inject), "corrupt-frame")
    body = frame[4:]
    with faults.inject("corrupt_frame", seed=11, nth=1):
        mine = faults.wire_bytes("wire.recv", body)
    with rfaults.inject("corrupt_frame", seed=11, nth=1):
        ref = rfaults.wire_bytes("wire.recv", body)
    assert mine == ref != body
