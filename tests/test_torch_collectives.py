"""The port's remaining collectives held against the JAX package's:
``commit_split``, ``permute``, ``bcast``, ``scatter``, ``gather``,
``reduce``, ``scan`` and ``exscan`` at 8 positions (the reference's
8-device CPU mesh), on divisible and ragged lengths, and ``gather``/
``reduce`` under ``int8_block``, bitwise the reference's quantized ring
at 4 positions.

A tensor carries no sharding, so where the reference reads the split of
its input, the port's ``bcast`` takes it as an argument.  Cases come from
the reference's ``test_communication.py`` and ``test_collective_matrix.py``.
Exact everywhere but float scans (``rtol 2e-6, atol 1e-6``; ``rtol
1e-13`` in float64).
"""

import numpy as np
import pytest
import torch

import jax

import heat_tpu as ht
from test_torch_reference_state import reference_state  # noqa: F401,E402  (restores the JAX package's state)

import heat_tpu_torch as htt
from heat_tpu_torch.comm import compressed as tcq


P = len(jax.devices())


@pytest.fixture
def comms():
    return ht.get_comm(), htt.TorchCommunication(["cpu"] * P)


def _np(a):
    return np.asarray(a)


def _scan_close(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want)
    else:
        rtol = 1e-13 if want.dtype == np.float64 else 2e-6
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6)


@pytest.mark.parametrize("rows", [2 * P, 2 * P - 3])
@pytest.mark.parametrize("split", [None, 0, 1])
def test_commit_split_matches_reference(comms, rows, split):
    ref, mine = comms
    data = np.arange(rows * (P + 3), dtype=np.float32).reshape(rows, P + 3)
    want = _np(ref.commit_split(ht.array(data).larray, split))
    got = mine.commit_split(torch.from_numpy(data), split).numpy()
    np.testing.assert_array_equal(got, want)


PERMS = {
    "ring+1": lambda n: [(i, (i + 1) % n) for i in range(n)],
    "ring-3": lambda n: [(i, (i - 3) % n) for i in range(n)],
    "reverse": lambda n: [(i, n - 1 - i) for i in range(n)],
    "pairs": lambda n: [(i, i ^ 1) for i in range(n)],
    "partial": lambda n: [(0, n - 1), (2, 1)],
    "empty": lambda n: [],
}


@pytest.mark.parametrize("perm", sorted(PERMS))
@pytest.mark.parametrize("rows", [3 * P, 3 * P - 5, P - 2])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_permute_matches_reference(comms, perm, rows, dtype):
    ref, mine = comms
    data = (np.arange(rows * 3).reshape(rows, 3) - 7).astype(dtype)
    pairs = PERMS[perm](P)
    want = _np(ref.permute(ht.array(data).larray, pairs))
    got = mine.permute(torch.from_numpy(data), pairs).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert got.shape[0] == mine.padded_size(rows)


@pytest.mark.parametrize("pairs", [[(0, 1), (0, 2)], [(0, 1), (2, 1)], [(0, P)], [(-1, 0)]])
def test_permute_rejects_what_the_reference_rejects(comms, pairs):
    ref, mine = comms
    x = np.zeros((P, 2), np.float32)
    with pytest.raises(ValueError):
        ref.permute(ht.array(x).larray, pairs)
    with pytest.raises(ValueError):
        mine.permute(torch.from_numpy(x), pairs)


def test_ring_permute_is_the_rotation_permute(comms):
    _, mine = comms
    x = torch.arange(3 * P * 2, dtype=torch.float32).reshape(3 * P, 2)
    for shift in (1, -2, 3):
        assert torch.equal(mine.ring_permute(x, shift), mine.permute(x, [(i, (i + shift) % P) for i in range(P)]))


@pytest.mark.parametrize("shape,split", [((4 * P,), 0), ((2, 3 * P), 1), ((4 * P, 3), 0), ((4 * P, 3), None)])
@pytest.mark.parametrize("root", [0, P - 1, 2])
def test_bcast_matches_reference(comms, shape, split, root):
    ref, mine = comms
    data = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    want = _np(ref.bcast(ht.array(data, split=split).larray, root=root))
    got = mine.bcast(torch.from_numpy(data), root=root, split=split)
    np.testing.assert_array_equal(got.numpy(), want)
    if split is not None:
        assert got.untyped_storage().data_ptr() != torch.from_numpy(data).untyped_storage().data_ptr()


@pytest.mark.parametrize("rows", [2 * P, 2 * P - 3])
@pytest.mark.parametrize("axis", [0, 1])
def test_scatter_gather_roundtrip_matches_reference(comms, rows, axis):
    ref, mine = comms
    data = np.arange(rows * P, dtype=np.float32).reshape(rows, P)
    sc = mine.scatter(torch.from_numpy(data), axis=axis)
    back = mine.gather(sc, axis=axis)
    want = _np(ref.gather(ref.scatter(ht.array(data).larray, axis=axis), axis=axis))
    np.testing.assert_array_equal(sc.numpy(), data)
    np.testing.assert_array_equal(back.numpy(), want)


OPS = ["sum", "prod", "max", "min"]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", ["float32", "int32", "float64"])
@pytest.mark.parametrize("tail", [(), (3,), (2, 2)])
def test_reduce_matches_reference(comms, op, dtype, tail):
    ref, mine = comms
    rng = np.random.default_rng(5)
    data = (rng.uniform(0.5, 2.0, size=(P,) + tail) if dtype != "int32"
            else rng.integers(1, 5, size=(P,) + tail)).astype(dtype)
    want = _np(ref.reduce(ht.array(data).larray, op))
    got = mine.reduce(torch.from_numpy(data), op).numpy()
    assert got.shape == want.shape == tail
    if dtype == "int32":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-13 if dtype == "float64" else 2e-6)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", ["float32", "int32", "float64", "int64", "int8"])
@pytest.mark.parametrize("exclusive", [False, True])
def test_scan_matches_reference(comms, op, dtype, exclusive):
    ref, mine = comms
    rng = np.random.default_rng(7)
    if dtype.startswith("float"):
        data = rng.uniform(-2.0, 2.0, size=(P, 3)).astype(dtype)
    else:
        data = rng.integers(-40, 40, size=(P, 3)).astype(dtype)
    rfn, mfn = (ref.exscan, mine.exscan) if exclusive else (ref.scan, mine.scan)
    want = _np(rfn(ht.array(data).larray, op))
    got = mfn(torch.from_numpy(data), op).numpy()
    _scan_close(got, want)


def test_exscan_identities(comms):
    _, mine = comms
    f = torch.ones((P, 2))
    i = torch.ones((P, 2), dtype=torch.int32)
    assert mine.exscan(f, "max")[0, 0].item() == np.finfo(np.float32).min
    assert mine.exscan(f, "min")[0, 0].item() == np.finfo(np.float32).max
    assert mine.exscan(i, "max")[0, 0].item() == np.iinfo(np.int32).min
    assert mine.exscan(i, "min")[0, 0].item() == np.iinfo(np.int32).max
    assert mine.exscan(f, "sum")[0, 0].item() == 0 and mine.exscan(f, "prod")[0, 0].item() == 1
    with pytest.raises(ValueError):
        mine.scan(f, "median")
    with pytest.raises(ValueError):
        mine.scan(torch.ones((P + 1, 2)), "sum")


def test_one_position_collectives():
    one = htt.TorchCommunication(["cpu"])
    x = torch.arange(6.0).reshape(1, 6)
    assert torch.equal(one.scan(x), x) and torch.equal(one.exscan(x), torch.zeros_like(x))
    assert torch.equal(one.reduce(x), x[0])
    assert torch.equal(one.permute(x, [(0, 0)]), x) and torch.equal(one.bcast(x, split=0), x)


def test_gather_and_reduce_ride_the_int8_ring_bitwise(comms):
    """At 4 positions under int8_block: gather quantizes each shard once
    (1 quantize, 1 dequantize launch), reduce runs the reduce-scatter ring
    (1 quantize, 3 hops, 1 dequantize), each bitwise the reference's."""
    ref4 = ht.core.communication.XlaCommunication(jax.devices()[:4])
    mine4 = htt.TorchCommunication(["cpu"] * 4)
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(4 * 256, 8)) * 3).astype(np.float32)
    parts = (rng.normal(size=(4, 2048)) * 2).astype(np.float32)
    counted = (tcq.quantize_blocks, tcq.dequantize_blocks, tcq.dequantize_fma_blocks,
               tcq.dequantize_add_quantize_blocks)
    with ht.comm.collective_precision("int8_block"):
        want_g = _np(ref4.gather(ref4.apply_sharding(jax.numpy.asarray(x), 0), axis=0))
        want_r = _np(ref4.reduce(jax.numpy.asarray(parts), "sum"))
    with tcq.collective_precision("int8_block"):
        for fn in counted:
            fn.launches = 0
        got_g = mine4.gather(torch.from_numpy(x), axis=0).numpy()
        g_launches = [fn.launches for fn in counted]
        for fn in counted:
            fn.launches = 0
        got_r = mine4.reduce(torch.from_numpy(parts), "sum").numpy()
        r_launches = [fn.launches for fn in counted]
    assert not np.array_equal(got_g, x), "gather did not quantize"
    np.testing.assert_array_equal(got_g.view(np.int32), want_g.view(np.int32))
    np.testing.assert_array_equal(got_r.view(np.int32), want_r.view(np.int32))
    assert g_launches == [0, 0, 0, 0] and r_launches == [0, 0, 0, 0], "plain versions run on the CPU"
