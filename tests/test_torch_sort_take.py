"""The port's distributed sort and take/put held against the JAX package.

Both packages get the same seeded numpy inputs, at the reference's 8
positions and at a ragged 7: the ring rank sort (1-D, every dtype, both
directions, NaN last in both), the narrow batched ring (1 < columns <
positions), the resplit sort, ``ring_take``/``ring_put`` on padded
buffers with negative and out-of-range keys, and array keys through
``DNDarray.__getitem__``/``__setitem__`` on both sides of
``_RING_INDEX_MIN`` (the constant monkeypatched in both packages).

Everything is exact: values bit for bit, indices and layouts equal.  The
one exception is the reference's signed-zero fault in the 1-D ring sort
(every ``-0.0`` before every ``+0.0``): there the port's indices are
numpy's stable ``argsort``, pinned by
``test_signed_zeros_keep_index_order_as_numpy``.  Cases come from the
reference's ``test_distributed_sort.py`` and ``test_ring_indexing.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import heat_tpu as ht
from heat_tpu.core import dndarray as ref_dnd
from heat_tpu.parallel import take as ref_take
from test_torch_reference_state import reference_state  # noqa: F401,E402  (restores the JAX package's state)

import heat_tpu_torch as htt
from heat_tpu_torch.core import dndarray as port_dnd
from heat_tpu_torch.parallel import sort as port_sort
from heat_tpu_torch.parallel import take as port_take

_COMMS = {}


def comms(p: int):
    """The reference's and the port's communicators over ``p`` positions."""
    if p not in _COMMS:
        _COMMS[p] = (ht.core.communication.XlaCommunication(jax.devices()[:p]),
                     htt.TorchCommunication(["cpu"] * p))
    return _COMMS[p]


def both(data, split, p, dtype=None):
    rc, pc = comms(p)
    kw = {} if dtype is None else {"dtype": getattr(ht, dtype)}
    kp = {} if dtype is None else {"dtype": getattr(htt, dtype)}
    return ht.array(data, split=split, comm=rc, **kw), htt.array(data, split=split, comm=pc, **kp)


def host(x) -> np.ndarray:
    """A DNDarray of either package on the host; bfloat16 as float32."""
    a = np.asarray(x.larray) if hasattr(x.larray, "devices") else x.numpy()
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def bitwise(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, got.dtype, want.shape, want.dtype)
    if got.dtype.kind == "f":
        got, want = got.view(f"u{got.itemsize}"), want.view(f"u{want.itemsize}")
    np.testing.assert_array_equal(got, want)


def same(t, j):
    assert t.shape == tuple(j.shape) and t.split == j.split, (t.shape, t.split, j.shape, j.split)
    assert t.dtype.__name__ == j.dtype.__name__, (t.dtype, j.dtype)
    bitwise(host(t), host(j))


def ties(rng, shape, dtype):
    """Values with many ties (integers in [-3, 3], as ``dtype``), NaN in a
    float's every seventh element."""
    x = rng.integers(-3, 4, size=shape).astype(np.float64)
    if dtype in ("float32", "float64", "float16", "bfloat16"):
        x.reshape(-1)[::7] = np.nan
        x.reshape(-1)[1::5] += 0.5
    if dtype == "bool":
        return x > 0
    if dtype == "uint8":
        return (x + 3).astype(np.uint8)
    return x.astype("float32" if dtype == "bfloat16" else dtype)


DTYPES = ["float32", "float64", "int32", "int64", "int16", "int8", "uint8", "bool", "float16", "bfloat16"]


# --------------------------------------------------------------------- #
# the 1-D ring rank sort                                                  #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ring_rank_sort_bitwise_every_dtype(dtype, descending):
    data = ties(np.random.default_rng(1), 61, dtype)
    r, t = both(data, 0, 8, dtype if dtype == "bfloat16" else None)
    assert port_sort.supports(t.larray.dtype, 61, t.comm)
    rv, ri = ht.sort(r, descending=descending)
    tv, ti = htt.sort(t, descending=descending)
    same(tv, rv)
    same(ti, ri)
    if dtype not in ("float16", "bfloat16"):  # numpy: NaN last in both directions
        key = -data if data.dtype.kind == "f" else ~data
        np.testing.assert_array_equal(host(ti), np.argsort(key if descending else data, kind="stable"))


@pytest.mark.parametrize("dtype", ["float32", "int64"])
def test_ring_rank_sort_at_seven_positions(dtype):
    data = ties(np.random.default_rng(2), 50, dtype)
    r, t = both(data, 0, 7)
    for descending in (False, True):
        rv, ri = ht.sort(r, descending=descending)
        tv, ti = htt.sort(t, descending=descending)
        same(tv, rv)
        same(ti, ri)


def test_signed_zeros_keep_index_order_as_numpy():
    """The reference's 1-D ring sort folds the raw bits, so every -0.0
    ranks before every +0.0; numpy's stable argsort (and the reference's
    own n-D path) keep equal zeros in index order.  The port follows
    numpy in both directions."""
    data = np.array([0.0, -0.0, 1.0, -0.0, 0.0, np.nan, -1.0, 0.0] * 4, np.float32)
    r, t = both(data, 0, 8)
    ri = host(ht.sort(r)[1])
    assert not np.array_equal(ri, np.argsort(data, kind="stable"))  # the fault, as found
    for descending, key in ((False, data), (True, -data)):
        want = np.argsort(key, kind="stable")
        tv, ti = htt.sort(t, descending=descending)
        np.testing.assert_array_equal(host(ti), want)
        bitwise(host(tv), data[want])  # values verbatim: each zero keeps its sign
    rd = host(ht.sort(r, descending=True)[1])
    assert not np.array_equal(rd, np.argsort(-data, kind="stable"))


# --------------------------------------------------------------------- #
# n-D: the narrow batched ring and the resplit sort                       #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("p,cols", [(8, 3), (7, 2), (8, 16), (7, 33)])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_split_axis_sort_nd_bitwise(p, cols, dtype):
    data = ties(np.random.default_rng(cols), (57, cols), dtype)
    r, t = both(data, 0, p)
    for descending in (False, True):
        rv, ri = ht.sort(r, axis=0, descending=descending)
        tv, ti = htt.sort(t, axis=0, descending=descending)
        same(tv, rv)
        same(ti, ri)


def test_sort_3d_split1_axis1_and_off_split_axis():
    rng = np.random.default_rng(13)
    data = rng.integers(-50, 50, size=(5, 37, 6)).astype(np.int32)
    r, t = both(data, 1, 8)
    for axis in (1, 2, 0):
        rv, ri = ht.sort(r, axis=axis)
        tv, ti = htt.sort(t, axis=axis)
        same(tv, rv)
        same(ti, ri)


def test_sort_bool_resplit_and_float64_narrow():
    rng = np.random.default_rng(15)
    x = rng.integers(0, 2, size=(30, 16)).astype(bool)
    r, t = both(x, 0, 8)
    same(htt.sort(t, axis=0)[0], ht.sort(r, axis=0)[0])
    y = ties(rng, (41, 2), "float64")
    r, t = both(y, 0, 8)
    for got, want in zip(htt.sort(t, axis=0, descending=True), ht.sort(r, axis=0, descending=True)):
        same(got, want)


# --------------------------------------------------------------------- #
# ring_take / ring_put                                                    #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("p", [8, 7])
@pytest.mark.parametrize("oob", ["fill", "clip"])
def test_ring_take_matches_reference(p, oob):
    rng = np.random.default_rng(3)
    n = 29
    arr = rng.normal(size=(n, 3)).astype(np.float32)
    idx = np.array([0, 3, n - 1, 3, -1, -n, n, 40, -n - 3, 17, 5], np.int64)
    rc, pc = comms(p)
    # the canonically padded buffer in, the true length as n
    buf = np.concatenate([arr, np.zeros((pc.padded_size(n) - n, 3), np.float32)])
    want = np.asarray(ref_take.ring_take(jnp.asarray(buf), jnp.asarray(idx), comm=rc, n=n, oob=oob, fill=-2.0))
    got = port_take.ring_take(torch.from_numpy(buf), torch.from_numpy(idx), comm=pc, n=n, oob=oob, fill=-2.0)
    bitwise(got.numpy(), want)
    padded = port_take.ring_take(torch.from_numpy(arr), torch.from_numpy(idx), comm=pc, oob=oob, fill=-2.0,
                                 padded_out=True)
    assert padded.shape[0] == pc.padded_size(len(idx))
    bitwise(padded[: len(idx)].numpy(), want)
    assert not padded[len(idx):].any()  # pad rows zero


@pytest.mark.parametrize("p", [8, 7])
@pytest.mark.parametrize("with_base", [False, True])
def test_ring_put_matches_reference(p, with_base):
    rng = np.random.default_rng(4)
    n = 31
    perm = rng.permutation(n)
    idx = np.concatenate([perm[:20], perm[20:25] - n, [n, n + 7, -n - 2]]).astype(np.int32)  # negatives, drops
    vals = rng.normal(size=(len(idx), 2)).astype(np.float32)
    base = rng.normal(size=(n, 2)).astype(np.float32) if with_base else None
    rc, pc = comms(p)
    want = np.asarray(ref_take.ring_put(n, jnp.asarray(idx), jnp.asarray(vals), comm=rc,
                                        base=None if base is None else jnp.asarray(base)))
    got = port_take.ring_put(n, torch.from_numpy(idx), torch.from_numpy(vals), comm=pc,
                             base=None if base is None else torch.from_numpy(base))
    bitwise(got.numpy(), want)


def test_ring_put_duplicates_last_write_in_ring_order_wins():
    """Four positions, three queries each, twelve rows in blocks of three.
    Row 3 lies in block 1: position 1 writes it in round 0 and position 0
    in round 3, so position 0's later query (value 1) wins; row 0 (block
    0) ends with position 3's last query, 11."""
    comm = htt.TorchCommunication(["cpu"] * 4)
    idx = torch.tensor([3, 3, 0, 0, 3, 3, 9, 1, 1, 0, 0, 0])
    vals = torch.arange(12, dtype=torch.float32)
    got = port_take.ring_put(12, idx, vals, comm=comm)
    assert got[3] == 1 and got[0] == 11 and got[1] == 8 and got[9] == 6


# --------------------------------------------------------------------- #
# array keys through the DNDarray, plain and ring                         #
# --------------------------------------------------------------------- #
@pytest.fixture(params=["plain", "ring"])
def route(request, monkeypatch):
    """Both packages on one side of ``_RING_INDEX_MIN``: the ring side
    counts the port's ring calls."""
    calls = {"take": 0, "put": 0}
    if request.param == "ring":
        monkeypatch.setattr(ref_dnd, "_RING_INDEX_MIN", 0)
        monkeypatch.setattr(port_dnd, "_RING_INDEX_MIN", 0)
        take, put = port_take.ring_take, port_take.ring_put

        def counted_take(*a, **k):
            calls["take"] += 1
            return take(*a, **k)

        def counted_put(*a, **k):
            calls["put"] += 1
            return put(*a, **k)

        monkeypatch.setattr(port_take, "ring_take", counted_take)
        monkeypatch.setattr(port_take, "ring_put", counted_put)
    else:
        monkeypatch.setattr(port_dnd, "_RING_INDEX_MIN", 1 << 62)
        monkeypatch.setattr(ref_dnd, "_RING_INDEX_MIN", 1 << 62)
    return request.param, calls


def _ring_key(key, split) -> bool:
    """Whether the key is the ring's: one 1-D list on the split axis, every
    other element ``slice(None)``."""
    keyt = key if isinstance(key, tuple) else (key,)
    lists = [d for d, k in enumerate(keyt) if isinstance(k, list)]
    rest = all(k == slice(None) for k in keyt if not isinstance(k, list))
    return rest and lists == [split] and np.ndim(keyt[split]) == 1


GET_KEYS = [
    [0, 3, 12, 3],  # duplicates
    [-1, -13, 5],  # negative wrap
    [40, -40, 2],  # out of range: clamps
    list(range(12, -1, -1)),  # a permutation
    (slice(None), [2, 0]),
    ([1, 4], slice(None)),
    ([1, 4], [0, 2]),
    (slice(1, 9), [0, 0, 3]),
    (Ellipsis, [1]),
    ([2, 5], None),
    ([[0, 1], [2, 3]],),
]


@pytest.mark.parametrize("split", [0, 1, None])
@pytest.mark.parametrize("key", GET_KEYS, ids=[repr(k) for k in GET_KEYS])
def test_array_key_getitem_matches_reference(route, key, split):
    name, calls = route
    rng = np.random.default_rng(5)
    data = rng.normal(size=(13, 4)).astype(np.float32)
    r, t = both(data, split, 8)
    same(t[key], r[key])
    assert calls["take"] == (name == "ring" and _ring_key(key, split))


@pytest.mark.parametrize("split", [0, None])
def test_mask_and_dndarray_keys(route, split):
    rng = np.random.default_rng(6)
    data = rng.normal(size=(13, 4)).astype(np.float32)
    r, t = both(data, split, 8)
    same(t[t[:, 0] > 0], r[r[:, 0] > 0])  # data-dependent length
    same(t[t > 0], r[r > 0])
    ri, ti = both(np.array([3, 0, 12, 7]), 0, 8)
    same(t[ti], r[ri])
    same(t[ti, 1], r[ri, 1])


SET_KEYS = [
    ([0, 5, 12], "row"),
    ([-1, -13, 6], 2.5),
    ([40, 3, -40], "row"),  # out of range: dropped
    (list(range(12, -1, -1)), "dnd"),
    ((slice(None), [3, 0]), 1.0),
    (([1, 4], [0, 2]), -1.0),
    ("mask", 0.0),
]


@pytest.mark.parametrize("split", [0, 1, None])
@pytest.mark.parametrize("key,value", SET_KEYS, ids=[repr(k) for k, _ in SET_KEYS])
def test_array_key_setitem_matches_reference(route, key, value, split):
    name, calls = route
    rng = np.random.default_rng(7)
    data = rng.normal(size=(13, 4)).astype(np.float32)
    r, t = both(data, split, 8)
    if key == "mask":
        rk, tk = r[:, 0] > 0, t[:, 0] > 0
    else:
        rk = tk = key
    if isinstance(value, str) and value == "row":
        value = np.arange(4, dtype=np.float32)
    if isinstance(value, str) and value == "dnd":
        rv, tv = both(rng.normal(size=(13, 4)).astype(np.float32), split, 8)
    else:
        rv = tv = value
    r[rk] = rv
    t[tk] = tv
    same(t, r)
    assert not t._buffer[13:].any() if split == 0 else True  # pad rows zero
    assert calls["put"] == (name == "ring" and _ring_key(key, split))


def test_integer_key_out_of_range_raises_and_array_key_clamps():
    r, t = both(np.arange(10, dtype=np.float32), 0, 8)
    for x in (r, t):
        with pytest.raises(IndexError):
            x[10]
        with pytest.raises(IndexError):
            x[10] = 1.0
        with pytest.raises(IndexError):
            x[[1, 2], 5] if x.ndim > 1 else x[np.int64(-11)]
    same(t[np.array([10, -11, 2**40], np.int64)], r[np.array([10, -11, 2**40], np.int64)])
    same(t[np.array([-128, 127, 3], np.int8)], r[np.array([-128, 127, 3], np.int8)])


def test_ring_round_trip_permutation(monkeypatch):
    monkeypatch.setattr(port_dnd, "_RING_INDEX_MIN", 0)
    rng = np.random.default_rng(8)
    data = rng.normal(size=(29, 3)).astype(np.float32)
    _, t = both(data, 0, 7)
    perm = rng.permutation(29)
    y = t[perm]
    z = htt.zeros((29, 3), split=0, comm=t.comm)
    z[perm] = y  # the aligned at-rest value goes in as it is
    bitwise(z.numpy(), data)
    bitwise(y.numpy(), data[perm])


@pytest.mark.parametrize("half", ["bfloat16", "float16"])
@pytest.mark.parametrize("src", ["float32", "float64"])
def test_half_nan_converts_as_the_reference(src, half):
    """torch turns a float32 NaN into the bfloat16 0xFFFF and drops a
    float64 NaN's sign; the reference gives the quiet NaN of its sign in
    bfloat16, and in float16 the sign, the quiet bit and the payload's top
    bits (the card's own conversion writes 0x7FFF)."""
    payload = np.array([0x7F800001, 0xFFA00000, 0x7FC12345, 0xFFFFFFFF], np.uint32).view(np.float32)
    data = np.concatenate([np.array([np.nan, -np.nan, 1.5, -0.0], np.float32), payload]).astype(src)
    r, t = both(data, 0, 8, half)
    same(t, r)
    rc, pc = comms(8)
    same(htt.array(data, comm=pc).astype(getattr(htt, half)), ht.array(data, comm=rc).astype(getattr(ht, half)))
