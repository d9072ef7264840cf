"""The port's threefry RNG held against the JAX package's, bit for bit.

The same seed and counter go into ``heat_tpu.random`` and
``heat_tpu_torch.random``; the draws are compared on their bits (every
dtype the reference admits, splits None/0/1, at 1, 2, 7 and 8 positions:
the streams do not depend on the positions), and the generator states
must agree after every draw.  ``randn`` goes through ``log1p``, which
XLA and torch round differently in the last bit now and then; the
difference grows through the cancellation in ``w - 2.5`` (``w - 3.125``
in float64) and the polynomial, so ``randn`` is held within 4 ulps of the
reference's float32 result (3 measured on 2 million draws) and 64 ulps of
its float64 result (about 2^-46 relative; 22 measured on 2 million
inverse error function values), bit for bit in float16 and bfloat16, and
by its first two moments.
"""

import numpy as np
import pytest

import jax

import heat_tpu as ht
from heat_tpu.core.communication import XlaCommunication
from test_torch_reference_state import reference_state  # noqa: F401,E402  (restores the JAX package's state)

import torch

import heat_tpu_torch as htt
from heat_tpu_torch.core import communication as tcomm
from heat_tpu_torch.core import random as trandom


@pytest.fixture
def port():
    comm = htt.TorchCommunication(["cpu"] * len(jax.devices()))
    prev = tcomm._default_comm
    htt.use_comm(comm)
    yield comm
    htt.use_comm(prev)


def _state(seed=7, counter=123):
    ht.random.set_state(("Threefry", seed, counter, 0, 0.0))
    htt.random.set_state(("Threefry", seed, counter, 0, 0.0))


def _dt(kw):
    """The keyword arguments with a dtype name turned into each package's type."""
    jkw, tkw = dict(kw), dict(kw)
    if "dtype" in kw:
        jkw["dtype"], tkw["dtype"] = getattr(ht, kw["dtype"]), getattr(htt, kw["dtype"])
    return jkw, tkw


def _bits(a: np.ndarray) -> np.ndarray:
    """Comparable bits: bfloat16 (which the reference returns as
    ``ml_dtypes.bfloat16`` and the port as float32) widened exactly to
    float32, floats viewed as unsigned integers."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    if a.dtype.kind == "f":
        return a.view({2: np.uint16, 4: np.uint32, 8: np.uint64}[a.dtype.itemsize])
    return a


def _draw_both(fn, *args, comm_t=None, comm_j=None, **kw):
    """The same draw from both packages at one state; asserts the states
    agree afterwards; returns (port, reference) DNDarrays."""
    jkw, tkw = _dt(kw)
    if comm_j is not None:
        jkw["comm"], tkw["comm"] = comm_j, comm_t
    j = getattr(ht.random, fn)(*args, **jkw)
    t = getattr(htt.random, fn)(*args, **tkw)
    assert htt.random.get_state() == ht.random.get_state()
    return t, j


def _same_bits(t, j):
    assert t.shape == tuple(j.shape) and t.split == j.split
    assert t.dtype.__name__ == j.dtype.__name__
    jn = np.asarray(j.numpy())
    tn = t.numpy()
    if jn.dtype.name == "bfloat16":
        tn = tn.astype(np.float32)
    np.testing.assert_array_equal(_bits(tn), _bits(jn))
    if t.split is not None:
        n = t.shape[t.split]
        assert t.padshape == tuple(j.padshape)
        assert not t._buffer.narrow(t.split, n, t.padshape[t.split] - n).any()


@pytest.mark.parametrize("dtype", ["float32", "float64", "float16", "bfloat16"])
@pytest.mark.parametrize("split", [None, 0, 1])
def test_rand_bitwise(port, dtype, split):
    _state()
    _same_bits(*_draw_both("rand", 13, 6, dtype=dtype, split=split))
    _same_bits(*_draw_both("rand", 5, 3, dtype=dtype, split=split))


@pytest.mark.parametrize("p", [1, 2, 7, 8])
@pytest.mark.parametrize("fn,args,kw", [
    ("rand", (11, 5), {}),
    ("randn", (9, 4), {"dtype": "float16"}),
    ("randint", (-7, 90, (13, 3)), {"dtype": "int64"}),
    ("randperm", (29,), {}),
], ids=["rand", "randn_f16", "randint", "randperm"])
def test_streams_do_not_depend_on_positions(fn, args, kw, p):
    """At 1, 2, 7 and 8 positions (the reference on as many mesh devices)
    the draws are the reference's, laid out and padded as there."""
    devs = jax.devices()
    if len(devs) < p:
        pytest.skip(f"needs {p} JAX devices")
    comm_t, comm_j = htt.TorchCommunication(["cpu"] * p), XlaCommunication(devs[:p])
    _state(11, 5)
    _same_bits(*_draw_both(fn, *args, split=0, comm_t=comm_t, comm_j=comm_j, **kw))


@pytest.mark.parametrize("name", ["random_sample", "random", "ranf", "sample"])
@pytest.mark.parametrize("shape", [None, (), 0, 5, (3, 4)], ids=str)
def test_random_sample_aliases_bitwise(port, name, shape):
    _state()
    _same_bits(*_draw_both(name, shape))


@pytest.mark.parametrize("low,high,size", [(0.0, 1.0, (7, 3)), (-2.0, 3.0, (4, 5)), (5.0, 5.5, 9), (1.0, -1.0, None)])
@pytest.mark.parametrize("split", [None, 0])
def test_uniform_bitwise(port, low, high, size, split):
    _state()
    _same_bits(*_draw_both("uniform", low, high, size, split=split if size is not None else None))


RANDINT = [
    (0, 100), (-5, 7), (0, 2**31), (-(2**31), 2**31 - 1), (3, None), (0, 2**15), (-120, 300), (250, 256),
    (-5, 2**31 + 7), (-3, 2**62), (-(2**63), 2**63 - 1), (0, 2**40 + 3), (7, 8),
]


#: the bounds each dtype takes: under int64 the reference casts a bound to
#: its sampling type, so bounds past 32 bits are int64's alone
RANDINT_CASES = [
    (bounds, dtype)
    for dtype in ("int64", "int32", "int16", "int8", "uint8")
    for bounds in RANDINT
    if dtype == "int64" or (abs(bounds[0]) < 2**31 and (bounds[1] or 0) <= 2**31)
]


@pytest.mark.parametrize("bounds,dtype", RANDINT_CASES, ids=str)
def test_randint_bitwise(port, bounds, dtype):
    """Every dtype the reference admits, spans from 1 to 2^64 - 1, bounds
    past the dtype's range (clipped as there)."""
    low, high = bounds
    _state(3, 77)
    _same_bits(*_draw_both("randint", low, high, (40,), dtype=dtype, split=0))


@pytest.mark.parametrize("split", [None, 0, 1])
def test_randint_shapes_and_errors(port, split):
    _state()
    _same_bits(*_draw_both("randint", 0, 9, (6, 7), split=split))
    _same_bits(*_draw_both("randint", 0, 9, 5))
    _same_bits(*_draw_both("randint", 0, 9))
    for bad in ((5, 5), (6, 2)):
        with pytest.raises(ValueError):
            ht.random.randint(*bad)
        with pytest.raises(ValueError):
            htt.random.randint(*bad)
    with pytest.raises(ValueError):
        htt.random.randint(0, 5, dtype=htt.float32)
    with pytest.raises(ValueError):
        htt.random.rand(3, dtype=htt.int32)


def _ulps(t: np.ndarray, j: np.ndarray) -> float:
    t, j = t.astype(np.float64), np.asarray(j)
    return float((np.abs(t - j.astype(np.float64)) / np.spacing(np.abs(j))).max())


@pytest.mark.parametrize("dtype,ulps", [("float32", 4), ("float64", 64), ("float16", 0), ("bfloat16", 0)])
@pytest.mark.parametrize("split", [None, 0, 1])
def test_randn_within_ulps(port, dtype, ulps, split):
    _state(5, 0)
    t, j = _draw_both("randn", 300, 40, dtype=dtype, split=split)
    assert t.shape == tuple(j.shape) and t.split == j.split and t.dtype.__name__ == j.dtype.__name__
    jn = np.asarray(j.numpy())
    if ulps == 0:
        _same_bits(t, j)
    else:
        assert _ulps(t.numpy(), jn) <= ulps


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_randn_moments(port, dtype):
    """Mean and standard deviation of 200 000 draws within 5 standard
    errors of 0 and 1, and equal to the reference's to 1e-6."""
    _state(9, 1)
    t, j = _draw_both("randn", 200_000, dtype=dtype)
    x, y = t.numpy().astype(np.float64), np.asarray(j.numpy()).astype(np.float64)
    se = 1 / np.sqrt(x.size)
    assert abs(x.mean()) < 5 * se and abs(x.std() - 1) < 5 * se * np.sqrt(0.5)
    assert abs(x.mean() - y.mean()) < 1e-6 and abs(x.std() - y.std()) < 1e-6


def test_erfinv_edges_match_reference(port):
    """The inverse error function at and next to +-1 and 0: +-inf at +-1,
    finite and within 4 ulps just inside, exact at 0."""
    x = np.array([-1.0, -0.99999994, -0.5, 0.0, 1e-30, 0.5, 0.99999994, 1.0], np.float32)
    got = trandom._erfinv(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.scipy.special.erfinv(jax.numpy.asarray(x)))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert _ulps(got[fin], want[fin]) <= 4


@pytest.mark.parametrize("n", [0, 1, 2, 17, 1000])
@pytest.mark.parametrize("dtype", ["int64", "int32"])
@pytest.mark.parametrize("split", [None, 0])
def test_randperm_bitwise(port, n, dtype, split):
    _state()
    _same_bits(*_draw_both("randperm", n, dtype=dtype, split=split))


def test_randperm_settles_key_collisions_as_the_reference(port):
    """At n = 2^17 the 32-bit sort keys of the first round collide (about
    two pairs expected); the stable sort settles them in index order, as
    the reference's stable sort does, so the permutation is its bit for
    bit."""
    n = 1 << 17
    _state(1, 0)
    key = trandom._consume(0)
    _, sub = trandom._split(key)
    keys = trandom._bits(sub, 32, (n,), torch.device("cpu")).numpy()
    assert len(np.unique(keys)) < n, "no collision on this seed: pick another"
    _state(1, 0)
    t, j = _draw_both("randperm", n)
    _same_bits(t, j)
    np.testing.assert_array_equal(np.sort(t.numpy()), np.arange(n))


@pytest.mark.parametrize("split", [None, 0, 1])
def test_permutation_bitwise(port, split):
    """An int, a DNDarray (rows shuffled, split kept unless given), host
    data: the reference's shuffles."""
    _state()
    _same_bits(*_draw_both("permutation", 23))
    data = np.arange(60, dtype=np.float32).reshape(12, 5)
    t = htt.random.permutation(htt.array(data, split=split))
    j = ht.random.permutation(ht.array(data, split=split))
    assert htt.random.get_state() == ht.random.get_state()
    _same_bits(t, j)
    _same_bits(htt.random.permutation(htt.array(data), split=split),
               ht.random.permutation(ht.array(data), split=split))
    _same_bits(*_draw_both("permutation", data[:, 0].astype(np.int64)))
    _same_bits(*_draw_both("permutation", [3.5, 1.0, 2.0, 7.0]))


def test_seed_and_state_round_trips(port):
    """seed resets the counter; get_state/set_state round trip (5- and
    3-tuples); draws advance the counter by the elements drawn; malformed
    states raise as the reference's do."""
    htt.random.seed(42)
    ht.random.seed(42)
    assert htt.random.get_state() == ht.random.get_state() == ("Threefry", 42, 0, 0, 0.0)
    _same_bits(*_draw_both("rand", 4, 5))
    assert htt.random.get_state()[2] == 20
    _same_bits(*_draw_both("randperm", 7))
    _same_bits(*_draw_both("randint", 0, 3, (2, 3)))
    _same_bits(*_draw_both("randn", 3, dtype="float16"))
    assert htt.random.get_state()[2] == 20 + 7 + 6 + 3
    saved = htt.random.get_state()
    first = htt.random.rand(6).numpy()
    htt.random.set_state(saved)
    np.testing.assert_array_equal(htt.random.rand(6).numpy(), first)
    htt.random.set_state(saved[:3])
    np.testing.assert_array_equal(htt.random.rand(6).numpy(), first)
    for bad in (("Threefry", 1), ["Threefry", 1, 2], ("Philox", 1, 2)):
        with pytest.raises(ValueError):
            ht.random.set_state(bad)
        with pytest.raises(ValueError):
            htt.random.set_state(bad)
    htt.random.seed()
    assert htt.random.get_state()[2] == 0 and 0 <= htt.random.get_state()[1] < 2**63


@pytest.mark.parametrize("counter", [0, 5, 2**31 - 3, 2**31 + 9, 2**40])
def test_state_carries_from_the_reference(port, counter):
    """A state taken from the reference (any counter, folded modulo 2^31
    as there) gives the port the reference's next draws."""
    ht.random.seed(2024)
    ht.random.set_state(("Threefry", 2024, counter))
    ht.random.rand(3)
    htt.random.set_state(ht.random.get_state())
    _same_bits(*_draw_both("rand", 8, 2, split=0))
    _same_bits(*_draw_both("randint", 10, 10**6, (5,), dtype="int64"))
    _same_bits(*_draw_both("randperm", 40))


def test_draws_land_on_the_communicator_device(port):
    """The draw is made where the array lives: a CPU communicator's
    tensors are CPU tensors (the card's path is tests/test_torch_card.py)."""
    _state()
    for arr in (htt.random.rand(3, 2), htt.random.randn(4), htt.random.randint(0, 4, (3,)),
                htt.random.randperm(5)):
        assert arr.larray.device.type == "cpu"
