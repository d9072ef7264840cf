"""The port's manipulations held against the JAX package: every name of
``heat_tpu/core/manipulations.py``'s ``__all__``, the DNDarray method
forms, ``unique`` on its lexsort and hashed paths (the row hash bit for
bit the reference's), and ``topk``'s tie order (lowest index first, in
``lax.top_k``'s total order: NaN above every number, ``+0.0`` above
``-0.0``).

Both packages get the same seeded numpy inputs at 8 positions and at a
ragged 7, splits None/0/1.  Everything is exact (values bit for bit,
shapes, splits and types equal) except two float32 ``pad`` modes:
``linear_ramp``, whose ramp the reference computes with ``jnp.linspace``
(within rtol 2**-22, two float32 ulps), and ``mean``, whose sum XLA
orders its own way (within n 2**-24 max|x| for the n summed values).  Cases come from the reference's ``test_manipulations.py``,
``test_manipulations_sweep.py`` and ``test_extended_stats_manip.py``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import heat_tpu as ht
from heat_tpu.core import manipulations as ref_manip
from test_torch_reference_state import reference_state  # noqa: F401,E402  (restores the JAX package's state)

import heat_tpu_torch as htt
from heat_tpu_torch.core import manipulations as port_manip

_COMMS = {}


def comms(p: int):
    if p not in _COMMS:
        _COMMS[p] = (ht.core.communication.XlaCommunication(jax.devices()[:p]),
                     htt.TorchCommunication(["cpu"] * p))
    return _COMMS[p]


def both(data, split=None, p=8):
    rc, pc = comms(p)
    return ht.array(data, split=split, comm=rc), htt.array(data, split=split, comm=pc)


def host(x) -> np.ndarray:
    a = np.asarray(x.larray) if hasattr(x.larray, "devices") else x.numpy()
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def same(t, j, rtol=None, atol=0.0):
    if isinstance(j, (list, tuple)):
        assert len(t) == len(j)
        for a, b in zip(t, j):
            same(a, b, rtol, atol)
        return
    assert t.shape == tuple(j.shape) and t.split == j.split, (t.shape, t.split, j.shape, j.split)
    assert t.dtype.__name__ == j.dtype.__name__, (t.dtype, j.dtype)
    got, want = host(t), host(j)
    if rtol is not None:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    elif got.dtype.kind == "f":
        np.testing.assert_array_equal(got.view(f"u{got.itemsize}"), want.view(f"u{want.itemsize}"))
    else:
        np.testing.assert_array_equal(got, want)
    if t.split is not None:  # pad rows zero
        n = t.gshape[t.split]
        assert not t._buffer.narrow(t.split, n, t.padshape[t.split] - n).any()


def data(shape=(11, 6), dtype="float32", seed=0):
    rng = np.random.default_rng(seed)
    if dtype in ("int32", "int64"):
        return rng.integers(-20, 20, size=shape).astype(dtype)
    return rng.normal(size=shape).astype(dtype)


SPLITS = [None, 0, 1]


# --------------------------------------------------------------------- #
# joins and splits                                                        #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("p,split", [(7, 0)])
def test_concatenate_stack_and_friends(p, split):
    a, b = data((11, 6)), data((11, 6), "int32", 1)
    (ra, ta), (rb, tb) = both(a, split, p), both(b, split, p)
    for axis in (0, -1):
        same(htt.concatenate([ta, tb, ta], axis=axis), ht.concatenate([ra, rb, ra], axis=axis))
        same(htt.stack([ta, tb], axis=axis), ht.stack([ra, rb], axis=axis))
    for fn in ("hstack", "vstack", "row_stack", "column_stack"):
        same(getattr(htt, fn)([ta, tb]), getattr(ht, fn)([ra, rb]))
    (r1, t1), (r2, t2) = both(a[:, 0], split and 0, p), both(b[:, 1], split and 0, p)
    for fn in ("hstack", "vstack", "row_stack", "column_stack"):
        same(getattr(htt, fn)([t1, t2]), getattr(ht, fn)([r1, r2]))
    with pytest.raises(ValueError):
        htt.concatenate([ta, htt.array(data((3, 2)), comm=ta.comm)], axis=0)


@pytest.mark.parametrize("split", [0, 1])
def test_split_family(split):
    r, t = both(data((12, 6, 4)), split)
    for ios in (3, [2, 5], [0, 4, 11]):
        same(htt.split(t, ios, axis=0), ht.split(r, ios, axis=0))
        same(htt.vsplit(t, ios), ht.vsplit(r, ios))
    same(htt.hsplit(t, 2), ht.hsplit(r, 2))
    same(htt.dsplit(t, [1, 3]), ht.dsplit(r, [1, 3]))
    with pytest.raises(ValueError):
        htt.split(t, 5, axis=0)


# --------------------------------------------------------------------- #
# shape changes                                                           #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("p,split", [(8, 0), (7, 1)])
def test_reshape_flatten_squeeze_expand(p, split):
    r, t = both(data((12, 6)), split, p)
    for shape, ns in (((6, 12), None), ((3, 4, 6), None), ((-1,), None), ((72, 1), 0), ((4, -1), 1)):
        same(htt.reshape(t, shape, new_split=ns), ht.reshape(r, shape, new_split=ns))
    same(t.reshape(8, 9), r.reshape(8, 9))
    same(htt.flatten(t), ht.flatten(r))
    same(t.ravel(), r.ravel())
    same(t.flatten(), r.flatten())
    for axis in (0, 1, 2, -1, -3):
        same(htt.expand_dims(t, axis), ht.expand_dims(r, axis))
        same(t.expand_dims(axis), r.expand_dims(axis))
    r3, t3 = both(data((1, 12, 1, 3)), None if split is None else split + 1, p)
    for axis in (None, 0, 2, (0, 2)):
        same(htt.squeeze(t3, axis), ht.squeeze(r3, axis))
    same(t3.squeeze(), r3.squeeze())
    with pytest.raises(ValueError):
        htt.squeeze(t3, 1)
    assert htt.shape(t) == ht.shape(r)


@pytest.mark.parametrize("split", [None, 1])
def test_flip_rot90_diag(split):
    r, t = both(data((9, 7)), split)
    for axis in (None, 0, 1, (0, 1)):
        same(htt.flip(t, axis), ht.flip(r, axis))
        same(t.flip(axis), r.flip(axis))
    same(htt.fliplr(t), ht.fliplr(r))
    same(htt.flipud(t), ht.flipud(r))
    for k in (-1, 0, 1, 2, 3):
        same(htt.rot90(t, k), ht.rot90(r, k))
        same(htt.rot90(t, k, axes=(1, 0)), ht.rot90(r, k, axes=(1, 0)))
    for off in (-2, 0, 3):
        same(htt.diag(t, off), ht.diag(r, off))
    r1, t1 = both(data(7), split and 0)
    for off in (-1, 0, 2):
        same(htt.diag(t1, off), ht.diag(r1, off))
    r3, t3 = both(data((4, 5, 6)), split)
    same(htt.diagonal(t3, 1, 0, 2), ht.diagonal(r3, 1, 0, 2))
    same(htt.diagonal(t3, -1, 2, 1), ht.diagonal(r3, -1, 2, 1))


@pytest.mark.parametrize("split", [0, 1])
def test_repeat_resplit_balance(split):
    r, t = both(data((5, 4), "int32"), split)
    for reps, axis in ((2, None), (3, 0), (np.array([1, 0, 2, 1]), 1), (np.full(20, 2), None),
                       (np.array([1, 2, 0, 1, 3]), 0)):
        same(htt.repeat(t, reps, axis), ht.repeat(r, reps, axis))
        same(t.repeat(reps, axis), r.repeat(reps, axis))
    for axis in (None, 0, 1, -1):
        same(htt.resplit(t, axis), ht.resplit(r, axis))
    same(htt.balance(t, copy=True), ht.balance(r, copy=True))
    assert htt.balance(t) is t
    same(htt.redistribute(t, target_map=t.lshape_map), ht.redistribute(r, target_map=r.lshape_map))


PAD_MODES = ["constant", "edge", "reflect", "symmetric", "wrap", "maximum", "minimum", "mean", "median",
             "empty", "replicate", "circular", "linear_ramp"]


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("mode", PAD_MODES)
def test_pad_every_mode(mode, dtype):
    x = data((6, 5), dtype)
    r, t = both(x, 0)
    tol = {}
    if dtype == "float32" and mode == "linear_ramp":
        tol = {"rtol": 2.0 ** -22}
    elif dtype == "float32" and mode == "mean":
        tol = {"rtol": 0.0, "atol": 9 * 2.0 ** -24 * float(np.abs(x).max())}
    for width in (((1, 3), (0, 2)), ((3, 1),)):
        kw = {"constant_values": 7} if mode == "constant" else {}
        same(htt.pad(t, width, mode=mode, **kw), ht.pad(r, width, mode=mode, **kw), **tol)
    with pytest.raises(NotImplementedError):
        htt.pad(t, 1, mode="nope")


# --------------------------------------------------------------------- #
# sort off the split axis, method form                                    #
# --------------------------------------------------------------------- #
def test_sort_method_and_out():
    r, t = both(data((9, 5)), 0)
    for got, want in zip(t.sort(axis=1, descending=True), r.sort(axis=1, descending=True)):
        same(got, want)
    out = htt.zeros((9, 5), split=0, comm=t.comm)
    vals, _ = htt.sort(t, axis=0, out=out)
    assert vals is out
    same(out, ht.sort(r, axis=0)[0])


# --------------------------------------------------------------------- #
# unique                                                                  #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("p,split,dtype", [(8, 0, "int32"), (7, 0, "float64")])
def test_unique_flat(p, split, dtype):
    rng = np.random.default_rng(3)
    x = rng.integers(-5, 5, size=(13, 3)).astype(dtype)
    if dtype != "int32":
        x[2, 1] = x[7, 0] = np.nan  # NaNs collapse to one
    r, t = both(x, split, p)
    same(htt.unique(t), ht.unique(r))
    (tu, ti), (ru, ri) = htt.unique(t, return_inverse=True), ht.unique(r, return_inverse=True)
    same(tu, ru)
    same(ti, ri)
    same(t.unique(), r.unique())


@pytest.mark.parametrize("cols,split", [(5, 1)])
def test_unique_axis_lexsort(cols, split):
    rng = np.random.default_rng(cols)
    base = rng.integers(0, 3, size=(6, cols)).astype(np.float32)
    base[1, 0] = np.nan
    x = base[rng.integers(0, 6, size=19)]
    r, t = both(x, split)
    for axis in (0, 1):
        for got, want in zip(htt.unique(t, axis=axis, return_inverse=True),
                             ht.unique(r, axis=axis, return_inverse=True)):
            same(got, want)


@pytest.mark.parametrize("p,cols,dtype", [(8, 65, "float32"), (7, 96, "int8")])
def test_unique_axis_hashed_bitwise(p, cols, dtype):
    rng = np.random.default_rng(cols)
    base = rng.integers(-3, 3, size=(9, cols)).astype(dtype)
    if dtype.startswith("float"):
        base[2, 3], base[4, 0] = np.nan, -0.0  # NaN equal to NaN, -0.0 to +0.0
        base[5] = base[4]
        base[5, 0] = 0.0
    x = base[rng.integers(0, 9, size=37)]
    r, t = both(x, 0, p)
    for s in (False, True) if dtype.startswith("int") else (False,):
        (tu, ti), (ru, ri) = (htt.unique(t, sorted=s, axis=0, return_inverse=True),
                              ht.unique(r, sorted=s, axis=0, return_inverse=True))
        same(tu, ru)
        same(ti, ri)
        np.testing.assert_array_equal(host(tu)[host(ti)], np.where(x == 0, 0, x))
    want = np.unique(np.where(x == 0, 0, x), axis=0)
    got = host(htt.unique(t, sorted=True, axis=0))
    if dtype.startswith("int"):
        np.testing.assert_array_equal(got, want)  # with sorted=True: numpy's order


@pytest.mark.parametrize("dtype", ["float32", "float64", "int8", "int16", "int32", "int64", "uint8", "bool",
                                   "float16", "bfloat16"])
def test_row_hash_bitwise_reference(dtype):
    import torch

    rng = np.random.default_rng(9)
    x = (rng.normal(size=(17, 9)) * 100).astype(np.float32)
    x[0, 0], x[1, 1], x[2, 2] = np.nan, -0.0, np.inf
    if dtype == "bool":
        x = x > 0
    elif dtype != "bfloat16":
        x = x.astype(dtype) if dtype.startswith("float") else np.nan_to_num(x).astype(dtype)
    jrows = jnp.asarray(x, dtype=jnp.bfloat16) if dtype == "bfloat16" else jnp.asarray(x)
    trows = torch.from_numpy(x).to(torch.bfloat16) if dtype == "bfloat16" else torch.from_numpy(x)
    jw, tw = ref_manip._row_words(jrows), port_manip._row_words(trows)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw).astype(np.int64))
    for seed in range(3):
        for a, b in zip(port_manip._hash_rows(tw, seed), ref_manip._hash_rows(jw, seed)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(np.int64))


# --------------------------------------------------------------------- #
# topk                                                                    #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("split", [None, 1])
@pytest.mark.parametrize("largest", [True, False])
def test_topk_ties_lowest_index_first(split, largest):
    x = np.array([[3, 1, 3, 2, 3, 1], [0, 0, 5, 5, -1, 5]] * 3, np.int32)
    r, t = both(x, split)
    for dim in (0, 1, -1):
        for k in (1, 3):
            for got, want in zip(htt.topk(t, k, dim=dim, largest=largest), ht.topk(r, k, dim=dim, largest=largest)):
                same(got, want)
    assert host(htt.topk(htt.array([3, 1, 3, 2, 3, 1], comm=t.comm), 3)[1]).tolist() == [0, 2, 4]


@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_topk_total_order(dtype, largest):
    x = np.array([1.0, np.nan, 3.0, 3.0, -0.0, 0.0, -np.inf, np.inf, 0.0, -0.0, -3.0], np.float32)
    rc, pc = comms(8)
    if dtype == "bfloat16":
        r, t = ht.array(x, dtype=ht.bfloat16, comm=rc), htt.array(x, dtype=htt.bfloat16, comm=pc)
    else:
        r, t = both(x.astype(dtype), 0)
    for k in (1, 6, 11):
        for got, want in zip(htt.topk(t, k, largest=largest), ht.topk(r, k, largest=largest)):
            same(got, want)
    out = (htt.zeros(4, comm=pc), htt.zeros(4, dtype=htt.int64, comm=pc))
    assert htt.topk(t, 4, out=out, largest=largest) is out
    same(out[1], ht.topk(r, 4, largest=largest)[1])
