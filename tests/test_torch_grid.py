"""The port's 2-D grid of positions held against the JAX package's.

The same numpy inputs go through ``heat_tpu`` on ``grid_comm(mesh)`` (its
8-device CPU mesh under ``tests/conftest.py``) and ``heat_tpu_torch`` on a
grid of as many CPU positions, at meshes (2, 2) and (2, 4).  Covered: the
communicator's grid (``mesh_shape``, ``normalize_splits`` and its errors,
``chunk``/``lshape`` per flat position, ``pad_to_shards(splits=)``, the
blocks view), ``split``/``splits`` on the DNDarray and the factories, the
result layouts of the op engine, ``resplit`` with tuples, and the three
grid SUMMA layouts (``tests/test_mesh2d.py``'s first half).

Tolerances, each with its reason:

* layouts (``splits``, ``split``, shapes, at-rest buffer shapes), chunk
  geometry, factories, resplits and every value computed without
  arithmetic: equal;
* elementwise maps and reductions: ``rtol 1e-6, atol 1e-6`` in float32
  (torch's and XLA's float32 ``exp``/``log`` and sums round apart);
* products: ``rtol 1e-5, atol 1e-5`` against the reference (float32 sums
  of k terms taken in another order: the reference accumulates r*c panels,
  the port one ``torch.matmul``) and against numpy's float64 product;
* ``sum``/``prod`` where the reference keeps mesh axis 1's pad: numpy's
  shape, and numpy's float64 values within ``rtol 1e-5`` (float32 sums and
  products of at most 10 terms).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import heat_tpu as ht
from heat_tpu.core.communication import grid_comm as ref_grid_comm
from test_torch_reference_state import reference_state  # noqa: F401,E402  (restores the JAX package's state)

import heat_tpu_torch as htt

MESHES = [(2, 2), (2, 4)]
#: a divisible shape, the issue's probe (ragged on mesh axis 1), and one
#: ragged on both axes
SHAPES = [(8, 16), (10, 7), (9, 6)]
RTOL, ATOL = 1e-6, 1e-6


def _comms(mesh):
    if len(jax.devices()) < mesh[0] * mesh[1]:
        pytest.skip(f"needs {mesh[0] * mesh[1]} devices")
    return ref_grid_comm(mesh), htt.grid_comm(mesh, ["cpu"] * (mesh[0] * mesh[1]))


def _data(shape, seed=29):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _both(data, comms, splits=(0, 1)):
    ref, mine = comms
    return ht.array(data, splits=splits, comm=ref), htt.array(data, splits=splits, comm=mine)


def _same_layout(t, j):
    assert t.shape == tuple(j.shape)
    assert t.splits == tuple(j.splits) and t.split == j.split
    assert t.dtype.__name__ == j.dtype.__name__


def _pads_zero(t):
    """The port's at-rest pads are zero along every sharded dimension."""
    buf = t._buffer
    for d, g in enumerate(t.splits):
        n = t.shape[d]
        if g is not None and buf.shape[d] > n:
            assert not buf.narrow(d, n, buf.shape[d] - n).any()


# --------------------------------------------------------------------- #
# the communicator's grid                                                #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("mesh", MESHES)
def test_grid_comm_metadata_matches_reference(mesh):
    ref, mine = _comms(mesh)
    assert mine.mesh_shape == ref.mesh_shape == mesh
    assert mine.mesh_ndim == ref.mesh_ndim == 2
    assert mine.axis_names == ref.axis_names == ("heat0", "heat1")
    assert mine.size == ref.size
    flat = htt.TorchCommunication(["cpu"] * 4)
    assert flat.mesh_shape == (4,) and flat.axis_names == ("heat",) and flat.mesh_ndim == 1
    assert mine != htt.TorchCommunication(["cpu"] * mine.size)


def test_grid_comm_is_cached_per_shape_and_checks_its_tiling():
    prev = htt.core.devices._default
    htt.use_device("cpu")
    try:
        a = htt.grid_comm((2, 2))
        assert a is htt.grid_comm((2, 2)) and a.mesh_shape == (2, 2) and a.size == 4
        assert htt.grid_comm((2, 2), positions=["cpu"] * 4) == a
    finally:
        htt.use_device(prev)
    with pytest.raises(ValueError):
        htt.grid_comm((2, 3), ["cpu"] * 4)
    with pytest.raises(ValueError):
        htt.TorchCommunication(["cpu"] * 4, mesh_shape=(3, 1))


SPELLINGS = [None, 0, 1, -1, (0, 1), (1, 0), (None, 1), (0, None), (None, None), [1, None]]
BAD_SPELLINGS = [(0,), (0, 1, None), (0, 2), (2, None), (0, 0), (1, 1)]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("spelling", SPELLINGS)
def test_normalize_splits_matches_reference(mesh, spelling):
    ref, mine = _comms(mesh)
    want = ref.normalize_splits(2, spelling)
    assert mine.normalize_splits(2, spelling) == want
    assert mine.split_view(want) == ref.split_view(want)


@pytest.mark.parametrize("spelling", BAD_SPELLINGS)
def test_normalize_splits_errors_match_reference(spelling):
    ref, mine = _comms((2, 2))
    with pytest.raises(ValueError):
        ref.normalize_splits(2, spelling)
    with pytest.raises(ValueError):
        mine.normalize_splits(2, spelling)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("shape", SHAPES + [(3, 1), (0, 5)])
@pytest.mark.parametrize("splits", [(0, 1), (1, 0), (None, 1), (0, None)])
def test_chunk_per_flat_position_matches_reference(mesh, shape, splits):
    ref, mine = _comms(mesh)
    for rank in range(ref.size):
        assert mine.chunk(shape, splits, rank=rank) == ref.chunk(shape, splits, rank=rank)
    for axis in (0, 1):
        for n in shape:
            assert mine.shard_width(n, mesh_axis=axis) == ref.shard_width(n, mesh_axis=axis)
            assert mine.padded_size(n, mesh_axis=axis) == ref.padded_size(n, mesh_axis=axis)
            assert mine.valid_counts(n, mesh_axis=axis) == ref.valid_counts(n, mesh_axis=axis)
            assert mine.padded_size(n) == ref.padded_size(n)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("splits", [(0, 1), (1, 0), (None, 1)])
def test_pad_to_shards_with_splits_matches_reference(mesh, shape, splits):
    ref, mine = _comms(mesh)
    data = _data(shape)
    want = np.asarray(ref.pad_to_shards(jnp.asarray(data), splits=splits))
    got = mine.pad_to_shards(torch.from_numpy(data), splits=splits).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("splits", [(0, 1), (1, 0), (0, None), (None, 1)])
def test_blocks_view_holds_each_positions_chunk(mesh, splits):
    _, mine = _comms(mesh)
    x = htt.array(_data((9, 6)), splits=splits, comm=mine)
    view = mine.blocks(x._buffer, splits)
    assert tuple(view.shape[:2]) == mesh
    for rank in range(mine.size):
        i, j = divmod(rank, mesh[1])
        _, lshape, slices = mine.chunk(x.shape, splits, rank=rank)
        block = view[i, j][tuple(slice(0, s) for s in lshape)]
        np.testing.assert_array_equal(block.numpy(), x.numpy()[slices])


# --------------------------------------------------------------------- #
# split / splits on the DNDarray and the factories                       #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("split", [None, 0, 1])
def test_split_compat_view_roundtrips_on_1d_mesh(split):
    comm = htt.TorchCommunication(["cpu"] * 8)
    x = htt.ones((8, 8), split=split, comm=comm)
    assert x.split == split
    want = [None, None]
    if split is not None:
        want[split] = 0
    assert x.splits == tuple(want)
    y = htt.ones((8, 8), splits=x.splits, comm=comm)
    assert y.split == split and y.splits == x.splits and y.padshape == x.padshape


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("splits", [(0, 1), (1, 0), (None, 1), (0, None), (None, 0), (None, None)])
def test_grid_metadata_matches_reference(mesh, shape, splits):
    comms = _comms(mesh)
    data = _data(shape)
    j, t = _both(data, comms, splits)
    _same_layout(t, j)
    assert t.lshape == tuple(j.lshape)
    np.testing.assert_array_equal(t.create_lshape_map(), np.asarray(j.create_lshape_map()))
    assert t.padshape == tuple(j._buffer.shape)
    np.testing.assert_array_equal(t.numpy(), data)
    _pads_zero(t)


@pytest.mark.parametrize("factory", ["ones", "zeros", "empty", "full", "eye", "array"])
def test_split_and_splits_are_mutually_exclusive(factory):
    for mod, comm in zip((ht, htt), _comms((2, 2))):
        fn = getattr(mod, factory)
        args = {"full": ((8, 8), 2.0), "array": (np.ones((8, 8)),)}.get(factory, ((8, 8),))
        with pytest.raises(ValueError):
            fn(*args, split=0, splits=(0, None), comm=comm)


def test_splits_validates_against_mesh_rank():
    one = htt.TorchCommunication(["cpu"] * 8)
    grid = htt.grid_comm((2, 2), ["cpu"] * 4)
    for mod, flat, g in ((ht, None, ref_grid_comm((2, 2))), (htt, one, grid)):
        with pytest.raises(ValueError):
            mod.ones((8, 8), splits=(0, 1), comm=flat)
        with pytest.raises(ValueError):
            mod.ones((8, 8), splits=(0,), comm=flat)
        with pytest.raises(ValueError):
            mod.ones((8, 8), splits=(0, 0), comm=g)


FACTORIES = {
    "zeros": lambda m, c, s: m.zeros((5, 6), splits=s, comm=c),
    "ones": lambda m, c, s: m.ones((5, 6), splits=s, comm=c),
    "empty": lambda m, c, s: m.empty((5, 6), splits=s, comm=c),
    "full": lambda m, c, s: m.full((5, 6), 3.5, splits=s, comm=c),
    "eye": lambda m, c, s: m.eye((5, 6), splits=s, comm=c),
    "array": lambda m, c, s: m.array(np.arange(30.0).reshape(5, 6), splits=s, comm=c),
    "zeros_split": lambda m, c, s: m.zeros((5, 6), split=s, comm=c),
}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", list(FACTORIES))
@pytest.mark.parametrize("splits", [(1, 0), (0, 1), (None, 1)])
def test_factories_take_splits_like_reference(mesh, name, splits):
    ref, mine = _comms(mesh)
    j, t = FACTORIES[name](ht, ref, splits), FACTORIES[name](htt, mine, splits)
    _same_layout(t, j)
    assert t.padshape == tuple(j._buffer.shape)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j.larray))
    _pads_zero(t)


@pytest.mark.parametrize("mesh", MESHES)
def test_array_of_a_grid_array_keeps_its_layout_on_its_comm(mesh):
    comms = _comms(mesh)
    j, t = _both(_data((10, 7)), comms)
    _same_layout(htt.array(t, comm=comms[1]), ht.array(j, comm=comms[0]))
    other = htt.TorchCommunication(["cpu"] * 8)
    moved = htt.array(t, comm=other)
    assert moved.splits == (0, None) and moved.split == 0
    _same_layout(htt.zeros_like(t), ht.zeros_like(j))


# --------------------------------------------------------------------- #
# result layouts of the op engine                                        #
# --------------------------------------------------------------------- #
def _y(m, x):
    """A (7, 10)-like partner of ``x`` at ``(0, 1)`` for the product row."""
    return m.array(np.asarray(x.larray if m is ht else x.numpy()).T.copy() * 0.5 + 1.0,
                   splits=(0, 1), comm=x.comm)


#: the calls of the layout table; each runs on both packages
TABLE = {
    "exp": lambda m, x: m.exp(x),
    "abs": lambda m, x: abs(x),
    "neg": lambda m, x: -x,
    "sqrt_abs": lambda m, x: m.sqrt(abs(x)),
    "clip": lambda m, x: m.clip(x, -0.5, 0.5),
    "astype": lambda m, x: x.astype(m.float64),
    "add_scalar": lambda m, x: x + 1,
    "mul_self": lambda m, x: x * x,
    "add_self": lambda m, x: x + x,
    "rmul_float": lambda m, x: 2.0 * x,
    "eq": lambda m, x: x == x,
    "T": lambda m, x: x.T,
    "transpose": lambda m, x: m.linalg.transpose(x),
    "slice_rows": lambda m, x: x[2:5],
    "slice_cols": lambda m, x: x[:, 1:3],
    "row": lambda m, x: x[3],
    "mean_1": lambda m, x: m.mean(x, axis=1),
    "mean_0": lambda m, x: m.mean(x, axis=0),
    "max_0": lambda m, x: x.max(0),
    "min_0": lambda m, x: x.min(0),
    "min_1": lambda m, x: x.min(1),
    "sum_1": lambda m, x: x.sum(1),
    "sum_all": lambda m, x: x.sum(),
    "std_0": lambda m, x: m.std(x, 0),
    "resplit_none_1": lambda m, x: m.resplit(x, (None, 1)),
    "resplit_1_0": lambda m, x: m.resplit(x, (1, 0)),
    "resplit_0": lambda m, x: m.resplit(x, 0),
    "resplit_none": lambda m, x: m.resplit(x, None),
    "concatenate": lambda m, x: m.concatenate([x, x], 0),
    "sort_0": lambda m, x: m.sort(x, axis=0)[0],
    "sort_1": lambda m, x: m.sort(x, axis=1)[0],
    "reshape": lambda m, x: x.reshape((-1,)),
    "copy": lambda m, x: x.copy(),
    "matmul": lambda m, x: x @ _y(m, x),
}


#: table calls where the reference raises on a grid (a fault of the
#: reference, ROADMAP): ``jax.lax.sort`` gets operands of unequal shapes
#: on (2, 4); the port gives numpy's result at the table's layout
REF_RAISES = {("sort_0", (2, 4)): (lambda a: np.sort(a, axis=0), (0, None))}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("shape", [(10, 7), (8, 16)])
@pytest.mark.parametrize("name", list(TABLE))
def test_result_layouts_match_reference(mesh, shape, name):
    """Layouts and values of the table's calls.  The reference's binary ops
    on an array padded along mesh axis 1 keep that pad in their ``larray``
    (a (10, 8) tensor for a (10, 7) result: a fault of the reference), so
    its values are taken at the result's shape."""
    comms = _comms(mesh)
    data = _data(shape)
    j, t = _both(data, comms)
    tr = TABLE[name](htt, t)
    if (name, mesh) in REF_RAISES:
        fn, splits = REF_RAISES[(name, mesh)]
        want = fn(data)
        assert tr.splits == splits and tr.shape == want.shape
    else:
        jr = TABLE[name](ht, j)
        _same_layout(tr, jr)
        want = np.asarray(jr.larray)[tuple(slice(0, s) for s in jr.shape)]
    tol = 1e-5 if name == "matmul" else RTOL
    np.testing.assert_allclose(tr.numpy(), want, rtol=tol, atol=tol)
    _pads_zero(tr)


@pytest.mark.parametrize("shape", [(10, 7), (9, 6)])
@pytest.mark.parametrize("op", ["sum", "prod"])
@pytest.mark.parametrize("axis", [0, 1])
def test_grid_reduction_drops_the_pad_like_numpy(shape, op, axis):
    """``sum``/``prod`` of a ``(0, 1)`` array on (2, 2): numpy's shape and
    values.  The reference reduces the padded buffer and keeps mesh axis
    1's pad along axis 0 (10 x 7: eight sums, the last 0; 9 x 6 raises),
    a fault of the reference recorded in ROADMAP."""
    _, mine = _comms((2, 2))
    data = 1.0 + 1e-1 * np.sin(np.arange(np.prod(shape), dtype=np.float64)).reshape(shape)
    data = data.astype(np.float32)
    t = htt.array(data, splits=(0, 1), comm=mine)
    got = getattr(t, op)(axis)
    want = getattr(data.astype(np.float64), op)(axis)
    assert got.shape == want.shape
    assert got.splits == ((None,) if axis == 0 else (0,))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    for x in (htt.log(t), htt.exp(t)):
        res = getattr(x, op)(axis)
        assert res.shape == want.shape and np.isfinite(res.numpy()).all()


# --------------------------------------------------------------------- #
# resplit with tuples                                                    #
# --------------------------------------------------------------------- #
GRID_TRANSITIONS = [
    ((0, 1), (1, 0)),
    ((0, 1), (None, None)),
    ((None, None), (0, 1)),
    ((0, None), (0, 1)),
    ((0, 1), (0, None)),
    ((0, None), (None, 0)),
    ((0, 1), 1),
    ((1, 0), None),
]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("shape", [(16, 16), (7, 9)])
@pytest.mark.parametrize("src,dst", GRID_TRANSITIONS)
def test_resplit_tuples_match_reference(mesh, shape, src, dst):
    comms = _comms(mesh)
    data = _data(shape)
    j, t = _both(data, comms, src)
    jr, tr = j.resplit(dst), t.resplit(dst)
    _same_layout(tr, jr)
    assert tr.padshape == tuple(jr._buffer.shape)
    np.testing.assert_array_equal(tr.numpy(), data)
    _pads_zero(tr)
    # in place, and the out-of-place function
    _same_layout(htt.resplit(t, dst), jr)
    t.resplit_(dst)
    j.resplit_(dst)
    _same_layout(t, j)
    np.testing.assert_array_equal(t.numpy(), data)
    _pads_zero(t)


@pytest.mark.parametrize("mesh", MESHES)
def test_resplit_round_trip_is_bitwise(mesh):
    _, mine = _comms(mesh)
    data = _data((10, 7))
    x = htt.array(data, splits=(0, 1), comm=mine)
    for dst, want in (((None, 1), (None, 1)), ((1, 0), (1, 0)), (None, (None, None)), ((0, 1), (0, 1))):
        x = x.resplit(dst)
        assert x.splits == want
        np.testing.assert_array_equal(x.numpy(), data)
        _pads_zero(x)
    same = htt.resplit(x, (0, 1))
    assert same._buffer.data_ptr() == x._buffer.data_ptr()


def test_comm_commit_split_with_tuples_matches_reference():
    ref, mine = _comms((2, 4))
    data = _data((7, 9))
    for splits in ((0, 1), (1, 0), (None, 1), 0, None):
        want = np.asarray(ref.commit_split(jnp.asarray(data), splits))
        got = mine.commit_split(torch.from_numpy(data), splits).numpy()
        np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------- #
# grid SUMMA: the three layouts                                           #
# --------------------------------------------------------------------- #
LAYOUTS = [("grid", (0, 1), (0, 1)), ("rowcol", (0, None), (None, 1)), ("colrow", (None, 1), (0, None))]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("layout,sa,sb", LAYOUTS)
@pytest.mark.parametrize("m,k,n", [(8, 16, 8), (7, 13, 9), (8, 12, 10)])
def test_grid_summa_matches_reference(mesh, layout, sa, sb, m, k, n):
    comms = _comms(mesh)
    rng = np.random.default_rng(29)
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = rng.normal(size=(k, n)).astype(np.float32)
    ja, ta = _both(a, comms, sa)
    jb, tb = _both(b, comms, sb)
    jr, tr = ja @ jb, ta @ tb
    assert tr.splits == (0, 1) and tr.shape == (m, n)
    _same_layout(tr, jr)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr.larray), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tr.numpy(), a.astype(np.float64) @ b, rtol=1e-5, atol=1e-5)
    _pads_zero(tr)


def _poisoned(x):
    """``x`` with ``-inf`` written into every pad of its at-rest buffer."""
    buf = x._buffer.clone()
    mask = torch.ones_like(buf, dtype=torch.bool)
    mask[tuple(slice(0, s) for s in x.shape)] = False
    buf[mask] = -float("inf")
    return htt.DNDarray(buf, x.shape, x.dtype, x.splits, x.device, x.comm)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("layout,sa,sb", LAYOUTS)
def test_grid_summa_pad_poisoning(mesh, layout, sa, sb):
    """Ragged k: both operands carry k-axis pads, here ``-inf`` (the
    reference's ``log`` leaves them so); no pad reaches the k-sum."""
    comms = _comms(mesh)
    rng = np.random.default_rng(29)
    m, k, n = 7, 13, 9
    a = (np.abs(rng.normal(size=(m, k))) + 0.5).astype(np.float32)
    b = (np.abs(rng.normal(size=(k, n))) + 0.5).astype(np.float32)
    ja, ta = _both(a, comms, sa)
    jb, tb = _both(b, comms, sb)
    ta, tb = _poisoned(htt.log(ta)), _poisoned(htt.log(tb))
    assert np.isinf(ta._buffer.numpy()).any() or ta.padshape == ta.shape
    got = (ta @ tb).numpy()
    assert np.isfinite(got).all()
    want = np.asarray((ht.log(ja) @ ht.log(jb)).larray)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_matmul_precision_and_out_forwarding_on_grid():
    comms = _comms((2, 2))
    data = _data((8, 8))
    _, a = _both(data, comms)
    _, b = _both(data.T.copy(), comms)
    want = (a @ b).numpy()
    hi = htt.matmul(a, b, precision="highest")
    np.testing.assert_allclose(hi.numpy(), want, rtol=1e-5, atol=1e-5)
    out = htt.zeros((8, 8), splits=(0, 1), comm=comms[1])
    res = htt.matmul(a, b, out=out)
    assert res is out and out.splits == (0, 1)
    np.testing.assert_array_equal(out.numpy(), want)


def test_dndarray_resplit_tuple_roundtrip():
    _, mine = _comms((2, 2))
    data = _data((8, 8))
    x = htt.array(data, splits=(0, 1), comm=mine)
    y = x.resplit((1, 0))
    assert y.splits == (1, 0)
    np.testing.assert_array_equal(y.numpy(), data)
    z = y.resplit((None, None))
    assert z.splits == (None, None)
    np.testing.assert_array_equal(z.numpy(), data)
