"""The port's grid results held to numpy where the reference errs.

On a 10 x 7 float32 array at ``splits=(0, 1)`` on grids of (2, 2) and
(2, 4) CPU positions, every call below gives numpy's shape and values.
The JAX package keeps mesh axis 1's pad in these results, raises, or
(for the quantized reductions and halos) builds a ring over mesh axis 0
only: faults of the reference recorded in ROADMAP.md.  So, as
``tests/test_torch_grid.py``'s ``REF_RAISES`` does, the port is compared
with numpy here, not with the reference.

Tolerances, each with its reason:

* indexing, masks, ``where``, ``minimum``, ``flatten``, ``unique``,
  ``bincount``, ``argmin``, ``any``: equal (no arithmetic);
* ``prod``/``cumsum``: numpy's float64 values within ``rtol 1e-5`` (float32
  sums and products of at most 10 terms);
* ``percentile``: numpy's float32 result within ``rtol 1e-6`` (the
  linear interpolation in float32, one rounding apart);
* ``sum``/``mean``/``var``/``std`` under ``int8_block``: bitwise the
  port's exact (``f32``) result on the same grid, since no quantized ring
  runs on a grid, and numpy's float64 values within ``rtol 1e-5``.
"""

import numpy as np
import pytest

import heat_tpu_torch as htt
from heat_tpu_torch.comm import compressed as cq

MESHES = [(2, 2), (2, 4)]


def _x(mesh):
    comm = htt.grid_comm(mesh, ["cpu"] * (mesh[0] * mesh[1]))
    data = np.random.default_rng(29).normal(size=(10, 7)).astype(np.float32)
    return data, htt.array(data, splits=(0, 1), comm=comm), comm


#: name -> (the port's call, numpy's); each compared exactly
EXACT = {
    "argmin_0": (lambda x, c: htt.argmin(x, 0), lambda d: np.argmin(d, 0)),
    "any_gt1_0": (lambda x, c: htt.any(x > 1, 0), lambda d: np.any(d > 1, 0)),
    "rows_key": (lambda x, c: x[htt.array([3, 0, 9, 9, 2], comm=c)], lambda d: d[[3, 0, 9, 9, 2]]),
    "cols_key": (lambda x, c: x[:, htt.array([3, 0, 6], comm=c)], lambda d: d[:, [3, 0, 6]]),
    "mask_key": (lambda x, c: x[x > 0], lambda d: d[d > 0]),
    "where": (lambda x, c: htt.where(x > 0, x, 0.0), lambda d: np.where(d > 0, d, np.float32(0))),
    "minimum": (lambda x, c: htt.minimum(x, x * 0.5), lambda d: np.minimum(d, d * np.float32(0.5))),
    "unique_round": (lambda x, c: htt.unique(htt.round(x)), lambda d: np.unique(np.round(d))),
    "flatten": (lambda x, c: x.flatten(), lambda d: d.flatten()),
    "bincount": (
        lambda x, c: htt.bincount(htt.abs(htt.round(x * 2)).astype(htt.int64).flatten()),
        lambda d: np.bincount(np.abs(np.round(d * 2)).astype(np.int64).flatten()),
    ),
}

#: name -> (the port's call, numpy's float64 call); within rtol 1e-5
NUMERIC = {
    "prod_1": (lambda x: htt.prod(x, 1), lambda d: np.prod(d, 1)),
    "cumsum_0": (lambda x: htt.cumsum(x, 0), lambda d: np.cumsum(d, 0)),
    "cumsum_1": (lambda x: htt.cumsum(x, 1), lambda d: np.cumsum(d, 1)),
}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", list(EXACT))
def test_grid_call_equals_numpy(mesh, name):
    data, x, comm = _x(mesh)
    mine, ref = EXACT[name]
    got, want = mine(x, comm), ref(data)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", list(NUMERIC))
def test_grid_scan_and_product_within_float32_of_numpy(mesh, name):
    data, x, _ = _x(mesh)
    mine, ref = NUMERIC[name]
    got, want = mine(x), ref(data.astype(np.float64))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_grid_percentile_on_2x4_equals_numpy():
    data, x, _ = _x((2, 4))
    got = htt.percentile(x, 30, axis=0)
    want = np.percentile(data, 30, axis=0)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", ["sum", "mean", "var", "std"])
@pytest.mark.parametrize("axis", [None, 0, 1])
def test_grid_int8_block_reductions_stay_exact(mesh, name, axis):
    data, x, _ = _x(mesh)
    fn = getattr(htt, name)
    launches = cq.quantize_blocks.launches
    with cq.collective_precision("int8_block"):
        got = fn(x, axis)
    assert cq.quantize_blocks.launches == launches  # no quantized ring ran
    exact = fn(x, axis)
    np.testing.assert_array_equal(
        np.asarray(got.numpy()).view(np.uint32), np.asarray(exact.numpy()).view(np.uint32)
    )
    want = getattr(np, name)(data.astype(np.float64), axis=axis)
    assert got.shape == np.shape(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mesh", MESHES)
def test_grid_get_halo_raises_not_implemented(mesh):
    _, x, _ = _x(mesh)
    with pytest.raises(NotImplementedError):
        x.get_halo(1)
