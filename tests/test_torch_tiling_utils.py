"""The port's tiling and utilities held against the JAX package:
``SplitTiles`` and ``SquareDiagTiles`` (every geometry property, tile
reads and writes, ``local_to_global``, ``match_tiles``) over the shape
regimes of the reference's tiling sweep, ``utils.matrixgallery.parter``,
and ``utils.profiler`` (its three names on torch).

Both packages get the same inputs at 8 positions and at a ragged 7; the
geometry is host metadata and every table, index and tile is exact.
``parter`` is float32 with one rounding a step in both packages: exact.
Cases come from the reference's ``test_tiling_matrix.py``.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

import heat_tpu as ht
from heat_tpu.core.tiling import SplitTiles as RefSplitTiles
from heat_tpu.core.tiling import SquareDiagTiles as RefSquareDiagTiles
from heat_tpu.utils import profiler as ref_profiler
from test_torch_reference_state import reference_state  # noqa: F401,E402  (restores the JAX package's state)

import heat_tpu_torch as htt
from heat_tpu_torch.core.tiling import SplitTiles, SquareDiagTiles
from heat_tpu_torch.utils import matrixgallery, profiler

_COMMS = {}


def comms(p: int):
    if p not in _COMMS:
        _COMMS[p] = (ht.core.communication.XlaCommunication(jax.devices()[:p]),
                     htt.TorchCommunication(["cpu"] * p))
    return _COMMS[p]


def both(data, split, p):
    rc, pc = comms(p)
    return ht.array(data, split=split, comm=rc), htt.array(data, split=split, comm=pc)


def tables_equal(a, b):
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            tables_equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("p", [8, 7])
@pytest.mark.parametrize("shape", [(20, 21), (5, 3, 9)])
@pytest.mark.parametrize("split", [None, 0, 1])
def test_split_tiles_geometry_and_tiles(p, shape, split):
    x = np.arange(np.prod(shape), dtype=np.float64).reshape(shape)
    r, t = both(x, split, p)
    rt, tt = RefSplitTiles(r), SplitTiles(t)
    for name in ("tile_ends_g", "tile_locations", "lshape_map", "tile_dimensions"):
        tables_equal(getattr(tt, name), getattr(rt, name))
    grid = tuple(len(e) for e in tt.tile_ends_g)
    for pos in np.ndindex(grid):
        assert tt.tile_slices(pos) == rt.tile_slices(pos)
        assert tt.get_tile_size(pos) == rt.get_tile_size(pos)
        np.testing.assert_array_equal(tt[pos].numpy(), np.asarray(rt[pos]))
    assert tt.tile_slices(0) == rt.tile_slices(0)
    with pytest.raises(TypeError):
        tt["p"]
    last = tuple(g - 1 for g in grid)
    tt[last] = -1.0
    want = x.copy()
    want[rt.tile_slices(last)] = -1.0
    np.testing.assert_array_equal(t.numpy(), want)
    assert tt.arr is t


REGIMES = [((20, 20), 0, 1), ((20, 20), 1, 2), ((40, 12), 0, 2), ((12, 40), 1, 1), ((33, 17), 0, 1),
           ((17, 33), 1, 2), ((9, 9), None, 1)]


@pytest.mark.parametrize("p", [8, 7])
@pytest.mark.parametrize("shape,split,tpp", REGIMES)
def test_square_diag_tiles_geometry(p, shape, split, tpp):
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    r, t = both(x, split, p)
    rt, tt = RefSquareDiagTiles(r, tpp), SquareDiagTiles(t, tpp)
    for name in ("tiles_per_proc", "row_indices", "col_indices", "lshape_map", "tile_rows", "tile_columns",
                 "tile_rows_per_process", "tile_columns_per_process", "last_diagonal_process", "tile_map"):
        tables_equal(getattr(tt, name), getattr(rt, name))
    for i in range(tt.tile_rows):
        for j in range(tt.tile_columns):
            assert tt.get_start_stop((i, j)) == rt.get_start_stop((i, j))
            np.testing.assert_array_equal(tt.local_get((i, j)).numpy(), np.asarray(rt.local_get((i, j))))
    for rank in range(p):
        for key in ((0, 0), (1, 0), (0, 1)):
            try:
                want = rt.local_to_global(key, rank)
            except IndexError:
                with pytest.raises(IndexError):
                    tt.local_to_global(key, rank)
                continue
            assert tt.local_to_global(key, rank) == want
    tt.local_set((0, 0), 7.0)
    want = x.copy()
    rs, re, cs, ce = rt.get_start_stop((0, 0))
    want[rs:re, cs:ce] = 7.0
    np.testing.assert_array_equal(t.numpy(), want)


def test_square_diag_match_tiles_and_errors():
    r, t = both(np.ones((30, 20), np.float32), 0, 8)
    r2, t2 = both(np.ones((25, 25), np.float32), 1, 8)
    rt, tt = RefSquareDiagTiles(r, 2), SquareDiagTiles(t, 2)
    rt.match_tiles(RefSquareDiagTiles(r2, 1))
    tt.match_tiles(SquareDiagTiles(t2, 1))
    tables_equal([tt.row_indices, tt.col_indices, tt.tile_map], [rt.row_indices, rt.col_indices, rt.tile_map])
    with pytest.raises(TypeError):
        tt.match_tiles(object())
    for bad, exc in (((np.ones(4, np.float32), 1), ValueError), ((np.ones((4, 4), np.float32), 0), ValueError),
                     ((np.ones((4, 4), np.float32), 1.5), TypeError), ((np.ones((4, 4), np.float32), True), TypeError)):
        with pytest.raises(exc):
            SquareDiagTiles(htt.array(bad[0], comm=t.comm), bad[1])
    with pytest.raises(TypeError):
        SquareDiagTiles(np.ones((4, 4)))


@pytest.mark.parametrize("p,split", [(8, None), (8, 0), (7, 1)])
def test_parter_matches_reference(p, split):
    rc, pc = comms(p)
    want = ht.utils.matrixgallery.parter(23, split=split, comm=rc)
    got = matrixgallery.parter(23, split=split, comm=pc)
    assert got.split == want.split and got.shape == tuple(want.shape) and got.dtype is htt.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want.larray).view(np.uint32))
    with pytest.raises(TypeError):
        matrixgallery.parter(3.0)


def test_profiler_names(tmp_path):
    assert set(profiler.__all__) == set(ref_profiler.__all__)
    x = torch.randn(64, 64)
    with profiler.profile(str(tmp_path)):
        with profiler.annotate("heat_tpu_torch.matmul"):
            x @ x
    trace = tmp_path / "trace.json"
    assert trace.exists()
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert "heat_tpu_torch.matmul" in names
    with profiler.timer() as t:
        x @ x
    assert t.seconds is not None and t.seconds >= 0
    with profiler.timer(sync=False) as t:
        pass
    assert t.seconds >= 0
    assert os.path.isdir(tmp_path)
