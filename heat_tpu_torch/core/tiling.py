"""Tile decompositions of split arrays: host metadata over the
canonical layout.

Port of ``heat_tpu/core/tiling.py``.  ``SplitTiles`` maps every
(position x split slab) tile to its global index ranges;
``SquareDiagTiles`` is the diagonal-aligned square tile grid.  Both only
compute geometry on the host; reading a tile indexes the global tensor,
and writing one goes through ``DNDarray.__setitem__``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

__all__ = ["SplitTiles", "SquareDiagTiles"]


class SplitTiles:
    """One tile per (mesh position × split slab)
    (reference tiling.py:9-302).

    For an array split along one axis over ``size`` positions, the tile
    grid is the cartesian product of each dimension's shard boundaries.
    """

    def __init__(self, arr):
        self.__arr = arr
        comm, shape = arr.comm, arr.shape
        size = comm.size
        # per-dimension cut points: the split axis uses the shard boundaries,
        # other axes are a single slab (reference tile_ends_g, tiling.py:36-60)
        ends = []
        for dim, n in enumerate(shape):
            if dim == arr.split:
                cuts = []
                for r in range(size):
                    off, lshape, _ = comm.chunk(shape, dim, rank=r)
                    cuts.append(off + lshape[dim])
                ends.append(np.asarray(cuts, dtype=np.int64))
            else:
                ends.append(np.asarray([n], dtype=np.int64))
        self.__tile_ends = ends

    @property
    def arr(self):
        return self.__arr

    @property
    def tile_ends_g(self) -> List[np.ndarray]:
        """Global end index of every tile along every dimension."""
        return self.__tile_ends

    @property
    def tile_locations(self) -> np.ndarray:
        """Owner mesh position of each tile along the split axis
        (reference tiling.py:90-123)."""
        arr = self.__arr
        if arr.split is None:
            return np.zeros(tuple(len(e) for e in self.__tile_ends), dtype=np.int64)
        shape = tuple(len(e) for e in self.__tile_ends)
        owners = np.zeros(shape, dtype=np.int64)
        idx = [slice(None)] * len(shape)
        for r in range(shape[arr.split]):
            idx[arr.split] = r
            owners[tuple(idx)] = r
        return owners

    def tile_slices(self, pos: Tuple[int, ...]) -> Tuple[slice, ...]:
        """Global-coordinate slices of the tile at grid position ``pos``
        (partial keys select position 0 on the omitted trailing dims, like
        ``__getitem__``)."""
        if isinstance(pos, (int, np.integer)):
            pos = (pos,)
        pos = tuple(pos) + (0,) * (len(self.__tile_ends) - len(pos))
        slices = []
        for dim, p in enumerate(pos):
            if not isinstance(p, (int, np.integer)):
                raise TypeError(
                    f"tile keys must be ints, got {type(p)}"
                )  # reference tiling.py:166-171
            ends = self.__tile_ends[dim]
            start = 0 if p == 0 else int(ends[p - 1])
            slices.append(slice(start, int(ends[p])))
        return tuple(slices)

    def __getitem__(self, key):
        """The tile's data (a tensor view) at grid position ``key``."""
        return self.__arr.larray[self.tile_slices(key)]

    def __setitem__(self, key, value):
        """Overwrite the tile at grid position ``key``."""
        self.__arr[self.tile_slices(key)] = value

    @property
    def lshape_map(self) -> np.ndarray:
        """Shard-shape table of the tiled array (reference tiling.py:127)."""
        return self.__arr.lshape_map

    @property
    def tile_dimensions(self) -> List[np.ndarray]:
        """Width of every tile along every dimension
        (reference tiling.py:156-159)."""
        dims = []
        for ends in self.__tile_ends:
            starts = np.concatenate([[0], ends[:-1]])
            dims.append(ends - starts)
        return dims

    def get_tile_size(self, pos: Tuple[int, ...]) -> Tuple[int, ...]:
        """Shape of the tile at grid position ``pos``
        (reference tiling.py:264-270)."""
        return tuple(s.stop - s.start for s in self.tile_slices(pos))


class SquareDiagTiles:
    """Diagonal-aligned square tile grid (reference tiling.py:303-1258).

    Computes the reference's width-matched row/column tile decomposition
    where tiles along the global diagonal are square (``tiles_per_proc``
    knob, reference :344).  The QR routine that consumed the caching/
    match_tiles machinery is replaced by TSQR; the geometry remains for
    introspection and for algorithms that want diagonal-aligned blocking.
    """

    def __init__(self, arr, tiles_per_proc: int = 1):
        from .sanitation import sanitize_in

        sanitize_in(arr)  # reference tiling.py:349-352: TypeError contract
        if not isinstance(tiles_per_proc, (int, np.integer)) or isinstance(
            tiles_per_proc, bool
        ):
            raise TypeError(f"tiles_per_proc must be an int, got {type(tiles_per_proc)}")
        if arr.ndim != 2:
            raise ValueError("SquareDiagTiles requires a 2-D DNDarray")
        if tiles_per_proc < 1:
            raise ValueError("tiles_per_proc must be >= 1")
        self.__arr = arr
        comm = arr.comm
        size = comm.size
        m, n = arr.shape
        k = min(m, n)
        # divide the diagonal extent into size * tiles_per_proc near-equal tiles
        ntiles = max(size * tiles_per_proc, 1)
        base = k // ntiles
        rem = k % ntiles
        widths = [base + (1 if i < rem else 0) for i in range(ntiles)]
        widths = [w for w in widths if w > 0]
        row_ends = list(np.cumsum(widths))
        if row_ends and row_ends[-1] < m:
            row_ends[-1] = m  # last row tile absorbs the overhang
        col_ends = list(np.cumsum(widths))
        if col_ends and col_ends[-1] < n:
            col_ends[-1] = n
        self.__row_ends = row_ends
        self.__col_ends = col_ends
        self.__tiles_per_proc = tiles_per_proc

    @property
    def arr(self):
        return self.__arr

    @property
    def tiles_per_proc(self) -> int:
        return self.__tiles_per_proc

    @property
    def row_indices(self) -> List[int]:
        """Global start row of each tile row (reference :700-740)."""
        return [0] + self.__row_ends[:-1]

    @property
    def col_indices(self) -> List[int]:
        """Global start column of each tile column."""
        return [0] + self.__col_ends[:-1]

    def get_start_stop(self, key: Tuple[int, int]) -> Tuple[int, int, int, int]:
        """(row_start, row_stop, col_start, col_stop) of tile ``key``
        (reference tiling.py:810-930)."""
        r, c = key
        rs = 0 if r == 0 else self.__row_ends[r - 1]
        cs = 0 if c == 0 else self.__col_ends[c - 1]
        return int(rs), int(self.__row_ends[r]), int(cs), int(self.__col_ends[c])

    def __getitem__(self, key):
        """Tile data at (row, col), a tensor view."""
        rs, re, cs, ce = self.get_start_stop(key)
        return self.__arr.larray[rs:re, cs:ce]

    def __setitem__(self, key, value) -> None:
        """Overwrite tile ``(row, col)``."""
        rs, re, cs, ce = self.get_start_stop(key)
        self.__arr[rs:re, cs:ce] = value

    def local_get(self, key):
        """Alias of ``__getitem__`` (reference tiling.py:933-955; local and
        global coordinates coincide in the single-controller model)."""
        return self[key]

    def local_set(self, key, value) -> None:
        """Alias of ``__setitem__`` (reference tiling.py:957-1018)."""
        self[key] = value

    @property
    def lshape_map(self) -> np.ndarray:
        """Shard-shape table of the tiled array (reference tiling.py:701)."""
        return self.__arr.lshape_map

    @property
    def tile_rows(self) -> int:
        """Number of tile rows (reference tiling.py:791-799)."""
        return len(self.__row_ends)

    @property
    def tile_columns(self) -> int:
        """Number of tile columns (reference tiling.py:731-739)."""
        return len(self.__col_ends)

    def __per_position(self, ends: List[int], axis: int) -> List[int]:
        """Tiles along ``axis`` held by each mesh position: the full grid
        when ``axis`` is not the split axis (only the split axis is
        distributed), else the tiles overlapping the position's shard."""
        comm, shape, split = self.__arr.comm, self.__arr.shape, self.__arr.split
        if split is None or split != axis:
            return [len(ends)] * comm.size
        counts = []
        for r in range(comm.size):
            off, lshape, _ = comm.chunk(shape, axis, rank=r)
            lo, hi = off, off + lshape[axis]
            starts = [0] + list(ends[:-1])
            counts.append(
                sum(1 for s, e in zip(starts, ends) if s < hi and e > lo)
            )
        return counts

    @property
    def tile_rows_per_process(self) -> List[int]:
        """Tile rows overlapping each mesh position's shard
        (reference tiling.py:801-809: tile rows *on* each rank; with the
        canonical layout a tile may straddle two positions — it is then
        counted for both)."""
        return self.__per_position(self.__row_ends, 0)

    @property
    def tile_columns_per_process(self) -> List[int]:
        """Tile columns overlapping each mesh position's shard
        (reference tiling.py:741-749)."""
        return self.__per_position(self.__col_ends, 1)

    @property
    def last_diagonal_process(self) -> int:
        """Mesh position owning the end of the global diagonal
        (reference tiling.py:711-719)."""
        arr = self.__arr
        split = arr.split if arr.split is not None else 0
        k = min(arr.shape[0], arr.shape[1])
        _, lshape, _ = arr.comm.chunk(arr.shape, split, rank=0)
        width = max(lshape[split], 1)
        return min((k - 1) // width, arr.comm.size - 1) if k else 0

    @property
    def tile_map(self) -> np.ndarray:
        """(tile_rows, tile_columns, 3) table of [row_start, col_start,
        owner position] per tile (reference tiling.py:751-789; ownership
        follows the split axis of the canonical layout)."""
        arr = self.__arr
        rows, cols = self.row_indices, self.col_indices
        out = np.zeros((len(rows), len(cols), 3), dtype=np.int64)
        split = arr.split if arr.split is not None else 0
        _, lshape, _ = arr.comm.chunk(arr.shape, split, rank=0)
        width = max(lshape[split], 1)
        for i, rstart in enumerate(rows):
            for j, cstart in enumerate(cols):
                start = rstart if split == 0 else cstart
                owner = min(start // width, arr.comm.size - 1)
                out[i, j] = (rstart, cstart, owner)
        return out

    def __owned_tiles(self, rank: int, axis: int) -> List[int]:
        """Global tile indices along ``axis`` OWNED by ``rank`` (ownership
        = the position holding a tile's start row/column, exactly the rule
        ``tile_map`` uses — unlike the per-process overlap tables, it
        assigns each tile to one position, so prefix offsets stay exact
        even when a tile straddles shard boundaries)."""
        arr = self.__arr
        starts = self.row_indices if axis == 0 else self.col_indices
        split = arr.split if arr.split is not None else 0
        if split != axis:
            return list(range(len(starts)))
        _, lshape, _ = arr.comm.chunk(arr.shape, split, rank=0)
        width = max(lshape[split], 1)
        return [
            i for i, s in enumerate(starts)
            if min(s // width, arr.comm.size - 1) == rank
        ]

    def local_to_global(self, key: Tuple[int, int], rank: int) -> Tuple[int, int]:
        """Map a process-local tile key to the global tile grid
        (reference tiling.py:1020-1082): the local index counts the tiles
        ``rank`` owns (``tile_map`` ownership) along the split axis."""
        r, c = key
        arr = self.__arr
        if arr.split == 0 or arr.split is None:
            owned = self.__owned_tiles(rank, 0)
            if r >= len(owned):
                raise IndexError(f"rank {rank} owns {len(owned)} tile rows, got index {r}")
            return int(owned[r]), int(c)
        owned = self.__owned_tiles(rank, 1)
        if c >= len(owned):
            raise IndexError(f"rank {rank} owns {len(owned)} tile columns, got index {c}")
        return int(r), int(owned[c])

    def match_tiles(self, tiles_to_match: "SquareDiagTiles") -> None:
        """Align this grid's tile boundaries with another array's grid
        (reference tiling.py:1084-1213, used there to keep Q's tiles
        composable with R's during the tiled QR).  The boundary lists are
        adopted from ``tiles_to_match`` clipped to this array's shape,
        with the final tile absorbing any overhang — the reference's
        redistribution step is unnecessary here because the canonical
        layout never moves."""
        if not isinstance(tiles_to_match, SquareDiagTiles):
            raise TypeError(
                f"tiles_to_match must be SquareDiagTiles, got {type(tiles_to_match)}"
            )
        m, n = self.__arr.shape

        def adopt(ends: List[int], limit: int) -> List[int]:
            clipped = [int(e) for e in ends if e < limit]
            return clipped + [limit]

        self.__row_ends = adopt(tiles_to_match._SquareDiagTiles__row_ends, m)
        self.__col_ends = adopt(tiles_to_match._SquareDiagTiles__col_ends, n)
