"""Communication layer: positions, the at-rest layout, and collectives.

Port of ``heat_tpu/core/communication.py``.  The model stays
single-controller: one Python process holds every DNDarray as ONE global,
canonically padded tensor, and a communicator is a list of **positions**
(the reference's mesh positions).  Position ``r`` owns rows
``[r*c, (r+1)*c)`` of the padded split axis, ``c = ceil(n/p)``.

Each position maps to a torch device, and one device may fill several
positions, as one host fills eight mesh positions in the reference's test
rig.  This matters because the quantized ring is an identity at one
position: a one-card machine exercises it only with several positions on
that card.  While every position shares one device, a collective is a
tensor operation along the stacked ``(p, ...)`` position axis and a ring
hop is a roll along it.  Positions on different devices of one process
are not supported yet and raise :class:`NotImplementedError`.

:func:`init_multihost` starts several controller processes and installs a
**process-spanning** communicator: its positions belong to processes,
process ``k`` owning the contiguous run ``[k * pl, (k + 1) * pl)`` on its
one device (``pl`` positions each, equal everywhere).  A split DNDarray
then holds only its process's *slab* of the at-rest buffer, and a
collective is the tensor op on the process's stacked ``(pl, ...)`` axis
plus a ``torch.distributed`` call between processes
(:mod:`._xproc`: gloo, staged through host memory).  The tensor forms of
the collectives take the process's part there: the stacked ``(pl, ...)``
blocks of its positions, or its slab of a split tensor.  The planner stays
off across processes, as the reference's does; grids over processes are
refused (ROADMAP A3b2).

A communicator also has a ``mesh_shape``, ``(size,)`` by default.
:func:`grid_comm` arranges the positions on an ``r x c`` grid, over which a
layout is a *splits tuple*: ``splits[d]`` names the mesh axis that shards
array dimension ``d`` (or None), and each sharded dimension is padded to a
multiple of its own mesh axis.  The legacy ``split`` int is the tuple that
shards one dimension over mesh axis 0.  The axis forms of
:meth:`~TorchCommunication.pad_to_shards`, :meth:`~TorchCommunication.blocks`,
:meth:`~TorchCommunication.shard_width` and friends keep their 1-D reading
over all positions on a grid too: the port's ring algorithms take the
positions as one flat ring of ``size``.
"""

from __future__ import annotations

import atexit
import math
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..telemetry import _core as _tel
from . import _xproc, devices
from ._tracing import in_trace, record_dispatch

__all__ = [
    "Communication",
    "MESH_AXIS",
    "TorchCommunication",
    "get_comm",
    "use_comm",
    "sanitize_comm",
    "comm_for_device",
    "grid_comm",
    "init_multihost",
]


#: name of the positions axis (the reference's mesh axis name)
MESH_AXIS = "heat"


class Communication:
    """The communication seam every communicator implements."""


def _torch_device(d: Union[str, torch.device]) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _nbytes(array: torch.Tensor) -> int:
    return array.numel() * array.element_size()


_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _user_stacklevel() -> int:
    """``warnings.warn`` stacklevel attributing to the first frame OUTSIDE
    the package (the reference's ``communication._user_stacklevel``): a
    warning raised behind a wrapper still points at the user's line."""
    level = 2  # stacklevel=2 == the caller of the method that warns
    frame = sys._getframe(2)  # 0=this helper, 1=the warning method, 2=its caller
    while frame is not None and os.path.abspath(frame.f_code.co_filename).startswith(
        _PKG_DIR + os.sep
    ):
        frame = frame.f_back
        level += 1
    return level


class TorchCommunication(Communication):
    """A communicator over ``positions``, a sequence of torch devices (or
    their names), one entry per position.  Defaults to one position per
    visible CUDA device, or one CPU position when the default device is
    the CPU.  ``mesh_shape`` arranges the positions on a grid (row-major:
    position ``i * c + j`` is grid position ``(i, j)``); its product must
    be the number of positions.  Defaults to ``(size,)``, one axis.

    ``process`` (set by :func:`init_multihost`) is ``(rank, nprocs)``: the
    positions then span ``nprocs`` processes, ``size // nprocs`` each in
    process order, and ``positions`` lists every process's devices."""

    def __init__(
        self,
        positions: Optional[Sequence[Union[str, torch.device]]] = None,
        mesh_shape: Optional[Sequence[int]] = None,
        process: Optional[Tuple[int, int]] = None,
    ):
        if positions is None:
            dev = devices.get_device()
            if dev is devices.gpu:
                positions = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            else:
                positions = ["cpu"]
        self._positions: List[torch.device] = [_torch_device(p) for p in positions]
        if not self._positions:
            raise ValueError("a communicator needs at least one position")
        self._process: Optional[Tuple[int, int]] = None
        if process is not None and int(process[1]) > 1:
            rank, nprocs = int(process[0]), int(process[1])
            if len(self._positions) % nprocs or not 0 <= rank < nprocs:
                raise ValueError(
                    f"{len(self._positions)} position(s) do not divide over {nprocs} processes "
                    f"(process {rank})"
                )
            if mesh_shape is not None and len(tuple(mesh_shape)) > 1:
                _xproc.refuse("a position grid")
            self._process = (rank, nprocs)
        local = self._positions[self.local_position():self.local_position() + self.local_size]
        if len(set(local)) > 1:
            raise NotImplementedError(
                f"positions on several devices ({sorted(set(map(str, local)))}) "
                "are not supported yet: every position of a process must share one device"
            )
        if mesh_shape is None:
            mesh_shape = (len(self._positions),)
        mesh_shape = tuple(int(s) for s in mesh_shape)
        if any(s < 1 for s in mesh_shape) or math.prod(mesh_shape) != len(self._positions):
            raise ValueError(
                f"mesh_shape {mesh_shape} does not tile {len(self._positions)} position(s)"
            )
        self._mesh_shape = mesh_shape
        if len(mesh_shape) == 1:
            self._axis_names: Tuple[str, ...] = (MESH_AXIS,)
        else:
            self._axis_names = tuple(f"{MESH_AXIS}{i}" for i in range(len(mesh_shape)))

    # ------------------------------------------------------------------ #
    # identity                                                            #
    # ------------------------------------------------------------------ #
    @property
    def device(self) -> torch.device:
        """The torch device every position of this process lives on."""
        return self._positions[self.local_position()]

    @property
    def size(self) -> int:
        """Number of positions (the reference's mesh size)."""
        return len(self._positions)

    @property
    def rank(self) -> int:
        """Index of the controlling process: 0 without a cluster, this
        process's index in the :func:`init_multihost` group otherwise (the
        reference's ``comm.rank``, its JAX process index)."""
        return self._process[0] if self._process else _xproc.group_rank()

    def is_distributed(self) -> bool:
        """True when the communicator has more than one position."""
        return self.size > 1

    @property
    def _index(self) -> int:
        """This process's index among the processes the positions span."""
        return self._process[0] if self._process else 0

    def local_position(self) -> int:
        """The first position the calling process owns: 0 in one process,
        ``rank * local_size`` on a process-spanning communicator (the
        reference's, which :attr:`DNDarray.lshape` reads)."""
        return self._index * self.local_size

    @property
    def nprocs(self) -> int:
        """Number of processes the positions span (1 without a cluster)."""
        return self._process[1] if self._process else 1

    @property
    def local_size(self) -> int:
        """Number of positions this process owns (all of them in one
        process)."""
        return len(self._positions) // self.nprocs

    @property
    def spans_processes(self) -> bool:
        """True when the positions belong to several processes."""
        return self._process is not None

    @property
    def backend(self) -> Optional[str]:
        """The ``torch.distributed`` backend between the processes (None
        in one process)."""
        return _xproc.BACKEND if self._process else None

    @property
    def transport(self) -> Optional[str]:
        """How bytes cross between processes (None in one process)."""
        return _xproc.TRANSPORT if self._process else None

    @property
    def mesh_shape(self) -> Tuple[int, ...]:
        """The grid the positions are arranged on; ``(size,)`` on one axis."""
        return self._mesh_shape

    @property
    def mesh_ndim(self) -> int:
        """Number of mesh axes (1 unless made by :func:`grid_comm`)."""
        return len(self._mesh_shape)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        """Mesh axis names: ``("heat",)`` on one axis, ``("heat0", "heat1")``
        on a 2-D grid."""
        return self._axis_names

    def __repr__(self) -> str:
        grid = "" if self.mesh_ndim == 1 else f", mesh={'x'.join(map(str, self._mesh_shape))}"
        procs = "" if not self._process else (
            f", process {self._process[0]} of {self._process[1]} over {self.backend}")
        return f"TorchCommunication({self.size} position(s) on {self.device}{grid}{procs})"

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, TorchCommunication)
            and self._positions == other._positions
            and self._mesh_shape == other._mesh_shape
            and self._process == other._process
        )

    def __hash__(self) -> int:
        return hash((tuple(str(p) for p in self._positions), self._mesh_shape, self._process))

    # ------------------------------------------------------------------ #
    # splits tuples                                                       #
    # ------------------------------------------------------------------ #
    def normalize_splits(self, ndim: int, split) -> Tuple[Optional[int], ...]:
        """Any layout spelling as a splits tuple: ``None`` is replicated, an
        int ``s`` shards dimension ``s`` over mesh axis 0, a sequence of
        ``ndim`` mesh axes or Nones is checked and returned.  A mesh axis
        shards at most one dimension."""
        ndim = int(ndim)
        if split is None:
            return (None,) * ndim
        if isinstance(split, (tuple, list)):
            splits = tuple(None if g is None else int(g) for g in split)
            if len(splits) != ndim:
                raise ValueError(f"splits {splits} has arity {len(splits)}, array has ndim {ndim}")
            used = [g for g in splits if g is not None]
            for g in used:
                if not 0 <= g < self.mesh_ndim:
                    raise ValueError(
                        f"splits {splits}: mesh axis {g} out of range for a "
                        f"{self.mesh_ndim}-D mesh of shape {self._mesh_shape}"
                    )
            if len(set(used)) != len(used):
                raise ValueError(f"splits {splits} uses a mesh axis more than once")
            return splits
        entries: List[Optional[int]] = [None] * ndim
        entries[int(split)] = 0
        return tuple(entries)

    @staticmethod
    def split_view(splits: Tuple[Optional[int], ...]) -> Optional[int]:
        """The ``split`` int of a splits tuple: the dimension mesh axis 0
        shards (None when it shards none)."""
        for d, g in enumerate(splits):
            if g == 0:
                return d
        return None

    def _axis_size(self, mesh_axis: Optional[int] = None) -> int:
        """Positions along one mesh axis; all of them for ``None``."""
        return self.size if mesh_axis is None else int(self._mesh_shape[mesh_axis])

    # ------------------------------------------------------------------ #
    # shard geometry                                                      #
    # ------------------------------------------------------------------ #
    def chunk(
        self, shape: Sequence[int], split: Optional[int], rank: Optional[int] = None
    ) -> Tuple[int, Tuple[int, ...], Tuple[slice, ...]]:
        """``(offset, lshape, slices)`` of the shard position ``rank`` owns:
        ceil-division shards, trailing shards absorb the shortfall.  A
        splits tuple gives the grid shard of the row-major flat position
        ``rank`` (:meth:`_chunk_grid`)."""
        rank = 0 if rank is None else rank
        shape = tuple(int(s) for s in shape)
        if split is None:
            return 0, shape, tuple(slice(0, s) for s in shape)
        if isinstance(split, (tuple, list)):
            return self._chunk_grid(shape, tuple(split), rank)
        split = int(split) % max(len(shape), 1)
        n = shape[split]
        c = self.shard_width(n)
        start = min(rank * c, n)
        stop = min((rank + 1) * c, n)
        lshape = shape[:split] + (stop - start,) + shape[split + 1:]
        slices = tuple(
            slice(start, stop) if dim == split else slice(0, s) for dim, s in enumerate(shape)
        )
        return start, lshape, slices

    def _chunk_grid(
        self, shape: Tuple[int, ...], splits: Tuple[Optional[int], ...], rank: int
    ) -> Tuple[int, Tuple[int, ...], Tuple[slice, ...]]:
        """The splits-tuple shard of flat position ``rank``: each sharded
        dimension divides ceil-wise over its own mesh axis.  The offset is
        the one along the dimension mesh axis 0 shards (0 if none)."""
        splits = self.normalize_splits(len(shape), splits)
        pos = np.unravel_index(int(rank) % max(self.size, 1), self._mesh_shape)
        lshape, slices, offset0 = [], [], 0
        for n, g in zip(shape, splits):
            if g is None:
                lshape.append(n)
                slices.append(slice(0, n))
                continue
            c = self.shard_width(n, mesh_axis=g)
            start = min(int(pos[g]) * c, n)
            stop = min((int(pos[g]) + 1) * c, n)
            lshape.append(stop - start)
            slices.append(slice(start, stop))
            if g == 0:
                offset0 = start
        return offset0, tuple(lshape), tuple(slices)

    def counts_displs_shape(
        self, shape: Sequence[int], split: int
    ) -> Tuple[Tuple[int, ...], Tuple[int, ...], Tuple[int, ...]]:
        """Per-position counts and displacements along ``split``, and the
        shape of position 0's shard."""
        counts, displs = [], []
        for r in range(self.size):
            offset, lshape, _ = self.chunk(shape, split, rank=r)
            counts.append(lshape[split])
            displs.append(offset)
        _, lshape0, _ = self.chunk(shape, split, rank=0)
        return tuple(counts), tuple(displs), tuple(lshape0)

    def shard_width(self, n: int, mesh_axis: Optional[int] = None) -> int:
        """Width of every padded shard of an axis of length ``n`` over all
        positions, or over mesh axis ``mesh_axis``."""
        n = int(n)
        return -(-n // self._axis_size(mesh_axis)) if n else 0

    def padded_size(self, n: int, mesh_axis: Optional[int] = None) -> int:
        """Padded axis length ``p * shard_width(n)`` (>= n), ``p`` the
        positions along ``mesh_axis`` (all of them for None)."""
        return self._axis_size(mesh_axis) * self.shard_width(n, mesh_axis)

    def valid_counts(self, n: int, mesh_axis: Optional[int] = None) -> Tuple[int, ...]:
        """Per-position count of real (un-padded) rows of an axis of
        length ``n``, over all positions or along ``mesh_axis``."""
        c = self.shard_width(n, mesh_axis)
        n = int(n)
        return tuple(min(c, max(0, n - r * c)) for r in range(self._axis_size(mesh_axis)))

    def pad_to_shards(self, array: torch.Tensor, axis: int = 0, splits=None) -> torch.Tensor:
        """Zero-pad to the canonical padded lengths (no copy when they
        divide): ``axis`` over all positions, or, given ``splits``, every
        dimension a mesh axis shards over that mesh axis (the at-rest form
        of a DNDarray laid out at ``splits``).  On one mesh axis the two
        agree."""
        if splits is None:
            widths = {int(axis) % max(array.ndim, 1): self.padded_size(int(array.shape[axis]))}
        else:
            splits = self.normalize_splits(array.ndim, splits)
            widths = {d: self.padded_size(int(array.shape[d]), mesh_axis=g)
                      for d, g in enumerate(splits) if g is not None}
        pads = [0] * (2 * array.ndim)  # (left, right) per dimension, the last first
        for d, pn in widths.items():
            pads[2 * (array.ndim - 1 - d) + 1] = pn - int(array.shape[d])
        return torch.constant_pad_nd(array, pads) if any(pads) else array

    def unpad(self, array: torch.Tensor, n: int, axis: int = 0) -> torch.Tensor:
        """The first ``n`` entries of a padded axis (a view)."""
        if int(array.shape[axis]) == int(n):
            return array
        return array.narrow(axis, 0, int(n))

    def blocks(self, buffer: torch.Tensor, split) -> torch.Tensor:
        """View a padded buffer split at ``split`` as its stacked position
        blocks: shape ``(p,) + local block shape``.  Given a splits tuple,
        the view has shape ``mesh_shape + local block shape``: grid
        position ``(i, j)``'s block at ``[i, j]`` (a mesh axis that shards
        no dimension repeats the block along it, with stride 0), so a
        broadcast from an owner is an index into it."""
        if isinstance(split, (tuple, list)):
            return self._grid_blocks(buffer, self.normalize_splits(buffer.ndim, split))
        shape = tuple(buffer.shape)
        p = self.local_size  # a process's slab holds its own positions' blocks
        c = shape[split] // p
        view = buffer.reshape(shape[:split] + (p, c) + shape[split + 1:])
        return view.movedim(split, 0)

    def _grid_blocks(self, buffer: torch.Tensor, splits) -> torch.Tensor:
        shape, view_shape, mesh_pos, local = tuple(buffer.shape), [], {}, []
        for d, g in enumerate(splits):
            if g is not None:
                p = self._axis_size(g)
                mesh_pos[g] = len(view_shape)
                view_shape.append(p)
                local.append(len(view_shape))
                view_shape.append(shape[d] // p)
            else:
                local.append(len(view_shape))
                view_shape.append(shape[d])
        view = buffer.reshape(view_shape).permute([mesh_pos[g] for g in sorted(mesh_pos)] + local)
        for g in range(self.mesh_ndim):
            if g not in mesh_pos:
                view = view.unsqueeze(g)
        return view.expand(list(self._mesh_shape) + list(view.shape[self.mesh_ndim:]))

    # ------------------------------------------------------------------ #
    # collectives on the stacked position axis                            #
    # ------------------------------------------------------------------ #
    def allreduce(self, array: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """All-reduce a per-position quantity: ``array`` has shape
        ``(size, ...)``, one block per position; returns the combined
        ``(...)``.  A compressible ``sum`` payload rides the block-scaled
        quantized ring when the collective-precision policy asks for it."""
        if op not in ("sum", "prod", "max", "min"):
            raise ValueError(f"unsupported allreduce op {op!r}")
        n = self.size
        if int(array.shape[0]) != self.local_size:
            raise ValueError(
                f"allreduce expects one block per mesh position: leading axis "
                f"{array.shape[0]} != mesh size {n}"
                + (f" ({self.local_size} in this process)" if self.spans_processes else "")
            )
        if n == 1:
            return array[0]
        if op == "sum":
            from ..comm import compressed as _cq

            mode = _cq.reduce_mode(array.dtype, _nbytes(array) // self.local_size)
            if mode is not None:
                return _cq.allreduce_q(array, op=op, comm=self, precision=mode)
        if _tel.enabled:
            from ..comm.compressed import _account_wire

            elems = math.prod(array.shape[1:]) if array.ndim > 1 else 1
            _account_wire("allreduce", None, elems, n, comm=self)
            with _tel.span("comm:allreduce", op=op, mesh=n):
                return self._combine(self._stack_all(array), op)
        return self._combine(self._stack_all(array), op)

    def _stack_all(self, array: torch.Tensor) -> torch.Tensor:
        """Every position's block: this process's stacked ``(pl, ...)``
        blocks joined with every other process's, in position order, so a
        combine over them runs exactly as in one process (the identity in
        one process)."""
        if not self.spans_processes:
            return array
        return torch.cat(_xproc.all_gather(array), dim=0)

    @staticmethod
    def _combine(array: torch.Tensor, op: str) -> torch.Tensor:
        if op == "sum":
            return array.sum(dim=0)
        if op == "prod":
            return array.prod(dim=0)
        if op == "max":
            return array.amax(dim=0)
        return array.amin(dim=0)

    def allgather(self, array: torch.Tensor, axis: Optional[int] = 0) -> torch.Tensor:
        """Replicate a global tensor split at ``axis`` (``None``: already
        replicated).  The global tensor already holds every shard, so the
        exact form returns it unchanged; under a compressing policy a
        canonically split payload rides the quantized ring
        (:func:`heat_tpu_torch.comm.allgather_q`)."""
        if self.size > 1 and axis is not None and array.ndim:
            from ..comm import compressed as _cq

            mode = _cq.reduce_mode(array.dtype, _nbytes(array) * self.nprocs)
            if mode is not None and int(array.shape[axis]) % self.local_size == 0:
                return _cq.allgather_q(array, axis=axis, comm=self, precision=mode)
            if self.spans_processes:
                # this process's slab along ``axis`` in, the padded global out
                if _tel.enabled:
                    _cq._account_wire("allgather", None, array.numel() // self.local_size,
                                      self.size, comm=self)
                return torch.cat(_xproc.all_gather(array), dim=int(axis) % array.ndim)
            # ledger + span only when traffic would move: a replicated
            # input (axis None) makes the exact gather a no-op
            if _tel.enabled:
                _cq._account_wire("allgather", None, array.numel() // self.size, self.size)
                with _tel.span("comm:allgather", mesh=self.size):
                    # the global tensor already holds every shard
                    return self._reshard(lambda: array)
        return array

    @staticmethod
    def _reshard(relayout):
        """``relayout()``, a change of layout at rest, counted under
        ``comm.reshards`` and a ``comm:reshard`` span as the reference's
        reshard is.  Callers hold the telemetry predicate."""
        _tel.inc("comm.reshards")
        with _tel.span("comm:reshard"):
            return relayout()

    def resplit(self, array: torch.Tensor, split, src=None, gshape=None) -> torch.Tensor:
        """The at-rest form of a TRUE-shape global tensor laid out at
        ``split``: the split axis zero-padded to its canonical length.  A
        splits tuple, or any layout on a grid, pads every sharded
        dimension over its mesh axis (:meth:`pad_to_shards` ``splits=``).

        A tensor carries no layout, so ``src`` names the one it is laid
        out at (None: replicated).  The change consults the
        redistribution policy (:func:`heat_tpu_torch.comm.set_redistribution`):
        an eligible eager change runs its plan
        (:mod:`heat_tpu_torch.comm.redistribute`), which under a
        compressing collective precision sends the moving pieces through
        the wire format; everything else is the monolithic padded copy.

        The monolithic commit, outside a trace and on several positions,
        counts one dispatch (the reference's reshard,
        ``communication.py:1105``); inside an ``htt.fuse`` trace it counts
        nothing and inspects nothing on the host.

        Across processes ``array`` is this process's slab at ``src`` (the
        whole tensor when ``src`` is None), ``gshape`` the global shape,
        and the result this process's slab at ``split`` (the whole true
        tensor for None): the exact all-to-all of :meth:`_xp_relayout`."""
        return self._relayout(array, split, src, allow_pad=False, gshape=gshape)

    def _relayout(self, array: torch.Tensor, split, src, allow_pad: bool, gshape=None) -> torch.Tensor:
        """The layout change behind :meth:`resplit` and :meth:`commit_split`:
        the planned result where the policy plans it, else the monolithic
        padded copy."""
        if self.spans_processes:
            return self._xp_relayout(array, split, src, gshape)
        if self.mesh_ndim > 1 and array.ndim:
            from ..comm import redistribute as _rd

            splits = self.normalize_splits(array.ndim, split)
            out = _rd.grid_redistribute_or_none(array, splits, self, allow_pad, src=src)
            if out is not None:
                return out
        elif array.ndim:
            out = self._planned_resplit(array, split, src, allow_pad)
            if out is not None:
                return out
        if split is None or array.ndim == 0:
            return array
        if in_trace():
            # part of the enclosing program: no launch of its own to count
            return self._pad_to(array, split)
        if self.size > 1:
            record_dispatch()
            if _tel.enabled:
                return self._reshard(lambda: self._pad_to(array, split))
        return self._pad_to(array, split)

    def _xp_relayout(self, array: torch.Tensor, split, src, gshape) -> torch.Tensor:
        """A layout change across processes, exact (the planner stays off
        across processes, as the reference's ``communication.py:748``):
        replicated -> split cuts this process's slab; split -> replicated
        gathers every slab; split -> split is one all-to-all, process ``k``
        sending process ``j`` its true rows cut to ``j``'s range of the new
        axis."""
        if isinstance(split, (tuple, list)) or isinstance(src, (tuple, list)):
            _xproc.refuse("a splits-tuple layout")
        if array.ndim == 0 or split == src:
            return array
        if src is None:
            return self.slab_of(array, int(split) % array.ndim)
        if gshape is None:
            raise ValueError("a layout change across processes needs the global shape (gshape=)")
        gshape = tuple(int(v) for v in gshape)
        src = int(src) % array.ndim
        if in_trace():
            _xproc.refuse("a layout change inside a trace")
        record_dispatch()
        if split is None:
            # exact, whatever the collective precision: the planner is off
            whole = torch.cat(_xproc.all_gather(array), dim=src)
            return self.unpad(whole, gshape[src], src)
        dst = int(split) % array.ndim
        rank, nprocs = self._index, self.nprocs
        ranges_s = [self.process_rows(gshape[src], k) for k in range(nprocs)]
        ranges_d = [self.process_rows(gshape[dst], k) for k in range(nprocs)]
        a, b = ranges_s[rank]
        local = array.narrow(src, 0, b - a)
        sends, recvs = {}, {}
        for j in range(nprocs):
            a_d, b_d = ranges_d[j]
            sends[j] = local.narrow(dst, a_d, b_d - a_d).contiguous()
            shape = list(gshape)
            shape[src] = ranges_s[j][1] - ranges_s[j][0]
            shape[dst] = ranges_d[rank][1] - ranges_d[rank][0]
            recvs[j] = (shape, array.dtype)
        got = _xproc.exchange(sends, recvs, array.device)
        out = torch.cat([got[j] for j in range(nprocs)], dim=src)
        return self.pad_slab(out, gshape[dst], dst)

    def process_rows(self, n: int, rank: Optional[int] = None) -> Tuple[int, int]:
        """``[start, stop)`` of the true rows of an axis of length ``n`` that
        process ``rank`` (this one by default) owns: its positions' shards,
        clipped to ``n``."""
        rank = self._index if rank is None else int(rank)
        span = self.local_size * self.shard_width(n)
        return min(rank * span, int(n)), min((rank + 1) * span, int(n))

    def slab_of(self, array: torch.Tensor, axis: int) -> torch.Tensor:
        """This process's slab of a whole tensor along ``axis`` (true or
        padded length): its positions' rows of the padded form, a copy."""
        padded = self.pad_to_shards(array, axis=axis)
        span = self.local_size * self.shard_width(int(array.shape[axis]))
        return padded.narrow(axis, self._index * span, span).clone()

    def pad_slab(self, local: torch.Tensor, n: int, axis: int) -> torch.Tensor:
        """This process's true rows of an axis of length ``n`` zero-padded
        to its slab's length."""
        span = self.local_size * self.shard_width(n)
        have = int(local.shape[axis])
        if have == span:
            return local
        pads = [0] * (2 * local.ndim)
        pads[2 * (local.ndim - 1 - axis) + 1] = span - have
        return torch.constant_pad_nd(local, pads)

    def _planned_resplit(self, array: torch.Tensor, split, src, allow_pad: bool) -> Optional[torch.Tensor]:
        """The redistribution-policy seam on one mesh axis: the planned
        result, or None when this change stays on the monolithic path.

        Falls back (as the reference's ``_planned_resplit``) under policy
        "monolithic"; at one position; inside a trace; for 0-d and empty
        tensors; for a ragged source; when ``src == dst``; for a ragged
        destination the caller does not let pad (``resplit``;
        ``commit_split`` pads).  Policy "auto" also demands a split ->
        split change of at least
        :func:`heat_tpu_torch.comm.get_redistribution_threshold` bytes."""
        from ..comm import redistribute as _rd

        policy = _rd.get_redistribution()
        if policy == "monolithic" or self.size == 1 or in_trace():
            return None
        if any(int(s) == 0 for s in array.shape):
            return None
        ndim = array.ndim
        if isinstance(split, (tuple, list)):
            split = self.split_view(self.normalize_splits(ndim, split))
        if isinstance(src, (tuple, list)):
            src = self.split_view(self.normalize_splits(ndim, src))
        dst = None if split is None else int(split) % ndim
        src = None if src is None else int(src) % ndim
        if src is not None and int(array.shape[src]) % self.size:
            return None  # ragged source: the monolithic copy handles it
        if src == dst:
            return None
        if dst is not None and not allow_pad and int(array.shape[dst]) % self.size:
            return None
        if policy == "auto" and (
            src is None or dst is None or _nbytes(array) < _rd.get_redistribution_threshold()
        ):
            return None
        return _rd.redistribute(array, dst, comm=self, src=src)

    def _pad_to(self, array: torch.Tensor, split) -> torch.Tensor:
        if isinstance(split, (tuple, list)) or self.mesh_ndim > 1:
            return self.pad_to_shards(array, splits=self.normalize_splits(array.ndim, split))
        return self.pad_to_shards(array, axis=int(split) % array.ndim)

    def alltoall(self, array: torch.Tensor, split_axis: int, concat_axis: int, gshape=None) -> torch.Tensor:
        """Move the split from ``concat_axis`` to ``split_axis``: every
        position sends piece ``j`` of its shard (cut along ``split_axis``)
        to position ``j``, which concatenates what it receives along
        ``concat_axis`` (the reference's all-to-all).  As in the
        reference, this is :meth:`resplit` from ``concat_axis`` to
        ``split_axis``, so the redistribution policy applies: the result
        is ``array`` with ``split_axis`` zero-padded to its canonical
        length, its moving pieces through the wire format where a plan
        compresses them."""
        if self.size == 1 or array.ndim == 0:
            return array
        return self.resplit(array, int(split_axis) % array.ndim, src=int(concat_axis) % array.ndim,
                            gshape=gshape)

    def ring_permute(self, array: torch.Tensor, shift: int = 1) -> torch.Tensor:
        """Rotate the axis-0 shards around the ring: position ``i``'s shard
        moves to position ``i + shift``.  A non-divisible axis is padded
        first, so the result has the padded length."""
        n = self.size
        if n == 1:
            return array
        if self.spans_processes:
            return self._xp_move(array, [(i, (i + int(shift)) % n) for i in range(n)])
        array = self.pad_to_shards(array, axis=0)
        blocks = array.reshape((n, -1) + tuple(array.shape[1:]))
        return torch.roll(blocks, shifts=int(shift), dims=0).reshape(array.shape)

    def _xp_move(self, array: torch.Tensor, perm) -> torch.Tensor:
        """Across processes: position ``dst`` receives position ``src``'s
        axis-0 block for every pair of ``perm``, the others zeros;
        ``array`` is this process's slab (its ``local_size`` blocks), and
        each process sends one message to each process it feeds."""
        pl, first, rank = self.local_size, self.local_position(), self._index
        if int(array.shape[0]) % pl:
            raise ValueError(f"a slab of {array.shape[0]} rows does not hold {pl} equal blocks")
        blocks = array.reshape((pl, -1) + tuple(array.shape[1:]))
        out = torch.zeros_like(blocks)
        sends: Dict[int, list] = {}
        lands: Dict[int, list] = {}
        for s, d in perm:
            if s // pl == rank:
                sends.setdefault(d // pl, []).append(blocks[s - first])
            if d // pl == rank:
                lands.setdefault(s // pl, []).append(d - first)
        got = _xproc.exchange(
            {j: torch.stack(v) for j, v in sends.items()},
            {j: ((len(v),) + tuple(blocks.shape[1:]), blocks.dtype) for j, v in lands.items()},
            array.device,
        )
        for j, rows in lands.items():
            out[torch.tensor(rows, dtype=torch.int64, device=array.device)] = got[j]
        return out.reshape(array.shape)

    def commit_split(self, array: torch.Tensor, split, src=None, gshape=None) -> torch.Tensor:
        """The at-rest form of a TRUE-shape global tensor laid out at
        ``split``, as :meth:`resplit` (``src`` the layout it is at), except
        that a plan may pad a ragged destination axis (the reference's
        ``resplit`` keeps the true shape there; both give the padded form
        here)."""
        return self._relayout(array, split, src, allow_pad=True, gshape=gshape)

    def permute(self, array: torch.Tensor, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """Point-to-point exchange of axis-0 shards: for every ``(src,
        dst)`` pair of ``perm``, position ``dst`` receives position
        ``src``'s shard; positions that receive nothing get zeros.  A
        non-divisible axis is zero-padded first, so the result has the
        padded length ``padded_size(n)`` and destination block ``dst``
        carries ``valid_counts(n)[src]`` real leading rows.  Duplicate
        sources or destinations, and positions out of range, raise
        ``ValueError``."""
        n = self.size
        if n == 1:
            return array
        if not self.spans_processes:
            array = self.pad_to_shards(array, axis=0)
        perm = tuple((int(s), int(d)) for s, d in perm)
        srcs = [s for s, _ in perm]
        dsts = [d for _, d in perm]
        bad = [v for v in srcs + dsts if not 0 <= v < n]
        if bad:
            raise ValueError(f"permute: index {bad[0]} out of range for {n} shards")
        if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
            raise ValueError(
                f"permute: perm {perm} is not a partial bijection "
                "(duplicate source or destination)"
            )
        if self.spans_processes:
            return self._xp_move(array, perm)
        blocks = array.reshape((n, -1) + tuple(array.shape[1:]))
        out = torch.zeros_like(blocks)
        if perm:
            idx = lambda v: torch.tensor(v, dtype=torch.int64, device=array.device)  # noqa: E731
            out.index_copy_(0, idx(dsts), blocks.index_select(0, idx(srcs)))
        return out.reshape(array.shape)

    def bcast(self, array: torch.Tensor, root: int = 0, split: Optional[int] = None,
              n: Optional[int] = None) -> torch.Tensor:
        """Position ``root``'s shard of a global tensor split at ``split``,
        replicated: the root's block along ``split`` (its ``lshape``).  A
        tensor carries no layout, so the split is an argument here where
        the reference reads it from the array's sharding; ``None`` (a
        replicated input) returns the input."""
        if self.size == 1 or split is None or array.ndim == 0:
            return array
        if self.spans_processes:
            # this process's slab in; the root's padded block (its true
            # rows when ``n`` names the axis length) out, from its process
            split = int(split) % array.ndim
            pl = self.local_size
            c = int(array.shape[split]) // pl
            owner = int(root) // pl
            block = None
            if owner == self.rank:
                block = array.narrow(split, (int(root) - self.local_position()) * c, c)
            shape = list(array.shape)
            shape[split] = c
            out = _xproc.broadcast(block, owner, shape, array.dtype, array.device)
            if n is not None:
                out = out.narrow(split, 0, self.valid_counts(n)[int(root)])
            return out
        _, _, slices = self.chunk(tuple(array.shape), split, rank=root)
        return array[slices].clone()

    def scatter(self, array: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """Lay a replicated global tensor out so each position owns one
        block along ``axis``.  The global tensor already holds every
        block, so its values come back unchanged; across processes each
        process keeps its slab."""
        if self.spans_processes and array.ndim:
            return self.slab_of(array, int(axis) % array.ndim)
        return array

    def gather(self, array: torch.Tensor, root: int = 0, axis: Optional[int] = 0) -> torch.Tensor:
        """Collect every shard of a global tensor split at ``axis``: the
        :meth:`allgather` (every position ends up with the whole tensor;
        ``root`` is kept for the reference's signature), so a compressing
        policy puts it on the quantized ring."""
        del root
        return self.allgather(array, axis=axis)

    def reduce(self, array: torch.Tensor, op: str = "sum", root: int = 0) -> torch.Tensor:
        """Reduce a per-position quantity of shape ``(size, ...)``: the
        :meth:`allreduce` (the result is everywhere; ``root`` is kept for
        the reference's signature), so a compressing policy puts a sum on
        the quantized ring."""
        del root
        return self.allreduce(array, op=op)

    def scan(self, array: torch.Tensor, op: str = "sum", exclusive: bool = False) -> torch.Tensor:
        """Prefix-combine a per-position quantity of shape ``(size, ...)``
        across the positions: row ``r`` of the result combines rows
        ``0..r`` (``exclusive``: ``0..r-1``, and row 0 holds the op's
        identity: 0 for sum, 1 for prod, ``finfo``/``iinfo`` min for max
        and max for min).  Integer sums and products keep the input's
        type (wrapping), as the reference's."""
        if op not in ("sum", "prod", "max", "min"):
            raise ValueError(f"unsupported scan op {op!r}")
        n = self.size
        if int(array.shape[0]) != self.local_size:
            raise ValueError(
                f"scan expects one block per mesh position: leading axis "
                f"{array.shape[0]} != mesh size {n}"
            )
        if self.spans_processes:
            first = self.local_position()
            whole = self._stack_all(array)
            one = TorchCommunication([whole.device] * n)
            return one.scan(whole, op, exclusive)[first:first + self.local_size]
        if op in ("sum", "prod"):
            fn = torch.cumsum if op == "sum" else torch.cumprod
            out = fn(array, dim=0)
            if array.dtype != torch.bool:
                out = out.to(array.dtype)
            ident = 0 if op == "sum" else 1
        else:
            out = (torch.cummax if op == "max" else torch.cummin)(array, dim=0).values
            info = torch.finfo if array.dtype.is_floating_point else torch.iinfo
            ident = info(array.dtype).min if op == "max" else info(array.dtype).max
        if exclusive:
            out = torch.cat([torch.full_like(out[:1], ident), out[:-1]], dim=0)
        return out

    def exscan(self, array: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Exclusive :meth:`scan`."""
        return self.scan(array, op=op, exclusive=True)


# ---------------------------------------------------------------------- #
# process-wide default communicator                                       #
# ---------------------------------------------------------------------- #
_default_comm: Optional[TorchCommunication] = None
_device_comms: Dict[str, TorchCommunication] = {}


def comm_for_device(device) -> TorchCommunication:
    """The default communicator of a device class (cached): one position
    per visible CUDA device for the GPU, one position for the CPU."""
    device = devices.sanitize_device(device)
    key = device.device_type
    if key not in _device_comms:
        if device is devices.gpu:
            if not torch.cuda.is_available():
                raise RuntimeError("device 'gpu' requested but no CUDA device is available")
            pos = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        else:
            pos = ["cpu"]
        _device_comms[key] = TorchCommunication(pos)
    return _device_comms[key]


def get_comm() -> TorchCommunication:
    """The communicator set by :func:`use_comm`, else the default
    device's."""
    if _default_comm is not None:
        return _default_comm
    return comm_for_device(devices.get_device())


_grid_comms: Dict[Tuple, TorchCommunication] = {}


def grid_comm(
    mesh_shape: Sequence[int],
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
    positions: Optional[Sequence[Union[str, torch.device]]] = None,
) -> TorchCommunication:
    """A communicator arranging positions on a grid of ``mesh_shape``
    (mesh axes ``"heat0"``, ``"heat1"``, ...), over which ``splits``
    tuples shard several dimensions at once.  ``positions`` (also the
    second positional argument) lists one device per position, e.g.
    ``grid_comm((2, 2), ["cuda"] * 4)`` puts four positions on one card;
    without it, ``prod(mesh_shape)`` positions share the default
    communicator's device, and the communicator is cached per shape and
    device."""
    mesh_shape = tuple(int(s) for s in mesh_shape)
    if positions is None:
        positions = devices
    _xproc.refuse_across("grid_comm over processes", None)
    if positions is not None:
        return TorchCommunication(positions, mesh_shape=mesh_shape)
    device = get_comm().device
    key = (mesh_shape, str(device))
    if key not in _grid_comms:
        _grid_comms[key] = TorchCommunication([device] * math.prod(mesh_shape), mesh_shape=mesh_shape)
    return _grid_comms[key]


def use_comm(comm: Optional[TorchCommunication] = None) -> None:
    """Set the process-wide default communicator (``None`` clears it)."""
    global _default_comm
    if comm is not None and not isinstance(comm, TorchCommunication):
        raise TypeError(f"expected a TorchCommunication, got {type(comm)}")
    _default_comm = comm


def sanitize_comm(comm: Optional[TorchCommunication]) -> TorchCommunication:
    """Validate a communicator argument, substituting the default for None."""
    if comm is None:
        return get_comm()
    if not isinstance(comm, TorchCommunication):
        raise TypeError(f"expected a TorchCommunication or None, got {type(comm)}")
    return comm


def init_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
) -> TorchCommunication:
    """Start several controller processes and install the communicator
    over all their positions (the reference's ``init_multihost``, over
    ``jax.distributed.initialize``).

    Each process calls this once.  It starts the default
    ``torch.distributed`` process group, gloo, over
    ``tcp://<coordinator_address>`` with ``num_processes`` processes, this
    one ``process_id``; with no address it reads torch's ``env://``
    (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, as
    ``torchrun`` sets them).  ``local_device_ids`` lists this process's
    positions, one device each (CUDA indices, or device names such as
    ``"cpu"``); by default one position per visible CUDA device, else one
    ``"cpu"`` position.  Every process's list is exchanged once, here.
    Every process must own the same number of positions (``ValueError``
    otherwise).

    The result spans the processes in process order, then local order,
    as ``jax.devices()`` orders them, and is installed with
    :func:`use_comm`.  Between processes it moves bytes through gloo,
    staged through host memory (:attr:`TorchCommunication.transport`).
    Called again with the group up, it reinstalls the communicator.  A
    group this call starts is destroyed when the interpreter exits."""
    import torch.distributed as dist

    if local_device_ids is None:
        if torch.cuda.is_available():
            local = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        else:
            local = [torch.device("cpu")]
    else:
        ids = [local_device_ids] if isinstance(local_device_ids, (int, str, torch.device)) \
            else list(local_device_ids)
        local = [torch.device("cuda", i) if isinstance(i, int) else _torch_device(i) for i in ids]
    if not dist.is_initialized():
        if coordinator_address is None:
            dist.init_process_group(_xproc.BACKEND, init_method="env://")
        else:
            if num_processes is None or process_id is None:
                raise ValueError("init_multihost with an address needs num_processes and process_id")
            dist.init_process_group(
                _xproc.BACKEND, init_method=f"tcp://{coordinator_address}",
                world_size=int(num_processes), rank=int(process_id),
            )
        # gloo's threads must stop before the interpreter does: a process
        # that exits with the group up can abort in its teardown
        atexit.register(_xproc.shutdown)
    rank, nprocs = dist.get_rank(), dist.get_world_size()
    lists = _xproc.all_gather_object([str(d) for d in local])
    counts = sorted({len(v) for v in lists})
    if len(counts) > 1:
        raise ValueError(
            f"every process must own the same number of positions; got {[len(v) for v in lists]}"
        )
    positions = [torch.device(d) for v in lists for d in v]
    positions[rank * len(local):(rank + 1) * len(local)] = local
    comm = TorchCommunication(positions, process=(rank, nprocs))
    use_comm(comm)
    return comm
