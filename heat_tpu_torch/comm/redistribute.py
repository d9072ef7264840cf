"""Planned redistribution: ``resplit`` as a planned schedule of moves.

Port of ``heat_tpu/comm/redistribute.py``.  :func:`plan` decomposes a
(src split -> dst split) change over the positions into a short schedule
of primitive steps, priced by the stdlib-only model in
:mod:`heat_tpu_torch.comm._costs` (the same arithmetic the reference's
planner delegates to, so a plan has the same steps, mode and byte figures
in both packages):

``("pad", axis, n)``
    zero-pad a ragged target axis to its canonical length ``p * ceil(n/p)``;
``("slice", axis)``
    each position keeps its own slab along ``axis`` (replicated -> split;
    no bytes move);
``("allgather", axis)``
    the split axis gathered back to full length (split -> replicated);
``("view", axis)`` / ``("assemble", axis)``
    bookkeeping around the rotations;
``("rotate", k)``
    one hop with shift ``k``: every position ships the piece of its slab
    (its source block restricted to a destination block) that position
    ``(i + k) mod p`` owns; split -> split is ``p - 1`` such hops.

Grid plans (``mesh_shape`` with two or more axes, splits tuples) chain
one such 1-D stage per mesh axis, replayed from
:func:`~heat_tpu_torch.comm._costs.grid_plan_cost`'s ``stages`` and
``stage_modes``.

**Execution on one card.**  Every position of the port shares one
device and a DNDarray is one global, canonically padded tensor, so an
exact plan moves no bytes: its result is the padded global tensor the
monolithic path gives.  Under a compressing collective precision
(``"bf16"``, ``"int8_block"``, ``"auto"``) the moving pieces ride the
wire format, as in the reference, and the result is the reference's bit
for bit: every off-diagonal piece of a split -> split stage (position
``i``'s source slab restricted to destination block ``j != i``) is
encoded and decoded, diagonal pieces stay exact; a split -> None stage
under ``"planned"`` encodes and decodes each position's slab, source axis
first, as the reference's compressed all-gather ring does (its own slab
decoded too).  Each piece is its flattened float32 in its own
row-major order, zero-padded to ``max(128, ceil(n/128) * 128)``; pieces
are cut after a ragged destination axis is padded, so the padding moves
the block boundaries exactly as it does in the reference.  Blocks never
cross pieces, so a stage encodes ALL its pieces in one
``blockquant_quantize`` launch and decodes them in one
``blockquant_dequantize`` launch, bit for bit the per-piece result.

Policy
    ``set_redistribution("planned" | "monolithic" | "auto")``, the
    reference's: ``"auto"`` (the default) plans eager split -> split
    changes of at least :func:`get_redistribution_threshold` bytes,
    ``"planned"`` every eligible change, ``"monolithic"`` none.  The
    policy token joins every ``jitted`` and ``htt.fuse`` key.

Telemetry: each executed plan opens a ``comm:resplit`` span, credits
its modeled bytes to the byte ledger under op ``"resplit"``, counts
``comm.resplit.planned`` and runs under the ``comm:resplit:step`` span
pair of :func:`~heat_tpu_torch.comm.overlap.timed_dispatch`.  One
planned resplit is one dispatch.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..core._compile import context_token, jitted, register_key_context
from ..core._tracing import in_trace
from ..telemetry import _core as _tel
from . import _costs
from . import compressed as _cq
from .compressed import BLOCK
from .overlap import overlap_enabled, timed_dispatch

__all__ = [
    "Plan",
    "get_redistribution",
    "get_redistribution_threshold",
    "grid_redistribute_or_none",
    "monolithic_model",
    "plan",
    "plan_cache_size",
    "clear_plan_cache",
    "redistribute",
    "redistribution",
    "set_redistribution",
    "set_redistribution_threshold",
]

_POLICIES = ("planned", "monolithic", "auto")
_POLICY = "auto"
#: "auto" plans only split->split changes of at least this many bytes
_AUTO_THRESHOLD = 1 << 16


# --------------------------------------------------------------------- #
# policy (mirrors compressed.set_collective_precision)                   #
# --------------------------------------------------------------------- #
def set_redistribution(policy: str) -> None:
    """Set the process-wide redistribution policy: ``"monolithic"`` (every
    layout change is the one-shot relayout), ``"planned"`` (every eligible
    eager change runs its plan) or ``"auto"`` (the default: plans for
    split -> split changes of at least
    :func:`get_redistribution_threshold` bytes)."""
    global _POLICY
    if policy not in _POLICIES:
        raise ValueError(
            f"unknown redistribution policy {policy!r}: expected one of {_POLICIES}"
        )
    _POLICY = policy


def get_redistribution() -> str:
    """The current process-wide redistribution policy."""
    return _POLICY


@contextlib.contextmanager
def redistribution(policy: str):
    """Context-manager form of :func:`set_redistribution`."""
    prev = _POLICY
    set_redistribution(policy)
    try:
        yield
    finally:
        set_redistribution(prev)


def set_redistribution_threshold(nbytes: int) -> None:
    """Minimum array size (bytes) that ``"auto"`` policy plans."""
    global _AUTO_THRESHOLD
    nbytes = int(nbytes)
    if nbytes < 0:
        raise ValueError("threshold must be non-negative")
    _AUTO_THRESHOLD = nbytes


def get_redistribution_threshold() -> int:
    """Current ``"auto"``-policy array-size threshold in bytes."""
    return _AUTO_THRESHOLD


@register_key_context
def _redist_token() -> Tuple:
    """The redistribution policy's contribution to every compiled-program
    key (``jitted`` and the ``htt.fuse`` cache): flipping the policy keys
    fresh entries."""
    return ("redist", _POLICY, _AUTO_THRESHOLD)


# --------------------------------------------------------------------- #
# the plan                                                               #
# --------------------------------------------------------------------- #
@dataclass(frozen=True)
class Plan:
    """One redistribution schedule plus its cost model (immutable and
    hashable; :attr:`key` is its program-cache signature)."""

    global_shape: Tuple[int, ...]  # TRUE (unpadded) global shape
    dtype: str                     # dtype name
    #: 1-D plans carry split ints, grid plans splits tuples
    src: Union[int, Tuple[Optional[int], ...], None]
    dst: Union[int, Tuple[Optional[int], ...], None]
    size: int
    mode: Optional[str]            # wire mode of compressible steps
    steps: Tuple[Tuple, ...]
    #: modeled bytes each position puts on the wire (mode-dependent)
    wire_bytes: int
    #: the same traffic shipped exact
    exact_wire_bytes: int
    #: modeled peak live bytes per position while the plan runs
    peak_live_bytes: int
    max_live_bytes: Optional[int] = None
    #: set on grid plans: the mesh the splits tuples index into
    mesh_shape: Optional[Tuple[int, ...]] = None

    @property
    def key(self) -> Tuple:
        return (
            self.global_shape, self.dtype, self.src, self.dst,
            self.size, self.mode, self.steps, self.mesh_shape,
        )

    @property
    def out_shape(self) -> Tuple[int, ...]:
        """Global shape of the result: the true shape with ragged
        destination axes padded to their canonical lengths."""
        shape = list(self.global_shape)
        if self.mesh_shape is not None:
            for d, g in enumerate(self.dst):
                if g is not None:
                    p = self.mesh_shape[g]
                    shape[d] = p * (-(-shape[d] // p))
            return tuple(shape)
        if self.dst is not None:
            w = -(-shape[self.dst] // self.size)
            shape[self.dst] = self.size * w
        return tuple(shape)

    def wire_model(self, compute_ms_per_step: float = 0.0) -> dict:
        """Cost-model dict in the :func:`compressed.wire_model` shape, with
        the schedule's ``critical_path_ms`` under both ring schedules
        (:func:`~heat_tpu_torch.comm._costs.critical_path_ms` at its
        default rate)."""
        exact = self.exact_wire_bytes
        hops = sum(1 for s in self.steps if s[0] == "rotate")
        return {
            "steps": len(self.steps),
            "rotate_hops_per_device": hops,
            "exact_wire_bytes": exact,
            "wire_bytes": self.wire_bytes,
            "peak_live_bytes": self.peak_live_bytes,
            "bytes_ratio": round(self.wire_bytes / exact, 4) if exact else None,
            "critical_path_ms": {
                "serial": _costs.critical_path_ms(
                    self.wire_bytes, hops, compute_ms_per_step, overlap=False
                ),
                "overlap": _costs.critical_path_ms(
                    self.wire_bytes, hops, compute_ms_per_step, overlap=True
                ),
            },
        }

    def explain(self) -> str:
        """Human-readable schedule (one line per step)."""
        head = (
            f"redistribute {self.global_shape} {self.dtype} "
            f"split {self.src} -> {self.dst} over {self.size} devices "
            f"[wire {self.wire_bytes} B/dev, peak {self.peak_live_bytes} B/dev"
            + (f", mode {self.mode}" if self.mode else "")
            + "]"
        )
        lines = [head]
        for s in self.steps:
            lines.append(f"  {s[0]}" + (f" {s[1:]}" if len(s) > 1 else ""))
        if not self.steps:
            lines.append("  (no-op)")
        return "\n".join(lines)


def _dtype_name(dtype) -> str:
    """The dtype's name as the cost model spells it (``"float32"``)."""
    if isinstance(dtype, str):
        _costs.itemsize(dtype)  # raises on an unknown name
        return dtype
    return _cq._dtype_name(dtype)


def monolithic_model(global_shape, dtype, src, dst, size: int) -> dict:
    """Per-position cost envelope of the one-shot relayout: split -> None
    an all-gather, None -> split a local slice, split -> split the
    gather-then-slice envelope the planner must beat."""
    shape = tuple(int(s) for s in global_shape)
    return _costs.monolithic_cost(shape, _costs.itemsize(_dtype_name(dtype)), src, dst, size)


#: plan cache, keyed on the request and the registered key-context
#: tokens (so policy flips re-plan)
_PLANS: dict = {}


def plan_cache_size() -> int:
    return len(_PLANS)


def clear_plan_cache() -> None:
    _PLANS.clear()


def _as_splits(spelling, ndim: int, mesh_ndim: int) -> Tuple[Optional[int], ...]:
    """A split spelling (None / int / tuple) as the splits tuple over an
    ``mesh_ndim``-axis mesh: an int is its one-hot tuple on mesh axis 0."""
    if spelling is None:
        return (None,) * ndim
    if isinstance(spelling, (tuple, list)):
        return tuple(None if g is None else int(g) for g in spelling)
    entries = [None] * ndim
    entries[int(spelling) % ndim] = 0
    return tuple(entries)


def plan(
    global_shape,
    dtype,
    src,
    dst,
    size: int,
    *,
    mesh_shape: Optional[Tuple[int, ...]] = None,
    max_live_bytes: Optional[int] = None,
) -> Plan:
    """Plan the redistribution of a ``global_shape`` array laid out at
    split ``src`` to split ``dst`` over ``size`` positions.

    ``global_shape`` is the TRUE shape; a ragged destination axis is
    padded by the schedule itself, a ragged *source* axis raises
    ``ValueError``.  With a ``mesh_shape`` of two or more axes, ``src``
    and ``dst`` are splits tuples (int/None spellings promote) and the
    schedule is :func:`~heat_tpu_torch.comm._costs.grid_plan_cost`'s
    per-mesh-axis factoring.  ``max_live_bytes`` bounds the modeled peak
    per position: a schedule that cannot fit raises ``ValueError``.
    """
    shape = tuple(int(s) for s in global_shape)
    ndim = len(shape)
    p = int(size)
    if p < 1:
        raise ValueError(f"mesh size must be >= 1, got {p}")
    dt = _dtype_name(dtype)
    grid = mesh_shape is not None and len(tuple(mesh_shape)) > 1
    if not grid and (isinstance(src, (tuple, list)) or isinstance(dst, (tuple, list))):
        # tuple spellings over a 1-D mesh are exactly their compat ints
        if isinstance(src, (tuple, list)):
            src = next((d for d, g in enumerate(src) if g == 0), None)
        if isinstance(dst, (tuple, list)):
            dst = next((d for d, g in enumerate(dst) if g == 0), None)
    if grid:
        mesh_shape = tuple(int(s) for s in mesh_shape)
        if math.prod(mesh_shape) != p:
            raise ValueError(
                f"mesh_shape {mesh_shape} does not tile {p} device(s)"
            )
        src = _as_splits(src, ndim, len(mesh_shape))
        dst = _as_splits(dst, ndim, len(mesh_shape))
        ckey = (shape, dt, src, dst, p, mesh_shape, max_live_bytes) + context_token()
        cached = _PLANS.get(ckey)
        if cached is not None:
            return cached
        p_obj = _build_grid_plan(shape, dt, src, dst, mesh_shape, max_live_bytes)
        _PLANS[ckey] = p_obj
        return p_obj
    if src is not None:
        src = int(src) % ndim
    if dst is not None:
        dst = int(dst) % ndim
    if src is not None and shape[src] % p:
        raise ValueError(
            f"ragged source axis: shape {shape} axis {src} does not divide "
            f"over {p} devices (a canonically committed input is divisible; "
            "ragged arrays live replicated and plan as src=None)"
        )
    ckey = (shape, dt, src, dst, p, max_live_bytes) + context_token()
    cached = _PLANS.get(ckey)
    if cached is not None:
        return cached
    p_obj = _build_plan(shape, dt, src, dst, p, max_live_bytes)
    _PLANS[ckey] = p_obj
    return p_obj


def _build_plan(shape, dt, src, dst, p, max_live_bytes) -> Plan:
    cost = _costs.plan_cost(
        shape, dt, src, dst, p,
        mode_for=lambda nbytes: _cq.reduce_mode(dt, nbytes),
    )
    if max_live_bytes is not None and cost["peak_live_bytes"] > max_live_bytes:
        raise ValueError(
            f"no schedule for {shape} {dt} split {src}->{dst} over {p} "
            f"devices fits max_live_bytes={max_live_bytes}: the minimal "
            f"schedule needs {cost['peak_live_bytes']} live bytes per device"
        )
    return Plan(
        global_shape=tuple(shape), dtype=dt, src=src, dst=dst, size=p,
        mode=cost["mode"], steps=cost["steps"],
        wire_bytes=int(cost["wire_bytes"]),
        exact_wire_bytes=int(cost["exact_wire_bytes"]),
        peak_live_bytes=int(cost["peak_live_bytes"]),
        max_live_bytes=max_live_bytes,
    )


def _build_grid_plan(shape, dt, src, dst, mesh_shape, max_live_bytes) -> Plan:
    cost = _costs.grid_plan_cost(
        shape, dt, src, dst, mesh_shape,
        mode_for=lambda nbytes: _cq.reduce_mode(dt, nbytes),
    )
    if max_live_bytes is not None and cost["peak_live_bytes"] > max_live_bytes:
        raise ValueError(
            f"no schedule for {tuple(shape)} {dt} splits {src}->{dst} over "
            f"mesh {tuple(mesh_shape)} fits max_live_bytes={max_live_bytes}: "
            f"the minimal factored schedule needs {cost['peak_live_bytes']} "
            "live bytes per device"
        )
    return Plan(
        global_shape=tuple(shape), dtype=dt, src=src, dst=dst,
        size=int(math.prod(mesh_shape)),
        mode=cost["mode"], steps=cost["steps"],
        wire_bytes=int(cost["wire_bytes"]),
        exact_wire_bytes=int(cost["exact_wire_bytes"]),
        peak_live_bytes=int(cost["peak_live_bytes"]),
        max_live_bytes=max_live_bytes,
        mesh_shape=tuple(mesh_shape),
    )


# --------------------------------------------------------------------- #
# execution on the global tensor                                         #
# --------------------------------------------------------------------- #
def _stages(p_obj: Plan):
    """``(mesh_shape, src splits, [((mesh axis, src dim, dst dim), mode)])``
    of a plan: one stage for a 1-D plan, :func:`grid_plan_cost`'s stages
    and wire modes for a grid plan."""
    if p_obj.mesh_shape is None:
        ndim = len(p_obj.global_shape)
        return (p_obj.size,), _as_splits(p_obj.src, ndim, 1), [((0, p_obj.src, p_obj.dst), p_obj.mode)]
    cost = _costs.grid_plan_cost(
        p_obj.global_shape, p_obj.dtype, p_obj.src, p_obj.dst, p_obj.mesh_shape,
        mode_for=lambda nbytes: _cq.reduce_mode(p_obj.dtype, nbytes),
    )
    return p_obj.mesh_shape, p_obj.src, list(zip(cost["stages"], cost["stage_modes"]))


def _pieces(t: torch.Tensor, parts, first: Optional[int] = None):
    """``t`` viewed as its pieces: each ``(dim, count)`` of ``parts`` cuts
    dimension ``dim`` into ``count`` blocks, and the block indices lead, in
    the order of ``parts``; the rest is one piece, its dimensions in
    ``t``'s order (``first``'s moved to the front).  Returns the view and
    the permutation that made it."""
    cut = dict(parts)
    view, lead, local = [], {}, []
    for d, n in enumerate(t.shape):
        if d in cut:
            view += [cut[d], int(n) // cut[d]]
            lead[d] = len(view) - 2
        else:
            view.append(int(n))
        local.append((d, len(view) - 1))
    order = [a for d, a in local if d == first] + [a for d, a in local if d != first]
    perm = [lead[d] for d, _ in parts] + order
    return t.reshape(view).permute(perm), view, perm


def _assemble(pieces: torch.Tensor, view, perm, shape) -> torch.Tensor:
    """Inverse of :func:`_pieces`: the tensor of ``shape`` the pieces cut."""
    inv = [0] * len(perm)
    for i, a in enumerate(perm):
        inv[a] = i
    return pieces.reshape([view[a] for a in perm]).permute(inv).reshape(shape).contiguous()


def _roundtrip_rows(rows: torch.Tensor, mode: str) -> torch.Tensor:
    """What each row of ``rows`` (one piece a row) is after the wire:
    its float32 zero-padded to ``max(BLOCK, ceil(n/BLOCK) * BLOCK)``,
    encoded and decoded in ONE launch of each kernel over all rows (blocks
    never cross rows), cut back and cast to the rows' type."""
    r, n = int(rows.shape[0]), int(rows.shape[1])
    padded = max(BLOCK, -(-n // BLOCK) * BLOCK)
    flat = rows.to(torch.float32)
    if padded != n:
        flat = F.pad(flat, (0, padded - n))
    out = _cq._roundtrip(flat.reshape(-1), mode, BLOCK).reshape(r, padded)
    if padded != n:
        out = out[:, :n]
    return out.to(rows.dtype)


def _off_diagonal(p: int, device) -> torch.Tensor:
    return torch.tensor([s * p + d for s in range(p) for d in range(p) if s != d],
                        dtype=torch.int64, device=device)


def _stage(t: torch.Tensor, state, mesh_shape, g: int, sd, td, mode) -> torch.Tensor:
    """One 1-D stage along mesh axis ``g`` on the global tensor ``t`` laid
    out at ``state``: the destination axis padded, and, under a wire
    mode, the moving pieces through the wire format."""
    p = mesh_shape[g]
    if td is not None:
        shape = list(t.shape)
        shape[td] = p * (-(-shape[td] // p))
        t = _pad_to(t, shape)
    if mode is None or sd is None:
        return t  # exact moves and slices: the global tensor already holds them
    # dimensions held by the other mesh axes are local inside this stage
    others = [(d, mesh_shape[h]) for d, h in enumerate(state) if h is not None and h != g]
    groups = math.prod(c for _, c in others)
    if td is None:
        # split -> None: each position's slab, source axis first, once
        # through the wire format (the compressed all-gather ring)
        pieces, view, perm = _pieces(t, others + [(sd, p)], first=sd)
        n = math.prod(pieces.shape[len(others) + 1:])
        rows = _roundtrip_rows(pieces.reshape(groups * p, n), mode)
        return _assemble(rows, view, perm, t.shape)
    # split -> split: every off-diagonal piece through the wire format
    pieces, view, perm = _pieces(t, others + [(sd, p), (td, p)])
    n = math.prod(pieces.shape[len(others) + 2:])
    flat = pieces.reshape(groups, p * p, n)
    if flat._is_view():  # written below: never into the caller's tensor
        flat = flat.clone()
    idx = _off_diagonal(p, t.device)
    moved = _roundtrip_rows(flat.index_select(1, idx).reshape(-1, n), mode)
    flat.index_copy_(1, idx, moved.reshape(groups, p * (p - 1), n))
    return _assemble(flat, view, perm, t.shape)


def _run_plan(x: torch.Tensor, p_obj: Plan) -> torch.Tensor:
    """Execute ``p_obj`` on the true-shape global tensor ``x``."""
    mesh_shape, src, stages = _stages(p_obj)
    state = list(src)
    t = x
    for (g, sd, td), mode in stages:
        t = _stage(t, state, mesh_shape, g, sd, td, mode)
        if sd is not None:
            state[sd] = None
        if td is not None:
            state[td] = g
    return t


def _pad_to(t: torch.Tensor, shape) -> torch.Tensor:
    """``t`` zero-padded at the end of each dimension to ``shape`` (no
    copy when it has that shape)."""
    if tuple(t.shape) == tuple(shape):
        return t
    pads = [0] * (2 * t.ndim)
    for d, n in enumerate(shape):
        pads[2 * (t.ndim - 1 - d) + 1] = int(n) - int(t.shape[d])
    return torch.constant_pad_nd(t, pads)


def redistribute(
    array,
    split,
    comm=None,
    *,
    src=None,
    max_live_bytes: Optional[int] = None,
):
    """Redistribute a true-shape global tensor to ``split`` by its plan,
    as one dispatch (:func:`execute`).  A tensor carries no layout, so
    ``src`` names the one it is laid out at (None: replicated).  A ragged
    destination axis comes back padded to its canonical length."""
    from ..core.communication import sanitize_comm

    comm = sanitize_comm(comm)
    if comm.mesh_ndim > 1:
        p_obj = plan(
            tuple(int(s) for s in array.shape), array.dtype, src, split,
            comm.size, mesh_shape=comm.mesh_shape,
            max_live_bytes=max_live_bytes,
        )
        return execute(array, p_obj, comm)
    p_obj = plan(
        tuple(int(s) for s in array.shape), array.dtype, src, split, comm.size,
        max_live_bytes=max_live_bytes,
    )
    return execute(array, p_obj, comm)


def grid_redistribute_or_none(array, dst_splits, comm, allow_pad: bool, src=None):
    """The grid's redistribution-policy seam behind the communicator's
    ``resplit`` / ``commit_split``: the planned result, or None when the
    change stays on the monolithic path.  ``src`` is the splits tuple the
    tensor is laid out at (None: replicated).

    Falls back under policy "monolithic", at one position, across
    processes (as the reference's), inside a trace, for 0-d and empty
    tensors, ragged sources, no-op changes and ragged destinations the
    caller does not let pad; "auto" also demands a sharded -> sharded
    change of at least :func:`get_redistribution_threshold` bytes.
    """
    policy = get_redistribution()
    if policy == "monolithic" or comm.size == 1 or comm.spans_processes:
        return None
    if in_trace() or not array.ndim:
        return None
    if any(int(s) == 0 for s in array.shape):
        return None
    mesh_shape = comm.mesh_shape
    dst = tuple(dst_splits)
    src = comm.normalize_splits(array.ndim, src)
    if any(g is not None and int(array.shape[d]) % mesh_shape[g] for d, g in enumerate(src)):
        return None  # ragged source: monolithic handles it replicated
    if src == dst:
        return None
    if not allow_pad and any(
        g is not None and int(array.shape[d]) % mesh_shape[g]
        for d, g in enumerate(dst)
    ):
        return None
    if policy == "auto" and (
        all(g is None for g in src)
        or all(g is None for g in dst)
        or array.numel() * array.element_size() < get_redistribution_threshold()
    ):
        return None
    p_obj = plan(
        tuple(int(s) for s in array.shape), array.dtype, src, dst, comm.size,
        mesh_shape=mesh_shape,
    )
    return execute(array, p_obj, comm)


def execute(array: torch.Tensor, p_obj: Plan, comm) -> torch.Tensor:
    """Run a :class:`Plan` on the true-shape global tensor ``array`` as
    one dispatch, crediting the telemetry ledger outside a trace.  No
    process holds a global tensor across processes: there a plan refuses
    (the planner is off, as the reference's)."""
    if comm.spans_processes:
        from ..core import _xproc

        _xproc.refuse("a redistribution plan")
    if tuple(int(s) for s in array.shape) != p_obj.global_shape:
        raise ValueError(
            f"plan was built for shape {p_obj.global_shape}, got {tuple(array.shape)}"
        )
    if not p_obj.steps:  # identity: the at-rest form, no program
        return _pad_to(array, p_obj.out_shape)
    plan_sig = p_obj.key  # plain data: (shape, dtype, src, dst, size, mode, steps)
    fn = jitted(("comm.resplit", comm, plan_sig), lambda: lambda x: _run_plan(x, p_obj))
    if _tel.enabled and not in_trace():
        _tel.account_bytes(
            "resplit", p_obj.mode or "f32", p_obj.exact_wire_bytes, p_obj.wire_bytes
        )
        _tel.inc("comm.resplit.planned")
        ring_ov = overlap_enabled(p_obj.size) and any(
            s[0] == "rotate" for s in p_obj.steps
        )
        with _tel.span(
            "comm:resplit",
            src=p_obj.src, dst=p_obj.dst, mesh=p_obj.size,
            steps=len(p_obj.steps), mode=p_obj.mode or "f32",
        ):
            return timed_dispatch("resplit", ring_ov, lambda: fn(array))
    return fn(array)
