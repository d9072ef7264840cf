"""Pure wire/memory cost arithmetic of the comm layer (stdlib only).

The port's own copy of ``heat_tpu/comm/_costs.py``, kept equal in
meaning so a plan, a ring and a grid call price to the same bytes in
both packages:

- :func:`ring_wire_model`: bytes per position for one ring collective
  (:func:`heat_tpu_torch.comm.compressed.wire_model` delegates here);
- :func:`plan_cost` / :func:`grid_plan_cost`: the planned
  redistribution's schedule and its wire/peak model
  (:func:`heat_tpu_torch.comm.redistribute.plan` delegates here, and the
  grid program replays :func:`grid_plan_cost`'s stages);
- :func:`monolithic_cost`: the one-shot relayout's envelope;
- :func:`resolve_mode`: the collective-precision policy arithmetic;
- :class:`LayoutSolver`: the cost-driven layout search over a
  layout-transfer summary, pricing every candidate with the same
  functions;
- :func:`summa_grid_model`, :func:`grid_qr_model`,
  :func:`qdwh_svd_model`: the grid linear algebra's wire models, which
  the grid calls credit the telemetry ledger from;
- :func:`stream_model`: the out-of-core stream's schedule.

It imports nothing but the standard library, so a static tool can load
it by file path.  All byte figures are PER POSITION, the telemetry
ledger's convention.  The three rates (:data:`DEFAULT_ICI_GBPS`,
:data:`DEFAULT_HOST_READ_GBPS`, :data:`DEFAULT_H2D_GBPS`) are the card's
and its host's, measured by ``chip_smoke.py``; the reference's are a TPU
link's and nominal host figures.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

__all__ = [
    "BLOCK",
    "DEFAULT_H2D_GBPS",
    "DEFAULT_HOST_READ_GBPS",
    "DEFAULT_ICI_GBPS",
    "LayoutSolver",
    "critical_path_ms",
    "encoded_bytes",
    "grid_panel_bounds",
    "grid_plan_cost",
    "grid_qr_model",
    "itemsize",
    "layout_rank",
    "monolithic_cost",
    "plan_cost",
    "qdwh_svd_model",
    "resolve_mode",
    "ring_wire_model",
    "stream_model",
    "summa_grid_model",
]

#: Quantization block length: one f32 scale per this many payload values.
#: One block is one warp-row of the Hopper kernels (32 lanes x 4 values).
BLOCK = 128

#: dtype-name → bytes per element, for the dtypes the package produces.
#: A plain table (not ``np.dtype``) keeps this module stdlib-only.
_ITEMSIZES = {
    "bool": 1, "int8": 1, "uint8": 1,
    "float16": 2, "bfloat16": 2, "int16": 2, "uint16": 2,
    "float32": 4, "int32": 4, "uint32": 4,
    "float64": 8, "int64": 8, "uint64": 8,
    "complex64": 8, "complex128": 16,
}

#: dtype names the collective-precision policy may compress; everything
#: else always rides the wire exact.
_COMPRESSIBLE = ("float32", "bfloat16")

#: Rate (GB/s) of one move between positions, the denominator of the
#: modeled wire time: a roll of the stacked ``(4, ...)`` pieces of a 64 MB
#: float32 array by one position on the card (the port's ring hop), the
#: bytes that move over device time: 790.5 GB/s, which ``chip_smoke.py``
#: phase 15 measured on an NVIDIA H100 80GB HBM3 (700.00 W power limit;
#: 731.4 GB/s at 4 MB).  The name is the reference's, whose figure is a
#: TPU link's; a planning constant, paired with measured twins.
DEFAULT_ICI_GBPS = 790.5


def critical_path_ms(
    wire_bytes: int,
    hops: int,
    compute_ms_per_step: float = 0.0,
    *,
    gbps: float = DEFAULT_ICI_GBPS,
    overlap: bool = False,
) -> float:
    """Modeled critical-path time of a ring whose ``wire_bytes`` travel
    in ``hops`` equal steps, each step followed (serial) or accompanied
    (overlap) by ``compute_ms_per_step`` of math.

    ``overlap=False`` is the strictly alternating schedule — every hop
    pays wire + compute in sequence.  ``overlap=True`` is the
    double-buffered schedule: after one warm-up hop, each step costs
    ``max(wire, compute)`` — the concurrent copy/compute roofline the overlap
    policy targets.  ``hops == 0`` degenerates to a
    single transfer plus one compute step on both schedules.
    """
    h = max(int(hops), 1)
    step_wire = (int(wire_bytes) / h) / (float(gbps) * 1e6)  # ms
    if not overlap:
        return h * (step_wire + float(compute_ms_per_step))
    return step_wire + h * max(step_wire, float(compute_ms_per_step))


#: Host read rate (GB/s) of one NetCDF-3 read (scipy's reader, the file
#: mapped, the rows copied out) of a 25.6 MB slab, 200 000 x 32 float32,
#: in the page cache: 2.76 GB/s, the median of 5 that ``chip_smoke.py``
#: phase 13 measured on the host of an NVIDIA H100 80GB HBM3 (700.00 W
#: power limit).  A planning constant: every run pairs it with a measured
#: twin.
DEFAULT_HOST_READ_GBPS = 2.76

#: Host-to-device rate (GB/s) of one ``copy_(non_blocking=True)`` of the
#: same slab from pinned memory to the card: 37.9 GB/s, the median of 5
#: ``chip_smoke.py`` phase 13 measured on an NVIDIA H100 80GB HBM3 (700.00
#: W power limit).
DEFAULT_H2D_GBPS = 37.9


def stream_model(
    chunk_bytes: int,
    chunks: int,
    compute_ms_per_chunk: float = 0.0,
    *,
    read_gbps: float = DEFAULT_HOST_READ_GBPS,
    h2d_gbps: float = DEFAULT_H2D_GBPS,
    prefetch: bool = True,
) -> dict:
    """Modeled time of an out-of-core streaming fit: ``chunks`` slabs of
    ``chunk_bytes`` each read from storage, copied host to device, and
    consumed by one chunk update of ``compute_ms_per_chunk``.

    Serial is ``h (read + copy + compute)``; the double-buffered schedule
    hides the ingest stage behind compute after one warm-up slab,
    ``(read + copy) + h max(read + copy, compute)``.  ``peak_host_slabs``
    is the schedule's host-memory bound (two live slabs overlapped, one
    serial), which :func:`heat_tpu_torch.io.stream.slab_peak` is held
    against.  ``bound`` names the side the overlapped schedule sits on:
    ``"ingest"`` when read + copy > compute, else ``"compute"``.
    """
    h = max(int(chunks), 1)
    cb = int(chunk_bytes)
    read_ms = cb / (float(read_gbps) * 1e6)
    h2d_ms = cb / (float(h2d_gbps) * 1e6)
    stage_ms = read_ms + h2d_ms
    compute_ms = float(compute_ms_per_chunk)
    serial_ms = h * (stage_ms + compute_ms)
    overlapped_ms = stage_ms + h * max(stage_ms, compute_ms)
    best_ms = overlapped_ms if prefetch else serial_ms
    return {
        "chunks": h,
        "chunk_bytes": cb,
        "read_ms_per_chunk": read_ms,
        "h2d_ms_per_chunk": h2d_ms,
        "compute_ms_per_chunk": compute_ms,
        "serial_ms": serial_ms,
        "overlapped_ms": overlapped_ms,
        "speedup": serial_ms / overlapped_ms if overlapped_ms > 0.0 else 1.0,
        "prefetch": bool(prefetch),
        "peak_host_slabs": 2 if prefetch else 1,
        "bound": "ingest" if stage_ms >= compute_ms else "compute",
        "modeled_ms": best_ms,
    }


def itemsize(dtype_name: str) -> int:
    """Bytes per element of a canonical dtype name (e.g. ``"float32"``)."""
    try:
        return _ITEMSIZES[str(dtype_name)]
    except KeyError:
        raise ValueError(f"unknown dtype name {dtype_name!r}") from None


def resolve_mode(
    dtype_name: str,
    payload_nbytes: int,
    precision: str = "f32",
    threshold: int = 1 << 16,
) -> Optional[str]:
    """Wire mode a payload rides under the given precision policy.

    Returns ``"bf16"`` / ``"int8_block"``, or ``None`` for exact
    transmission — the same decision table as
    :func:`heat_tpu_torch.comm.compressed.reduce_mode` with the process-global
    policy passed in explicitly (that function delegates here after its
    own contract checks).
    """
    if precision == "f32" or precision is None:
        return None
    if str(dtype_name) not in _COMPRESSIBLE:
        return None
    if precision == "auto":
        return "int8_block" if int(payload_nbytes) >= int(threshold) else None
    return precision


def encoded_bytes(n_elems: int, mode: Optional[str], item: int) -> int:
    """Bytes one payload of ``n_elems`` occupies on the wire under
    ``mode`` (block-padded; one f32 scale per :data:`BLOCK` for int8)."""
    if mode is None:
        return int(n_elems) * int(item)
    padded = max(BLOCK, -(-int(n_elems) // BLOCK) * BLOCK)
    if mode == "int8_block":
        return padded + (padded // BLOCK) * 4
    return padded * 2  # bf16


def ring_wire_model(n_elems: int, size: int, mode: Optional[str], *,
                    block: int = BLOCK, op: str = "allreduce") -> dict:
    """Bytes-moved model for one ring collective, per device.

    The single source of the 0.258x claim: exact f32 ships 4 B/element,
    ``int8_block`` 1 B/element plus one f32 scale per ``block`` elements
    (132/512 per 128-block), ``bf16`` 2 B/element.  ``op="allreduce"``
    models the reduce-scatter + all-gather ring (each device sends
    ``2*(size-1)`` chunks of ``ceil(n/size)`` elements padded to the
    block grid); ``op="allgather"`` the one-way ring (``size-1`` hops of
    the ``n_elems``-element local shard).
    """
    p = max(int(size), 1)
    if op == "allreduce":
        chunk = -(-int(n_elems) // p)
        hops = 2 * (p - 1)
    elif op == "allgather":
        chunk = int(n_elems)
        hops = p - 1
    else:
        raise ValueError(f"unknown ring op {op!r}")
    chunk_p = -(-chunk // int(block)) * int(block)
    exact = hops * chunk_p * 4
    if mode == "int8_block":
        wire = hops * (chunk_p + (chunk_p // int(block)) * 4)
    elif mode == "bf16":
        wire = hops * chunk_p * 2
    else:  # exact transmission (policy answered None / "f32")
        wire = exact
    return {
        "ring_hops_per_device": hops,
        "chunk_elems_padded": chunk_p,
        "exact_wire_bytes": exact,
        "wire_bytes": wire,
        "bytes_ratio": round(wire / exact, 4) if exact else None,
    }


def _nelems(shape: Tuple[int, ...]) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def monolithic_cost(shape: Tuple[int, ...], item: int,
                    src: Optional[int], dst: Optional[int], size: int) -> dict:
    """Per-position cost envelope of the one-shot relayout.

    split→None is an all-gather (``(p-1)/p`` of the array per device; the
    full array live).  None→split is a local slice (zero wire).
    split→split is modeled as the reference ``Alltoallv``'s envelope —
    the general lowering gathers then slices, so the wire bytes are
    the all-gather's and the peak briefly holds the full array plus the
    input shard.
    """
    p = max(int(size), 1)
    total = _nelems(shape) * int(item)
    if p == 1 or src == dst or (src is None and dst is None):
        return {"exact_wire_bytes": 0, "wire_bytes": 0, "peak_live_bytes": total}
    if src is None:  # replicated -> split: local slice
        return {
            "exact_wire_bytes": 0,
            "wire_bytes": 0,
            "peak_live_bytes": total + total // p,
        }
    gather = (p - 1) * (total // p)  # each device receives p-1 foreign shards
    peak = total + total // p  # full array + own shard live at the boundary
    return {"exact_wire_bytes": gather, "wire_bytes": gather, "peak_live_bytes": peak}


def plan_cost(
    shape: Tuple[int, ...],
    dtype_name: str,
    src: Optional[int],
    dst: Optional[int],
    size: int,
    *,
    mode_for: Optional[Callable[[int], Optional[str]]] = None,
    overlap: bool = False,
) -> dict:
    """Schedule + cost model of the planned redistribution.

    The arithmetic half of :func:`heat_tpu_torch.comm.redistribute.plan`:
    returns ``{steps, mode, wire_bytes, exact_wire_bytes,
    peak_live_bytes}`` for a ``shape`` array committed at split ``src``
    moving to split ``dst`` over ``size`` devices.  ``mode_for`` maps a
    wire payload's byte count to its compression mode (defaults to exact
    transmission); the runtime passes the live collective-precision
    policy, the static analyzer whatever policy it is asked to model.

    ``overlap=True`` models the pipelined rotation schedule (two pieces
    in flight instead of one): wire bytes are unchanged, the split→split
    peak grows by one piece (plus its f32 staging when compressed).

    Steps and figures are identical to the runtime planner's — the
    runtime delegates here, so they cannot diverge.
    """
    shape = tuple(int(s) for s in shape)
    item = itemsize(dtype_name)
    p = max(int(size), 1)
    n = _nelems(shape)
    total = n * item
    mode_for = mode_for or (lambda nbytes: None)

    if p == 1 or src == dst or not shape or n == 0:
        at_rest = total if src is None else total // p
        return {
            "steps": (), "mode": None, "wire_bytes": 0,
            "exact_wire_bytes": 0, "peak_live_bytes": at_rest,
        }

    if dst is not None:
        w_d = -(-shape[dst] // p)
        pad_d = p * w_d - shape[dst]

    if src is None:
        # replicated -> split: pure local slice-discard, zero wire.
        steps = []
        if pad_d:
            steps.append(("pad", dst, shape[dst]))
        steps.append(("slice", dst))
        padded_total = (n // shape[dst]) * (p * w_d) * item
        peak = padded_total + padded_total // p  # full input + own slab
        return {
            "steps": tuple(steps), "mode": None, "wire_bytes": 0,
            "exact_wire_bytes": 0, "peak_live_bytes": peak,
        }

    if dst is None:
        # split -> replicated: all-gather fraction.  Each device ships
        # its shard p-1 times around the ring; mode compresses the
        # payload.
        shard_elems = n // p
        mode = mode_for(shard_elems * item)
        exact = (p - 1) * shard_elems * item
        wire = (p - 1) * encoded_bytes(shard_elems, mode, item)
        peak = total // p + total  # own shard + assembled full array
        if mode is not None:
            peak += shard_elems * 4  # f32 staging of the encoded payload
        return {
            "steps": (("allgather", src),), "mode": mode, "wire_bytes": wire,
            "exact_wire_bytes": exact, "peak_live_bytes": peak,
        }

    # split -> split: p-1 ppermute rotations over 1/p²-sized pieces.
    # Wire (p-1)/p² of the array per device — p× less than gather+slice —
    # and peak = input shard + output shard + one piece in flight.
    w_s = shape[src] // p
    rest = n // shape[src] // shape[dst]  # elements off the two split axes
    piece_elems = w_s * w_d * rest
    mode = mode_for(piece_elems * item)
    steps = []
    if pad_d:
        steps.append(("pad", dst, shape[dst]))
    steps.append(("view", dst))
    steps.extend(("rotate", k) for k in range(1, p))
    steps.append(("assemble", src))
    exact = (p - 1) * piece_elems * item
    wire = (p - 1) * encoded_bytes(piece_elems, mode, item)
    slab = p * piece_elems * item  # == padded input shard == output shard
    in_flight = 2 if overlap else 1  # pipelined rotations double-buffer
    peak = 2 * slab + in_flight * piece_elems * item
    if mode is not None:
        peak += in_flight * piece_elems * 4  # f32 staging of encoded pieces
    return {
        "steps": tuple(steps), "mode": mode, "wire_bytes": wire,
        "exact_wire_bytes": exact, "peak_live_bytes": peak,
    }


def _dim_of(layout, g: int) -> Optional[int]:
    """Array dim sharded by mesh axis ``g`` under ``layout`` (splits
    tuple: ``layout[d]`` is the mesh axis sharding dim ``d``)."""
    for d, x in enumerate(layout):
        if x == g:
            return d
    return None


def _check_splits(name: str, splits, ndim: int, mesh_ndim: int) -> Tuple:
    splits = tuple(None if g is None else int(g) for g in splits)
    if len(splits) != ndim:
        raise ValueError(
            f"{name} splits {splits} has arity {len(splits)} for a "
            f"{ndim}-dimensional shape"
        )
    seen = set()
    for g in splits:
        if g is None:
            continue
        if not 0 <= g < mesh_ndim:
            raise ValueError(
                f"{name} splits {splits}: mesh axis {g} out of range for a "
                f"{mesh_ndim}-axis mesh"
            )
        if g in seen:
            raise ValueError(f"{name} splits {splits}: mesh axis {g} used twice")
        seen.add(g)
    return splits


def grid_plan_cost(
    shape: Tuple[int, ...],
    dtype_name: str,
    src_splits: Tuple[Optional[int], ...],
    dst_splits: Tuple[Optional[int], ...],
    mesh_shape: Tuple[int, ...],
    *,
    mode_for: Optional[Callable[[int], Optional[str]]] = None,
    overlap: bool = False,
) -> dict:
    """Schedule + cost model of a planned N-D (grid) redistribution.

    Factors the (``src_splits`` → ``dst_splits``) layout change into a
    short sequence of per-mesh-axis 1-D **stages**, each priced by
    :func:`plan_cost` over the sub-mesh of that axis.  The greedy
    ordering moves each mesh axis directly (``src dim → dst dim``) when
    its target dim is free; a cyclic layout transpose (e.g. ``(0, 1) →
    (1, 0)`` on a 2-D mesh) is broken by routing one axis through
    replicated, exactly like the 1-D planner's split→None→split escape
    hatch.  Every stage's 1-D cost is evaluated on the stage-local
    extents — dims held sharded by *other* mesh axes enter at their local
    (padded) widths — so wire bytes are the sum of stage wires and the
    modeled peak is the max of stage peaks.

    Source-sharded dims must divide their mesh axis (the canonical
    commit invariant; ragged arrays reach planners replicated, as in the
    1-D contract).  Returns the :func:`plan_cost` dict extended with
    ``stages`` (``(mesh_axis, src_dim, dst_dim)`` triples — the runtime
    program builder replays exactly these) and ``out_shape`` (the true
    shape with ragged destination dims padded).  Step tuples carry the
    mesh axis as their second element: ``("rotate", g, k)``.
    """
    shape = tuple(int(s) for s in shape)
    ndim = len(shape)
    mesh_shape = tuple(max(int(p), 1) for p in mesh_shape)
    mesh_ndim = len(mesh_shape)
    src = _check_splits("source", src_splits, ndim, mesh_ndim)
    dst = _check_splits("destination", dst_splits, ndim, mesh_ndim)
    item = itemsize(dtype_name)
    mode_for = mode_for or (lambda nbytes: None)
    for d, g in enumerate(src):
        if g is not None and shape[d] % mesh_shape[g]:
            raise ValueError(
                f"ragged source axis: shape {shape} dim {d} does not divide "
                f"over {mesh_shape[g]} devices along mesh axis {g} (a "
                "canonically committed input is divisible; ragged dims live "
                "replicated and plan as src=None)"
            )

    # greedy stage factoring over the mesh axes whose dim assignment moves
    state = list(src)
    remaining = {g for g in range(mesh_ndim) if _dim_of(state, g) != _dim_of(dst, g)}
    stages = []
    while remaining:
        progressed = False
        for g in sorted(remaining):
            sd, td = _dim_of(state, g), _dim_of(dst, g)
            if td is not None and state[td] is not None and state[td] != g:
                continue  # target dim held by another mesh axis: blocked
            stages.append((g, sd, td))
            if sd is not None:
                state[sd] = None
            if td is not None:
                state[td] = g
            remaining.discard(g)
            progressed = True
        if not progressed:
            # cyclic layout transpose: break the lowest blocked axis's
            # move through replicated; its None→dst leg runs once the
            # axis holding its target dim has moved off
            g = min(remaining)
            sd = _dim_of(state, g)
            stages.append((g, sd, None))
            state[sd] = None

    # price each stage on its stage-local extents
    ext = list(shape)  # current padded global extents
    state = list(src)
    steps, stage_modes = [], []
    wire = exact = 0
    at_rest = _nelems(shape) * item
    for g in (x for x in src if x is not None):
        at_rest //= mesh_shape[g]
    peak = at_rest
    for g, sd, td in stages:
        p = mesh_shape[g]
        eff = []
        for d in range(ndim):
            h = state[d]
            if d in (sd, td) or h is None or h == g:
                eff.append(ext[d])
            else:
                eff.append(ext[d] // mesh_shape[h])  # local width elsewhere
        sub = plan_cost(
            tuple(eff), dtype_name, sd, td, p, mode_for=mode_for, overlap=overlap
        )
        steps.extend((s[0], g) + s[1:] for s in sub["steps"])
        stage_modes.append(sub["mode"])
        wire += sub["wire_bytes"]
        exact += sub["exact_wire_bytes"]
        peak = max(peak, sub["peak_live_bytes"])
        if sd is not None:
            state[sd] = None
        if td is not None:
            state[td] = g
            ext[td] = p * (-(-ext[td] // p))
    mode = next((m for m in stage_modes if m is not None), None)
    out_shape = list(shape)
    for d, g in enumerate(dst):
        if g is not None:
            p = mesh_shape[g]
            out_shape[d] = p * (-(-out_shape[d] // p))
    return {
        "steps": tuple(steps), "mode": mode, "wire_bytes": int(wire),
        "exact_wire_bytes": int(exact), "peak_live_bytes": int(peak),
        "stages": tuple(stages), "stage_modes": tuple(stage_modes),
        "out_shape": tuple(out_shape),
    }


def layout_rank(layout) -> Tuple:
    """Deterministic total order over layout spellings — the solver's
    tie-break.  Replicated sorts first, then int splits by axis, then
    splits tuples entrywise (``None`` entries below mesh axes), so equal
    argmin costs always resolve to the same plan on every run."""
    if layout is None:
        return (0, ())
    if isinstance(layout, tuple):
        return (2, tuple(-1 if g is None else int(g) for g in layout))
    return (1, (int(layout),))


def _one_hot(layout, ndim: int, mesh_ndim: int):
    """Promote the 1-D compat spelling to a splits tuple on mesh axis 0
    (the ``normalize_splits`` convention); tuples pass through."""
    if isinstance(layout, tuple):
        return tuple(None if g is None else int(g) for g in layout)
    out = [None] * int(ndim)
    if layout is not None:
        out[int(layout)] = 0
    return tuple(out)


class LayoutSolver:
    """Cost-driven auto-layout search over a layout-transfer summary.

    The solver behind the reference's ``autoshard``.  Input is a
    *layout-transfer summary* — plain data exported by
    a static layout analysis — whose ``seams`` are the
    pipeline's layout-change events in program order, each carrying a
    literal shape/dtype, the hand-placed ``src``/``dst`` layouts, chain
    provenance (``prev``: the seam producing this seam's operand, when
    that intermediate is dead), and the op layer's declared layout
    ``alternatives`` (``core/_split_semantics.layout_alternatives``).

    Search space: for every chain of seams over one value, each
    non-pinned intermediate placement ranges over the declared
    alternatives (1-D splits and splits tuples); the chain's final
    placement stays pinned to the hand layout, so a solved pipeline is a
    drop-in — identical output metadata, bitwise-identical values.
    Choosing the incoming layout again elides the seam entirely.  Each
    seam additionally prices its collective-precision arm
    (``choose_precision=True``: the ambient-policy mode vs exact f32 —
    block padding and scale rows make compression a *loss* on small
    payloads, which ``resolve_mode``'s threshold alone cannot see).

    Objective (lexicographic): total ``wire_bytes``, then total
    :func:`critical_path_ms` under the solver's overlap arm (so the
    double-buffered schedule is priced, not just byte counts),
    then :func:`layout_rank` of the placement path — a deterministic
    tie-break, identical plan on every run.  Exact dynamic programming
    per chain; ``beam_width`` bounds the per-position frontier for large
    alternative sets (pruning is by the same objective, so it stays
    deterministic).  Locked ``matmul`` seams ride along in both totals
    via :func:`summa_grid_model` — priced, never re-placed (v1).

    Stdlib-only on purpose: the static analyzer loads this file by path,
    and the runtime delegates to the same arithmetic, so the plan a
    pipeline executes and the bytes its ledger is credited with cannot
    drift from the numbers solved here.
    """

    def __init__(
        self,
        size: Optional[int] = None,
        *,
        mesh_shape: Optional[Tuple[int, ...]] = None,
        precision: Optional[str] = "f32",
        threshold: int = 1 << 16,
        overlap: bool = False,
        compute_ms_per_step: float = 0.0,
        gbps: float = DEFAULT_ICI_GBPS,
        beam_width: int = 64,
        choose_precision: bool = False,
    ):
        if mesh_shape is not None:
            self.mesh_shape = tuple(max(int(p), 1) for p in mesh_shape)
            self.size = 1
            for p in self.mesh_shape:
                self.size *= p
        else:
            self.size = max(int(size if size is not None else 1), 1)
            self.mesh_shape = None
        self.precision = precision
        self.threshold = int(threshold)
        self.overlap = bool(overlap)
        self.compute_ms_per_step = float(compute_ms_per_step)
        self.gbps = float(gbps)
        self.beam_width = max(int(beam_width), 1)
        self.choose_precision = bool(choose_precision)

    # ------------------------------------------------------------------ #
    # pricing                                                             #
    # ------------------------------------------------------------------ #
    def price(self, shape, dtype_name, src, dst, *, choose=None) -> dict:
        """Price one layout change with the runtime's own arithmetic.

        Tuple spellings (or any solver built with ``mesh_shape``) route
        through :func:`grid_plan_cost`; the 1-D compat spelling through
        :func:`plan_cost`.  With ``choose`` (default: the solver's
        ``choose_precision``) the cheaper of the ambient-policy mode and
        exact transmission wins, ties to exact.
        """
        shape = tuple(int(s) for s in shape)
        choose = self.choose_precision if choose is None else bool(choose)
        grid = self.mesh_shape is not None and (
            len(self.mesh_shape) > 1
            or isinstance(src, tuple) or isinstance(dst, tuple)
        )

        def ambient(nbytes):
            return resolve_mode(dtype_name, nbytes, self.precision, self.threshold)

        arms = [ambient]
        if choose:
            arms.append(lambda nbytes: None)
        best = None
        for mode_for in arms:
            if grid:
                plan = grid_plan_cost(
                    shape, dtype_name,
                    _one_hot(src, len(shape), len(self.mesh_shape)),
                    _one_hot(dst, len(shape), len(self.mesh_shape)),
                    self.mesh_shape, mode_for=mode_for, overlap=self.overlap,
                )
            else:
                plan = plan_cost(
                    shape, dtype_name, src, dst, self.size,
                    mode_for=mode_for, overlap=self.overlap,
                )
            hops = sum(1 for s in plan["steps"] if s[0] == "rotate")
            arm = {
                "wire_bytes": plan["wire_bytes"],
                "exact_wire_bytes": plan["exact_wire_bytes"],
                "peak_live_bytes": plan["peak_live_bytes"],
                "mode": plan["mode"],
                "hops": hops,
                "critical_path_ms": {
                    "serial": critical_path_ms(
                        plan["wire_bytes"], hops, self.compute_ms_per_step,
                        gbps=self.gbps, overlap=False,
                    ),
                    "overlap": critical_path_ms(
                        plan["wire_bytes"], hops, self.compute_ms_per_step,
                        gbps=self.gbps, overlap=True,
                    ),
                },
            }
            key = (arm["wire_bytes"], 0 if arm["mode"] is None else 1)
            if best is None or key < best[0]:
                best = (key, arm)
        return best[1]

    def matmul_cost(self, m: int, k: int, n: int, *, mode=None) -> dict:
        """Locked-rider pricing of a matmul seam: the grid SUMMA model on
        this solver's mesh (1-D meshes price as a degenerate ``(p, 1)``
        grid — the row-ring panel schedule)."""
        mesh = self.mesh_shape if (
            self.mesh_shape is not None and len(self.mesh_shape) == 2
        ) else (self.size, 1)
        return summa_grid_model(
            m, k, n, mesh, mode=mode, overlap=self.overlap,
            compute_ms_per_step=self.compute_ms_per_step, gbps=self.gbps,
        )

    # ------------------------------------------------------------------ #
    # search                                                              #
    # ------------------------------------------------------------------ #
    def _cp(self, priced: dict) -> float:
        return priced["critical_path_ms"]["overlap" if self.overlap else "serial"]

    def _candidates(self, seam: dict, locked: bool):
        hand = seam["dst"]
        if locked:
            return [hand]
        alts = seam.get("alternatives") or ()
        cands = list(alts)
        if hand not in cands:
            cands.append(hand)
        cands.sort(key=layout_rank)
        return cands

    def solve(self, summary: dict) -> dict:
        """Search the summary's layout space; return the argmin plan.

        The plan is plain data: per-seam ``decisions`` keyed by the
        runtime signature ``(shape, dtype, solved-incoming layout,
        hand-requested layout)`` — what ``manipulations.resplit`` sees at
        the call site under the solved plan — plus solved and hand
        totals and a stable ``fingerprint`` (part of the fuse cache key).
        """
        import hashlib

        seams = [dict(s) for s in summary.get("seams", ())]
        by_index = {s["index"]: s for s in seams}
        next_of = {}
        for s in seams:
            prev = s.get("prev")
            if prev is not None and prev in by_index:
                next_of[prev] = s["index"]
        heads = [
            s["index"] for s in seams
            if s["op"] in ("resplit", "noop_collective")
            and (s.get("prev") is None or s["prev"] not in by_index)
        ]

        decisions = []
        totals = {"wire": 0, "exact": 0, "cp_serial": 0.0, "cp_overlap": 0.0}
        hand = {"wire": 0, "exact": 0, "cp_serial": 0.0, "cp_overlap": 0.0}

        def _tally(bucket, priced):
            bucket["wire"] += priced["wire_bytes"]
            bucket["exact"] += priced["exact_wire_bytes"]
            bucket["cp_serial"] += priced["critical_path_ms"]["serial"]
            bucket["cp_overlap"] += priced["critical_path_ms"]["overlap"]

        for s in seams:
            if s["op"] == "matmul":
                if s.get("shape") is not None and len(s["shape"]) == 3:
                    m, k, n = (int(x) for x in s["shape"])
                    rider = self.matmul_cost(m, k, n)
                    for bucket in (totals, hand):
                        bucket["wire"] += rider["wire_bytes"]
                        bucket["exact"] += rider["exact_wire_bytes"]
                        bucket["cp_serial"] += rider["critical_path_ms"]["serial"]
                        bucket["cp_overlap"] += rider["critical_path_ms"]["overlap"]
                continue
            _tally(hand, self.price(
                s["shape"], s["dtype"], s["src"], s["dst"], choose=False
            ))
            if s["op"] == "implicit_resplit":
                # locked v1: the binary-op anchor stays; priced, not moved
                priced = self.price(
                    s["shape"], s["dtype"], s["src"], s["dst"], choose=False
                )
                _tally(totals, priced)
                decisions.append(self._decision(s, s["src"], s["dst"], priced))

        for head in sorted(heads):
            chain = [by_index[head]]
            while chain[-1]["index"] in next_of:
                chain.append(by_index[next_of[chain[-1]["index"]]])
            entry = chain[0]["src"]
            # frontier: layout -> (wire, cp, rank-path, placements)
            frontier = {entry: (0, 0.0, (), ())}
            priced_edges = []
            for pos, seam in enumerate(chain):
                last = pos == len(chain) - 1
                locked = last or bool(seam.get("pinned"))
                cands = self._candidates(seam, locked)
                nxt = {}
                edge_prices = {}
                for lay in sorted(frontier, key=layout_rank):
                    w, cp, rp, path = frontier[lay]
                    for cand in cands:
                        p = self.price(seam["shape"], seam["dtype"], lay, cand)
                        edge_prices[(lay, cand)] = p
                        tup = (
                            w + p["wire_bytes"], cp + self._cp(p),
                            rp + (layout_rank(cand),), path + ((lay, cand),),
                        )
                        cur = nxt.get(cand)
                        if cur is None or tup[:3] < cur[:3]:
                            nxt[cand] = tup
                if len(nxt) > self.beam_width:
                    keep = sorted(nxt, key=lambda c: nxt[c][:3])[: self.beam_width]
                    nxt = {c: nxt[c] for c in keep}
                frontier = nxt
                priced_edges.append(edge_prices)
            final = min(frontier, key=lambda c: frontier[c][:3])
            _, _, _, path = frontier[final]
            for pos, (seam, (incoming, chosen)) in enumerate(zip(chain, path)):
                p = priced_edges[pos][(incoming, chosen)]
                _tally(totals, p)
                decisions.append(self._decision(seam, incoming, chosen, p))

        decisions.sort(key=lambda d: d["seam"])
        canonical = (
            "autoshard-plan", summary.get("function"),
            self.mesh_shape or self.size, self.precision, self.threshold,
            self.overlap, self.choose_precision,
            tuple(
                (d["seam"], d["shape"], d["dtype"],
                 layout_rank(d["src"]), layout_rank(d["requested"]),
                 layout_rank(d["apply"]), d["mode"], d["wire_bytes"])
                for d in decisions
            ),
        )
        fingerprint = hashlib.sha256(repr(canonical).encode()).hexdigest()[:16]
        return {
            "function": summary.get("function"),
            "fingerprint": fingerprint,
            "mesh": self.mesh_shape or self.size,
            "precision": self.precision,
            "overlap": self.overlap,
            "decisions": decisions,
            "modeled_wire_bytes": totals["wire"],
            "modeled_exact_bytes": totals["exact"],
            "modeled_critical_path_ms": {
                "serial": totals["cp_serial"], "overlap": totals["cp_overlap"],
            },
            "hand_wire_bytes": hand["wire"],
            "hand_exact_bytes": hand["exact"],
            "hand_critical_path_ms": {
                "serial": hand["cp_serial"], "overlap": hand["cp_overlap"],
            },
        }

    def _decision(self, seam, incoming, chosen, priced) -> dict:
        return {
            "seam": seam["index"],
            "op": seam["op"],
            "line": seam.get("line"),
            "shape": tuple(int(x) for x in seam["shape"]),
            "dtype": seam["dtype"],
            "src": incoming,
            "requested": seam["dst"],
            "apply": chosen,
            "elide": layout_rank(chosen) == layout_rank(incoming),
            "mode": priced["mode"],
            "wire_bytes": priced["wire_bytes"],
            "exact_bytes": priced["exact_wire_bytes"],
            "critical_path_ms": dict(priced["critical_path_ms"]),
        }


def summa_grid_model(
    m: int,
    k: int,
    n: int,
    mesh_shape: Tuple[int, int],
    *,
    mode: Optional[str] = None,
    overlap: bool = False,
    layout: str = "grid",
    compute_ms_per_step: float = 0.0,
    gbps: float = DEFAULT_ICI_GBPS,
) -> dict:
    """Per-device wire/memory model of the grid SUMMA matmul.

    ``layout`` selects the operand schedule on the ``r×c`` mesh:

    * ``"grid"`` — A splits ``(0, 1)``, B splits ``(0, 1)``: the schedule
      runs ``L = r*c`` k-panels of width ``w = ceil(k / L)``; each panel
      step broadcasts A's ``(m/r, w)`` panel along the mesh columns (a
      masked psum over the ``c``-ring) and B's ``(w, n/c)`` panel along
      the mesh rows (over the ``r``-ring).
    * ``"rowcol"`` — A splits ``(0, None)``, B splits ``(None, 1)``: every
      device already owns A's full k rows for its row block and B's full
      k columns for its column block, so the same L-panel accumulation
      runs entirely rank-local — ZERO wire.  This is the layout whose
      modeled bytes are strictly below the redistribute-to-``(0, 1)``-
      then-SUMMA alternative (which pays the full grid broadcast wire).
    * ``"colrow"`` — A splits ``(None, 1)``, B splits ``(0, None)``: the
      k axis is the sharded axis of both operands, and the panel
      broadcasts (owner slices its own row/column block before the masked
      psum) ship exactly the grid schedule's bytes — wire PARITY with
      redistribute-then-SUMMA; the win is eliding the two planned
      redistribution dispatches and their committed copies.

    All three run the identical L-step panel-ordered accumulation, so
    they share one bitwise replicated twin.  Figures assume f32 panels
    (:func:`ring_wire_model`'s exact-byte convention); degenerate mesh
    axes contribute zero wire.  This function is the single source the
    runtime telemetry is credited from (``core/linalg/basics.py``) and
    the bench headline prices — delegation keeps accounted and modeled
    bytes identical.
    """
    if layout not in ("grid", "rowcol", "colrow"):
        raise ValueError(f"unknown SUMMA layout {layout!r}")
    r, c = (max(int(s), 1) for s in mesh_shape)
    L = r * c
    w = -(-int(k) // L) if k else 0
    mloc = -(-int(m) // r)
    nloc = -(-int(n) // c)
    if layout == "rowcol":
        hops = exact = wire = 0
    else:
        a_step = ring_wire_model(mloc * w, c, mode, op="allreduce")
        b_step = ring_wire_model(w * nloc, r, mode, op="allreduce")
        hops = L * (a_step["ring_hops_per_device"] + b_step["ring_hops_per_device"])
        exact = L * (a_step["exact_wire_bytes"] + b_step["exact_wire_bytes"])
        wire = L * (a_step["wire_bytes"] + b_step["wire_bytes"])
    # at-rest operands + accumulator + in-flight panels (x2 double-buffered)
    bufs = 2 if overlap else 1
    if layout == "rowcol":
        a_rest, b_rest = mloc * (L * w), (L * w) * nloc
    elif layout == "colrow":
        a_rest, b_rest = (r * mloc) * (r * w), (c * w) * (c * nloc)
    else:
        a_rest, b_rest = mloc * (r * w), (c * w) * nloc
    peak = 4 * (
        a_rest + b_rest + mloc * nloc
        + bufs * (mloc * w + w * nloc)
    )
    return {
        "mesh": (r, c),
        "layout": layout,
        "panels": L,
        "panel_width": w,
        "panel_a_elems": mloc * w,
        "panel_b_elems": w * nloc,
        "hops": hops,
        "exact_wire_bytes": exact,
        "wire_bytes": wire,
        "bytes_ratio": round(wire / exact, 4) if exact else None,
        "peak_live_bytes": peak,
        "critical_path_ms": {
            "serial": critical_path_ms(
                wire, hops, compute_ms_per_step, gbps=gbps, overlap=False
            ),
            "overlap": critical_path_ms(
                wire, hops, compute_ms_per_step, gbps=gbps, overlap=True
            ),
        },
    }


def grid_panel_bounds(
    n: int, c: int, tiles_per_proc: int = 1
) -> Tuple[Tuple[int, int, int], ...]:
    """The column-panel schedule of the grid blocked QR: one
    ``(owner mesh column, local column offset, width)`` triple per panel.

    Columns live block-distributed over the ``c`` mesh columns in chunks
    of ``nloc = ceil(n / c)``; each chunk's REAL width (``valid_counts``
    algebra — pads only ever trail the last nonempty chunks) is cut into
    ``tiles_per_proc`` tiles.  Pad columns are never part of any panel:
    the kernel and the wire model both iterate this exact tuple, which is
    what keeps modeled and executed collectives in lock-step."""
    c = max(int(c), 1)
    nloc = -(-int(n) // c)
    out = []
    for jc in range(c):
        vc = min(nloc, max(0, int(n) - jc * nloc))
        if vc <= 0:
            continue
        nb = -(-vc // max(int(tiles_per_proc), 1))
        lo = 0
        while lo < vc:
            out.append((jc, lo, min(nb, vc - lo)))
            lo += nb
    return tuple(out)


def grid_qr_model(
    m: int,
    n: int,
    mesh_shape: Tuple[int, int],
    *,
    tiles_per_proc: int = 1,
    mode: Optional[str] = None,
    overlap: bool = False,
    compute_ms_per_step: float = 0.0,
    gbps: float = DEFAULT_ICI_GBPS,
) -> dict:
    """Per-device wire model of the grid blocked/CAQR QR (``m >= n``,
    operand splits ``(0, 1)`` on an ``r×c`` mesh).

    Per panel of width ``nb`` (schedule from :func:`grid_panel_bounds`):

    1. panel broadcast — masked psum of the owner column's ``(m/r, nb)``
       slab along the mesh columns (``c``-ring allreduce);
    2. BCGS2 reorthogonalization (every panel after the first) — the
       ``(n/c, nb)`` projection-coefficient stack gathered down the mesh
       rows, then the ``((m/r + n/c), nb)`` correction/coefficient bundle
       gathered along the mesh columns (both all-gathers followed by a
       panel-ordered local sum, keeping the combine bitwise-pinnable);
    3. TSQR combine — the ``(nb, nb)`` R factors all-gathered down the
       mesh rows;
    4. trailing coefficients — the ``(nb, n/c)`` W partials all-gathered
       down the mesh rows and summed in row order.

    All genuine reductions go through all-gather + ordered local sum
    rather than psum: a psum's internal reduction order is unspecified,
    and the twin discipline requires every combine
    to be reproducible op-for-op on the replicated golden.  Figures
    assume f32 (the :func:`ring_wire_model` convention).
    """
    r, c = (max(int(s), 1) for s in mesh_shape)
    mloc = -(-int(m) // r)
    nloc = -(-int(n) // c)
    bounds = grid_panel_bounds(n, c, tiles_per_proc)
    hops = exact = wire = 0
    for idx, (_jc, _lo, nb) in enumerate(bounds):
        steps = [
            ring_wire_model(mloc * nb, c, mode, op="allreduce"),
            ring_wire_model(nb * nb, r, mode, op="allgather"),
            ring_wire_model(nb * nloc, r, mode, op="allgather"),
        ]
        if idx:
            steps.append(ring_wire_model(nloc * nb, r, mode, op="allgather"))
            steps.append(
                ring_wire_model((mloc + nloc) * nb, c, mode, op="allgather")
            )
        for s in steps:
            hops += s["ring_hops_per_device"]
            exact += s["exact_wire_bytes"]
            wire += s["wire_bytes"]
    nb_max = max((b[2] for b in bounds), default=0)
    # working set: A + Q + R columns at rest, plus the widest panel's
    # broadcast slab, TSQR stack, and W row block (x2 when the lookahead
    # arm keeps the next panel in flight)
    bufs = 2 if overlap else 1
    peak = 4 * (
        2 * mloc * nloc + (c * nloc) * nloc
        + bufs * (mloc * nb_max + r * nb_max * nb_max + r * nb_max * nloc)
    )
    return {
        "mesh": (r, c),
        "panels": len(bounds),
        "panel_widths": tuple(b[2] for b in bounds),
        "hops": hops,
        "exact_wire_bytes": exact,
        "wire_bytes": wire,
        "bytes_ratio": round(wire / exact, 4) if exact else None,
        "peak_live_bytes": peak,
        "critical_path_ms": {
            "serial": critical_path_ms(
                wire, hops, compute_ms_per_step, gbps=gbps, overlap=False
            ),
            "overlap": critical_path_ms(
                wire, hops, compute_ms_per_step, gbps=gbps, overlap=True
            ),
        },
    }


def qdwh_svd_model(
    m: int,
    n: int,
    mesh_shape: Tuple[int, int],
    *,
    iterations: int = 12,
    mode: Optional[str] = None,
    compute_ms_per_step: float = 0.0,
    gbps: float = DEFAULT_ICI_GBPS,
) -> dict:
    """Per-device wire model of the QDWH polar-decomposition SVD (``m >=
    n``, operand splits ``(0, 1)`` on an ``r×c`` mesh).

    Components, mirroring the kernel's collectives exactly:

    * init — the Frobenius-norm scale: two scalar all-gathers (down the
      mesh rows, then along the columns) with ordered local sums;
    * per Halley iteration (``iterations`` is the static trip cap the
      telemetry is credited for — the on-device ``while_loop`` may stop
      earlier, and the model documents the worst case): one grid blocked
      QR of the stacked ``(m + n, n)`` operand (:func:`grid_qr_model` on
      the row-augmented shape), the identity-block Q2 gathered down the
      mesh rows, ``c`` panel steps of the Q1·Q2ᵀ combine (two masked
      psums along the mesh columns each), and the convergence scalars;
    * epilogue — A gathered along the mesh columns, the Upᵀ·A partials
      gathered down the rows, the symmetric factor H replicated along the
      columns, and the U = Up·V partials gathered along the columns.
    """
    r, c = (max(int(s), 1) for s in mesh_shape)
    mloc = -(-int(m) // r)
    nloc = -(-int(n) // c)
    Np = c * nloc
    nploc = -(-Np // r)
    Npr = r * nploc

    def _steps(*steps):
        return (
            sum(s["ring_hops_per_device"] for s in steps),
            sum(s["exact_wire_bytes"] for s in steps),
            sum(s["wire_bytes"] for s in steps),
        )

    scalar = _steps(
        ring_wire_model(1, r, mode, op="allgather"),
        ring_wire_model(1, c, mode, op="allgather"),
    )
    qr_m = grid_qr_model(
        r * (mloc + nploc), Np, (r, c), mode=mode,
        compute_ms_per_step=compute_ms_per_step, gbps=gbps,
    )
    combine = _steps(
        ring_wire_model(nploc * nloc, r, mode, op="allgather"),
        *(
            [
                ring_wire_model(mloc * nloc, c, mode, op="allreduce"),
                ring_wire_model(Npr * nloc, c, mode, op="allreduce"),
            ]
            * c
        ),
    )
    per_iter = (
        qr_m["hops"] + combine[0] + scalar[0],
        qr_m["exact_wire_bytes"] + combine[1] + scalar[1],
        qr_m["wire_bytes"] + combine[2] + scalar[2],
    )
    epilogue = _steps(
        ring_wire_model(mloc * nloc, c, mode, op="allgather"),
        ring_wire_model(nloc * Np, r, mode, op="allgather"),
        ring_wire_model(nloc * Np, c, mode, op="allgather"),
        ring_wire_model(mloc * Np, c, mode, op="allgather"),
    )
    it = max(int(iterations), 1)
    hops = scalar[0] + it * per_iter[0] + epilogue[0]
    exact = scalar[1] + it * per_iter[1] + epilogue[1]
    wire = scalar[2] + it * per_iter[2] + epilogue[2]
    peak = qr_m["peak_live_bytes"] + 4 * (
        2 * mloc * nloc + Npr * nloc + mloc * Npr + 2 * Np * Np
    )
    return {
        "mesh": (r, c),
        "iterations": it,
        "per_iteration_wire_bytes": per_iter[2],
        "qr_wire_bytes": qr_m["wire_bytes"],
        "hops": hops,
        "exact_wire_bytes": exact,
        "wire_bytes": wire,
        "bytes_ratio": round(wire / exact, 4) if exact else None,
        "peak_live_bytes": peak,
        "critical_path_ms": {
            "serial": critical_path_ms(
                wire, hops, compute_ms_per_step, gbps=gbps, overlap=False
            ),
            "overlap": critical_path_ms(
                wire, hops, compute_ms_per_step, gbps=gbps, overlap=True
            ),
        },
    }
