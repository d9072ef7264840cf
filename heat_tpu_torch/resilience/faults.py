"""Seeded, deterministic fault injection: ``htt.resilience.inject(...)``.

Port of ``heat_tpu/resilience/faults.py``; the payload seams corrupt
torch tensors where the reference corrupts jax arrays, with the same
values at the same places.  A fault plan is a context manager that arms
one fault *kind* against the seams the library exposes for it — the
compressed-collective boundary in :mod:`heat_tpu_torch.comm.compressed`
(``allreduce_q``/``allgather_q``), and the host-only seams whose callers
(the file opens and slab writes, the serving payload, the checkpoint
tick of the resumable loops) come with the IO, resume and serving
layers.  Whether a given trigger opportunity actually fires is decided
by a ``numpy`` generator seeded per plan, so a fault schedule is a pure
function of ``(seed, rate/nth, the sequence of trigger opportunities)``
— the reference's schedule for the same triple, bit for bit.

Kinds
-----
``"nonfinite"``
    Overwrites the first element of a compressed-collective input with a
    non-finite value (NaN by default; pass ``value=float("inf")``).
``"saturate"``
    Multiplies the compressed-collective input by ``factor`` (default
    1e36), driving block absmax — and with it the wire scales and the
    ring's partial sums — into overflow.
``"bitflip"``
    Flips bit 30 (the high exponent bit) of one f32 word of the
    collective's decoded result, at the program boundary — the observable
    effect of an exponent bit-flip in a forwarded wire scale: a
    finite-but-~2^64-inflated value the guard's overflow clause exists to
    catch.
``"io_error"``
    Raises a transient ``OSError`` (EIO) at an HDF5/NetCDF open site.
``"preempt"``
    Raises :class:`Preempted` at a preemption point: the checkpoint tick
    between training-loop segments (``site="iteration"``) or between two
    slab writes inside a save (``site="save-slab"``).
``"device_loss"``
    Raises :class:`DeviceLossError` at a device-loss point (the same
    checkpoint tick, after the snapshot is durable): rank ``rank``
    (default: the last rank of the current mesh) "drops out", and the
    error carries the surviving-mesh description.  Catch it, shrink the
    mesh, then ``fit(..., resume="elastic")`` — the ICE-preempted-host
    lifecycle of a multi-host TPU slice.
``"device_arrival"``
    The inverse of ``device_loss``: raises :class:`DeviceArrival` at an
    arrival point (the fleet's scale tick), announcing ``rank`` new
    devices (default 1) joining the mesh.  Catch it, build a comm over
    the larger device set, then :func:`heat_tpu_torch.resilience.elastic.grow`
    — the scale-up half of the elastic lifecycle, as a pure function of
    the plan's seed.
``"slow_rank"``
    Arms a simulated straggler: :func:`extra_latency` reports ``delay``
    extra seconds for rank ``rank`` at matching sites.  Consumed by the
    deadline watchdog (:mod:`heat_tpu_torch.resilience.elastic`), which
    classifies a dispatch blowing its per-site budget as a suspected
    lost rank.  No real sleeping happens — the delay is part of the
    deterministic schedule, not wall time.
``"slow_replica"``
    The serving-plane straggler (the gray failure hedging exists for):
    :func:`serve_delay` reports ``delay`` extra seconds at matching
    sites (the procfleet worker announces ``site="replica<i>"`` and
    *does* sleep the reported delay in its own thread, because hedging
    and deadlines act on real end-to-end latency).  Reply bytes are
    untouched, so the ledger stays a pure function of the seed.
``"stalled_socket"``
    A half-open connection: :func:`socket_stalled` reports True at a
    matching site and the procfleet worker treats the replica's socket
    as wedged — a recv that would never return — failing the request
    over to the breaker/re-queue path instead of hanging forever.
``"corrupt_frame"``
    Flips one seeded bit (the 0x40 high bit of one byte — the wire
    analog of the ``bitflip`` kind's bit 30) of a received wire frame
    body via :func:`wire_bytes`, *before* the crc32 trailer check in
    :mod:`heat_tpu_torch.net.wire` — so what the chaos lane asserts is the
    codec's own ``corrupt-frame`` detection, not a mock.

All injection happens at host-visible boundaries (tensor ops on the
payload entering or leaving a collective), never inside its kernels:
the faulted ring runs the same kernels on the corrupted input.
"""

from __future__ import annotations

import contextlib
import errno
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

__all__ = [
    "DeviceArrival",
    "DeviceLossError",
    "Preempted",
    "inject",
    "any_active",
    "clear",
]

_KINDS = (
    "nonfinite",
    "saturate",
    "bitflip",
    "io_error",
    "preempt",
    "device_loss",
    "device_arrival",
    "slow_rank",
    "slow_replica",
    "stalled_socket",
    "corrupt_frame",
)

#: the smallest normal float32: below it a value is flushed to zero
_FLT_MIN = float(np.finfo(np.float32).tiny)

#: trigger sites, by kind, that consume one schedule decision per call
_COMM_INPUT_KINDS = ("nonfinite", "saturate")
_COMM_OUTPUT_KINDS = ("bitflip",)


class Preempted(RuntimeError):
    """Simulated preemption: the process was 'killed' at a preemption
    point (between training iterations, or mid-save between two slab
    writes).  Catch it, then call ``fit(..., resume=True)`` / re-run the
    save — exactly the SIGTERM-then-reschedule lifecycle of a preemptible
    TPU VM."""


class DeviceLossError(RuntimeError):
    """A rank dropped out of the mesh (injected ``device_loss``, or a
    dispatch the deadline watchdog classified as a suspected-lost rank).

    Carries the failure topology so callers can shrink and recover:
    ``lost_rank`` (the dead rank), ``survivors`` (the surviving rank
    tuple), ``mesh_size`` (the old device count).  The fit's latest
    snapshot is durable (the loss point sits *after* the checkpoint
    tick), so the recovery story is: build a comm over the surviving
    devices, then ``fit(..., resume="elastic")`` — or call
    :func:`heat_tpu_torch.resilience.elastic.recover` directly.
    """

    def __init__(self, message: str, *, lost_rank: int, mesh_size: int,
                 site: str = ""):
        super().__init__(message)
        self.lost_rank = int(lost_rank)
        self.mesh_size = int(mesh_size)
        self.survivors = tuple(
            r for r in range(self.mesh_size) if r != self.lost_rank
        )
        self.site = site


class DeviceArrival(RuntimeError):
    """New devices joined the mesh (injected ``device_arrival``) — the
    scale-up mirror of :class:`DeviceLossError`.

    Carries the arrival topology so callers can grow: ``arrived`` (how
    many devices showed up), ``mesh_size`` (the old device count),
    ``new_mesh_size`` (old + arrived).  The latest snapshot is durable
    (the arrival point sits after the checkpoint tick), so the scale-up
    story is: build a comm over the larger device set, then
    :func:`heat_tpu_torch.resilience.elastic.grow` — bitwise-identical to a
    run that held the big mesh all along.
    """

    def __init__(self, message: str, *, arrived: int, mesh_size: int,
                 site: str = ""):
        super().__init__(message)
        self.arrived = int(arrived)
        self.mesh_size = int(mesh_size)
        self.new_mesh_size = self.mesh_size + self.arrived
        self.site = site


class _Plan:
    """One armed fault: kind + deterministic fire schedule."""

    def __init__(
        self,
        kind: str,
        seed: int,
        rate: float,
        nth: Optional[Union[int, Sequence[int]]],
        value: float,
        factor: float,
        max_faults: Optional[int],
        site: Optional[str],
        rank: Optional[int] = None,
        delay: float = 0.0,
    ):
        if kind not in _KINDS:
            raise ValueError(f"unknown fault kind {kind!r}: expected one of {_KINDS}")
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {rate}")
        self.kind = kind
        self.seed = int(seed)
        self.rate = float(rate)
        self.nth = (
            None
            if nth is None
            else frozenset([int(nth)] if isinstance(nth, int) else [int(i) for i in nth])
        )
        self.value = float(value)
        self.factor = float(factor)
        self.max_faults = max_faults
        self.site = site
        self.rank = None if rank is None else int(rank)
        self.delay = float(delay)
        self.rng = np.random.default_rng(self.seed)
        self.calls = 0  # trigger opportunities seen
        self.fired = 0  # faults actually injected

    def should_fire(self, site: Optional[str] = None) -> bool:
        """One schedule decision.  Every trigger opportunity advances the
        call counter AND the RNG stream (even under ``nth``), so a plan's
        fire pattern depends only on the opportunity sequence.

        A plan armed with a ``site`` fires ONLY at seams that announce
        that exact site — a seam that passes no site (``site=None``)
        never matches a site-filtered plan.  This keeps e.g. a
        ``site="registry_open"`` io_error plan from leaking into the
        checkpoint/HDF5 open seams that predate site announcements."""
        if self.site is not None and site != self.site:
            return False
        self.calls += 1
        draw = float(self.rng.random())
        if self.max_faults is not None and self.fired >= self.max_faults:
            return False
        hit = self.calls in self.nth if self.nth is not None else draw < self.rate
        if hit:
            self.fired += 1
        return hit


_PLANS: List[_Plan] = []


def any_active() -> bool:
    """True when at least one fault plan is armed (the fast-path gate the
    injection seams check before doing any work)."""
    return bool(_PLANS)


def clear() -> None:
    """Disarm every fault plan (test teardown)."""
    _PLANS.clear()


@contextlib.contextmanager
def inject(
    kind: str,
    *,
    seed: int = 0,
    rate: float = 1.0,
    nth: Optional[Union[int, Sequence[int]]] = None,
    value: float = float("nan"),
    factor: float = 1e36,
    max_faults: Optional[int] = None,
    site: Optional[str] = None,
    rank: Optional[int] = None,
    delay: float = 0.0,
):
    """Arm one deterministic fault plan for the duration of the block.

    ``nth`` (1-based call index, or a collection of them) pins faults to
    exact trigger opportunities; otherwise each opportunity fires with
    probability ``rate`` from the plan's seeded stream.  ``max_faults``
    caps total injections (a *transient* fault: fail N times, then heal —
    the shape retry logic must survive).  ``site`` restricts a
    ``"preempt"``/``"device_loss"``/``"slow_rank"`` plan to one trigger
    site (e.g. ``"iteration"``).  ``rank`` picks the lost/straggling rank
    for ``"device_loss"``/``"slow_rank"`` (default: the mesh's last
    rank); ``delay`` is the simulated extra latency, in seconds, a
    ``"slow_rank"`` plan reports.  Plans nest; each keeps its own
    counters.
    """
    plan = _Plan(kind, seed, rate, nth, value, factor, max_faults, site,
                 rank=rank, delay=delay)
    _PLANS.append(plan)
    try:
        yield plan
    finally:
        try:
            _PLANS.remove(plan)
        except ValueError:  # already cleared by faults.clear()
            pass


# --------------------------------------------------------------------- #
# trigger seams (called by comm/io/resume — no-ops when nothing is armed)
# --------------------------------------------------------------------- #
def comm_input(site: str, array: torch.Tensor) -> torch.Tensor:
    """Corrupt a compressed collective's input per the armed plans.
    Applied at the host boundary on a copy (the caller's tensor is never
    mutated); the ring's kernels themselves are untouched.  ``saturate``
    multiplies in the tensor's own dtype; ``nonfinite`` writes element 0
    of the flattened tensor."""
    for plan in list(_PLANS):
        if plan.kind not in _COMM_INPUT_KINDS or not plan.should_fire(site):
            continue
        if plan.kind == "saturate":
            factor = torch.tensor(plan.factor, dtype=array.dtype, device=array.device)
            array = (array * factor).to(array.dtype)
        else:  # nonfinite
            flat = array.reshape(-1).clone()
            flat[0] = plan.value
            array = flat.reshape(array.shape)
    return array


def comm_output(site: str, array: torch.Tensor) -> torch.Tensor:
    """Flip the high exponent bit of one f32 word of the collective's
    decoded result — the boundary-visible signature of a bit-flip in a
    forwarded wire scale.  The word is the plan's seeded draw over the
    flattened result; the xor runs on the result's float32 bits viewed as
    int32 (bit 30 is positive in int32), then casts back.  A cast to
    another type flushes float32 subnormals to zero first, as the
    reference's compiled convert does (a deflated word can be one)."""
    for plan in list(_PLANS):
        if plan.kind not in _COMM_OUTPUT_KINDS or not plan.should_fire(site):
            continue
        shape, dtype = array.shape, array.dtype
        flat = array.reshape(-1).to(torch.float32).clone()
        n = int(flat.shape[0])
        idx = int(plan.rng.integers(n))
        bits = flat.view(torch.int32)
        bits[idx] ^= 1 << 30
        if dtype != torch.float32:
            flat = torch.where(flat.abs() < _FLT_MIN, flat * 0.0, flat)
        array = flat.reshape(shape).to(dtype)
    return array


def payload_input(site: str, array):
    """Corrupt one serving request's host payload per the armed plans —
    the per-request seam of the serve engine (``site`` is
    ``"serve:<tenant>/<model>"``).  Handles the same kinds as
    :func:`comm_input` (``"nonfinite"``/``"saturate"``) but on the host
    numpy payload, *before* batch assembly: the engine's health screen
    then quarantines exactly the requests the deterministic schedule
    hit, and the shared micro-batch is never touched.  Returns a
    corrupted copy; the caller's array is never mutated."""
    for plan in list(_PLANS):
        if plan.kind not in _COMM_INPUT_KINDS or not plan.should_fire(site):
            continue
        out = np.array(array, copy=True)
        if plan.kind == "saturate":
            out = (out * plan.factor).astype(out.dtype)
        else:  # nonfinite
            out.reshape(-1)[0] = plan.value
        array = out
    return array


def io_open(path: str, site: Optional[str] = None) -> None:
    """Transient-``OSError`` seam at a file-open site.  ``site`` (e.g.
    ``"registry_open"`` for the fleet's model-registry reads) lets a plan
    target one open seam; the HDF5/NetCDF/checkpoint sites pass no site
    and so only match unfiltered plans."""
    for plan in list(_PLANS):
        if plan.kind == "io_error" and plan.should_fire(site):
            raise OSError(
                errno.EIO, f"injected transient IO fault (seed={plan.seed})", path
            )


def preempt_point(site: str) -> None:
    """Simulated-preemption seam; ``site`` is ``"iteration"`` (the
    checkpoint tick between loop segments) or ``"save-slab"`` (between
    two slab writes inside a save)."""
    for plan in list(_PLANS):
        if plan.kind == "preempt" and plan.should_fire(site):
            raise Preempted(
                f"injected preemption at {site} (seed={plan.seed}, "
                f"opportunity #{plan.calls})"
            )


def device_point(site: str, mesh: Optional[int] = None) -> None:
    """Device-loss seam, placed *after* the durable checkpoint tick so
    the snapshot survives the loss (the preempt seam's contract, kept).
    ``mesh`` is the current device count; the plan's ``rank`` defaults to
    the last rank of that mesh."""
    for plan in list(_PLANS):
        if plan.kind == "device_loss" and plan.should_fire(site):
            size = int(mesh) if mesh is not None else 1
            lost = plan.rank if plan.rank is not None else size - 1
            raise DeviceLossError(
                f"injected device loss at {site}: rank {lost} of mesh "
                f"size {size} dropped (seed={plan.seed}, opportunity "
                f"#{plan.calls}); latest snapshot is durable — shrink the "
                f'mesh and resume with resume="elastic"',
                lost_rank=lost,
                mesh_size=size,
                site=site,
            )


def arrival_point(site: str, mesh: Optional[int] = None) -> None:
    """Device-arrival seam — the scale-up mirror of
    :func:`device_point`, placed at the fleet's scale tick (after the
    durable snapshot, same contract).  ``mesh`` is the current device
    count; the plan's ``rank`` is reused as the number of arriving
    devices (default 1)."""
    for plan in list(_PLANS):
        if plan.kind == "device_arrival" and plan.should_fire(site):
            size = int(mesh) if mesh is not None else 1
            arrived = plan.rank if plan.rank is not None else 1
            raise DeviceArrival(
                f"injected device arrival at {site}: {arrived} device(s) "
                f"joined mesh size {size} (seed={plan.seed}, opportunity "
                f"#{plan.calls}); latest snapshot is durable — build a "
                f"comm over the larger device set and grow",
                arrived=arrived,
                mesh_size=size,
                site=site,
            )


def extra_latency(site: str):
    """Straggler seam: the simulated extra seconds an armed ``slow_rank``
    plan adds at ``site``, plus the suspect rank — ``(0.0, None)`` when
    nothing fires.  Consumed by the deadline watchdog; no wall-clock
    sleeping happens here."""
    total, suspect = 0.0, None
    for plan in list(_PLANS):
        if plan.kind == "slow_rank" and plan.should_fire(site):
            total += plan.delay
            suspect = plan.rank if plan.rank is not None else suspect
    return total, suspect


def serve_delay(site: str) -> float:
    """Serving-plane straggler seam: the extra seconds armed
    ``slow_replica`` plans add at ``site`` (the procfleet worker passes
    ``"replica<i>"``), 0.0 when nothing fires.  Unlike
    :func:`extra_latency` the caller IS expected to sleep this — hedged
    retries and end-to-end deadlines act on real wall latency, and the
    sleep happens in the one worker thread that owns the slow replica,
    so nothing else stalls."""
    total = 0.0
    for plan in list(_PLANS):
        if plan.kind == "slow_replica" and plan.should_fire(site):
            total += plan.delay
    return total


def socket_stalled(site: str) -> bool:
    """Half-open-socket seam: True when an armed ``stalled_socket`` plan
    fires at ``site`` — the caller must treat the pipe as one whose next
    recv would never return (fail over to the breaker/re-queue path
    rather than blocking forever)."""
    hit = False
    for plan in list(_PLANS):
        if plan.kind == "stalled_socket" and plan.should_fire(site):
            hit = True
    return hit


def wire_bytes(site: str, body: bytes) -> bytes:
    """Frame-corruption seam (receive side, *before* the crc32 trailer
    check in :mod:`heat_tpu_torch.net.wire`): each firing ``corrupt_frame``
    plan XORs the 0x40 high bit of one seeded byte of ``body`` — the
    byte-stream analog of the ``bitflip`` kind's bit-30 flip — so the
    codec's own ``corrupt-frame`` detection is what the chaos lane
    asserts.  Returns a corrupted copy; the input is never mutated."""
    out = None
    for plan in list(_PLANS):
        if plan.kind != "corrupt_frame" or not plan.should_fire(site):
            continue
        if out is None:
            out = bytearray(body)
        if out:
            idx = int(plan.rng.integers(len(out)))
            out[idx] ^= 0x40
    return body if out is None else bytes(out)
