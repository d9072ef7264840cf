"""Seeded open-loop load generation for the serve engine.

Port of ``heat_tpu/serve/loadgen.py`` (numpy and the standard library
only): the same seed gives the same schedule, payloads and reply
checksum in both packages.

The arrival process is a pure function of the seed (default
``HEAT_CHAOS_SEED``, the chaos lane's knob): exponential inter-arrival
gaps at ``rate_hz``, integer row counts in ``[min_rows, max_rows]``, and
standard-normal payloads from a derived stream — :func:`schedule` and
:func:`payloads` take no wall-clock input at all, so the same seed
replays the same request sequence byte for byte.

:func:`run` drives an engine with that sequence and reports the two
bench headlines — ``serve_predictions_per_sec`` and ``serve_p99_ms`` —
plus the dispatch model (dispatches per micro-batch, batch occupancy)
and wire model (payload/reply bytes).  With ``twin=True`` it re-runs
every request through the engine's UNBATCHED direct-predict path and
compares replies bitwise: the in-run golden that pins the batched fast
path to per-request truth.

Chaos double-duty: arm a fault plan (``resilience.inject``) around
:func:`run` and the engine's per-request payload seam poisons exactly
the requests the deterministic schedule hits — the report's
``degraded`` tuple is then itself a pure function of the seeds, which
is what the chaos lane asserts.
"""

from __future__ import annotations

import os
import time
import zlib
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..telemetry.hist import Histogram

__all__ = [
    "Arrival",
    "LoadReport",
    "chaos_seed",
    "latency_hist_ms",
    "merge_percentiles_ms",
    "payloads",
    "run",
    "schedule",
]


def chaos_seed() -> int:
    """The chaos lane's seed (``HEAT_CHAOS_SEED``, default 0)."""
    return int(os.environ.get("HEAT_CHAOS_SEED", "0"))


@dataclass(frozen=True)
class Arrival:
    """One scheduled request: offset from t0 (seconds) and row count."""

    t: float
    rows: int


def schedule(
    seed: Optional[int] = None,
    *,
    n_requests: int = 64,
    rate_hz: float = 500.0,
    min_rows: int = 1,
    max_rows: int = 8,
) -> Tuple[Arrival, ...]:
    """The deterministic open-loop arrival process (see module docs)."""
    if n_requests < 1:
        raise ValueError(f"n_requests must be >= 1, got {n_requests}")
    if not 1 <= min_rows <= max_rows:
        raise ValueError(f"need 1 <= min_rows <= max_rows, got {min_rows}/{max_rows}")
    rng = np.random.default_rng(chaos_seed() if seed is None else int(seed))
    gaps = rng.exponential(1.0 / float(rate_hz), size=n_requests)
    times = np.cumsum(gaps)
    rows = rng.integers(min_rows, max_rows + 1, size=n_requests)
    return tuple(Arrival(float(t), int(r)) for t, r in zip(times, rows))


def payloads(
    arrivals: Sequence[Arrival],
    n_features: int,
    *,
    seed: Optional[int] = None,
    dtype=np.float32,
) -> List[np.ndarray]:
    """Deterministic request payloads for ``arrivals`` — a stream derived
    from (seed, 1) so payload bytes and arrival times are independent."""
    base = chaos_seed() if seed is None else int(seed)
    rng = np.random.default_rng([base, 1])
    return [
        rng.standard_normal((a.rows, int(n_features))).astype(np.dtype(dtype))
        for a in arrivals
    ]


@dataclass
class LoadReport:
    """One load-generation run's outcome (see module docs).

    ``checksum``/``degraded``/``rows`` are seed-deterministic; the
    timing fields are measurements.  ``twin`` is None unless the
    unbatched golden pass ran."""

    n_requests: int
    rows: int
    wall_s: float
    predictions_per_sec: float
    p50_ms: float
    p99_ms: float
    degraded: Tuple[int, ...]
    checksum: int
    batches: int
    dispatches: int
    dispatches_per_batch: float
    batch_occupancy: float
    payload_bytes: int
    reply_bytes: int
    twin: Optional[dict]
    #: the request ids the engine stamped on the replies, in submit
    #: order — the handles that walk each request through the event
    #: stream / Perfetto export / flight postmortem
    trace_ids: Tuple[str, ...] = ()
    #: canonical ``Histogram.state()`` of the millisecond latency stream
    #: — the mergeable form: fleet-level percentiles come from merging
    #: these states across sources (see :func:`merge_percentiles_ms`),
    #: never from concatenating raw latency lists (which a multi-process
    #: fleet cannot ship without unbounded memory)
    latency_hist: Optional[dict] = None


def latency_hist_ms(latencies_s: Sequence[float]) -> Histogram:
    """Fold a latency stream (seconds) into a millisecond log8
    :class:`~heat_tpu_torch.telemetry.hist.Histogram`."""
    h = Histogram()
    for lat in latencies_s:
        h.record(float(lat) * 1e3)
    return h


def merge_percentiles_ms(states: Sequence[dict]) -> Tuple[float, float]:
    """``(p50_ms, p99_ms)`` across multiple latency sources, by merging
    their ``Histogram.state()`` dicts (replica RPC frames carry states,
    never objects).  The log8 merge is byte-exact and associative, so
    the merged percentiles equal what a single histogram observing the
    concatenated stream would report — within the same documented
    ``Histogram.REL_ERROR`` of the true nearest-rank sample, independent
    of how the stream was sharded."""
    merged = Histogram()
    for st in states:
        merged.merge(Histogram.from_state(st))
    return merged.percentile(50.0), merged.percentile(99.0)


def _percentiles_ms(latencies: Sequence[float]) -> Tuple[float, float]:
    """``(p50_ms, p99_ms)`` of a latency stream, via the fixed-memory
    streaming :class:`~heat_tpu_torch.telemetry.hist.Histogram` (log8 buckets:
    each percentile is within ``Histogram.REL_ERROR`` ≈ 4.4% of the
    exact nearest-rank sample — the documented trade for not retaining
    per-request latency lists).  An empty stream answers ``(0.0, 0.0)``
    instead of raising the way ``np.percentile([])`` does."""
    h = latency_hist_ms(latencies)
    return h.percentile(50.0), h.percentile(99.0)


def run(
    engine,
    tenant: str,
    model: str,
    *,
    version: Optional[int] = None,
    seed: Optional[int] = None,
    n_requests: int = 64,
    rate_hz: float = 500.0,
    min_rows: int = 1,
    max_rows: int = 8,
    n_features: Optional[int] = None,
    dtype=np.float32,
    realtime: bool = False,
    twin: bool = True,
) -> LoadReport:
    """Drive ``engine`` with the seeded open-loop sequence (module docs).

    ``realtime=False`` (default): every request is submitted immediately
    and the engine flushes synchronously — deterministic batching, the
    replay/test mode.  ``realtime=True``: the engine runs its background
    coalescing workers and submits happen on the schedule's clock (the
    latency-measurement mode).
    """
    arrivals = schedule(
        seed, n_requests=n_requests, rate_hz=rate_hz,
        min_rows=min_rows, max_rows=max_rows,
    )
    if n_features is None:
        n_features = engine._lane(tenant, model, version).n_features
        if n_features is None:
            raise ValueError(
                "this estimator does not expose a feature count — pass "
                "n_features= explicitly"
            )
    pays = payloads(arrivals, n_features, seed=seed, dtype=dtype)

    before = engine.stats()
    t0 = time.monotonic()
    if realtime:
        engine.start()
        futures = []
        for arrival, payload in zip(arrivals, pays):
            delay = (t0 + arrival.t) - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            futures.append(
                engine.submit(tenant, model, payload, version=version)
            )
        replies = [f.result() for f in futures]
    else:
        futures = [
            engine.submit(tenant, model, payload, version=version)
            for payload in pays
        ]
        engine.flush()
        replies = [f.result() for f in futures]
    wall = time.monotonic() - t0
    after = engine.stats()

    rows = sum(a.rows for a in arrivals)
    degraded = tuple(i for i, r in enumerate(replies) if r.degraded)
    checksum = zlib.crc32(
        b"".join(np.ascontiguousarray(r.value).tobytes() for r in replies)
    )
    lat_hist = latency_hist_ms([r.latency_s for r in replies])
    p50, p99 = lat_hist.percentile(50.0), lat_hist.percentile(99.0)

    twin_report = None
    if twin:
        # unbatched golden: every request through the direct path, on the
        # CLEAN payload (the fault seam sits on submit(), so a degraded
        # request's twin is the counterfactual healthy answer — bitwise
        # comparison is therefore restricted to undegraded requests)
        t0d = time.monotonic()
        direct_lat = []
        equal = True
        compared = 0
        for i, payload in enumerate(pays):
            td = time.monotonic()
            golden = engine.direct_predict(tenant, model, payload, version=version)
            direct_lat.append(time.monotonic() - td)
            if i in degraded:
                continue
            compared += 1
            got = replies[i].value
            if (
                got.shape != golden.shape
                or got.dtype != golden.dtype
                or got.tobytes() != golden.tobytes()
            ):
                equal = False
        dwall = time.monotonic() - t0d
        dp50, dp99 = _percentiles_ms(direct_lat)
        twin_report = {
            "predictions_per_sec": rows / dwall if dwall > 0 else float("inf"),
            "p50_ms": dp50,
            "p99_ms": dp99,
            "bitwise_equal": equal,
            "compared": compared,
        }

    d_batches = int(after["batches"] - before["batches"])
    d_dispatches = int(after["dispatches"] - before["dispatches"])
    d_rows = int(after["rows"] - before["rows"])
    d_padded = int(after["padded_rows"] - before["padded_rows"])
    return LoadReport(
        n_requests=len(arrivals),
        rows=rows,
        wall_s=wall,
        predictions_per_sec=rows / wall if wall > 0 else float("inf"),
        p50_ms=p50,
        p99_ms=p99,
        degraded=degraded,
        checksum=int(checksum),
        batches=d_batches,
        dispatches=d_dispatches,
        dispatches_per_batch=(d_dispatches / d_batches) if d_batches else 0.0,
        batch_occupancy=(d_rows / d_padded) if d_padded else 0.0,
        payload_bytes=int(after["payload_bytes"] - before["payload_bytes"]),
        reply_bytes=int(after["reply_bytes"] - before["reply_bytes"]),
        twin=twin_report,
        trace_ids=tuple(r.trace_id for r in replies),
        latency_hist=lat_hist.state(),
    )
