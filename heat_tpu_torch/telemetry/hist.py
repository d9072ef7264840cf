"""Fixed-memory streaming histograms with log-spaced buckets.

Port of ``heat_tpu/telemetry/hist.py`` (stdlib only, copied; ``state()``
is the reference's for the same observations).  Percentiles over
unbounded observation streams — per-call latencies, queue depths —
without retaining every sample.  In a :class:`Histogram` observations land
in logarithmically spaced buckets, so the whole structure is a bounded
dict of integer counts no matter how many values stream through, any
quantile is recoverable within a *documented multiplicative error
bound*, and two histograms merge by adding counts — an associative,
commutative operation, so per-thread (or per-replica) histograms combine
into the global one in any order.

Bucket scheme (``log8``)
------------------------
``BUCKETS_PER_OCTAVE = 8`` sub-buckets per power of two: a positive
value ``v`` lands in bucket ``k = floor(8 * log2(v))``, which covers the
half-open interval ``[2**(k/8), 2**((k+1)/8))`` — a growth factor of
``2**(1/8) ≈ 1.0905`` per bucket.  Quantiles report the bucket's
*geometric midpoint* ``2**((k + 0.5)/8)``, so the estimate is off from
the true sample by at most a factor of ``2**(1/16)`` in either
direction: the relative error bound is

    ``REL_ERROR = 2**(1/16) - 1 ≈ 4.4%``

independent of the value's magnitude (that is the point of log spacing —
a 2 ms p50 and a 900 ms p99 carry the same relative precision).  Values
``<= 0`` (and exact zeros, common for "no wait" latencies) are counted
in a dedicated zero bucket whose representative is ``0.0``; bucket
indices clamp to ``[K_MIN, K_MAX]`` (≈ 2.3e-10 .. 4.3e9 at 8/octave), so
memory is bounded by the fixed index range even for adversarial inputs.

Determinism: bucketing a value is a pure function of the value (no
clocks, no randomness), iteration orders are sorted, and ``state()``
emits a canonically ordered dict — two runs observing the same stream
produce byte-identical serialized states, which is what lets the flight
recorder's postmortem dumps embed histograms and stay replayable.

Kept free of numpy and torch so :mod:`heat_tpu_torch.telemetry._core`
can host a registry of these.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["Histogram"]

#: sub-buckets per power of two (the "log8" scheme)
_BPO = 8
#: clamp range for bucket indices: 2**(-256/8) = 2**-32 .. 2**32
_K_MIN = -256
_K_MAX = 256


class Histogram:
    """One fixed-memory log-bucketed histogram (see module docs).

    ``record`` / ``quantile`` / ``merge`` are **not** internally locked —
    the telemetry registry serializes access under its own lock, and a
    thread-private histogram needs none.  Merging is associative and
    commutative over the bucket counts, so sharded recording composes.
    """

    #: buckets per octave of the log2 scheme — merge requires equality
    BUCKETS_PER_OCTAVE = _BPO
    #: documented multiplicative quantile error: the geometric-midpoint
    #: estimate is within a factor 2**(1/(2*BPO)) of the true sample
    REL_ERROR = 2.0 ** (1.0 / (2 * _BPO)) - 1.0

    __slots__ = ("counts", "zero", "count", "sum", "min", "max")

    def __init__(self):
        self.counts: Dict[int, int] = {}
        self.zero = 0  # observations <= 0 (representative value 0.0)
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    # ------------------------------------------------------------------ #
    # recording
    # ------------------------------------------------------------------ #
    @staticmethod
    def bucket_index(value: float) -> int:
        """The bucket of a positive ``value``: ``floor(8*log2(v))``,
        clamped to the fixed index range."""
        k = math.floor(_BPO * math.log2(value))
        return _K_MIN if k < _K_MIN else (_K_MAX if k > _K_MAX else k)

    @staticmethod
    def bucket_bounds(k: int) -> Tuple[float, float]:
        """``[lo, hi)`` interval of bucket ``k``."""
        return 2.0 ** (k / _BPO), 2.0 ** ((k + 1) / _BPO)

    @staticmethod
    def bucket_mid(k: int) -> float:
        """Geometric midpoint of bucket ``k`` — the quantile
        representative, within ``REL_ERROR`` of any member."""
        return 2.0 ** ((k + 0.5) / _BPO)

    def record(self, value: float) -> None:
        """Observe one value."""
        value = float(value)
        if value != value:  # NaN: count it (the stream saw it) as zero-
            # bucket poison is wrong; drop into min/max-neutral zero slot
            self.zero += 1
            self.count += 1
            return
        self.count += 1
        self.sum += value
        if self.min is None or value < self.min:
            self.min = value
        if self.max is None or value > self.max:
            self.max = value
        if value <= 0.0:
            self.zero += 1
            return
        k = self.bucket_index(value)
        self.counts[k] = self.counts.get(k, 0) + 1

    # ------------------------------------------------------------------ #
    # merging
    # ------------------------------------------------------------------ #
    def merge(self, other: "Histogram") -> "Histogram":
        """Fold ``other``'s counts into ``self`` (in place; returns self).

        Associative and commutative over bucket counts and extrema;
        ``sum`` is a float accumulation, exact whenever the observed
        values are (e.g. dyadic rationals), otherwise within rounding.
        """
        if other.BUCKETS_PER_OCTAVE != self.BUCKETS_PER_OCTAVE:
            raise ValueError("cannot merge histograms of different schemes")
        for k, c in other.counts.items():
            self.counts[k] = self.counts.get(k, 0) + c
        self.zero += other.zero
        self.count += other.count
        self.sum += other.sum
        if other.min is not None and (self.min is None or other.min < self.min):
            self.min = other.min
        if other.max is not None and (self.max is None or other.max > self.max):
            self.max = other.max
        return self

    def copy(self) -> "Histogram":
        h = Histogram()
        h.counts = dict(self.counts)
        h.zero, h.count, h.sum = self.zero, self.count, self.sum
        h.min, h.max = self.min, self.max
        return h

    # ------------------------------------------------------------------ #
    # quantiles
    # ------------------------------------------------------------------ #
    def quantile(self, q: float) -> float:
        """The ``q``-quantile (``0 <= q <= 1``) as the geometric midpoint
        of the bucket holding the nearest-rank sample — within
        ``REL_ERROR`` of that sample.  An empty histogram answers
        ``0.0`` (the guard the serving percentiles rely on)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile needs 0 <= q <= 1, got {q}")
        if self.count == 0:
            return 0.0
        # nearest-rank (0-indexed): the ceil(q*n)-th smallest observation
        rank = max(0, min(self.count - 1, math.ceil(q * self.count) - 1))
        if rank < self.zero:
            return 0.0
        cum = self.zero
        for k in sorted(self.counts):
            cum += self.counts[k]
            if rank < cum:
                return self.bucket_mid(k)
        return self.bucket_mid(max(self.counts))  # pragma: no cover

    def percentile(self, p: float) -> float:
        """``quantile(p / 100)`` — the numpy-flavoured spelling."""
        return self.quantile(p / 100.0)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    # ------------------------------------------------------------------ #
    # export
    # ------------------------------------------------------------------ #
    def state(self) -> dict:
        """Canonical serializable state: sorted buckets, stable keys —
        the form the flight recorder embeds in postmortem dumps and
        ``telemetry.snapshot()`` reports under ``hists``."""
        return {
            "scheme": f"log{_BPO}",
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "zero": self.zero,
            "buckets": {str(k): self.counts[k] for k in sorted(self.counts)},
            "p50": self.quantile(0.5),
            "p99": self.quantile(0.99),
        }

    def prom_buckets(self) -> List[Tuple[float, int]]:
        """Cumulative ``(le, count)`` pairs for the Prometheus histogram
        exposition: one boundary per occupied bucket's upper edge (the
        zero bucket maps to ``le=0``), plus the implicit ``+Inf`` total
        the exporter appends."""
        out: List[Tuple[float, int]] = []
        cum = 0
        if self.zero:
            cum += self.zero
            out.append((0.0, cum))
        for k in sorted(self.counts):
            cum += self.counts[k]
            out.append((self.bucket_bounds(k)[1], cum))
        return out

    @classmethod
    def from_state(cls, state: dict) -> "Histogram":
        """Rebuild a histogram from a ``state()`` dict — the inverse of
        :meth:`state`, used to merge histograms shipped across a process
        boundary (replica RPC frames carry states, never objects).

        ``from_state(h.state()).state() == h.state()`` holds exactly:
        everything a state carries round-trips, so merging rebuilt
        replica histograms is byte-for-byte the same as merging the
        originals."""
        scheme = state.get("scheme")
        if scheme != f"log{_BPO}":
            raise ValueError(f"cannot rebuild scheme {scheme!r} (want 'log{_BPO}')")
        h = cls()
        h.count = int(state["count"])
        h.sum = float(state["sum"])
        h.min = None if state["min"] is None else float(state["min"])
        h.max = None if state["max"] is None else float(state["max"])
        h.zero = int(state["zero"])
        h.counts = {int(k): int(c) for k, c in state["buckets"].items()}
        return h

    @classmethod
    def of(cls, values: Iterable[float]) -> "Histogram":
        """Build a histogram from an iterable (test/report convenience)."""
        h = cls()
        for v in values:
            h.record(v)
        return h

    def __len__(self) -> int:
        return self.count

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (
            f"Histogram(count={self.count}, p50={self.quantile(0.5):.4g}, "
            f"p99={self.quantile(0.99):.4g})"
        )
