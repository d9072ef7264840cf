"""Abstract domain for sharding states.

Port of ``heat_tpu/analysis/splitflow/domain.py``, copied (stdlib-only).

The runtime invariant this mirrors: a DNDarray is split along at most ONE
axis (``split ∈ {None, 0..ndim-1}``) and its at-rest buffer may be padded
along a ragged split axis.  The abstract value adds ⊤ ("could be
anything") so the dataflow engine can stay sound where it cannot prove a
layout, and optionally carries the static shape/dtype so the comm-cost
report can price layout changes with the exact arithmetic of
:mod:`heat_tpu_torch.comm._costs`.

Lattice (on the ``split`` component)::

            ⊤  (unknown)
          / | \\
      None  0  1  ...     (known layouts)

``join`` goes UP (toward ⊤) — merging two control-flow paths that commit
different layouts yields "unknown", never a wrong concrete guess.  Rules
fire only on *known* facts, so ⊤ silences them; the oracle lane keeps the
engine honest about how often it reaches ⊤ on real pipelines (it must
not, for the supported op surface).

The lattice height is 2, so every loop fixpoint converges in at most two
body passes — the engine exploits that bound directly.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

__all__ = ["NOT_ARRAY", "Spec", "TOP", "UNKNOWN", "join", "join_split"]


class _Top:
    """Singleton ⊤ for the split component (distinct from None, which is
    the *known* replicated layout)."""

    __slots__ = ()

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return "⊤"


TOP = _Top()


@dataclass(frozen=True)
class Spec:
    """Abstract sharding state of one value.

    ``split``
        ``None`` (known replicated), an ``int`` axis (known split), or
        :data:`TOP` (unknown).
    ``shape`` / ``dtype``
        Static global shape and canonical dtype name when the engine
        could prove them (tuple literals reaching a factory call), else
        None.  Only used for costing and range checks — never required.
    ``ragged``
        True when the split axis is known not to divide evenly (the
        at-rest buffer is padded).
    ``is_array``
        False for abstract values that are *not* DNDarrays (estimators,
        scalars, plans); transfer functions ignore those operands.
    """

    split: object = TOP
    shape: Optional[Tuple[int, ...]] = None
    dtype: Optional[str] = None
    ragged: bool = False
    is_array: bool = True

    @property
    def known(self) -> bool:
        return self.split is not TOP

    @property
    def ndim(self) -> Optional[int]:
        return len(self.shape) if self.shape is not None else None

    def with_split(self, split) -> "Spec":
        return replace(self, split=split)

    def widened(self) -> "Spec":
        return replace(self, split=TOP)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        bits = [f"split={self.split!r}" if self.known else "split=⊤"]
        if self.shape is not None:
            bits.append(f"shape={self.shape}")
        if self.dtype is not None:
            bits.append(f"dtype={self.dtype}")
        if self.ragged:
            bits.append("ragged")
        if not self.is_array:
            bits = ["non-array"]
        return f"Spec({', '.join(bits)})"


#: the all-unknown array value — what the engine assumes for function
#: parameters with no call-site information
UNKNOWN = Spec()

#: abstract value for non-DNDarray objects (estimators, scalars, shapes)
NOT_ARRAY = Spec(split=TOP, is_array=False)


def join_split(a, b):
    """Least upper bound of two split components."""
    if a is TOP or b is TOP:
        return TOP
    return a if a == b else TOP


def join(a: Spec, b: Spec) -> Spec:
    """Least upper bound of two abstract values (per-component)."""
    if a is b:
        return a
    if not a.is_array and not b.is_array:
        return NOT_ARRAY
    return Spec(
        split=join_split(a.split, b.split),
        shape=a.shape if a.shape == b.shape else None,
        dtype=a.dtype if a.dtype == b.dtype else None,
        ragged=a.ragged or b.ragged,
        is_array=True,
    )
