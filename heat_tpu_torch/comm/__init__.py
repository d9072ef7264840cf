"""The comm layer: compressed collectives, planned redistribution and the
ring-overlap policy (port of ``heat_tpu/comm``).

``htt.comm.set_collective_precision("int8_block")`` puts every eligible
cross-position combine on the block-scaled quantized rings
(:mod:`heat_tpu_torch.comm.compressed`).

``htt.comm.set_redistribution("planned")`` routes ``resplit`` /
``alltoall`` / ``commit_split`` through the redistribution planner
(:mod:`heat_tpu_torch.comm.redistribute`); ``"auto"``, the default, plans
split -> split changes of at least the threshold.

``htt.comm.set_overlap("on")`` is the ring-overlap policy
(:mod:`heat_tpu_torch.comm.overlap`); on one card ``"auto"`` is serial.
"""

from . import compressed, redistribute
from ._costs import stream_model
from .overlap import (
    get_overlap,
    overlap,
    overlap_enabled,
    set_overlap,
)
from .redistribute import (
    Plan,
    get_redistribution,
    get_redistribution_threshold,
    grid_redistribute_or_none,
    monolithic_model,
    plan,
    redistribution,
    set_redistribution,
    set_redistribution_threshold,
)
from .compressed import (
    BLOCK,
    allgather_q,
    allreduce_q,
    collective_precision,
    dequantize_blocks,
    get_collective_precision,
    get_collective_threshold,
    quantize_blocks,
    reduce_mode,
    ring_allgather_q,
    ring_allreduce_q,
    ring_allreduce_q_ef,
    set_collective_precision,
    set_collective_threshold,
)

__all__ = [
    "BLOCK",
    "Plan",
    "allgather_q",
    "allreduce_q",
    "collective_precision",
    "compressed",
    "dequantize_blocks",
    "get_collective_precision",
    "get_collective_threshold",
    "get_overlap",
    "get_redistribution",
    "get_redistribution_threshold",
    "grid_redistribute_or_none",
    "monolithic_model",
    "overlap",
    "overlap_enabled",
    "plan",
    "quantize_blocks",
    "redistribute",
    "redistribution",
    "reduce_mode",
    "ring_allgather_q",
    "ring_allreduce_q",
    "ring_allreduce_q_ef",
    "set_collective_precision",
    "set_collective_threshold",
    "set_overlap",
    "set_redistribution",
    "set_redistribution_threshold",
    "stream_model",
]
