"""Sequence/context parallelism: attention and its communication primitives.

Port of the attention part of ``heat_tpu/parallel``: :func:`flash_attention`
and :func:`flash_attention_partial` (kernels B3/B4, hand-written CUDA for
Hopper), :func:`ring_attention` (contiguous and zig-zag causal),
:func:`ulysses_attention`, the ring primitives they are built on, and
the distributed sort (:func:`ring_rank_sort`, :func:`sort_axis0`) and
take/put (:func:`ring_take`, :func:`ring_put`).
"""

from .flash_attention import conforms, flash_attention, flash_attention_partial
from .primitives import (
    all_to_all_resplit,
    halo_exchange,
    prefix_scan,
    prefix_sum,
    ring_map,
    ring_source,
)
from .ring_attention import ring_attention, ring_self_attention
from .sort import ring_rank_sort, sort_axis0
from .take import ring_put, ring_take
from .ulysses import ulysses_attention

__all__ = [
    "all_to_all_resplit",
    "conforms",
    "flash_attention",
    "flash_attention_partial",
    "halo_exchange",
    "prefix_scan",
    "prefix_sum",
    "ring_map",
    "ring_source",
    "ring_attention",
    "ring_put",
    "ring_rank_sort",
    "ring_take",
    "sort_axis0",
    "ring_self_attention",
    "ulysses_attention",
]
