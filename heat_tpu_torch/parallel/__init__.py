"""Sequence/context parallelism: attention and its communication primitives.

Port of the attention part of ``heat_tpu/parallel``: :func:`flash_attention`
and :func:`flash_attention_partial` (kernels B3/B4, hand-written CUDA for
Hopper), :func:`ring_attention` (contiguous and zig-zag causal),
:func:`ulysses_attention`, and the ring primitives they are built on.
``sort``/``take`` are not ported yet.
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
    "ring_self_attention",
    "ulysses_attention",
]
