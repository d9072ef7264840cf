"""The operation count behind ``chip_smoke.py``'s attention bounds, on the CPU.

A bound counts the work the function needs, not what a kernel's tiling
visits: 4*D operations per head for each (query, key) pair the softmax
keeps, every pair without a mask and the lower triangle under causal.
"""

import pytest
import torch

import chip_smoke


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S,Sk", [(1, 1), (5, 3), (3, 5), (128, 384), (384, 128), (256, 256)])
def test_attention_operations_count_the_pairs_the_function_needs(S, Sk, causal):
    keep = torch.ones(S, Sk, dtype=torch.bool)
    if causal:
        keep = torch.tril(keep)  # key j is kept for query i when j <= i
    D, heads = 8, 3
    assert chip_smoke.attn_flops(S, Sk, D, heads, causal) == 4 * D * heads * int(keep.sum())
