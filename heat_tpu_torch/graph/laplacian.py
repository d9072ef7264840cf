"""Graph Laplacians from similarity matrices.

Port of ``heat_tpu/graph/laplacian.py``: the adjacency from a pairwise
similarity (fully connected, or an epsilon neighbourhood by a threshold),
no self-loops, then the simple ``L = D - A`` or the symmetrically
normalized ``I - D^{-1/2} A D^{-1/2}`` Laplacian, in float32.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core import types
from ..core.dndarray import DNDarray
from ..core.sanitation import sanitize_in

__all__ = ["Laplacian"]


class Laplacian:
    """Laplacian operator builder.

    Parameters
    ----------
    similarity : callable(DNDarray) -> DNDarray
        Maps (n, f) data to an (n, n) similarity matrix.
    weighted : bool — keep the similarities as edge weights (else 1)
    definition : 'simple' | 'norm_sym'
    mode : 'fully_connected' | 'eNeighbour'
    threshold_key : 'upper' | 'lower' — keep edges below / above the threshold
    threshold_value : float
    neighbours : int — accepted as the reference accepts it (unused there too)
    """

    def __init__(
        self,
        similarity: Callable,
        weighted: bool = True,
        definition: str = "norm_sym",
        mode: str = "fully_connected",
        threshold_key: str = "upper",
        threshold_value: float = 1.0,
        neighbours: int = 10,
    ):
        self.similarity_metric = similarity
        self.weighted = weighted
        if definition not in ("simple", "norm_sym"):
            raise NotImplementedError(
                "Only simple and normalized symmetric graphs supported, got " + definition
            )
        if mode not in ("fully_connected", "eNeighbour"):
            raise NotImplementedError(
                "Only eNeighbour or fully-connected graphs supported, got " + mode
            )
        self.definition = definition
        self.mode = mode
        self.epsilon = (threshold_key, threshold_value)
        self.neighbours = neighbours

    def _normalized_symmetric_L(self, A: torch.Tensor) -> torch.Tensor:
        """``I - D^{-1/2} A D^{-1/2}``."""
        degree = torch.sum(A, dim=1)
        d_inv_sqrt = torch.where(degree > 0, 1.0 / torch.sqrt(degree), torch.zeros_like(degree))
        L = -A * d_inv_sqrt[:, None] * d_inv_sqrt[None, :]
        L.fill_diagonal_(1.0)
        return L

    def _simple_L(self, A: torch.Tensor) -> torch.Tensor:
        """``D - A``."""
        return torch.diag(torch.sum(A, dim=1)) - A

    def construct(self, X: DNDarray) -> DNDarray:
        """The Laplacian of the rows of ``X``: (n, n) float32, row-split
        when ``X`` is."""
        sanitize_in(X)
        A = self.similarity_metric(X).larray.to(torch.float32)
        if self.mode == "eNeighbour":
            key, val = self.epsilon
            keep = A < val if key == "upper" else A > val
            A = torch.where(keep, A if self.weighted else torch.ones_like(A), torch.zeros_like(A))
        else:
            A = A.clone()  # the similarity's tensor is the caller's
        A.fill_diagonal_(0.0)  # no self-loops
        L = self._normalized_symmetric_L(A) if self.definition == "norm_sym" else self._simple_L(A)
        split = X.split if X.split == 0 else None
        return DNDarray(L, tuple(L.shape), types.float32, split, X.device, X.comm)
