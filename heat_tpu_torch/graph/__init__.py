"""Graph Laplacians."""

from .laplacian import Laplacian

__all__ = ["Laplacian"]
