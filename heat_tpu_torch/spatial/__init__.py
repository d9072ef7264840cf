"""Spatial functions: pairwise distances."""

from .distance import cdist, quadratic_d2

__all__ = ["cdist", "quadratic_d2"]
