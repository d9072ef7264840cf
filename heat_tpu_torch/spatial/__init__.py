"""Spatial functions: pairwise distances."""

from .distance import cdist, manhattan, quadratic_d2, rbf

__all__ = ["cdist", "manhattan", "quadratic_d2", "rbf"]
