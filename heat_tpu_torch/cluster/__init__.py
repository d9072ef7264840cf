"""Clustering estimators."""

from .kmeans import KMeans

__all__ = ["KMeans"]
