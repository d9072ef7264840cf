"""Classification estimators."""

from .knn import KNN

__all__ = ["KNN"]
