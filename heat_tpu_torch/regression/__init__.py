"""Regression estimators."""

from .lasso import Lasso

__all__ = ["Lasso"]
