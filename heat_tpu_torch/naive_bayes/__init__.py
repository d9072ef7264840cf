"""Naive Bayes classifiers."""

from .gaussianNB import GaussianNB

__all__ = ["GaussianNB"]
