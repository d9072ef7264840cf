"""Utilities: the test-matrix gallery and the profiling hooks."""

from . import matrixgallery, profiler
