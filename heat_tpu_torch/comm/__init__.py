"""Compressed collectives and their wire-cost model."""

from . import compressed
from .compressed import *  # noqa: F401,F403
