"""Compressed collectives, their wire-cost model, and the ring-dispatch
telemetry (``overlap``)."""

from . import compressed, overlap
from .compressed import *  # noqa: F401,F403
from ._costs import stream_model  # noqa: F401
