"""Profiling hooks.

Port of ``heat_tpu/utils/profiler.py`` onto ``torch.profiler``: a traced
region whose trace is written to a directory, a labelled range inside a
trace, and a wall-clock timer that waits for the card.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Iterator, Optional

import torch

__all__ = ["profile", "timer", "annotate"]


@contextlib.contextmanager
def profile(logdir: Optional[str] = None) -> Iterator[torch.profiler.profile]:
    """Trace the region on the host and, where there is one, the card, and
    write a Chrome trace (``trace.json``) into ``logdir`` (default: a
    ``heat_tpu_torch_profile`` directory under the temporary directory).

    >>> with htt.utils.profiler.profile("traces"):
    ...     htt.linalg.qr(x)
    """
    logdir = logdir or os.path.join(tempfile.gettempdir(), "heat_tpu_torch_profile")
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Label a region of the trace (``torch.profiler.record_function``)."""
    with torch.profiler.record_function(name):
        yield


class timer(contextlib.AbstractContextManager):
    """Wall-clock timer that waits for the card's queued work at the end
    (``sync=True``, where there is a card).

    >>> with htt.utils.profiler.timer() as t:
    ...     y = (x @ x.T).sum()
    >>> t.seconds
    """

    def __init__(self, sync: bool = True):
        self.sync = sync
        self.seconds: Optional[float] = None

    def __enter__(self):
        if self.sync and torch.cuda.is_available():
            torch.cuda.synchronize()
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync and torch.cuda.is_available():
            torch.cuda.synchronize()
        self.seconds = time.perf_counter() - self._start
        return False
