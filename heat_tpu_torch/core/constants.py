"""Mathematical constants.

Port of ``heat_tpu/core/constants.py``: plain Python floats, the same
values and the same aliases.
"""

import numpy as np

__all__ = ["e", "Euler", "inf", "Inf", "Infty", "Infinity", "nan", "NaN", "pi"]

e = float(np.e)
"""Euler's number."""
pi = float(np.pi)
"""Archimedes' constant."""
inf = float("inf")
"""IEEE positive infinity."""
nan = float("nan")
"""IEEE not-a-number."""

Euler = e
Inf = inf
Infty = inf
Infinity = inf
NaN = nan
INF = inf
NAN = nan
NINF = -inf
PI = pi
E = e
