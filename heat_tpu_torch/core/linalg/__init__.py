"""Linear algebra: matrix products and norms, QR, SVD and solvers."""

from . import basics, solver
from .basics import *  # noqa: F401,F403
from .qr import QR, qr
from .solver import *  # noqa: F401,F403
from .svd import SVD, svd

__all__ = basics.__all__ + solver.__all__ + ["QR", "SVD", "qr", "svd"]
