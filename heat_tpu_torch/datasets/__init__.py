"""Bundled datasets for tests and demos: iris and diabetes.

Port of ``heat_tpu/datasets``.  The port reads the repository's data
files in place, under ``heat_tpu/datasets/data/`` beside the port's
package, found by a path relative to this file (never by importing the
JAX package).  So an installed port without the repository's
``heat_tpu/datasets/data`` next to it cannot find them: :func:`data_path`
names where it looked.  ``load_iris`` and ``load_diabetes`` read HDF5 and
need ``h5py``; ``load_iris_split`` reads CSV.
"""

from __future__ import annotations

import os
from typing import Optional

_DATA_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "heat_tpu", "datasets", "data",
)

__all__ = ["data_path", "load_iris", "load_iris_split", "load_diabetes"]


def data_path(name: str) -> str:
    """Absolute path of a bundled data file (e.g. 'iris.csv', 'iris.h5',
    'diabetes.h5')."""
    return os.path.join(_DATA_DIR, name)


def load_iris(split: Optional[int] = None, device=None):
    """The iris measurements as a (150, 4) float32 DNDarray."""
    from ..core import io

    return io.load_hdf5(data_path("iris.h5"), "data", split=split, device=device)


def load_iris_split(split: Optional[int] = None, device=None):
    """The bundled 75/75 iris train/test split as four DNDarrays
    ``(X_train, X_test, y_train, y_test)``."""
    from ..core import io, types

    x_tr = io.load_csv(data_path("iris_X_train.csv"), sep=";", split=split, device=device)
    x_te = io.load_csv(data_path("iris_X_test.csv"), sep=";", split=split, device=device)
    y_tr = io.load_csv(data_path("iris_y_train.csv"), dtype=types.int32, split=split, device=device)
    y_te = io.load_csv(data_path("iris_y_test.csv"), dtype=types.int32, split=split, device=device)
    return x_tr, x_te, y_tr.flatten(), y_te.flatten()


def load_diabetes(split: Optional[int] = None, device=None):
    """The diabetes regression set: (x, y) DNDarrays of shape (442, 10) and
    (442,), float64."""
    from ..core import io, types

    x = io.load_hdf5(data_path("diabetes.h5"), "x", dtype=types.float64, split=split, device=device)
    y = io.load_hdf5(data_path("diabetes.h5"), "y", dtype=types.float64, split=split, device=device)
    return x, y
