"""``htt.io``: file IO and the out-of-core streaming path.

Port of ``heat_tpu/io``.  The flat loaders and savers
(:func:`load_hdf5`, :func:`save_netcdf`, ...) live in
:mod:`heat_tpu_torch.core.io` and are re-exported here unchanged, so
``htt.io.load(...)`` works; :mod:`heat_tpu_torch.io.stream` adds the
chunked stream sources over on-disk HDF5/NetCDF-3 datasets with the
``set_prefetch`` double-buffering policy that the mini-batch fits
(``KMeans(mini_batch=...)``, ``Lasso(solver="gd", mini_batch=...)``)
consume.
"""

from ..core.io import *  # noqa: F401,F403 — the flat io API, re-exported
from ..core.io import HDF5_EXTENSIONS  # noqa: F401 — shared routing table
from ..core.io import __all__ as _core_all

from . import stream  # noqa: F401
from .stream import (  # noqa: F401
    ArraySource,
    HDF5Source,
    NetCDFSource,
    StreamSource,
    as_source,
    get_prefetch,
    prefetch,
    prefetch_enabled,
    reset_slab_peak,
    set_prefetch,
    slab_peak,
    stream_chunks,
)

__all__ = list(_core_all) + [
    "ArraySource",
    "HDF5Source",
    "NetCDFSource",
    "StreamSource",
    "as_source",
    "get_prefetch",
    "prefetch",
    "prefetch_enabled",
    "reset_slab_peak",
    "set_prefetch",
    "slab_peak",
    "stream",
    "stream_chunks",
]
