"""Fitted-estimator checkpoints.

Port of ``heat_tpu/core/checkpoint.py``: one HDF5 file per estimator,
with a typed JSON manifest (a file attribute) describing the constructor
parameters and the fitted attributes: scalars and small host arrays
inline, large host arrays spilled to datasets, nested estimators
recursively, DNDarrays by dataset key with their split; everything
written in one file open with one atomic commit.  A DNDarray reachable
twice (Spectral's labels are its KMeans's) is written once and re-linked
on load.

**Files cross between the packages.**  The manifest names each class by
the JAX package's path, ``heat_tpu.<module>:<Class>``, which the
reference's loader accepts; the port maps such a path to
``heat_tpu_torch.<module>`` and imports only that, never a ``heat_tpu``
module.  Any other module prefix is refused, as the reference refuses
it.  The manifest records no device: DNDarrays load onto the default
communicator (or its device), wherever the file was written.
"""

from __future__ import annotations

import importlib
import json
import os
from typing import Any, Dict

import numpy as np
import torch

from ..telemetry import _core as _tel
from . import io as _io
from . import types
from .base import BaseEstimator
from .dndarray import DNDarray

__all__ = ["list_checkpoints", "load_estimator", "save_estimator"]

_MANIFEST_ATTR = "heat_tpu_estimator"
#: manifest schema version written (as ``format_version``); v1 manifests
#: (the version under the legacy ``format`` key) stay readable
_FORMAT_VERSION = 2
_READABLE_VERSIONS = (1, 2)
#: inline-manifest budget for host numpy arrays; bigger ones spill to a
#: dataset
_NPARRAY_INLINE_MAX = 16384
#: the package whose class paths the manifests name, and this one
_REF_PACKAGE = "heat_tpu"
_PORT_PACKAGE = __name__.split(".")[0]


class _SaveContext:
    """Dataset accumulator with identity dedup: the same DNDarray (or the
    same host array object) reachable twice is written once."""

    def __init__(self):
        self.datasets: Dict[str, Any] = {}
        self._by_id: Dict[int, str] = {}
        # id() keys hold only while the object lives: keep every identity
        # object, so a freed temporary's address never dedups falsely
        self._keepalive: list = []

    def add(self, value, key: str, ident=None) -> str:
        """Register ``value`` under ``key`` unless the identity object
        (``ident``, default the value itself) was registered before."""
        obj = value if ident is None else ident
        existing = self._by_id.get(id(obj))
        if existing is not None:
            return existing
        self._by_id[id(obj)] = key
        self._keepalive.append(obj)
        self.datasets[key] = value
        return key


def _encode(value, key: str, ctx: _SaveContext) -> Dict[str, Any]:
    """One manifest entry for ``value``; DNDarrays (and spilled host
    arrays) land in ``ctx`` under ``key`` (or an earlier key on a dedup
    hit)."""
    if isinstance(value, DNDarray):
        return {
            "kind": "dndarray",
            "key": ctx.add(value, key),
            "split": value.split,
            "dtype": value.dtype.__name__,
        }
    if isinstance(value, BaseEstimator):
        return {"kind": "estimator", "manifest": _manifest(value, key + "/", ctx)}
    ident = None
    if isinstance(value, torch.Tensor):
        # dedup keys on the original tensor: each host copy is new
        ident = value
        value = _io._host(value)
        if value.ndim == 0:
            value = value.item()
    if isinstance(value, np.generic):
        value = value.item()
    is_bf16 = isinstance(value, np.ndarray) and value.dtype.name == "bfloat16"
    if isinstance(value, np.ndarray) and (value.dtype.kind in "biuf" or is_bf16):
        obj = ident if ident is not None else value
        if value.size > _NPARRAY_INLINE_MAX:
            existing = ctx._by_id.get(id(obj))
            if existing is not None:
                heat_dtype = types.canonical_heat_type(ctx.datasets[existing].dtype).__name__
                used = existing
            else:
                host = np.ascontiguousarray(value)
                if is_bf16:
                    host = host.astype(np.float32)  # exact widening
                heat_dtype = types.canonical_heat_type(host.dtype).__name__
                used = ctx.add(host, key, ident=obj)
            return {
                "kind": "nparray_dataset",
                "key": used,
                "dtype": value.dtype.name,
                "heat_dtype": heat_dtype,
            }
        return {
            "kind": "nparray",
            "dtype": value.dtype.name,
            "shape": list(value.shape),
            "data": value.ravel().tolist(),
        }
    if value is None or isinstance(value, (bool, int, float, str)):
        return {"kind": "scalar", "value": value}
    if isinstance(value, (list, tuple)):
        if all(v is None or isinstance(v, (bool, int, float, str)) for v in value):
            # JSON collapses tuples into lists: record which it was
            return {
                "kind": "scalar",
                "value": list(value),
                "tuple": isinstance(value, tuple),
            }
    raise TypeError(
        f"cannot checkpoint {key!r} of type {type(value).__name__}: {value!r} "
        "(supported: DNDarray, estimators, scalars, strings, numeric "
        "bool/int/uint/float host numpy arrays, flat scalar lists)"
    )


def _in_package(mod_name: str, package: str) -> bool:
    return mod_name == package or mod_name.startswith(package + ".")


def _manifest(est: BaseEstimator, prefix: str, ctx: _SaveContext):
    cls = type(est)
    mod = cls.__module__
    if not _in_package(mod, _PORT_PACKAGE):
        raise TypeError(
            f"cannot checkpoint {mod}.{cls.__qualname__}: only {_PORT_PACKAGE} "
            "estimator classes are re-importable at load time"
        )
    ref_mod = _REF_PACKAGE + mod[len(_PORT_PACKAGE):]
    out: Dict[str, Any] = {
        "class": f"{ref_mod}:{cls.__qualname__}",
        "params": {},
        "fitted": {},
    }
    params = est.get_params(deep=False)
    for name, value in params.items():
        out["params"][name] = _encode(value, f"{prefix}params/{name}", ctx)
    for name in est._checkpoint_attrs():
        if name in params or not hasattr(est, name):
            continue
        out["fitted"][name] = _encode(getattr(est, name), f"{prefix}fitted/{name}", ctx)
    return out


def save_estimator(est: BaseEstimator, path: str) -> None:
    """Write ``est`` (constructor parameters and fitted state) to one
    HDF5 file, atomically."""
    if not _io.supports_hdf5():
        raise RuntimeError("h5py is required for estimator checkpointing")
    if not isinstance(est, BaseEstimator):
        raise TypeError(f"est must be a BaseEstimator, got {type(est)}")
    if not isinstance(path, str):
        raise TypeError(f"path must be str, not {type(path)}")
    if os.path.splitext(path)[-1].strip().lower() not in _io.HDF5_EXTENSIONS:
        raise ValueError("estimator checkpoints are HDF5: use a .h5/.hdf5 path")

    ctx = _SaveContext()
    manifest = {"format_version": _FORMAT_VERSION, "root": _manifest(est, "", ctx)}
    attrs = {_MANIFEST_ATTR: json.dumps(manifest)}
    if _tel.enabled:
        _tel.inc("checkpoint.saves")
        with _tel.span("ckpt:save_estimator", cls=type(est).__name__, path=path):
            _io._save_hdf5_many(path, sorted(ctx.datasets.items()), attrs=attrs)
        _tel.record_event("checkpoint", site=type(est).__name__, op="save", path=path)
        return
    _io._save_hdf5_many(path, sorted(ctx.datasets.items()), attrs=attrs)


def list_checkpoints(directory: str):
    """Scan one directory (not recursively) for estimator checkpoints:
    one dict per HDF5 file carrying a manifest, sorted by file name,
    ``{"path", "file", "format_version", "class"}``.  HDF5 data files
    without a manifest are skipped; an HDF5-named file that cannot be
    opened, or whose manifest is not valid JSON, raises ``ValueError``
    naming it.  Opens run under the seeded io retry policy."""
    if not _io.supports_hdf5():
        raise RuntimeError("h5py is required for estimator checkpointing")
    h5py = _io.h5py
    if not os.path.isdir(directory):
        raise ValueError(f"{directory} is not a directory")
    out = []
    for name in sorted(os.listdir(directory)):
        if os.path.splitext(name)[-1].strip().lower() not in _io.HDF5_EXTENSIONS:
            continue
        path = os.path.join(directory, name)

        def _open(path=path):
            _io._faults().io_open(path)
            return h5py.File(path, "r")

        try:
            f = _io._retry_open(_open, "checkpoint.list_checkpoints")
        except OSError as e:
            raise ValueError(
                f"{path} is not a readable checkpoint file (missing, "
                f"truncated, or not HDF5): {e}"
            ) from e
        with f:
            raw = f.attrs.get(_MANIFEST_ATTR)
        if raw is None:
            continue
        try:
            manifest = json.loads(raw)
        except (TypeError, ValueError) as e:
            raise ValueError(f"{path}: corrupt estimator manifest: {e}") from e
        if not isinstance(manifest, dict):
            raise ValueError(
                f"{path}: corrupt estimator manifest: expected a JSON "
                f"object, got {type(manifest).__name__}"
            )
        root = manifest.get("root")
        out.append(
            {
                "path": path,
                "file": name,
                "format_version": manifest.get("format_version", manifest.get("format")),
                "class": root.get("class") if isinstance(root, dict) else None,
            }
        )
    return out


def _resolve_class(class_path: str):
    """The port's class for a manifest's ``heat_tpu.<module>:<Class>``:
    ``heat_tpu_torch.<module>``'s, imported without touching the JAX
    package; every other module prefix is refused."""
    mod_name, _, qual = class_path.partition(":")
    if not _in_package(mod_name, _REF_PACKAGE):
        raise ValueError(
            f"refusing to import estimator class from {mod_name!r} "
            f"(only {_REF_PACKAGE} estimators are loadable)"
        )
    mod = importlib.import_module(_PORT_PACKAGE + mod_name[len(_REF_PACKAGE):])
    obj: Any = mod
    for part in qual.split("."):
        obj = getattr(obj, part)
    if not (isinstance(obj, type) and issubclass(obj, BaseEstimator)):
        raise TypeError(f"{class_path} is not a BaseEstimator subclass")
    return obj


def _decode(entry: Dict[str, Any], path: str, cache: Dict[str, Any]):
    kind = entry["kind"]
    if kind == "scalar":
        value = entry["value"]
        if entry.get("tuple"):
            value = tuple(value)
        return value
    if kind == "nparray":
        return np.asarray(entry["data"], dtype=np.dtype(entry["dtype"])).reshape(entry["shape"])
    if kind == "dndarray":
        key = entry["key"]
        if key not in cache:
            dtype = getattr(types, entry["dtype"])
            try:
                cache[key] = _io.load_hdf5(path, key, dtype=dtype, split=entry["split"])
            except KeyError as e:
                raise ValueError(
                    f"{path}: checkpoint dataset {key!r} is missing "
                    "(truncated or corrupted save)"
                ) from e
        return cache[key]
    if kind == "nparray_dataset":
        key = entry["key"]
        if key not in cache:
            dtype = getattr(types, entry["heat_dtype"])
            try:
                loaded = _io.load_hdf5(path, key, dtype=dtype, split=None)
            except KeyError as e:
                raise ValueError(
                    f"{path}: checkpoint dataset {key!r} is missing "
                    "(truncated or corrupted save)"
                ) from e
            cache[key] = loaded.numpy().astype(np.dtype(entry["dtype"]))
        return cache[key]
    if kind == "estimator":
        return _instantiate(entry["manifest"], path, cache)
    raise ValueError(f"unknown checkpoint entry kind {kind!r}")


def _instantiate(manifest: Dict[str, Any], path: str, cache: Dict[str, Any]) -> BaseEstimator:
    cls = _resolve_class(manifest["class"])
    kwargs = {name: _decode(entry, path, cache) for name, entry in manifest["params"].items()}
    est = cls(**kwargs)
    for name, entry in manifest["fitted"].items():
        setattr(est, name, _decode(entry, path, cache))
    return est


def load_estimator(path: str) -> BaseEstimator:
    """Rebuild an estimator written by :func:`save_estimator` (of either
    package): the class is resolved, constructed from its saved
    parameters, and its fitted attributes, nested estimators included,
    restored; arrays the save deduplicated load once and are re-linked."""
    if not _io.supports_hdf5():
        raise RuntimeError("h5py is required for estimator checkpointing")
    h5py = _io.h5py

    def _open():
        _io._faults().io_open(path)
        return h5py.File(path, "r")

    try:
        f = _io._retry_open(_open, "checkpoint.load_estimator")
    except OSError as e:
        raise ValueError(
            f"{path} is not a readable estimator checkpoint (missing, "
            f"truncated, or not HDF5): {e}"
        ) from e
    with f:
        raw = f.attrs.get(_MANIFEST_ATTR)
        if raw is None:
            raise ValueError(f"{path} is not an estimator checkpoint")
        manifest = json.loads(raw)
    version = manifest.get("format_version", manifest.get("format"))
    if version not in _READABLE_VERSIONS:
        raise ValueError(
            f"{path}: unsupported checkpoint format_version {version!r} "
            f"(this build reads versions {list(_READABLE_VERSIONS)})"
        )
    if _tel.enabled:
        _tel.inc("checkpoint.loads")
        with _tel.span("ckpt:load_estimator", path=path):
            est = _instantiate(manifest["root"], path, {})
        _tel.record_event("checkpoint", site=type(est).__name__, op="load", path=path)
        return est
    return _instantiate(manifest["root"], path, {})
