"""Per-tenant model registry over versioned checkpoint manifests.

One directory tree, one HDF5 estimator checkpoint per version::

    <root>/<tenant>/<model>/v<version>.h5

Port of ``heat_tpu/serve/registry.py``, on the same tree: a registry
either package published is read by the other.  Publishing goes through
:func:`heat_tpu_torch.core.checkpoint.save_estimator` (the reference's
format_version 2 manifests, class paths spelled ``heat_tpu.<module>``);
loading goes through ``load_estimator``
with its seeded-retry open policy, so a transient EIO at a model open
heals instead of failing the request.  Version discovery rides the
manifest-scan helper :func:`heat_tpu_torch.core.checkpoint.list_checkpoints`,
and every load failure is re-raised as a typed registry error that names
the ``(tenant, model, version)`` it was resolving — a serving incident
report must identify the model, not just the file.

Loaded estimators are LRU-cached per ``(tenant, model, version)``: the
registry is the reason the serve engine can hold PERSISTENT compiled
predict programs — the same estimator object (hence the same fused
program operands) answers every request for that version.

Executable sidecars (``v<N>.aotx``) hold the bundles of
:func:`heat_tpu_torch.core.aot.export_programs`: recipes that
``install_programs`` captures on the card at install, so a fresh
process's first request is a replay.  The reference's sidecars hold
another format, which the port's install skips by its fingerprint.
"""

from __future__ import annotations

import collections
import os
import pickle
import re
import threading
from typing import List, Optional, Tuple

from ..core import checkpoint as _ckpt
from ..resilience import faults as _faults
from ..resilience import retry as _retry
from ..telemetry import _core as _tel

__all__ = [
    "ManifestError",
    "ModelNotFoundError",
    "ModelRegistry",
    "RegistryError",
    "VersionNotFoundError",
]

#: version-file spelling; the registry only publishes (and only serves)
#: this shape, so foreign files in a model directory are never loadable
_VERSION_RE = re.compile(r"^v(\d+)\.(h5|hdf5)$")


class RegistryError(RuntimeError):
    """Base class of every serve-registry failure."""


class ModelNotFoundError(RegistryError):
    """No published versions exist for the requested (tenant, model)."""


class VersionNotFoundError(RegistryError):
    """The (tenant, model) exists but the requested version does not."""


class ManifestError(RegistryError):
    """A published checkpoint is unreadable or its manifest is corrupt.

    The message carries the (tenant, model, version) being resolved AND
    the underlying error (which names the offending file)."""


def _check_name(kind: str, name: str) -> str:
    if not isinstance(name, str) or not name:
        raise RegistryError(f"{kind} must be a non-empty string, got {name!r}")
    if name != os.path.basename(name) or name in (".", ".."):
        raise RegistryError(f"{kind} {name!r} must be a plain directory name")
    return name


class ModelRegistry:
    """Versioned multi-tenant estimator store (see module docs).

    Parameters
    ----------
    root : str — the registry directory (created on first publish).
    max_cached : int — loaded-estimator LRU capacity; 0 disables caching
        (every load re-reads the checkpoint — tests only).
    """

    def __init__(self, root: str, *, max_cached: int = 8):
        if not isinstance(root, str) or not root:
            raise RegistryError(f"root must be a non-empty path, got {root!r}")
        self.root = root
        self.max_cached = int(max_cached)
        self._cache: "collections.OrderedDict[Tuple[str, str, int], object]" = (
            collections.OrderedDict()
        )
        self._lock = threading.Lock()

    # ------------------------------------------------------------------ #
    # discovery
    # ------------------------------------------------------------------ #
    def tenants(self) -> List[str]:
        if not os.path.isdir(self.root):
            return []
        return sorted(
            d for d in os.listdir(self.root)
            if os.path.isdir(os.path.join(self.root, d))
        )

    def models(self, tenant: str) -> List[str]:
        base = os.path.join(self.root, _check_name("tenant", tenant))
        if not os.path.isdir(base):
            return []
        return sorted(
            d for d in os.listdir(base) if os.path.isdir(os.path.join(base, d))
        )

    def versions(self, tenant: str, model: str) -> List[int]:
        """Published versions of ``(tenant, model)``, ascending.  A
        corrupt checkpoint in the model directory raises
        :class:`ManifestError` (naming tenant/model and the file) —
        version discovery must not silently shrink the history."""
        base = os.path.join(
            self.root, _check_name("tenant", tenant), _check_name("model", model)
        )
        if not os.path.isdir(base):
            return []
        try:
            entries = _ckpt.list_checkpoints(base)
        except ValueError as e:
            raise ManifestError(
                f"tenant={tenant!r} model={model!r}: {e}"
            ) from e
        out = []
        for entry in entries:
            m = _VERSION_RE.match(entry["file"])
            if m is not None:
                out.append(int(m.group(1)))
        return sorted(out)

    def _path(self, tenant: str, model: str, version: int) -> str:
        return os.path.join(self.root, tenant, model, f"v{int(version)}.h5")

    def resolve(
        self, tenant: str, model: str, version: Optional[int] = None
    ) -> Tuple[int, str]:
        """``(version, path)`` for a request — the latest published
        version when ``version`` is None.  Raises the typed not-found
        errors this module exports."""
        tenant = _check_name("tenant", tenant)
        model = _check_name("model", model)
        versions = self.versions(tenant, model)
        if not versions:
            known = ", ".join(self.models(tenant)) or "<none>"
            raise ModelNotFoundError(
                f"no versions published for tenant={tenant!r} model={model!r} "
                f"under {self.root} (models for this tenant: {known})"
            )
        if version is None:
            version = versions[-1]
        elif int(version) not in versions:
            raise VersionNotFoundError(
                f"tenant={tenant!r} model={model!r} has no version "
                f"{int(version)} (published: {versions})"
            )
        return int(version), self._path(tenant, model, int(version))

    # ------------------------------------------------------------------ #
    # publish / load
    # ------------------------------------------------------------------ #
    def publish(self, tenant: str, model: str, est, *, version: Optional[int] = None) -> int:
        """Save ``est`` as a new version of ``(tenant, model)`` and return
        the version number (auto-incremented when not given).  Re-publishing
        an existing version number is refused — versions are immutable."""
        tenant = _check_name("tenant", tenant)
        model = _check_name("model", model)
        existing = self.versions(tenant, model)
        if version is None:
            version = (existing[-1] + 1) if existing else 1
        elif int(version) in existing:
            raise RegistryError(
                f"tenant={tenant!r} model={model!r} version {int(version)} "
                "is already published (versions are immutable — publish a "
                "new one)"
            )
        version = int(version)
        if version < 1:
            raise RegistryError(f"version must be >= 1, got {version}")
        base = os.path.join(self.root, tenant, model)
        os.makedirs(base, exist_ok=True)
        path = self._path(tenant, model, version)
        if _tel.enabled:
            with _tel.span(
                "serve:registry.publish", tenant=tenant, model=model, version=version
            ):
                _ckpt.save_estimator(est, path)
            _tel.inc("serve.registry.publishes")
        else:
            _ckpt.save_estimator(est, path)
        return version

    # ------------------------------------------------------------------ #
    # executable sidecars (zero-cold-start replicas, docs/design.md §22)
    # ------------------------------------------------------------------ #
    def _aotx_path(self, tenant: str, model: str, version: int) -> str:
        """The executable-sidecar path next to a version's checkpoint.
        ``.aotx`` deliberately does NOT match ``_VERSION_RE``, so sidecars
        are invisible to :meth:`versions` / manifest scans — a version
        with no sidecar is simply a cold replica, never an error."""
        return os.path.join(
            self.root, tenant, model, f"v{int(version)}.aotx"
        )

    def publish_executables(
        self, tenant: str, model: str, version: int, bundles: List[dict]
    ) -> str:
        """Attach serialized AOT executables (bundles from
        :func:`heat_tpu_torch.core.aot.export_programs`) to an already-published
        version.  Sidecars inherit version immutability: re-publishing one
        is refused.  Returns the sidecar path."""
        tenant = _check_name("tenant", tenant)
        model = _check_name("model", model)
        if int(version) not in self.versions(tenant, model):
            raise VersionNotFoundError(
                f"tenant={tenant!r} model={model!r} has no version "
                f"{int(version)} to attach executables to"
            )
        path = self._aotx_path(tenant, model, int(version))
        if os.path.exists(path):
            raise RegistryError(
                f"tenant={tenant!r} model={model!r} v{int(version)} already "
                "has an executable sidecar (sidecars are immutable)"
            )
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            pickle.dump(list(bundles), fh)
        os.replace(tmp, path)  # atomic: readers never see a partial sidecar
        if _tel.enabled:
            _tel.inc("serve.registry.aotx_publishes")
        return path

    def load_executables(
        self, tenant: str, model: str, version: Optional[int] = None,
        *, policy: Optional[_retry.RetryPolicy] = None,
    ) -> Tuple[List[dict], int]:
        """``(bundles, version)`` for a version's executable sidecar —
        ``([], version)`` when none was published (the cold rung of the
        fallback ladder, not an error).  The read retries transient
        ``OSError`` under ``policy`` (default :data:`~heat_tpu_torch.resilience.
        retry.IO_POLICY`) at site ``"registry_open"`` — the fleet's
        chaos seam (:func:`heat_tpu_torch.resilience.faults.io_open` with the
        same site filter)."""
        version, path = self.resolve(tenant, model, version)
        apath = self._aotx_path(tenant, model, version)
        if not os.path.exists(apath):
            return [], version
        bundles: List[dict] = []
        for attempt in _retry.retry(policy, site="registry_open"):
            with attempt:
                if _faults.any_active():
                    _faults.io_open(apath, site="registry_open")
                with open(apath, "rb") as fh:
                    bundles = pickle.load(fh)
        if _tel.enabled:
            _tel.inc("serve.registry.aotx_loads")
        return bundles, version

    def load(self, tenant: str, model: str, version: Optional[int] = None):
        """``(estimator, version)`` for a request, LRU-cached so repeat
        loads hand back the SAME estimator object (and with it the warm
        fused predict programs).  Checkpoint failures surface as
        :class:`ManifestError` carrying tenant/model/version."""
        version, path = self.resolve(tenant, model, version)
        key = (tenant, model, version)
        with self._lock:
            if key in self._cache:
                self._cache.move_to_end(key)
                if _tel.enabled:
                    _tel.inc("serve.registry.cache_hits")
                return self._cache[key], version
        try:
            if _tel.enabled:
                with _tel.span(
                    "serve:registry.load", tenant=tenant, model=model, version=version
                ):
                    est = _ckpt.load_estimator(path)
                _tel.inc("serve.registry.loads")
            else:
                est = _ckpt.load_estimator(path)
        except ValueError as e:
            raise ManifestError(
                f"tenant={tenant!r} model={model!r} version={version}: {e}"
            ) from e
        with self._lock:
            if self.max_cached > 0:
                self._cache[key] = est
                self._cache.move_to_end(key)
                while len(self._cache) > self.max_cached:
                    self._cache.popitem(last=False)
        return est, version
