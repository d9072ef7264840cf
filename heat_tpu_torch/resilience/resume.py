"""Preemption-safe training resume: loop-carry snapshots over HDF5.

Port of ``heat_tpu/resilience/resume.py``.  The resumable fit loops
(Lasso cd/gd and the mini-batch gd, KMeans exact, ``int8_block`` and
mini-batch, ``lanczos``) run in *segments* of ``checkpoint_every``
iterations of the one loop the uninterrupted fit runs, re-entered with
an explicit carry; between segments the carry (iteration counter,
iterate, convergence residual, and for the quantized paths the stacked
error-feedback residual) is snapshotted here, copied to the host once a
segment.  A run killed at a segment boundary and resumed from its
snapshot replays the identical float trajectory: resume is bitwise-equal
to never having been interrupted.

Snapshots ride the estimator checkpoints' writer
(:func:`heat_tpu_torch.core.io._save_hdf5_many`): one file open, and an
atomic commit by ``os.replace`` of a temporary file in the same
directory, so a preemption mid-snapshot leaves the previous snapshot
intact.  The files are the reference's, byte for byte in layout and
manifest: either package resumes the other's snapshot.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional, Tuple

import numpy as np

import torch

from ..core import io as _io
from ..telemetry import _core as _tel
from . import faults
from . import retry as _retry

__all__ = [
    "LoopCheckpointer",
    "MeshMismatchError",
    "load_loop_state",
    "save_loop_state",
    "stream_position",
]

_MANIFEST_ATTR = "heat_tpu_loop_state"
_FORMAT_VERSION = 1


class MeshMismatchError(ValueError):
    """A loop snapshot was taken at a different mesh size than the fit
    trying to consume it.  Carries ``snapshot_mesh`` and ``current_mesh``;
    the fix is ``fit(..., resume="elastic")``, which migrates the stacked
    carry entries to the current mesh instead of rejecting the snapshot."""

    def __init__(self, path: str, snapshot_mesh: int, current_mesh: int):
        self.snapshot_mesh = int(snapshot_mesh)
        self.current_mesh = int(current_mesh)
        super().__init__(
            f"{path}: snapshot was taken at mesh size {self.snapshot_mesh} "
            f"but this fit runs at mesh size {self.current_mesh}; pass "
            f'resume="elastic" to migrate the carry to the current mesh'
        )


def stream_position(it, chunks_per_epoch: int) -> Tuple[int, int]:
    """Decode a streaming fit's scalar step counter into
    ``(epoch, chunk)`` — the stream position a snapshot's ``it`` encodes.

    The mini-batch fits keep ONE monotone step counter in the carry;
    chunk ``it % h`` of epoch ``it // h``
    is the next chunk the fit will read, so a resumed fit re-enters the
    stream mid-epoch at exactly the snapshotted position without any
    extra snapshot state."""
    h = int(chunks_per_epoch)
    if h < 1:
        raise ValueError(f"chunks_per_epoch must be >= 1, got {h}")
    step = int(it)
    return step // h, step % h


def save_loop_state(path: str, state: Dict[str, Any], meta: Optional[Dict[str, Any]] = None) -> None:
    """Write one loop-carry snapshot: every ``state`` entry (host/device
    array or scalar) becomes an HDF5 dataset, ``meta`` (JSON-safe
    scalars) lands in the file manifest.  Multihost-safe and atomic —
    see the module docstring."""
    if not _io.supports_hdf5():
        raise RuntimeError("h5py is required for loop snapshots")
    datasets = []
    entries: Dict[str, Any] = {}
    for name, value in state.items():
        arr = _io._host(value) if isinstance(value, torch.Tensor) else np.asarray(value)
        entry: Dict[str, Any] = {"dtype": arr.dtype.name}
        if arr.ndim == 0:
            arr = arr.reshape(1)
            entry["scalar"] = True
        datasets.append((name, np.ascontiguousarray(arr)))
        entries[name] = entry
    manifest = {
        "format_version": _FORMAT_VERSION,
        "meta": dict(meta or {}),
        "entries": entries,
    }
    if _tel.enabled:
        _tel.inc("checkpoint.saves")
        with _tel.span("ckpt:save", path=str(path)):
            _io._save_hdf5_many(
                path, datasets, attrs={_MANIFEST_ATTR: json.dumps(manifest)}
            )
        _tel.record_event("checkpoint", site="loop", op="save", path=str(path))
        return
    _io._save_hdf5_many(
        path, datasets, attrs={_MANIFEST_ATTR: json.dumps(manifest)}
    )


def load_loop_state(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """Read a snapshot back as ``(state, meta)`` with host numpy arrays
    in their saved dtypes.  Unreadable files, wrong manifests, and
    missing datasets all surface as ``ValueError`` naming the file."""
    if not _io.supports_hdf5():
        raise RuntimeError("h5py is required for loop snapshots")
    import h5py

    def _open():
        faults.io_open(path)
        return h5py.File(path, "r")

    try:
        # transient EIO at the open heals under the bounded, seeded retry
        # policy; only an exhausted policy surfaces as the ValueError below
        f = _retry.call(_open, policy=_retry.IO_POLICY, site="resume.load")
    except OSError as e:
        raise ValueError(
            f"{path} is not a readable loop snapshot (missing, truncated, "
            f"or not HDF5): {e}"
        ) from e
    with f:
        raw = f.attrs.get(_MANIFEST_ATTR)
        if raw is None:
            raise ValueError(f"{path} is not a heat_tpu loop snapshot")
        manifest = json.loads(raw)
        version = manifest.get("format_version")
        if version != _FORMAT_VERSION:
            raise ValueError(
                f"{path}: unsupported loop-snapshot format_version "
                f"{version!r} (this build reads version {_FORMAT_VERSION})"
            )
        state: Dict[str, np.ndarray] = {}
        for name, entry in manifest["entries"].items():
            if name not in f:
                raise ValueError(
                    f"{path}: snapshot dataset {name!r} is missing "
                    "(truncated or corrupted save)"
                )
            arr = np.asarray(f[name][...], dtype=np.dtype(entry["dtype"]))
            if entry.get("scalar"):
                arr = arr.reshape(())
            state[name] = arr
    if _tel.enabled:
        _tel.inc("checkpoint.loads")
        _tel.record_event("checkpoint", site="loop", op="load", path=str(path))
    return state, manifest.get("meta", {})


class LoopCheckpointer:
    """The segmentation driver the resumable estimators share.

    ``algo`` tags snapshots so a KMeans resume can never consume a Lasso
    file; ``meta`` records the static fit configuration (shapes, solver
    constants) and is validated field-by-field on load — a snapshot from
    a different problem raises instead of silently continuing a different
    trajectory.  ``comm`` stamps the device count into the manifest as
    the reserved ``"mesh"`` key, and ``splits`` records each carry
    entry's partitioning (``None`` = replicated, ``"mesh"`` = stacked one
    row per rank) so an elastic resume knows exactly which entries must
    migrate when the mesh shrinks.  A mesh-size mismatch raises
    :class:`MeshMismatchError` under ``resume=True`` and triggers carry
    migration under ``resume="elastic"``.
    """

    def __init__(self, path: Optional[str], every: int, algo: str,
                 meta: Dict[str, Any], *, comm=None,
                 splits: Optional[Dict[str, Any]] = None):
        every = int(every or 0)
        if every < 0:
            raise ValueError(f"checkpoint_every must be >= 0, got {every}")
        if every > 0 and not path:
            raise ValueError("checkpoint_every > 0 requires checkpoint_path")
        self.path = path
        self.every = every
        self.algo = algo
        self.meta = dict(meta)
        self._comm = comm
        if comm is not None and "mesh" not in self.meta:
            self.meta["mesh"] = int(comm.size)
        if splits is not None:
            self.meta["splits"] = dict(splits)

    @property
    def enabled(self) -> bool:
        return self.every > 0

    def stop(self, it: int, max_iter: int) -> int:
        """The iteration bound for the segment starting at ``it``."""
        if not self.enabled:
            return max_iter
        return min(it + self.every, max_iter)

    def tick(self, it: int, state: Dict[str, Any]) -> None:
        """End-of-segment: snapshot the carry, then cross the simulated
        preemption point (so an injected kill lands AFTER a durable
        snapshot — the real SIGTERM can land anywhere, which is exactly
        why the snapshot write itself is atomic)."""
        if not self.enabled:
            return
        save_loop_state(
            self.path, state, {**self.meta, "algo": self.algo, "it": int(it)}
        )
        faults.preempt_point("iteration")
        faults.device_point("iteration", mesh=self.meta.get("mesh"))

    def load(self, elastic: bool = False) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        """Read and validate this fit's snapshot.

        ``elastic=True`` (``resume="elastic"``) relaxes two checks the
        strict path enforces: a mesh-size mismatch migrates the sharded
        carry entries to the current mesh instead of raising, and a
        snapshot written by the quantized twin of this algorithm
        (``<algo>-q``) is accepted — a fit that loses enough devices to
        land on a single-rank mesh legitimately resumes on the exact
        path, where the quantized carry's extra entries are ignored.
        """
        if not self.path:
            raise ValueError("resume requires checkpoint_path")
        state, meta = load_loop_state(self.path)
        if _tel.enabled:
            _tel.inc("checkpoint.resumes")
            _tel.record_event(
                "checkpoint", site=self.algo, op="resume",
                path=str(self.path), it=int(meta.get("it", -1)),
            )
        meta_algo = meta.get("algo")
        if meta_algo != self.algo and not (
            elastic and meta_algo == f"{self.algo}-q"
        ):
            raise ValueError(
                f"{self.path}: snapshot was written by {meta_algo!r}, "
                f"not {self.algo!r}"
            )
        snap_mesh = meta.get("mesh")
        want_mesh = self.meta.get("mesh")
        if (
            snap_mesh is not None
            and want_mesh is not None
            and int(snap_mesh) != int(want_mesh)
        ):
            if not elastic:
                raise MeshMismatchError(self.path, snap_mesh, want_mesh)
            from . import elastic as _elastic  # lazy: elastic imports resume

            state = _elastic.migrate_state(
                state, meta, int(want_mesh), comm=self._comm
            )
        for key, expect in self.meta.items():
            if key in ("mesh", "splits"):
                continue  # handled above / informational
            got = meta.get(key)
            if got != expect:
                raise ValueError(
                    f"{self.path}: snapshot {key}={got!r} does not match "
                    f"the current fit ({key}={expect!r})"
                )
        return state, meta
