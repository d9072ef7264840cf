"""Ahead-of-time bundles for fused programs.

Port of ``heat_tpu/core/aot.py``: the zero-cold-start half of serving.  A
warm process captures its ``htt.fuse`` programs and exports them; a fresh
process installs the bundles into the fuse cache, so its first request is
a cache *replay*: zero ``fuse.cache.misses`` at request time.

A CUDA graph cannot be serialized, and the kernels this package launches
through ``ctypes`` are opaque to ``torch.export``.  So a bundle holds the
**recipe** of a program, not an executable:

- the function's module and qualname;
- ``donate``, the plan token and the plan's decisions (a solved
  ``htt.autoshard`` layout, which the install traces under), the
  treedef, the keyparts and ``out_meta``, with the live communicator
  replaced by a sentinel;
- the operand specs (shape, dtype);
- ``guarded``.

:func:`install_programs` rebuilds each program and, on a CUDA device,
captures it at install time on zero-filled static inputs.  A trace is
data-independent by the :class:`~heat_tpu_torch.core._tracing.FuseTraceError`
contract (no value is read while tracing), so the captured graph serves
any data.  On the CPU a program is its plain traced call and install only
rebuilds it.

Soundness is fingerprint-gated, never assumed:

- :func:`fingerprint` pins the format version, the torch version,
  ``torch.version.cuda``, the device name and count, and the policy
  key-context (:func:`heat_tpu_torch.core._compile.context_token`).  A
  bundle whose fingerprint does not match is *skipped*, not loaded; a
  bundle exported by the JAX package never matches (another format).
- per bundle, the capture communicator's size and mesh shape must match
  the install communicator's.
- entries that cannot be exported soundly (no DNDarray operand, mixed
  communicators, unpicklable statics) are dropped from the bundle list;
  the serving process then builds those programs on first use.
"""

from __future__ import annotations

import contextlib
import importlib
import pickle
import sys as _sys
from typing import Any, Dict, List, Tuple

import torch

from ..telemetry import _core as _tel
from . import _compile
from . import fuse as _fuse_mod  # noqa: F401 - ensures the module is loaded

# the package rebinds the ``fuse`` attribute to the decorator function,
# so resolve the MODULE explicitly
_fuse = _sys.modules["heat_tpu_torch.core.fuse"]

__all__ = [
    "capture_programs",
    "export_programs",
    "fingerprint",
    "install_programs",
]

#: bumped whenever the bundle layout changes; a string, so that no bundle
#: of the JAX package (an integer format) can match
_FORMAT_VERSION = "heat_tpu_torch/1"

#: sentinel replacing live comm objects inside pickled key/meta parts
_COMM_SENTINEL = "__heat_tpu_torch_comm__"


def _device() -> Tuple[str, int]:
    if torch.cuda.is_available():
        return torch.cuda.get_device_name(0), torch.cuda.device_count()
    return "cpu", 0


def fingerprint() -> Tuple:
    """The compatibility fingerprint a bundle is stamped with: equal
    fingerprints mean "this process can soundly rebuild that process's
    programs"."""
    name, count = _device()
    return (
        _FORMAT_VERSION,
        torch.__version__,
        torch.version.cuda,
        name,
        count,
        tuple(_compile.context_token()),
    )


@contextlib.contextmanager
def capture_programs():
    """Record every cache-keyed fused-program call inside the block.

    Yields the capture dict (one entry per distinct fuse-cache key,
    recorded whether the call built or replayed); hand it to
    :func:`export_programs`.  Capture is observation only.
    """
    sink: Dict[Tuple, Dict[str, Any]] = {}
    _fuse._CAPTURE_SINKS.append(sink)
    try:
        yield sink
    finally:
        _fuse._CAPTURE_SINKS.remove(sink)


def _swap_comm(obj, comm, live):
    """Recursively replace ``comm``-equal objects with the sentinel
    (export, ``live=False``) or the sentinel with ``comm`` (install,
    ``live=True``) inside key/meta tuples."""
    if live:
        if isinstance(obj, str) and obj == _COMM_SENTINEL:
            return comm
    elif isinstance(obj, type(comm)) and obj == comm:
        return _COMM_SENTINEL
    if isinstance(obj, tuple):
        return tuple(_swap_comm(o, comm, live) for o in obj)
    return obj


def _comms_in(obj, out: list) -> None:
    """Collect communicators from nested key/meta tuples."""
    from .communication import Communication

    if isinstance(obj, tuple):
        for o in obj:
            _comms_in(o, out)
    elif isinstance(obj, Communication):
        out.append(obj)


def export_programs(capture: Dict[Tuple, Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Turn every captured program into a picklable recipe bundle.
    Entries that cannot be exported soundly (see the module docstring) are
    dropped; the count of bundles is the caller's signal."""
    bundles: List[Dict[str, Any]] = []
    for entry in capture.values():
        fn = entry["fn"]
        comm = entry["comm"]
        program = entry["program"]
        if comm is None or program.out_meta is None:
            continue  # no DNDarray operand: nothing topology-bound to pin
        seen: list = []
        _comms_in(entry["keyparts"], seen)
        _comms_in(program.out_meta, seen)
        if any(c != comm for c in seen):
            continue  # mixed comms: one live substitute cannot rebuild the key
        bundle = {
            "fingerprint": fingerprint(),
            "fn": (fn.__module__, fn.__qualname__),
            "donate": entry["donate"],
            "plan_token": entry["plan_token"],
            "plan": program.plan,
            "treedef": entry["treedef"],
            "keyparts": _swap_comm(entry["keyparts"], comm, live=False),
            "comm_size": int(comm.size),
            "mesh_shape": tuple(comm.mesh_shape),
            "out_treedef": program.out_treedef,
            "out_meta": _swap_comm(program.out_meta, comm, live=False),
            "guarded": program.guarded,
            "specs": entry["specs"],
        }
        try:
            pickle.dumps(bundle)
        except Exception:
            continue  # unpicklable static/meta leaf: built on first use
        bundles.append(bundle)
    if _tel.enabled and bundles:
        _tel.inc("aot.exported", len(bundles))
    return bundles


def _resolve_fn(module: str, qualname: str):
    obj: Any = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    if isinstance(obj, _fuse._FusedFunction):
        obj = obj._fn  # the raw fn is what fuse keys on
    return obj


def _slots(keyparts) -> Tuple:
    """A program's input slots, rebuilt from its keyparts."""
    slots = []
    for part in keyparts:
        if part[0] == "dnd":
            _, _shape, _dt, gshape, dtype, layout, device, comm = part
            slots.append(("dnd", gshape, dtype, layout, device, comm))
        elif part[0] == "arr":
            slots.append(("arr",))
        else:
            slots.append(part)
    return tuple(slots)


def install_programs(bundles: List[Dict[str, Any]], *, comm) -> int:
    """Install recipe bundles into the fuse cache for ``comm``.

    Returns how many bundles were installed; every skipped bundle (wrong
    fingerprint, topology mismatch, unresolvable function) leaves its
    program to be built on first use.  On a CUDA device each installed
    program is captured here, on zero-filled static inputs, so the next
    call of the captured pipeline with the captured operand layout is a
    pure replay: no build, one dispatch.
    """
    want = fingerprint()
    installed = 0
    for bundle in bundles:
        if bundle.get("fingerprint") != want:
            continue
        if int(bundle.get("comm_size", -1)) != int(comm.size):
            continue
        if tuple(bundle.get("mesh_shape", ())) != tuple(comm.mesh_shape):
            continue
        try:
            fn = _resolve_fn(*bundle["fn"])
        except (ImportError, AttributeError):
            continue
        keyparts = _swap_comm(bundle["keyparts"], comm, live=True)
        program = _fuse._Program(fn, _slots(keyparts), bundle["treedef"], _fuse._indexed(comm.device),
                                 bundle.get("plan"))
        program.out_treedef = bundle["out_treedef"]
        program.out_meta = _swap_comm(bundle["out_meta"], comm, live=True)
        program.guarded = bool(bundle["guarded"])
        if comm.device.type == "cuda":
            zeros = [torch.zeros(shape, dtype=getattr(torch, dt.removeprefix("torch.")),
                                 device=comm.device)
                     for shape, dt in bundle["specs"]]
            program.capture(zeros, False, getattr(fn, "__name__", "<pipeline>"))
        key = (
            fn,
            bundle["donate"],
            bundle["plan_token"],
            bundle["treedef"],
            keyparts,
            comm,
            _compile.context_token(),
        )
        _fuse._admit(key, program)
        del program
        _fuse._flush()
        installed += 1
    if _tel.enabled:
        if installed:
            _tel.inc("aot.installed", installed)
        _tel.gauge("fuse.cache.size", len(_fuse._FUSE_CACHE))
    return installed
