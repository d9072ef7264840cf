"""Native (C++) host components: the threaded CSV scanner.

Port of ``heat_tpu/native``: the scanner behind
:func:`heat_tpu_torch.load_csv` partitions the file into byte ranges, one
per thread, a range owning every line whose first byte falls inside it
(the reference HeAT's per-rank rule), and parses straight into a float64
buffer.  It is host code, not a device kernel.

The source is the port's own copy, ``fastcsv.cpp`` beside this module.
It compiles with the system ``g++`` at first use into
``build/native/_fastcsv-<hash>.so`` at the root of the checkout, the hash
covering the source and the flags (as :mod:`heat_tpu_torch.kernels` does
for the CUDA libraries), and loads with :mod:`ctypes`.  Nothing is
written beside the sources.  Without a toolchain, or when the build
fails, :func:`fastcsv_parse` returns None and the caller parses with
numpy, as the reference does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import warnings
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["fastcsv_available", "fastcsv_parse"]

_SRC = Path(__file__).resolve().parent / "fastcsv.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _target() -> Path:
    """The library of the current source and flags."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update("\0".join(_FLAGS).encode())
    return BUILD_DIR / f"_fastcsv-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return False
    if res.returncode != 0:
        warnings.warn(
            f"native fastcsv build failed ({res.stderr.decode(errors='replace')[:200]}); "
            "falling back to numpy CSV parsing"
        )
        return False
    os.replace(tmp, out)
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        out = _target()
        if not out.exists() and not _build(out):
            return None
        try:
            lib = ctypes.CDLL(str(out))
        except OSError:
            return None
        lib.fcsv_scan.restype = ctypes.c_int64
        lib.fcsv_scan.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.fcsv_parse.restype = ctypes.c_int64
        lib.fcsv_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char,
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ]
        _lib = lib
        return _lib


def fastcsv_available() -> bool:
    """True when the compiled scanner is (or can be) loaded."""
    return _load() is not None


def fastcsv_parse(
    path: str, header_lines: int = 0, sep: str = ",", nthreads: int = 0
) -> Optional[np.ndarray]:
    """Parse a numeric CSV into a float64 array with the native scanner.

    Returns None when the native path is unavailable or refuses the file
    (ragged rows, unreadable): callers fall back to numpy.  Single-row
    files come back 1-D, matching ``np.genfromtxt``.
    """
    lib = _load()
    if lib is None or len(sep) != 1:
        return None
    bpath = os.fsencode(path)
    bsep = sep.encode()[0:1]
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    if lib.fcsv_scan(bpath, header_lines, bsep, ctypes.byref(rows), ctypes.byref(cols)) != 0:
        return None
    r, c = rows.value, cols.value
    if r == 0 or c == 0:
        return np.empty((0, c), np.float64)
    out = np.empty((r, c), np.float64)
    code = lib.fcsv_parse(
        bpath, header_lines, bsep, r, c,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), nthreads,
    )
    if code != 0:
        return None
    if r == 1:
        return out[0] if c > 1 else out.reshape(())
    if c == 1:
        return out[:, 0]
    return out
