"""Build and load the hand-written CUDA kernels.

Every ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with
a plain C interface, ``build/kernels/lib<name>-<hash>.so`` next to the
package, and loads with :mod:`ctypes`.  The hash covers the source and
every header in ``csrc/`` (``*.cuh``, which the sources include), so a
changed source or header never loads a stale library.  Builds happen at
first use (or all at once, in parallel, through :func:`build_all`), never
at import; on a machine without ``nvcc`` nothing here runs.

Flags: ``sm_90a`` (Hopper) and ``-O3`` for every source, no fast math,
no flush of subnormals, IEEE division and square root; then each source's
own flags (:data:`_SOURCE_FLAGS`).  ``blockquant.cu`` builds with
``--fmad=false`` because the block-quantization kernels must match their
plain versions bit for bit; ``flash_attention.cu`` builds with
``--fmad=true``, since without FMA contraction every multiply-add of its
products becomes two instructions.  The library's hash covers the flags
too, so a changed flag never loads a stale library either.

``ptxas_report`` reads the registers and spills of each compiled kernel
from the build log (``nvcc -Xptxas -v``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import time
from pathlib import Path
from typing import Dict, List

__all__ = ["CSRC", "BUILD_DIR", "build_all", "build_log", "library", "ptxas_report"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"

_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "--ftz=false", "--prec-div=true", "--prec-sqrt=true",
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)
#: each source's own flags, after the shared ones
_SOURCE_FLAGS: Dict[str, tuple] = {
    "blockquant": ("--fmad=false",),
    "flash_attention": ("--fmad=true",),
}

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (nvcc); set CUDA_HOME")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _flags(name: str) -> tuple:
    return _NVCC_FLAGS + _SOURCE_FLAGS.get(name, ())


def _target(name: str) -> Path:
    """The library of ``csrc/<name>.cu``: its name hashes the source, every
    ``csrc/*.cuh`` header (by name and content) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(b"\0" + header.name.encode() + b"\0" + header.read_bytes())
    h.update("\0".join(_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, float]:
    """Compile every source in ``csrc/`` that has no up-to-date library,
    one ``nvcc`` per source, all started together.  Returns the seconds
    each build took (0.0 for a library already built); the compiler's
    register and spill report lands in ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs, seconds = {}, {}
    for src in sorted(CSRC.glob("*.cu")):
        name = src.stem
        out = _target(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        cmd = [nvcc, *_flags(name), "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp, out, log, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, log, t0) in procs.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(f"{name} (nvcc exit {rc}; see {out.with_suffix('.log')})")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + ", ".join(failed))
    return seconds


def build_log(name: str) -> str:
    """The compiler's output for ``csrc/<name>.cu``'s library."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def ptxas_report(name: str) -> List[dict]:
    """Per compiled kernel of ``csrc/<name>.cu``'s library, from its build
    log: ``{"entry", "registers", "spill_stores", "spill_loads"}`` (bytes
    of spills), plus any ptxas warning about it under ``"warnings"``."""
    rows: List[dict] = []
    cur = None
    for line in build_log(name).splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"entry": m.group(1), "registers": None, "spill_stores": None,
                   "spill_loads": None, "warnings": []}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
        if "warning" in line.lower():
            cur["warnings"].append(line.strip())
    return rows


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        out = _target(name)
        if not out.exists():
            build_all()
        lib = ctypes.CDLL(str(out))
        _loaded[name] = lib
    return lib
