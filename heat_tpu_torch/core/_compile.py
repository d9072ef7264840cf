"""Dispatch accounting for the op engine, and its compile telemetry.

Port of ``heat_tpu/core/_compile.py``.  The reference compiles each op's
primitive chain once with ``jax.jit`` and replays the executable;
``jitted(key, make_fn)`` memoizes that executable under a hashable key
describing the op and its static parameters.

Eager PyTorch compiles nothing, so the port keeps no program: each call
runs the function ``make_fn()`` returns, eagerly.  What ``jitted`` keeps
is the reference's accounting around it:

* one *dispatch* is recorded per call made outside a trace (an op counts
  one, whatever number of CUDA kernels it launches); calls made inside an
  ``htt.fuse`` trace are part of the enclosing program and count nothing;
* with telemetry on, the keys seen so far (the last ``_MAX_KEYS`` of
  them, least recently used first out) stand for the reference's cache:
  ``compile.cache.misses`` / ``compile.cache.hits`` and the
  ``compile.cache.size`` gauge, the ``jitted:{site}`` span and, on a
  key's first call, the ``compile`` event with the reference's fields:
  ``trace_lower_s`` is the time ``make_fn()`` took and ``compile_s`` is
  0.0, because nothing is compiled.  With telemetry off no key is built
  or kept: a call costs its dispatch count and nothing else.  Nor are
  keys counted while a fused program that was already built runs its
  trace again (:func:`_uncounted`): the reference replays the compiled
  program and looks nothing up.

Process-wide state whose value changes what a program computes (the
collective-compression policy, the guard policy, the io prefetch switch)
registers a token provider with :func:`register_key_context`; its token
joins every key here and every ``fuse`` key.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import types as _types
from collections import OrderedDict
from typing import Any, Callable, Optional, Tuple

import numpy as np

from ..telemetry import _core as _tel
from ._tracing import in_trace, record_dispatch

__all__ = [
    "jitted",
    "cache_stable",
    "clear_cache",
    "cache_size",
    "register_key_context",
    "context_token",
]

#: the keys seen with telemetry on, least recently used first
_SEEN: "OrderedDict[Tuple, _Site]" = OrderedDict()
_MAX_KEYS = 4096
_LOCK = threading.Lock()
#: per thread: True while a built fused program runs its trace again
_QUIET = threading.local()

#: zero-arg providers whose tuples join every cache key
_KEY_CONTEXT: list = []


def register_key_context(provider: Callable[[], Tuple]) -> Callable[[], Tuple]:
    """Register a zero-arg provider whose tuple joins every cache key."""
    if provider not in _KEY_CONTEXT:
        _KEY_CONTEXT.append(provider)
    return provider


def context_token() -> Tuple:
    """Concatenated tokens of all registered key-context providers."""
    out: Tuple = ()
    for provider in _KEY_CONTEXT:
        out = out + tuple(provider())
    return out


def cache_stable(fn: Any) -> bool:
    """True when ``fn``'s identity repeats across calls, so it is safe to
    embed in a cache key.

    Import-time singletons qualify: plain module-level ``def``s, numpy
    ufuncs, torch's builtins (``torch.add``, ``torch._C._nn.softplus``:
    created once at import, bound to no object or to their module), and
    any other callable that IS the attribute of its module under its own
    name.  Lambdas, closures (``"<locals>"`` in the qualname), bound
    methods and per-call ``partial`` objects do not: keying on a per-call
    identity grows the cache by one dead entry per call without ever
    hitting.  Callers route unstable functions to the uncounted eager
    path instead.
    """
    if isinstance(fn, _types.BuiltinFunctionType):
        owner = fn.__self__
        return owner is None or isinstance(owner, (_types.ModuleType, type))
    if getattr(fn, "__self__", None) is not None:
        return False  # bound method: per-instance identity
    if isinstance(fn, _types.FunctionType):
        return (
            fn.__closure__ is None
            and "<locals>" not in fn.__qualname__
            and fn.__name__ != "<lambda>"
        )
    if isinstance(fn, np.ufunc):
        return True  # ufuncs only exist as import-time singletons
    mod = sys.modules.get(getattr(fn, "__module__", None) or "")
    name = getattr(fn, "__name__", None)
    return mod is not None and name is not None and getattr(mod, name, None) is fn


class _Site:
    """What telemetry keeps of a key: its site name, the time ``make_fn()``
    took on the key's first call, and whether that call has run."""

    __slots__ = ("name", "make_s", "staged")

    def __init__(self, name: str, make_s: float):
        self.name = name
        self.make_s = make_s
        self.staged = False


class _Entry:
    """``make_fn()``'s function with its accounting (``site`` is None when
    the entry was made with telemetry off)."""

    __slots__ = ("fn", "site")

    def __init__(self, fn: Callable, site: Optional[_Site]):
        self.fn = fn
        self.site = site

    def __call__(self, *args, **kwargs):
        if in_trace():
            return self.fn(*args, **kwargs)
        record_dispatch()
        site = self.site
        if site is None or not _tel.enabled:
            return self.fn(*args, **kwargs)
        if not site.staged:
            site.staged = True
            _tel.record_event("compile", site=site.name, trace_lower_s=site.make_s, compile_s=0.0)
            with _tel.span(f"jitted:{site.name}", phase="first_run"):
                return self.fn(*args, **kwargs)
        with _tel.span(f"jitted:{site.name}"):
            return self.fn(*args, **kwargs)


def counted(fn: Callable) -> Callable:
    """``fn`` recording one dispatch per call made outside a trace, with
    no key: for functions whose identity changes from call to call."""
    return _Entry(fn, None)


def jitted(key: Tuple, make_fn: Callable[[], Callable]) -> Callable:
    """Return ``make_fn()``'s function, which records one dispatch per
    call made outside a trace (see :mod:`heat_tpu_torch.core._tracing`).

    ``make_fn`` must return a function of the per-call values alone, with
    the static parameters named in ``key`` closed over.  With telemetry
    on, ``key + context_token()`` is looked up among the keys seen so far
    and counted as a hit or a miss.
    """
    if not _tel.enabled or getattr(_QUIET, "on", False):
        return counted(make_fn())
    if _KEY_CONTEXT:
        key = key + context_token()
    with _LOCK:
        site = _SEEN.get(key)
        if site is not None:
            _SEEN.move_to_end(key)
    if site is not None:
        _tel.inc("compile.cache.hits")
        return _Entry(make_fn(), site)
    _tel.inc("compile.cache.misses")
    t0 = _tel.clock()
    fn = make_fn()
    make_s = _tel.clock() - t0
    name = key[0] if key and isinstance(key[0], str) else getattr(fn, "__name__", "op")
    with _LOCK:
        site = _SEEN.setdefault(key, _Site(name, make_s))
        while len(_SEEN) > _MAX_KEYS:
            _SEEN.popitem(last=False)
        size = len(_SEEN)
    _tel.gauge("compile.cache.size", size)
    return _Entry(fn, site)


@contextlib.contextmanager
def _uncounted():
    """Inside the block this thread's :func:`jitted` calls count no hit
    or miss and keep no key (``htt.fuse`` runs a built program's trace
    under it: on the CPU at every call after the first, on the card at
    its capture)."""
    prev = getattr(_QUIET, "on", False)
    _QUIET.on = True
    try:
        yield
    finally:
        _QUIET.on = prev


def clear_cache() -> None:
    """Forget every key seen (mainly for tests)."""
    with _LOCK:
        _SEEN.clear()


def cache_size() -> int:
    """Number of keys seen with telemetry on and still kept."""
    return len(_SEEN)
