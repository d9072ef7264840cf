"""The JAX package's process state, left as each port test file found it.

The port's parity files run the reference's estimators, fuse programs
and telemetry in the same worker process as the reference's own test
files.  Some of those tests pass or fail by what ran before them in the
worker (a warm ``jitted`` cache, telemetry left on, a policy left set:
ROADMAP, "Faults of the reference").  So every ``tests/test_torch_*.py``
file that imports ``heat_tpu`` imports :func:`reference_state`, a
module-scoped autouse fixture.  At the end of the file it restores:

* the ``jitted`` cache (``heat_tpu.core._compile``) and the fuse cache
  (``heat_tpu.core.fuse``) to the entries they held when the file began
  (both are cleared with their own functions, then refilled), and drops
  jax's compilation caches (``jax.clear_caches()``);
* telemetry: disabled and reset, then re-enabled only if it was on;
* the collective precision, the matmul precision and the guard policy
  with its overflow limit;
* the incident log (cleared) and the fault plans (disarmed);
* the default communicator.

The tests below hold the fixture to that, inside this module: each
reads the state the previous one left.
"""

import importlib

import numpy as np
import pytest

import jax

import heat_tpu as ht
from heat_tpu import telemetry as rtel
from heat_tpu.telemetry import _core as rtel_core
from heat_tpu.comm import compressed as rcq
from heat_tpu.core import _compile as rcompile
from heat_tpu.core import communication as rcomm
from heat_tpu.core.linalg import basics as rbasics
from heat_tpu.resilience import faults as rfaults
from heat_tpu.resilience import guards as rguards
from heat_tpu.resilience import incidents as rincidents

#: ``heat_tpu.core`` rebinds ``fuse`` to the decorator: reach the module
rfuse = importlib.import_module("heat_tpu.core.fuse")


def _snapshot() -> dict:
    return {
        "jitted": dict(rcompile._CACHE),
        "fused": dict(rfuse._FUSE_CACHE),
        "telemetry": (rtel.is_enabled(), rtel_core.is_deterministic()),
        "collective": rcq.get_collective_precision(),
        "matmul": rbasics.get_matmul_precision(),
        "guard": (rguards.get_guard_policy(), rguards.get_overflow_limit()),
        "comm": rcomm._default_comm,
    }


def _restore(saved: dict) -> None:
    rcompile.clear_cache()
    rcompile._CACHE.update(saved["jitted"])
    rfuse.fuse_clear_cache()
    rfuse._FUSE_CACHE.update(saved["fused"])
    jax.clear_caches()
    rtel.disable()
    rtel.reset()
    enabled, deterministic = saved["telemetry"]
    if enabled:
        rtel.enable(deterministic=deterministic)
    rcq.set_collective_precision(saved["collective"])
    rbasics.set_matmul_precision(saved["matmul"])
    rguards.set_guard_policy(*saved["guard"])
    rincidents.clear_incident_log()
    rfaults.clear()
    rcomm._default_comm = saved["comm"]


@pytest.fixture(scope="module", autouse=True)
def reference_state():
    """Restore the JAX package's process state at the end of the module
    that imports this fixture (see the module docstring)."""
    saved = _snapshot()
    yield saved
    _restore(saved)


# --------------------------------------------------------------------- #
# the fixture's own contract                                              #
# --------------------------------------------------------------------- #
def _dirty():
    """Change every piece of state the fixture restores, as a parity test
    might: a KMeans predict (jitted and fuse entries) with telemetry on, a
    policy flip of each kind, an incident and an armed plan."""
    rng = np.random.default_rng(0)
    x = ht.array(rng.standard_normal((24, 3)).astype(np.float32), split=0)
    km = ht.cluster.KMeans(n_clusters=2, init=ht.array(np.asarray(x.numpy())[:2]), max_iter=2).fit(x)
    km.predict(x)
    rtel.enable()
    rtel.inc("reference_state.probe")
    rcq.set_collective_precision("int8_block")
    rbasics.set_matmul_precision("float32")
    rguards.set_guard_policy("degrade", overflow_limit=1e30)
    rincidents.record("probe", "reference_state", "probe", "noted")
    plan = rfaults.inject("nonfinite", nth=10**6)
    plan.__enter__()
    rcomm._default_comm = rcomm.XlaCommunication(jax.devices()[:1])
    return plan


def test_restore_puts_back_what_a_module_changed(reference_state):
    before = _snapshot()
    sizes = (rcompile.cache_size(), rfuse.fuse_cache_size())
    plan = _dirty()
    assert rcompile.cache_size() > 0 and rfuse.fuse_cache_size() > 0
    assert rfaults.any_active() and rincidents.incident_log()
    _restore(before)
    plan.__exit__(None, None, None)  # the plan is gone already
    assert (rcompile.cache_size(), rfuse.fuse_cache_size()) == sizes
    assert _snapshot() == before
    assert not rfaults.any_active() and not rincidents.incident_log()
    assert rtel.snapshot() == {} and not rtel.is_enabled()


def test_the_module_starts_as_the_fixture_found_it(reference_state):
    """The previous test dirtied and restored: this one reads the state
    the module began with, less what the fixture clears at its end."""
    now = _snapshot()
    for key in ("collective", "matmul", "guard", "comm", "telemetry"):
        assert now[key] == reference_state[key], key
    assert now["jitted"] == reference_state["jitted"]
    assert now["fused"] == reference_state["fused"]


def test_restore_keeps_entries_the_module_found(reference_state):
    """An entry the module found stays the same object: the next file
    meets the cache it would have met without this one."""
    x = ht.array(np.arange(12, dtype=np.float32).reshape(4, 3), split=0)
    (x + 1.0).numpy()
    before = _snapshot()
    kept = dict(rcompile._CACHE)
    (x * 2.0 - 1.0).numpy()
    _restore(before)
    assert all(rcompile._CACHE[k] is v for k, v in kept.items())
    assert set(rcompile._CACHE) == set(kept)
