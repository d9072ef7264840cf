"""Pytest fixtures for the fault-injection harness.

Load with ``pytest_plugins = ["heat_tpu_torch.resilience.fixtures"]`` (or list
the module in a conftest).  Kept out of ``heat_tpu_torch.resilience``'s import
graph so the library never imports pytest.
"""

from __future__ import annotations

import os

import pytest

from . import faults, guards, incidents

__all__ = ["chaos_seed", "incident_log", "inject_fault", "no_faults"]


@pytest.fixture
def chaos_seed() -> int:
    """The chaos lane's seed (``HEAT_CHAOS_SEED``, default 0): the whole
    injected schedule of a test is a pure function of this value."""
    return int(os.environ.get("HEAT_CHAOS_SEED", "0"))


@pytest.fixture
def incident_log():
    """A clean incident log around the test; yields the snapshot
    function."""
    incidents.clear_incident_log()
    yield incidents.incident_log
    incidents.clear_incident_log()


@pytest.fixture
def inject_fault(chaos_seed):
    """Factory fixture: ``inject_fault("nonfinite", nth=2)`` arms a plan
    seeded from the chaos lane; everything is disarmed at teardown even
    if the test escapes the context manager."""

    def _arm(kind: str, **kwargs):
        kwargs.setdefault("seed", chaos_seed)
        return faults.inject(kind, **kwargs)

    yield _arm
    faults.clear()


@pytest.fixture(autouse=False)
def no_faults():
    """Assert-clean harness state: no armed plans, guards off."""
    faults.clear()
    guards.set_guard_policy("off")
    yield
    faults.clear()
    guards.set_guard_policy("off")
