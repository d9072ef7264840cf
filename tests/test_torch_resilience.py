"""The port's resilience layer held against the JAX package's.

The same seeded plans and the same numpy inputs go through
``heat_tpu.resilience`` and ``heat_tpu_torch.resilience``:

* every fault kind's result through ``allreduce_q`` (plain and error
  feedback) and ``allgather_q`` under ``int8_block`` at 2, 4 and 8
  positions is bitwise the reference's (NaN, Inf, the 1e36 saturation,
  the bit-30 flip through the kernels' plain versions on the CPU), NaNs
  compared by position (:func:`_same_bits`: the port writes the quiet NaN
  0x7fc00000, the reference's CPU program x86's 0xffc00000 where an
  ``inf - inf`` makes one);
* fault schedules (``rate``, ``nth``, ``max_faults``, ``site``) and the
  host-only seams fire at the reference's opportunities, and the seeded
  retry delays equal the reference's;
* the four guard policies: ``raise`` names the collective, ``warn`` gives
  exactly one ``GuardWarning`` attributed to this file, ``degrade`` is
  bitwise the exact ``precision="f32"`` result, ``off`` lets the fault
  through; each intervention's incident renders as the reference's.

It mirrors the A16a part of ``tests/test_resilience.py``; the ``fuse``,
checkpoint and resume cases wait for the compiled-program, IO and resume
layers.  Every comparison is exact but one: the port's exact f32 sum
against the reference's (``torch.sum`` against a ``psum``: float32 terms
added in another order, within ``(p - 1) eps sum|x_i|``).  Every test
starts and ends with no
armed plan, guards off and empty incident logs in both packages.
"""

import itertools
import os
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import heat_tpu as ht
from heat_tpu.comm import compressed as rcq
from heat_tpu.core.communication import XlaCommunication
from heat_tpu.resilience import faults as rfaults
from heat_tpu.resilience import guards as rguards
from heat_tpu.resilience import incidents as rincidents
from heat_tpu.resilience import retry as rretry
from test_torch_reference_state import reference_state  # noqa: F401,E402  (restores the JAX package's state)

import heat_tpu_torch as htt
from heat_tpu_torch.comm import compressed as cq
from heat_tpu_torch.resilience import faults, guards, incidents, retry
from heat_tpu_torch.resilience.faults import DeviceArrival, DeviceLossError, Preempted
from heat_tpu_torch.resilience.fixtures import chaos_seed, incident_log, inject_fault  # noqa: F401
from heat_tpu_torch.resilience.guards import GuardWarning, NumericalHealthError

RNG = np.random.default_rng(42)
KINDS = [("nonfinite", {}), ("nonfinite", {"value": float("inf")}), ("nonfinite", {"value": float("-inf")}),
         ("saturate", {}), ("bitflip", {"seed": 3}), ("bitflip", {"seed": 11})]


@pytest.fixture(autouse=True)
def _clean_harness():
    for f, g, i in ((faults, guards, incidents), (rfaults, rguards, rincidents)):
        f.clear()
        g.set_guard_policy("off")
        i.clear_incident_log()
    start = max(next(incidents._SEQ), next(rincidents._SEQ))
    incidents._SEQ = itertools.count(start)
    rincidents._SEQ = itertools.count(start)
    yield
    for f, g, i in ((faults, guards, incidents), (rfaults, rguards, rincidents)):
        f.clear()
        g.set_guard_policy("off")
        i.clear_incident_log()


def _comms(k):
    if len(jax.devices()) < k:
        pytest.skip(f"needs {k} devices")
    return XlaCommunication(jax.devices()[:k]), htt.TorchCommunication(["cpu"] * k)


def _stacked(p, m=296, scale=300.0):
    return (RNG.normal(size=(p, m)) * scale).astype(np.float32)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _same_bits(mine, ref):
    """Bitwise, NaNs compared by position: every NaN the port writes in
    float32 is 0x7fc00000 (the numerics rule of ``comm/compressed.py``),
    where the reference's CPU program writes x86's default NaN 0xffc00000
    for an invalid operation (``inf - inf`` in an error-feedback
    residual), and a NaN cast to another float type keeps its payload in
    torch where XLA's convert makes it canonical; all other bits are
    equal."""
    mine = np.asarray(mine.numpy() if isinstance(mine, torch.Tensor) else mine)
    ref = np.asarray(ref)
    assert mine.dtype == ref.dtype and mine.shape == ref.shape
    if np.issubdtype(mine.dtype, np.floating):
        nan = np.isnan(mine)
        np.testing.assert_array_equal(nan, np.isnan(ref))
        if mine.dtype == np.float32:
            assert (mine[nan].view(np.uint32) == 0x7FC00000).all()
        mine, ref = np.where(nan, 0, mine).astype(mine.dtype), np.where(nan, 0, ref).astype(ref.dtype)
    np.testing.assert_array_equal(mine.view(np.uint8), ref.view(np.uint8))


def _renders(log):
    return [i.render() for i in log()]


# --------------------------------------------------------------------- #
# the surface                                                            #
# --------------------------------------------------------------------- #
def test_exceptions_and_seams_exist():
    for name in ("inject", "any_active", "clear", "comm_input", "comm_output", "payload_input", "io_open",
                 "preempt_point", "device_point", "arrival_point", "extra_latency", "serve_delay",
                 "socket_stalled", "wire_bytes"):
        assert callable(getattr(faults, name)), name
    assert faults._KINDS == rfaults._KINDS
    assert faults.__all__ == rfaults.__all__ and guards.__all__ == rguards.__all__
    assert incidents.__all__ == rincidents.__all__ and retry.__all__ == rretry.__all__
    assert issubclass(Preempted, RuntimeError) and issubclass(GuardWarning, UserWarning)
    with pytest.raises(ValueError, match="unknown fault kind"):
        with faults.inject("gremlin"):
            pass
    with pytest.raises(ValueError, match="rate"):
        with faults.inject("nonfinite", rate=1.5):
            pass


# --------------------------------------------------------------------- #
# faults through the ring, bitwise the reference's                       #
# --------------------------------------------------------------------- #
def _ref_allreduce(data, rcomm, err=None):
    if err is None:
        return np.asarray(rcq.allreduce_q(jnp.asarray(data), comm=rcomm, precision="int8_block"))
    r, e = rcq.allreduce_q(jnp.asarray(data), comm=rcomm, precision="int8_block", error=jnp.asarray(err))
    return np.asarray(r), np.asarray(e)


def _port_allreduce(data, comm, err=None):
    x = torch.from_numpy(data)
    if err is None:
        return cq.allreduce_q(x, comm=comm, precision="int8_block")
    return cq.allreduce_q(x, comm=comm, precision="int8_block", error=torch.from_numpy(err))


@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("kind,kw", KINDS, ids=lambda v: str(v))
def test_faulted_allreduce_bitwise_reference(p, kind, kw):
    rcomm, comm = _comms(p)
    data = _stacked(p)
    with rfaults.inject(kind, nth=1, **kw) as rplan:
        want = _ref_allreduce(data, rcomm)
    with faults.inject(kind, nth=1, **kw) as plan:
        got = _port_allreduce(data, comm)
    assert (plan.calls, plan.fired) == (rplan.calls, rplan.fired) == (1, 1)
    _same_bits(got, want)
    assert not np.array_equal(_bits(got.numpy()), _bits(_port_allreduce(data, comm).numpy()))


@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("kind,kw", KINDS[:4], ids=lambda v: str(v))
def test_faulted_error_feedback_allreduce_bitwise_reference(p, kind, kw):
    rcomm, comm = _comms(p)
    data, err = _stacked(p), _stacked(p, scale=0.5)
    with rfaults.inject(kind, nth=1, **kw):
        want = _ref_allreduce(data, rcomm, err)
    with faults.inject(kind, nth=1, **kw):
        got = _port_allreduce(data, comm, err)
    _same_bits(got[0], want[0])
    _same_bits(got[1], want[1])


@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("kind,kw", KINDS, ids=lambda v: str(v))
def test_faulted_allgather_bitwise_reference(p, kind, kw):
    rcomm, comm = _comms(p)
    data = (RNG.normal(size=(p * 40, 5)) * 200.0).astype(np.float32)
    xr = rcomm.apply_sharding(jnp.asarray(data), 0)
    with rfaults.inject(kind, nth=1, **kw):
        want = np.asarray(rcq.allgather_q(xr, axis=0, comm=rcomm, precision="int8_block"))
    with faults.inject(kind, nth=1, **kw):
        got = cq.allgather_q(torch.from_numpy(data), axis=0, comm=comm, precision="int8_block")
    _same_bits(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.float16])
@pytest.mark.parametrize("kind,kw", KINDS, ids=lambda v: str(v))
def test_payload_seams_bitwise_reference(dtype, kind, kw):
    data = (RNG.normal(size=(3, 7)) * 10).astype(dtype)
    x = torch.from_numpy(data.copy())
    seam, rseam = ((faults.comm_output, rfaults.comm_output) if kind == "bitflip"
                   else (faults.comm_input, rfaults.comm_input))
    with rfaults.inject(kind, nth=[1, 3], **kw):
        want = [np.asarray(rseam("allreduce_q", jnp.asarray(data))) for _ in range(3)]
    with faults.inject(kind, nth=[1, 3], **kw):
        got = [seam("allreduce_q", x) for _ in range(3)]
    for g, w in zip(got, want):
        assert g.dtype == x.dtype
        _same_bits(g, w)
    np.testing.assert_array_equal(x.numpy(), data)  # the caller's tensor is untouched


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bitflip_deflation_bitwise_reference(dtype):
    """Every word >= 2 deflates to a float32 subnormal: kept in float32,
    flushed to zero by the cast back to float64 (the reference's
    compiled convert flushes)."""
    data = np.full((4, 4), 5.0, dtype=dtype)
    with rfaults.inject("bitflip", nth=1, seed=5):
        want = np.asarray(rfaults.comm_output("allreduce_q", jnp.asarray(data)))
    with faults.inject("bitflip", nth=1, seed=5):
        got = faults.comm_output("allreduce_q", torch.from_numpy(data))
    _same_bits(got, want)
    assert (got.numpy() != 5.0).sum() == 1


def test_nonfinite_payload_is_not_silent_garbage():
    _, comm = _comms(4)
    data = _stacked(4)
    data[2, 7] = np.nan
    assert not torch.isfinite(_port_allreduce(data, comm)).all()


# --------------------------------------------------------------------- #
# schedules                                                              #
# --------------------------------------------------------------------- #
def _pattern(mod, make, seed, rate=0.5, calls=12, **kw):
    pat = []
    with mod.inject("nonfinite", seed=seed, rate=rate, **kw) as plan:
        for _ in range(calls):
            out = mod.comm_input("allreduce_q", make())
            pat.append(bool(not np.isfinite(np.asarray(out)).all()))
    return tuple(pat), plan.calls, plan.fired


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("kw", [{}, {"rate": 0.3}, {"nth": 2}, {"nth": [1, 5, 9]}, {"max_faults": 2},
                                {"site": "allreduce_q"}, {"site": "allgather_q"}], ids=str)
def test_schedule_equals_reference(seed, kw):
    mine = _pattern(faults, lambda: torch.ones(8), seed, **kw)
    ref = _pattern(rfaults, lambda: jnp.ones((8,), jnp.float32), seed, **kw)
    assert mine == ref


def test_schedule_is_pure_function_of_seed():
    a = _pattern(faults, lambda: torch.ones(8), 5)[0]
    assert a == _pattern(faults, lambda: torch.ones(8), 5)[0]
    assert any(a) and not all(a)


def test_smoke_schedule_equals_reference_and_pin():
    """``chip_smoke.py`` phase 12 pins the call indices at which
    ``inject("nonfinite", rate=0.3, seed=0)`` fires over 20 allreduces
    (the card has no JAX); they are the reference's."""
    import chip_smoke

    def fires(mod, make):
        with mod.inject("nonfinite", rate=0.3, seed=0):
            return tuple(i for i in range(20)
                         if not np.isfinite(np.asarray(mod.comm_input("allreduce_q", make()))).all())

    mine = fires(faults, lambda: torch.ones(4))
    assert mine == fires(rfaults, lambda: jnp.ones((4,), jnp.float32)) == chip_smoke.SCHEDULE_FIRES


def _drive(mod, kind, seam, calls=6, **kw):
    """Outcomes of ``calls`` opportunities at one host-only seam."""
    out = []
    with mod.inject(kind, seed=7, rate=0.5, **kw):
        for i in range(calls):
            try:
                out.append(("ok", seam(mod, i)))
            except Exception as e:  # the seams raise their typed faults
                fields = {k: getattr(e, k) for k in ("lost_rank", "survivors", "mesh_size", "arrived",
                                                     "new_mesh_size", "site", "errno") if hasattr(e, k)}
                out.append((type(e).__name__, str(e), fields))
    return out


SEAMS = {
    "io_error": lambda m, i: m.io_open(f"/data/{i}.h5"),
    "preempt": lambda m, i: m.preempt_point("iteration"),
    "device_loss": lambda m, i: m.device_point("iteration", mesh=4),
    "device_arrival": lambda m, i: m.arrival_point("scale", mesh=4),
    "slow_rank": lambda m, i: m.extra_latency("kmeans.seg"),
    "slow_replica": lambda m, i: m.serve_delay("replica0"),
    "stalled_socket": lambda m, i: m.socket_stalled("replica1"),
    "corrupt_frame": lambda m, i: m.wire_bytes("rpc", bytes(range(i, i + 16))),
}


@pytest.mark.parametrize("kind", list(SEAMS))
def test_host_seams_equal_reference(kind):
    kw = {"delay": 0.25, "rank": 2} if kind in ("slow_rank", "slow_replica", "device_loss") else {}
    assert _drive(faults, kind, SEAMS[kind], **kw) == _drive(rfaults, kind, SEAMS[kind], **kw)


def test_payload_input_equals_reference():
    data = RNG.normal(size=(4, 3)).astype(np.float32)
    for kind in ("nonfinite", "saturate"):
        with faults.inject(kind, nth=[1, 2]), rfaults.inject(kind, nth=[1, 2]):
            for _ in range(3):
                np.testing.assert_array_equal(faults.payload_input("serve:a/b", data),
                                              rfaults.payload_input("serve:a/b", data))


def test_nth_fixture_fires_exactly_once(inject_fault, chaos_seed):
    with inject_fault("nonfinite", nth=2) as plan:
        outs = [faults.comm_input("allreduce_q", torch.ones(4)) for _ in range(4)]
    assert plan.seed == chaos_seed
    assert [bool(not torch.isfinite(o).all()) for o in outs] == [False, True, False, False]


# --------------------------------------------------------------------- #
# retry                                                                  #
# --------------------------------------------------------------------- #
POLICIES = [
    dict(), dict(attempts=6, base_delay=0.5, multiplier=3.0, max_delay=4.0, jitter=0.9, seed=3),
    dict(attempts=8, jitter=0.0), dict(attempts=10, base_delay=0.2, deadline=0.5, seed=1),
    dict(attempts=1),
]


@pytest.mark.parametrize("kw", POLICIES, ids=str)
@pytest.mark.parametrize("env_seed", [None, "7"])
def test_backoff_schedule_equals_reference(kw, env_seed, monkeypatch):
    if env_seed is None:
        monkeypatch.delenv("HEAT_CHAOS_SEED", raising=False)
    else:
        monkeypatch.setenv("HEAT_CHAOS_SEED", env_seed)
    assert retry.backoff_schedule(retry.RetryPolicy(**kw)) == rretry.backoff_schedule(rretry.RetryPolicy(**kw))


def _retry_run(mod, fmod, log_mod, attempts_io_faults):
    slept = []
    mod.set_sleep(slept.append)
    try:
        with fmod.inject("io_error", **attempts_io_faults):
            try:
                out = mod.call(lambda: fmod.io_open("/data/x.h5") or "opened",
                               policy=mod.RetryPolicy(attempts=3, seed=5), site="io.load")
            except OSError as e:
                out = f"raised {e.errno}"
    finally:
        mod.set_sleep(None)
    return out, slept, [i.render() for i in log_mod.incident_log()]


@pytest.mark.parametrize("kw", [{"nth": 1, "max_faults": 1}, {}, {"rate": 0.5, "seed": 2}], ids=str)
def test_retry_engine_equals_reference(kw):
    mine = _retry_run(retry, faults, incidents, kw)
    ref = _retry_run(rretry, rfaults, rincidents, kw)
    assert mine == ref


def test_retry_loop_and_decorator_forms():
    calls = []

    @retry.retry(retry.RetryPolicy(attempts=3, base_delay=0.0), site="flaky")
    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "done"

    assert flaky() == "done" and len(calls) == 3
    with pytest.raises(ValueError):
        for attempt in retry.retry(retry.RetryPolicy(attempts=3, base_delay=0.0)):
            with attempt:
                raise ValueError("not transient")
    assert [i.action for i in incidents.incident_log()] == ["retried", "retried"]


# --------------------------------------------------------------------- #
# guards                                                                 #
# --------------------------------------------------------------------- #
def test_health_flag_edges():
    assert guards.is_healthy(torch.ones(3), torch.zeros(0), torch.arange(5))
    assert not guards.is_healthy(torch.tensor([1.0, float("nan")]))
    assert not guards.is_healthy(torch.tensor([3.5e35]))
    assert bool(guards.health_flag([torch.tensor([3.5e35])], limit=1e36))
    assert guards.is_healthy()  # nothing to check
    assert guards.is_healthy(torch.tensor([1, 2], dtype=torch.int64) * 10 ** 18)
    for p in ("off", "raise", "warn", "degrade"):
        with guards.guard(p, overflow_limit=1e3):
            assert guards.get_guard_policy() == p and guards.get_overflow_limit() == 1e3
    assert guards.get_guard_policy() == "off" and guards.get_overflow_limit() == 3.4e35
    with pytest.raises(ValueError):
        guards.set_guard_policy("sometimes")


def test_guard_raise_names_the_collective():
    rcomm, comm = _comms(8)
    data = _stacked(8)
    data[0, 0] = np.nan
    for g, run, log in ((rguards, lambda: _ref_allreduce(data, rcomm), rincidents.incident_log),
                        (guards, lambda: _port_allreduce(data, comm), incidents.incident_log)):
        with g.guard("raise"):
            with pytest.raises(Exception, match="allreduce_q") as ei:
                run()
        assert type(ei.value).__name__ == "NumericalHealthError"
    assert isinstance(ei.value, NumericalHealthError)
    assert _renders(incidents.incident_log) == _renders(rincidents.incident_log)
    assert [(i.site, i.action) for i in incidents.incident_log()] == [("allreduce_q", "raised")]


def test_guard_warn_exactly_one_warning_attributed_to_caller():
    _, comm = _comms(8)
    data = _stacked(8)
    data[1, 3] = np.inf
    with guards.guard("warn"):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            out = _port_allreduce(data, comm)
    hits = [x for x in w if issubclass(x.category, GuardWarning)]
    assert len(hits) == 1
    assert os.path.basename(hits[0].filename) == os.path.basename(__file__)
    assert not torch.isfinite(out).all()
    assert [i.action for i in incidents.incident_log()] == ["warned"]


@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("kind", ["saturate", "nonfinite"])
def test_guard_degrade_bitwise_exact_f32_and_reference(p, kind):
    rcomm, comm = _comms(p)
    data = _stacked(p)
    x = torch.from_numpy(data)
    exact = cq.allreduce_q(x, comm=comm, precision="f32")
    compressed = cq.allreduce_q(x, comm=comm, precision="int8_block")
    assert not torch.equal(compressed, exact)
    with guards.guard("degrade"), faults.inject(kind, nth=1):
        degraded = cq.allreduce_q(x, comm=comm, precision="int8_block")
        healthy = cq.allreduce_q(x, comm=comm, precision="int8_block")
    _same_bits(degraded, exact.numpy())
    _same_bits(healthy, compressed.numpy())
    with rguards.guard("degrade"), rfaults.inject(kind, nth=1):
        rdegraded = _ref_allreduce(data, rcomm)
    # the reference's exact path is a psum, the port's one torch.sum: p
    # float32 terms added in another order, within (p - 1) eps sum|x_i|
    bound = (p - 1) * np.finfo(np.float32).eps * np.abs(data.astype(np.float64)).sum(0)
    assert (np.abs(degraded.numpy().astype(np.float64) - rdegraded) <= bound).all()
    assert _renders(incidents.incident_log) == _renders(rincidents.incident_log)
    log = incidents.incident_log()
    assert [(i.site, i.policy, i.action) for i in log] == [("allreduce_q", "degrade", "degraded")]


def test_guard_degrade_error_feedback_and_allgather():
    _, comm = _comms(4)
    data, err = _stacked(4), _stacked(4, scale=0.5)
    exact = cq.allreduce_q(torch.from_numpy(data), comm=comm, precision="f32", error=torch.from_numpy(err))
    with guards.guard("degrade"), faults.inject("saturate", nth=1):
        got = _port_allreduce(data, comm, err)
    _same_bits(got[0], exact[0].numpy())
    _same_bits(got[1], exact[1].numpy())
    g = (RNG.normal(size=(4 * 40, 5)) * 200.0).astype(np.float32)
    with guards.guard("degrade"), faults.inject("nonfinite", nth=1):
        out = cq.allgather_q(torch.from_numpy(g), axis=0, comm=comm, precision="int8_block")
    _same_bits(out, g)  # the exact all-gather of a global tensor is itself
    assert [i.site for i in incidents.incident_log()] == ["allreduce_q", "allgather_q"]


def test_guard_off_lets_faults_through_and_bitflip_raises():
    _, comm = _comms(4)
    data = _stacked(4)
    with faults.inject("nonfinite", nth=1):
        assert not torch.isfinite(_port_allreduce(data, comm)).all()
    assert incidents.incident_log() == ()
    small = RNG.uniform(0.01, 0.4, size=(4, 64)).astype(np.float32)
    with guards.guard("raise"), faults.inject("bitflip", nth=1, seed=3):
        with pytest.raises(NumericalHealthError):
            _port_allreduce(small, comm)


def test_degrade_without_fallback_is_unrecoverable():
    with guards.guard("degrade"):
        res = guards.handle("custom:site", torch.tensor([float("nan")]), None)
        inner = guards.handle("outer", torch.ones(1), lambda: guards.handle("inner", torch.zeros(1), lambda: 1))
    assert torch.isnan(res).all() and torch.equal(inner, torch.zeros(1))
    assert [(i.site, i.action) for i in incidents.incident_log()] == [
        ("custom:site", "unrecoverable"), ("outer", "degraded"), ("inner", "unrecoverable")]


def test_incident_records_equal_reference(incident_log):
    for mod in (incidents, rincidents):
        mod.record("nonfinite", "allreduce_q", "warn", "warned", detail="x")
        mod.record("overflow", "allgather_q", "degrade", "degraded")
    assert _renders(incident_log) == _renders(rincidents.incident_log)
    assert [(i.kind, i.site) for i in incident_log()] == [("nonfinite", "allreduce_q"), ("overflow", "allgather_q")]
