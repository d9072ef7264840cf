"""The port's telemetry held against the JAX package's.

The same sequence of API calls runs through ``heat_tpu.telemetry`` and
``heat_tpu_torch.telemetry`` in this process, and the two registries are
compared:

* under the deterministic clock, histogram states, flight-recorder
  postmortems and Perfetto trace JSON are equal byte for byte;
* the exact-vs-wire byte ledger of ``allreduce_q``/``allgather_q`` at
  meshes 1, 2, 4 and 8 under ``bf16`` and ``int8_block`` equals the
  reference's counters and gauges, and the hand-derived ring arithmetic;
* on the instrumented collectives the event streams are equal once the
  reference's compiled-program events are dropped.  The filter (stated
  once, in :func:`_a14`): spans whose site starts with ``jitted:`` or
  ``fuse:`` and events of type ``compile`` — the compiled-program layer's
  sites, which the two packages place differently (ROADMAP, dispatch
  accounting), dropped on both sides.  Timestamps are
  left out of that comparison, since the dropped events read the clock.

The rest mirrors ``tests/test_telemetry.py`` and the telemetry half of
``tests/test_obs.py`` on the port: span aggregates and exception safety,
thread-safe counters, the JSONL sink, the SLO monitor, ``/metrics`` on
port 0, the estimator spans, and the environment autostart (in a
subprocess).  Every comparison is exact; the one tolerance is the
reference's own acceptance for a fit's wire ratio (within 2 % of 0.258).

Every test leaves both registries as it found them: the enabled flag,
the flight recorder's dump directory and capacity, no trace or JSONL
sink open, no socket listening, ``os.environ`` untouched.
"""

import http.client
import itertools
import json
import os
import subprocess
import sys
import threading
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import heat_tpu as ht
from heat_tpu import telemetry as rtel
from heat_tpu.comm import compressed as rcq
from heat_tpu.core.communication import XlaCommunication
from heat_tpu.resilience import incidents as rincidents
from heat_tpu.telemetry import _core as rcore
from heat_tpu.telemetry import export as rexport
from heat_tpu.telemetry import flight as rflight
from heat_tpu.telemetry import hist as rhist
from heat_tpu.telemetry import httpz as rhttpz
from test_torch_reference_state import reference_state  # noqa: F401,E402  (restores the JAX package's state)

import heat_tpu_torch as htt
from heat_tpu_torch import telemetry as tel
from heat_tpu_torch.comm import compressed as cq
from heat_tpu_torch.resilience import incidents
from heat_tpu_torch.telemetry import _core
from heat_tpu_torch.telemetry import export
from heat_tpu_torch.telemetry import flight
from heat_tpu_torch.telemetry import hist
from heat_tpu_torch.telemetry import httpz

ROOT = Path(__file__).resolve().parent.parent
RNG = np.random.default_rng(11)


# --------------------------------------------------------------------- #
# fixtures: both registries, restored on exit                            #
# --------------------------------------------------------------------- #
def _save(core, fl):
    return core.is_enabled(), core.is_deterministic(), fl.dump_dir(), fl.capacity(), fl.is_enabled()


def _restore(core, fl, state):
    was, det, d, cap, fl_on = state
    core.reset()
    if was:
        core.enable(deterministic=det)
    else:
        core.disable()
    fl.clear()
    fl.set_dump_dir(d)
    fl.set_capacity(cap)
    (fl.enable if fl_on else fl.disable)()


def _fresh(core, fl, deterministic):
    core.enable(deterministic=deterministic)
    core.reset()
    fl.enable()
    fl.clear()


@pytest.fixture
def tels():
    """Both registries enabled (wall clock) and empty."""
    states = [_save(_core, flight), _save(rcore, rflight)]
    _fresh(_core, flight, False)
    _fresh(rcore, rflight, False)
    yield
    _restore(_core, flight, states[0])
    _restore(rcore, rflight, states[1])


@pytest.fixture
def det():
    """Both registries enabled on the deterministic clock, empty rings,
    clean incident logs, the incident sequences aligned and the port's
    dispatch count set to the reference's (the postmortem records both)."""
    states = [_save(_core, flight), _save(rcore, rflight)]
    start = max(next(incidents._SEQ), next(rincidents._SEQ))
    incidents._SEQ = itertools.count(start)
    rincidents._SEQ = itertools.count(start)
    incidents.clear_incident_log()
    rincidents.clear_incident_log()
    _core._dispatches = rcore._dispatches
    _fresh(_core, flight, True)
    _fresh(rcore, rflight, True)
    yield
    incidents.clear_incident_log()
    rincidents.clear_incident_log()
    _restore(_core, flight, states[0])
    _restore(rcore, rflight, states[1])


def _comms(k):
    if len(jax.devices()) < k:
        pytest.skip(f"needs {k} devices")
    return XlaCommunication(jax.devices()[:k]), htt.TorchCommunication(["cpu"] * k)


def _a14(ev) -> bool:
    """The compiled-program layer's events, placed differently by the two
    packages."""
    site = ev.get("site", "") or ""
    return site.startswith(("jitted:", "fuse:")) or ev.get("type") == "compile"


def _stream(events):
    return [{k: v for k, v in ev.items() if k not in ("ts", "dur")} for ev in events if not _a14(ev)]


def _comm_keys(d):
    """The ``comm.*`` counters or gauges less ``comm.reshards``: a
    reshard counts a layout commit, and the two packages commit layouts
    at different places (the reference on every ``device_put`` to a new
    sharding, the port when ``resplit`` pads a split tensor)."""
    return {k: v for k, v in d.items() if k.startswith("comm.") and k != "comm.reshards"}


# --------------------------------------------------------------------- #
# the surface                                                            #
# --------------------------------------------------------------------- #
def test_all_equals_reference():
    assert list(tel.__all__) == list(rtel.__all__)
    for name in tel.__all__:
        assert hasattr(tel, name), name


def test_enabled_attribute_tracks_the_live_flag():
    was = _core.is_enabled()
    try:
        tel.enable()
        assert tel.enabled is True
        tel.disable()
        assert tel.enabled is False
    finally:
        (tel.enable if was else tel.disable)()


# --------------------------------------------------------------------- #
# spans                                                                  #
# --------------------------------------------------------------------- #
def test_span_nesting_aggregates_per_site(tels):
    with tel.span("outer"):
        with tel.span("inner"):
            pass
        with tel.span("inner"):
            pass
    snap = tel.snapshot()
    assert snap["spans"]["outer"]["count"] == 1
    assert snap["spans"]["inner"]["count"] == 2
    sites = [e["site"] for e in tel.events() if e["type"] == "span"]
    assert sites == ["inner", "inner", "outer"]


def test_span_exception_safety(tels):
    with pytest.raises(ValueError):
        with tel.span("boom"):
            raise ValueError("x")
    (ev,) = [e for e in tel.events() if e["site"] == "boom"]
    assert ev["error"] == "ValueError"
    assert tel.snapshot()["spans"]["boom"]["count"] == 1


def test_span_decorator_rechecks_flag_per_call(tels):
    @tel.span("decorated")
    def f(x):
        return x + 1

    assert f.__telemetry_site__ == "decorated"
    assert f(1) == 2
    tel.disable()
    try:
        assert f(2) == 3
    finally:
        tel.enable()
    assert f(3) == 4
    assert tel.snapshot()["spans"]["decorated"]["count"] == 2


def test_span_extra_fields_land_on_event(tels):
    with tel.span("tagged", mode="int8_block", mesh=4):
        pass
    (ev,) = [e for e in tel.events() if e["site"] == "tagged"]
    assert ev["mode"] == "int8_block" and ev["mesh"] == 4


def test_disabled_records_nothing():
    was = _core.is_enabled()
    tel.disable()
    try:
        before = len(_core._events)
        with tel.span("ghost"):
            pass
        tel.inc("ghost.counter")
        tel.gauge("ghost.gauge", 1.0)
        tel.record_event("ghost")
        tel.observe("ghost.hist", 1.0)
        assert tel.snapshot() == {}
        assert len(_core._events) == before
        assert tel.histogram("ghost.hist") is None
    finally:
        if was:
            tel.enable()


def test_disabled_mode_reads_no_clock_and_records_nothing(monkeypatch):
    """The disabled-mode contract on the instrumented paths: with
    telemetry off and nothing armed, no site reads the clock (the
    predicate fails first) and the registry stays empty."""
    was = _core.is_enabled()
    tel.disable()

    def no_clock():
        raise AssertionError("a disabled site read the telemetry clock")

    monkeypatch.setattr(_core, "clock", no_clock)
    try:
        _, comm = _comms(4)
        data = RNG.normal(size=(64, 6)).astype(np.float32)
        before = len(_core._events)
        with cq.collective_precision("int8_block"):
            cq.allreduce_q(torch.from_numpy(data[:4]), comm=comm)
            cq.allreduce_q(torch.from_numpy(data[:4]), comm=comm, error=torch.zeros(4, 6))
            cq.allgather_q(torch.from_numpy(data), axis=0, comm=comm)
            x = htt.array(data, split=0, comm=comm)
            km = htt.cluster.KMeans(n_clusters=3, init=htt.array(data[:3], comm=comm), max_iter=3).fit(x)
            km.predict(x)
        comm.allreduce(torch.from_numpy(data[:4]), "max")
        comm.allgather(torch.from_numpy(data), 0)
        assert len(_core._events) == before and tel.snapshot() == {}
    finally:
        if was:
            tel.enable()


# --------------------------------------------------------------------- #
# counters, dispatch windows, thread safety                              #
# --------------------------------------------------------------------- #
def test_counters_and_gauges(tels):
    tel.inc("a")
    tel.inc("a", 4)
    tel.gauge("g", 0.5)
    snap = tel.snapshot()
    assert snap["counters"]["a"] == 5 and snap["gauges"]["g"] == 0.5


def test_counting_dispatches_window_is_a_baseline_diff(tels):
    with tel.counting_dispatches() as outer:
        tel.record_dispatch()
        with tel.counting_dispatches() as inner:
            tel.record_dispatch()
        assert inner.count == 1
    assert outer.count == 2
    assert tel.snapshot()["counters"]["dispatches"] == 2


def test_dispatch_counter_thread_safe():
    base = tel.dispatch_count()
    n, k = 8, 200

    def worker():
        for _ in range(k):
            tel.record_dispatch()

    ts = [threading.Thread(target=worker) for _ in range(n)]
    with tel.counting_dispatches() as d:
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert d.count == n * k
    assert tel.dispatch_count() == base + n * k


def test_counter_increments_thread_safe(tels):
    n, k = 8, 200

    def worker():
        for _ in range(k):
            tel.inc("threads.hits")
            tel.observe("threads.lat", 1.5)

    ts = [threading.Thread(target=worker) for _ in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    snap = tel.snapshot()
    assert snap["counters"]["threads.hits"] == n * k
    assert snap["hists"]["threads.lat"]["count"] == n * k


def test_event_buffer_overflow_counts_dropped(tels):
    prev = tel.set_max_events(4)
    try:
        for i in range(10):
            tel.record_event("tick", site="s", i=i)
        assert len(tel.events()) == 4
        assert tel.snapshot()["counters"]["telemetry.events.dropped"] == 6
    finally:
        tel.set_max_events(prev)


def test_trace_ctx_nests_and_tags_events(tels):
    with tel.trace_ctx("rq-1"):
        with tel.trace_ctx(["rq-2", "rq-3"]):
            assert tel.current_trace() == ("rq-1", "rq-2", "rq-3")
            with tel.span("inside"):
                pass
    assert tel.current_trace() == ()
    (ev,) = [e for e in tel.events() if e["site"] == "inside"]
    assert ev["rid"] == ["rq-1", "rq-2", "rq-3"]


# --------------------------------------------------------------------- #
# the byte ledger against the reference and the hand arithmetic          #
# --------------------------------------------------------------------- #
def _hand_wire(n_elems, p, mode, op):
    """The ring arithmetic re-derived by hand (``tests/test_telemetry.py``)."""
    block = cq.BLOCK
    chunk, hops = ((n_elems + p - 1) // p, 2 * (p - 1)) if op == "allreduce" else (n_elems, p - 1)
    chunk_p = ((chunk + block - 1) // block) * block
    exact = hops * chunk_p * 4
    if mode == "int8_block":
        return exact, hops * (chunk_p + (chunk_p // block) * 4)
    if mode == "bf16":
        return exact, hops * chunk_p * 2
    return exact, exact


def _both_snapshots(run_ref, run_port):
    rcore.reset()
    run_ref()
    a = rcore.snapshot()
    _core.reset()
    run_port()
    b = _core.snapshot()
    return a, b


@pytest.mark.parametrize("mesh_size", [1, 2, 4, 8])
@pytest.mark.parametrize("mode", ["bf16", "int8_block"])
def test_allreduce_q_byte_ledger_equals_reference(tels, mesh_size, mode):
    rcomm, comm = _comms(mesh_size)
    data = RNG.normal(size=(mesh_size, 37, 5)).astype(np.float32)
    xr = jnp.asarray(data)
    a, b = _both_snapshots(
        lambda: rcq.allreduce_q(xr, comm=rcomm, precision=mode),
        lambda: cq.allreduce_q(torch.from_numpy(data), comm=comm, precision=mode),
    )
    assert _comm_keys(b["counters"]) == _comm_keys(a["counters"])
    assert _comm_keys(b["gauges"]) == _comm_keys(a["gauges"])
    c = b["counters"]
    if mesh_size == 1:
        assert "comm.collectives.allreduce" not in c
        return
    exact, wire = _hand_wire(37 * 5, mesh_size, mode, "allreduce")
    assert c["comm.collectives.allreduce"] == 1
    assert (c[f"comm.exact_bytes.{mode}"], c[f"comm.wire_bytes.{mode}"]) == (exact, wire)
    assert b["gauges"][f"comm.wire_ratio.{mode}"] == wire / exact
    for site in ("commq:allreduce", "comm:allreduce_q:step:issue", "comm:allreduce_q:step:consume"):
        assert b["spans"][site]["count"] == a["spans"][site]["count"] == 1


@pytest.mark.parametrize("mesh_size", [1, 2, 4, 8])
@pytest.mark.parametrize("mode", ["bf16", "int8_block"])
def test_allgather_q_byte_ledger_equals_reference(tels, mesh_size, mode):
    rcomm, comm = _comms(mesh_size)
    data = RNG.normal(size=(mesh_size * 6, 9)).astype(np.float32)
    xr = rcomm.apply_sharding(jnp.asarray(data), 0)
    a, b = _both_snapshots(
        lambda: rcq.allgather_q(xr, axis=0, comm=rcomm, precision=mode),
        lambda: cq.allgather_q(torch.from_numpy(data), axis=0, comm=comm, precision=mode),
    )
    assert _comm_keys(b["counters"]) == _comm_keys(a["counters"])
    assert _comm_keys(b["gauges"]) == _comm_keys(a["gauges"])
    if mesh_size == 1:
        assert "comm.collectives.allgather" not in b["counters"]
        return
    exact, wire = _hand_wire(6 * 9, mesh_size, mode, "allgather")
    c = b["counters"]
    assert c["comm.collectives.allgather"] == 1
    assert (c[f"comm.exact_bytes.{mode}"], c[f"comm.wire_bytes.{mode}"]) == (exact, wire)
    assert b["spans"]["commq:allgather"]["count"] == 1


def test_int8_block_steady_state_ratio_is_0258(tels):
    _, comm = _comms(4)
    x = torch.from_numpy(RNG.normal(size=(4, 4 * cq.BLOCK)).astype(np.float32))
    cq.allreduce_q(x, comm=comm, precision="int8_block")
    ratio = tel.snapshot()["gauges"]["comm.wire_ratio.int8_block"]
    assert ratio == (cq.BLOCK + 4) / (4 * cq.BLOCK) == 0.2578125


def test_wire_model_equals_reference_and_hand_math():
    for n, p, mode, op in itertools.product([1, 185, 512, 2 ** 20], [2, 4, 8],
                                            [None, "bf16", "int8_block"], ["allreduce", "allgather"]):
        assert cq.wire_model(n, p, mode, op=op) == rcq.wire_model(n, p, mode, op=op)
        wm = cq.wire_model(n, p, mode, op=op)
        assert (wm["exact_wire_bytes"], wm["wire_bytes"]) == _hand_wire(n, p, mode, op)
    with pytest.raises(ValueError, match="ring op"):
        cq.wire_model(8, 2, None, op="scatter")


def test_exact_collectives_account_f32_bytes_as_reference(tels):
    rcomm, comm = _comms(2)
    data = RNG.normal(size=(2, 16)).astype(np.float32)
    gdata = RNG.normal(size=(8, 3)).astype(np.float32)
    xg = rcomm.apply_sharding(jnp.asarray(gdata), 0)
    a, b = _both_snapshots(
        lambda: (rcomm.allreduce(jnp.asarray(data), "sum"), rcomm.allreduce(jnp.asarray(data), "max"),
                 rcomm.allgather(xg)),
        lambda: (comm.allreduce(torch.from_numpy(data), "sum"), comm.allreduce(torch.from_numpy(data), "max"),
                 comm.allgather(torch.from_numpy(gdata), 0)),
    )
    assert _comm_keys(b["counters"]) == _comm_keys(a["counters"])
    assert b["counters"]["comm.collectives.allreduce"] == 2
    assert b["counters"]["comm.exact_bytes.f32"] == b["counters"]["comm.wire_bytes.f32"] > 0
    for site in ("comm:allreduce", "comm:allgather"):
        assert b["spans"][site]["count"] == a["spans"][site]["count"], site


@pytest.mark.parametrize("mesh_size", [2, 4, 8])
def test_collective_event_streams_equal_reference(det, mesh_size):
    """The instrumented collectives' streams, the reference's
    compiled-program events dropped (:func:`_a14`)."""
    rcomm, comm = _comms(mesh_size)
    data = RNG.normal(size=(mesh_size, 300)).astype(np.float32)
    err = RNG.normal(size=(mesh_size, 300)).astype(np.float32) * 1e-3
    gdata = RNG.normal(size=(mesh_size * 40, 5)).astype(np.float32)
    xr, er = jnp.asarray(data), jnp.asarray(err)
    xg = rcomm.apply_sharding(jnp.asarray(gdata), 0)
    rcore.reset()
    _core.reset()
    with rcq.collective_precision("int8_block"):
        rcq.allreduce_q(xr, comm=rcomm)
        rcq.allreduce_q(xr, comm=rcomm, error=er)
        rcq.allgather_q(xg, axis=0, comm=rcomm)
        rcq.allreduce_q(xr, comm=rcomm, precision="f32")
    with cq.collective_precision("int8_block"):
        cq.allreduce_q(torch.from_numpy(data), comm=comm)
        cq.allreduce_q(torch.from_numpy(data), comm=comm, error=torch.from_numpy(err))
        cq.allgather_q(torch.from_numpy(gdata), axis=0, comm=comm)
        cq.allreduce_q(torch.from_numpy(data), comm=comm, precision="f32")
    got, want = _stream(_core.events()), _stream(rcore.events())
    assert got == want
    assert [e["site"] for e in got].count("commq:allreduce") == 2


# --------------------------------------------------------------------- #
# byte-equal artifacts under the deterministic clock                     #
# --------------------------------------------------------------------- #
STREAMS = {
    "latencies": [0.25, 1.0, 2.0, 3.7, 12.5, 800.0, 0.0, 1e-12, 5e9],
    "with_nonpositive_and_nan": [-1.0, 0.0, float("nan"), 7.0, 7.0, 7.0],
    "lognormal": list(np.random.default_rng(3).lognormal(1.0, 2.0, size=500)),
    "empty": [],
}


@pytest.mark.parametrize("name", list(STREAMS))
def test_histogram_state_equals_reference(name):
    values = STREAMS[name]
    mine, ref = hist.Histogram.of(values), rhist.Histogram.of(values)
    assert json.dumps(mine.state()) == json.dumps(ref.state())
    assert mine.prom_buckets() == ref.prom_buckets()
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert mine.quantile(q) == ref.quantile(q)
    back = hist.Histogram.from_state(mine.state())
    assert back.state() == mine.state()
    merged = hist.Histogram.of(values[: len(values) // 2]).merge(hist.Histogram.of(values[len(values) // 2:]))
    assert merged.counts == mine.counts and merged.count == mine.count


def _scenario(telemetry, flight_mod, incidents_mod, dump_dir):
    """One chaos scenario through a package's public telemetry API."""
    flight_mod.set_dump_dir(str(dump_dir))
    with telemetry.trace_ctx("rq-0"):
        with telemetry.span("lane:step", step=0):
            telemetry.record_event("chaos.tick", site="lane", step=1)
        flight_mod.note("chaos.note", site="lane", step=2)
    telemetry.inc("chaos.counter", 3)
    telemetry.gauge("chaos.gauge", 0.25)
    for v in (12.5, 0.0, 3.0, 800.0):
        telemetry.observe("chaos.lat_ms", v)
    incidents_mod.record("chaos-fault", "lane:0", "guard", "degraded", detail="injected")
    return flight_mod.last_dump_path()


def test_postmortem_bytes_equal_reference(det, tmp_path):
    mine = _scenario(tel, flight, incidents, tmp_path / "port")
    ref = _scenario(rtel, rflight, rincidents, tmp_path / "ref")
    assert os.path.basename(mine) == os.path.basename(ref)
    blob = Path(mine).read_bytes()
    assert blob == Path(ref).read_bytes() and len(blob) > 0
    doc = json.loads(blob)
    assert doc["kind"] == "heat_tpu-flight-postmortem" and doc["deterministic"] is True
    assert doc["incident"]["kind"] == "chaos-fault"
    assert flight.encode(doc) + "\n" == blob.decode()


def test_perfetto_json_bytes_equal_reference(det, tmp_path):
    assert not export.trace_active() and not rexport.trace_active()
    paths = []
    for telemetry, fl, inc, exp, name in ((tel, flight, incidents, export, "port"),
                                          (rtel, rflight, rincidents, rexport, "ref")):
        path = str(tmp_path / f"{name}.json")
        exp.start_trace(path)
        try:
            _scenario(telemetry, fl, inc, tmp_path / f"dumps-{name}")
        finally:
            assert exp.stop_trace() == path
        paths.append(path)
    mine, ref = (Path(p).read_bytes() for p in paths)
    assert mine == ref
    evs = json.loads(mine)["traceEvents"]
    assert {e["ph"] for e in evs} == {"X", "i", "C"}
    assert all(e["pid"] == os.getpid() for e in evs)


def test_prometheus_text_equals_reference(det):
    for t in (tel, rtel):
        t.inc("serve.requests", 7)
        t.inc("odd name (avg)", 2)
        t.gauge("queue.depth", 3.5)
        for v in (1.0, 2.0, 4.0, 800.0):
            t.observe("lat.ms", v)
    flight.clear()
    rflight.clear()
    assert httpz.prometheus_text() == rhttpz.prometheus_text()
    assert httpz.sanitize_metric_name("a b-c/d") == "heat_a_b_c_d"


def test_slo_state_and_incident_equal_reference(det, tmp_path):
    logs = []
    for t, fl, inc, name in ((tel, flight, incidents, "port"), (rtel, rflight, rincidents, "ref")):
        fl.set_dump_dir(str(tmp_path / name))
        mon = t.SloMonitor("api", target_ms=10.0, min_events=8, long_s=600.0)
        for i in range(400):
            mon.observe(50.0 if i % 3 else 5.0)
            if mon.alerting:
                break
        assert mon.alerting and mon.n_alerts == 1
        logs.append((mon.state(), t.snapshot()["gauges"], t.snapshot()["hists"],
                     [i.render() for i in inc.incident_log()],
                     Path(fl.last_dump_path()).read_bytes()))
    assert logs[0] == logs[1]
    assert [i.kind for i in incidents.incident_log()] == ["slo-burn"]


def test_slo_rejects_bad_parameters():
    with pytest.raises(ValueError):
        tel.SloMonitor("x", target_ms=1.0, objective=1.5)
    with pytest.raises(ValueError):
        tel.SloMonitor("x", target_ms=1.0, short_s=60.0, long_s=30.0)


def test_deterministic_mode_is_bitwise_replayable(det):
    def run():
        tel.reset()
        with tel.span("a"):
            with tel.span("b"):
                pass
        tel.record_event("incident", site="guard", kind="nonfinite")
        return tel.events()

    first, second = run(), run()
    assert json.dumps(first, sort_keys=True) == json.dumps(second, sort_keys=True)
    assert [e["ts"] for e in first] == [1.0, 0.0, 4.0]


def test_incident_log_uses_injectable_clock(tels):
    tel.set_clock(lambda: 1234.5)
    try:
        incidents.clear_incident_log()
        incidents.record("nonfinite", "test.site", "warn", "warned")
        (inc,) = incidents.incident_log()
        assert inc.timestamp == 1234.5
    finally:
        tel.set_clock(None)
        incidents.clear_incident_log()
    c = tel.snapshot()["counters"]
    assert c["resilience.incidents"] == 1 and c["resilience.incidents.warned"] == 1


# --------------------------------------------------------------------- #
# exporters                                                              #
# --------------------------------------------------------------------- #
def test_start_trace_twice_raises(tmp_path, tels):
    export.start_trace(str(tmp_path / "a.json"))
    try:
        with pytest.raises(RuntimeError, match="already"):
            export.start_trace(str(tmp_path / "b.json"))
    finally:
        export.stop_trace()
    assert export.stop_trace() is None


def test_device_trace_written_beside_host_trace(tmp_path, tels):
    """Without a CUDA device the profiler traces host activity, with a
    warning; the kernels' names in a card trace are the card test's."""
    _, comm = _comms(4)
    x = torch.from_numpy(RNG.normal(size=(4, 512)).astype(np.float32))
    path, ddir = str(tmp_path / "host.json"), tmp_path / "device"
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        export.start_trace(path, device_trace_dir=str(ddir))
        try:
            cq.allreduce_q(x, comm=comm, precision="int8_block")
        finally:
            export.stop_trace()
    assert torch.cuda.is_available() or any("host activity only" in str(x.message) for x in w)
    host = json.loads(Path(path).read_text())["traceEvents"]
    names = {e["name"] for e in host}
    assert {"commq:allreduce", "comm:allreduce_q:step:issue", "comm:allreduce_q:step:consume"} <= names
    (dev,) = list(ddir.iterdir())
    assert dev.name.startswith(f"device-{os.getpid()}-") and dev.suffix == ".json"
    assert isinstance(json.loads(dev.read_text())["traceEvents"], list)


def test_jsonl_sink_streams_events(tmp_path, tels):
    path = str(tmp_path / "events.jsonl")
    tel.set_jsonl(path)
    try:
        assert tel.jsonl_path() == path
        with tel.span("logged"):
            pass
        tel.record_event("checkpoint", site="loop", op="save")
    finally:
        tel.set_jsonl(None)
    lines = [json.loads(ln) for ln in open(path)]
    assert [ln["type"] for ln in lines] == ["span", "checkpoint"]


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def test_metrics_server_endpoints_on_port_0(tels):
    tel.inc("comm.collectives.allreduce", 3)
    with tel.MetricsServer(port=0, varz=lambda: {"k": 1}) as srv:
        assert srv.url.startswith("http://127.0.0.1:") and srv.port > 0
        status, ctype, body = _get(srv.port, "/metrics")
        assert status == 200 and ctype.startswith("text/plain; version=0.0.4")
        assert "heat_comm_collectives_allreduce_total 3" in body.decode()
        assert body.decode() == httpz.prometheus_text()
        assert _get(srv.port, "/healthz")[2] == b"ok\n"
        assert json.loads(_get(srv.port, "/varz")[2])["k"] == 1
        assert _get(srv.port, "/nope")[0] == 404
    assert srv._httpd is None


def test_metrics_server_refuses_non_loopback_bind():
    with pytest.raises(ValueError, match="loopback"):
        tel.MetricsServer(host="0.0.0.0")


# --------------------------------------------------------------------- #
# estimators                                                             #
# --------------------------------------------------------------------- #
def test_estimator_spans_report_subclass_name(tels):
    _, comm = _comms(2)
    x = htt.array(RNG.normal(size=(16, 4)).astype(np.float32), split=0, comm=comm)
    km = htt.cluster.KMeans(n_clusters=2, max_iter=2, random_state=0)
    km.fit(x)
    km.predict(x)
    spans = tel.snapshot()["spans"]
    assert spans["fit:KMeans"]["count"] == 1 and spans["predict:KMeans"]["count"] == 1


def test_kmeans_predict_under_telemetry_equals_labels_off():
    """The reference's ``predict`` raises with telemetry on before its
    cdist was compiled (ROADMAP, faults of the reference); the port's
    ``jitted`` stages nothing on a first call and gives the labels it
    gives with telemetry off."""
    _, comm = _comms(4)
    data = np.random.default_rng(5).normal(size=(64, 6)).astype(np.float32)
    x = htt.array(data, split=0, comm=comm)
    km = htt.cluster.KMeans(n_clusters=3, init=htt.array(data[:3], comm=comm), max_iter=5, tol=-1.0).fit(x)
    was = _core.is_enabled()
    try:
        tel.disable()
        off = km.predict(x).numpy()
        tel.enable()
        on = km.predict(x).numpy()
    finally:
        (tel.enable if was else tel.disable)()
    np.testing.assert_array_equal(on, off)


def test_kmeans_int8_fit_ledger_equals_reference(tels):
    """The reference's acceptance (``tests/test_telemetry.py``): an
    ``int8_block`` fit's wire ratio within 2 % of 0.258, here with the
    port's counters equal to the reference's for the same fit."""
    rcomm, comm = _comms(8)
    data = RNG.normal(size=(64, 16)).astype(np.float32)
    init = data[:4].copy()

    def ref():
        with rcq.collective_precision("int8_block"):
            x = ht.array(data, split=0, comm=rcomm)
            ht.cluster.KMeans(n_clusters=4, init=ht.array(init, comm=rcomm), max_iter=5, tol=-1.0).fit(x)

    def port():
        with cq.collective_precision("int8_block"):
            x = htt.array(data, split=0, comm=comm)
            htt.cluster.KMeans(n_clusters=4, init=htt.array(init, comm=comm), max_iter=5, tol=-1.0).fit(x)

    a, b = _both_snapshots(ref, port)
    assert _comm_keys(b["counters"]) == _comm_keys(a["counters"])
    ratio = b["gauges"]["comm.wire_ratio.int8_block"]
    assert abs(ratio - 0.258) / 0.258 < 0.02
    assert b["counters"]["comm.collectives.allreduce"] == 1  # one entry for the loop
    assert b["spans"]["fit:KMeans"]["count"] == a["spans"]["fit:KMeans"]["count"] == 1


def test_lasso_int8_gd_ledger_equals_reference(tels):
    rcomm, comm = _comms(4)
    X = RNG.normal(size=(64, 6)).astype(np.float32)
    y = (X @ np.arange(6, dtype=np.float32)).astype(np.float32)
    kw = dict(lam=0.05, max_iter=12, tol=0.0, solver="gd")

    def ref():
        with rcq.collective_precision("int8_block"):
            ht.regression.Lasso(**kw).fit(ht.array(X, split=0, comm=rcomm), ht.array(y, split=0, comm=rcomm))

    def port():
        with cq.collective_precision("int8_block"):
            htt.regression.Lasso(**kw).fit(htt.array(X, split=0, comm=comm), htt.array(y, split=0, comm=comm))

    a, b = _both_snapshots(ref, port)
    keys = ("comm.collectives.allreduce", "comm.exact_bytes.int8_block", "comm.wire_bytes.int8_block")
    assert [b["counters"][k] for k in keys] == [a["counters"][k] for k in keys]
    assert b["spans"]["fit:Lasso"]["count"] == 1


# --------------------------------------------------------------------- #
# the environment autostart, in a fresh interpreter                      #
# --------------------------------------------------------------------- #
def test_environment_autostart_in_a_subprocess(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("HEAT_")}
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    env.update(HEAT_TELEMETRY_JSONL=str(tmp_path / "ev.jsonl"), HEAT_TELEMETRY_TRACE=str(tmp_path / "tr.json"),
               HEAT_FLIGHT_DIR=str(tmp_path / "flight"))
    code = (
        "import heat_tpu_torch as htt\n"
        "from heat_tpu_torch.telemetry import export, flight\n"
        "assert htt.telemetry.enabled and export.trace_active()\n"
        f"assert flight.dump_dir() == {str(tmp_path / 'flight')!r}\n"
        "with htt.telemetry.span('autostarted'):\n"
        "    pass\n"
        "htt.resilience.incidents.record('k', 'site', 'p', 'a')\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
    lines = [json.loads(ln) for ln in open(tmp_path / "ev.jsonl")]
    assert [ln["site"] for ln in lines] == ["autostarted", "site"]
    names = [e["name"] for e in json.loads((tmp_path / "tr.json").read_text())["traceEvents"]]
    assert names == ["autostarted", "site"]  # flushed at exit
    assert [p.name for p in (tmp_path / "flight").iterdir()][0].startswith("postmortem-")
    env2 = dict(env)
    for k in ("HEAT_TELEMETRY_JSONL", "HEAT_TELEMETRY_TRACE", "HEAT_FLIGHT_DIR"):
        env2.pop(k)
    env2["HEAT_TELEMETRY"] = "1"
    proc = subprocess.run([sys.executable, "-c", "import heat_tpu_torch as h; print(h.telemetry.enabled)"],
                          cwd=ROOT, env=env2, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "True", proc.stderr
