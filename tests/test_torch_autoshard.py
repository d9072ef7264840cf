"""``htt.autoshard`` on CPU positions: the reference's four contracts
(``tests/test_autoshard.py``) on the port, its ladder, the resplit
override and the plan applied on every trace.

The fixture is ``tests/splitflow_pipelines.py`` with its one import line
swapped to ``heat_tpu_torch``, written under a temporary directory and
imported from there by path.

1. **Drop-in**: on every fixture pipeline, at 1, 2, 4 and 8 positions,
   under ``"f32"`` and ``"int8_block"``, the solved program's values are
   bitwise its hand twin's run in the same process (the pipeline called
   eagerly) and its split metadata the same.
2. **One dispatch** at steady state for the traceable pipelines.
3. **Cheaper or equal**: the plan's modeled wire bytes never exceed the
   hand layout's; on the staged fixture they are strictly lower, with one
   elided hop.
4. **Ledger oracle**: the telemetry wire ledger around one solved call
   equals the plan's modeled bytes, byte for byte.

Then determinism, the policy key, the three rungs (plain on an
incomplete summary, eager on ``FuseTraceError`` with its event, and a
refused capture's ``RuntimeError`` reaching the caller), the override in
``resplit`` (``DNDarray.resplit`` and ``htt.resplit`` take it,
``resplit_`` does not) and the plan applied afresh by every trace of a
fused program (the warm-up and the capture on the card).
"""

import importlib
import importlib.util
import os

import numpy as np
import pytest
import torch

import heat_tpu_torch as htt
from heat_tpu_torch import telemetry
from heat_tpu_torch.comm import compressed as cq
from heat_tpu_torch.core import _tracing
from heat_tpu_torch.telemetry import _core as tcore
from heat_tpu_torch.telemetry import counting_dispatches

from test_torch_reference_state import reference_state  # noqa: F401  (restores the JAX package's state)

fuse_mod = importlib.import_module("heat_tpu_torch.core.fuse")
autoshard_mod = importlib.import_module("heat_tpu_torch.core.autoshard")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "splitflow_pipelines.py")
MESHES = [1, 2, 4, 8]
PRECISIONS = ["f32", "int8_block"]
PIPELINES = ["fused_pipeline", "gnb_pipeline", "kmeans_pipeline", "lasso_pipeline", "resplit_pipeline",
             "staged_resplit_pipeline", "svd_pipeline"]

#: the rung each fixture pipeline takes, the reference's: the fits cannot
#: trace (each reads a value on the host), so they run eagerly
RUNGS = {"fused_pipeline": "fused", "gnb_pipeline": "eager", "kmeans_pipeline": "eager",
         "lasso_pipeline": "eager", "resplit_pipeline": "fused", "staged_resplit_pipeline": "fused",
         "svd_pipeline": "fused"}


def port_fixture_source() -> str:
    with open(FIXTURE, encoding="utf-8") as fh:
        src = fh.read()
    assert src.count("\nimport heat_tpu as ht\n") == 1
    return src.replace("\nimport heat_tpu as ht\n", "\nimport heat_tpu_torch as ht\n")


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    path = tmp_path_factory.mktemp("autoshard") / "port_splitflow_pipelines.py"
    path.write_text(port_fixture_source(), encoding="utf-8")
    spec = importlib.util.spec_from_file_location("port_splitflow_pipelines", str(path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert sorted(mod.__all__) == PIPELINES
    return mod


@pytest.fixture(autouse=True)
def on_cpu():
    prev = htt.core.devices._default
    htt.use_device("cpu")
    yield
    htt.use_device(prev)


def _comm(k):
    return htt.TorchCommunication(["cpu"] * k)


def _assert_twin(hand, solved):
    assert len(hand) == len(solved)
    for h, s in zip(hand, solved):
        assert h.split == s.split
        assert h.gshape == s.gshape
        assert h.dtype == s.dtype
        assert h.larray.device.type == s.larray.device.type == "cpu"
        assert np.array_equal(h.numpy().view(np.uint8), s.numpy().view(np.uint8)), (
            "solved pipeline output differs from the hand-layout twin")


@pytest.fixture
def ledger():
    was = telemetry.is_enabled()
    telemetry.enable()
    telemetry.reset()
    yield
    telemetry.reset()
    (telemetry.enable if was else telemetry.disable)()


# --------------------------------------------------------------------- #
# 1. drop-in: bitwise twin on every fixture pipeline                     #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", PIPELINES)
def test_bitwise_equal_to_hand_twin(pipelines, name, mesh, precision):
    comm = _comm(mesh)
    fn = getattr(pipelines, name)
    auto = htt.autoshard(fn)
    with cq.collective_precision(precision):
        hand = fn(comm)
        _assert_twin(hand, auto(comm))
        # steady state replays the cached program: still the same values
        _assert_twin(hand, auto(comm))
        entry = auto._programs[autoshard_mod._policy_key(comm)]
    assert entry[0] == RUNGS[name]


# --------------------------------------------------------------------- #
# 2. one dispatch at steady state                                        #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["resplit_pipeline", "staged_resplit_pipeline", "fused_pipeline"])
def test_one_dispatch_at_steady_state(pipelines, name):
    comm = _comm(4)
    auto = htt.autoshard(getattr(pipelines, name))
    auto(comm)  # build call
    with counting_dispatches() as d:
        auto(comm)
    assert d.count == 1, f"{name}: {d.count} dispatches at steady state"


# --------------------------------------------------------------------- #
# 3. solved cost never exceeds the hand layout                           #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("mesh", [2, 4, 8])
@pytest.mark.parametrize("name", PIPELINES)
def test_modeled_bytes_never_exceed_hand(pipelines, name, mesh, precision):
    with cq.collective_precision(precision):
        plan = htt.autoshard(getattr(pipelines, name)).plan(_comm(mesh))
    assert plan is not None  # every fixture summary is complete
    assert plan["modeled_wire_bytes"] <= plan["hand_wire_bytes"]
    assert plan["modeled_critical_path_ms"]["serial"] >= 0.0


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("mesh", [2, 4, 8])
def test_staged_fixture_is_strictly_cheaper(pipelines, mesh, precision):
    """The dead-hop chain (0 -> 1 -> None) collapses to one all-gather."""
    with cq.collective_precision(precision):
        plan = htt.autoshard(pipelines.staged_resplit_pipeline).plan(_comm(mesh))
    assert plan["modeled_wire_bytes"] < plan["hand_wire_bytes"]
    elided = [d for d in plan["decisions"] if d["elide"]]
    assert len(elided) == 1, plan["decisions"]


# --------------------------------------------------------------------- #
# 4. ledger oracle: modeled == measured, byte for byte                   #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", ["resplit_pipeline", "staged_resplit_pipeline"])
def test_ledger_matches_model_byte_for_byte(pipelines, ledger, name, mesh, precision):
    comm = _comm(mesh)
    auto = htt.autoshard(getattr(pipelines, name))
    with cq.collective_precision(precision):
        plan = auto.plan(comm)
        auto(comm)  # build call (its credit lands before the reset below)
        telemetry.reset()
        auto(comm)
    counters = telemetry.snapshot()["counters"]
    assert counters.get("comm.wire_bytes", 0) == plan["modeled_wire_bytes"]
    assert counters.get("comm.exact_bytes", 0) == plan["modeled_exact_bytes"]
    shipped = sum(1 for d in plan["decisions"] if d["wire_bytes"] > 0)
    assert counters.get("comm.resplit.autoshard", 0) == shipped
    if mesh == 1:
        assert plan["modeled_wire_bytes"] == 0 and shipped == 0


# --------------------------------------------------------------------- #
# determinism and cache-key semantics                                    #
# --------------------------------------------------------------------- #
def test_plan_is_deterministic(pipelines):
    comm = _comm(4)
    a = htt.autoshard(pipelines.staged_resplit_pipeline).plan(comm)
    b = htt.autoshard(pipelines.staged_resplit_pipeline).plan(comm)
    assert a["fingerprint"] == b["fingerprint"]
    assert a["decisions"] == b["decisions"]


def test_policy_change_resolves_a_new_plan(pipelines):
    """The plan cache is policy-keyed: flipping the collective precision
    re-solves instead of replaying a plan priced elsewhere."""
    comm = _comm(2)
    auto = htt.autoshard(pipelines.staged_resplit_pipeline)
    auto(comm)
    with htt.comm.collective_precision("int8_block"):
        auto(comm)
        n_inside = len(auto._programs)
        inside = auto.plan(comm)
    assert n_inside == 2
    auto(comm)
    assert len(auto._programs) == 2  # the ambient-policy entry replays
    assert inside["fingerprint"] != auto.plan(comm)["fingerprint"]
    with htt.comm.redistribution("planned"), htt.comm.overlap("on"):
        auto.plan(comm)
    assert len(auto._programs) == 3
    key = autoshard_mod._policy_key(comm)
    assert key[0] is comm and key[1:] == ("f32", htt.comm.get_collective_threshold(),
                                          htt.comm.get_redistribution(),
                                          htt.comm.get_redistribution_threshold(), htt.comm.get_overlap())


def _loopy_pipeline(comm=None):
    x = htt.ones((64, 32), dtype=htt.float32, split=0, comm=comm)
    for axis in (1, 0):
        # deliberately summary-hostile: layout traffic under control flow
        x = x.resplit(axis)  # spmdlint: disable=SPMD206
    return (x,)


def test_incomplete_summary_falls_back_to_hand_layout(ledger):
    """Control flow around a seam makes the summary unsound: autoshard
    runs the hand layout (the plain fuse rung), not a guess."""
    comm = _comm(2)
    auto = htt.autoshard(_loopy_pipeline)
    hand = _loopy_pipeline(comm)
    _assert_twin(hand, auto(comm))
    assert auto.plan(comm) is None
    assert auto._programs[autoshard_mod._policy_key(comm)][0] == "plain"
    falls = [e for e in tcore.events() if e["type"] == "autoshard.fallback"]
    assert [e["reason"] for e in falls] == ["incomplete-summary"]


def test_grid_comm_takes_the_plain_rung(pipelines):
    grid = htt.grid_comm((2, 2), positions=["cpu"] * 4)
    auto = htt.autoshard(pipelines.staged_resplit_pipeline)
    assert auto.plan(grid) is None
    assert auto._programs[autoshard_mod._policy_key(grid)][0] == "plain"


def test_untraceable_pipeline_runs_eagerly_and_says_so(pipelines, ledger):
    comm = _comm(4)
    auto = htt.autoshard(pipelines.kmeans_pipeline)
    hand = pipelines.kmeans_pipeline(comm)
    _assert_twin(hand, auto(comm))
    falls = [e for e in tcore.events() if e["type"] == "autoshard.fallback"]
    assert [(e["reason"], e["site"]) for e in falls] == [("untraceable", "autoshard:kmeans_pipeline")]
    plans = [e for e in tcore.events() if e["type"] == "autoshard.plan"]
    assert len(plans) == 1 and plans[0]["seams"] == 0
    assert tcore.snapshot()["counters"]["autoshard.plans.solved"] == 1
    _assert_twin(hand, auto(comm))  # the eager entry replays without a second event
    assert len([e for e in tcore.events() if e["type"] == "autoshard.fallback"]) == 1


def test_a_refused_capture_reaches_the_caller(pipelines, monkeypatch):
    """Only FuseTraceError takes the eager rung: a capture the card refuses
    raises RuntimeError from fuse, and autoshard lets it through without
    running the pipeline itself."""
    calls = []

    def refused(self, operands, donate, name):
        raise RuntimeError(f"htt.fuse: capturing {name} as a CUDA graph failed: stub")

    def counted(comm=None):
        calls.append(1)
        return pipelines.staged_resplit_pipeline(comm)

    counted.__qualname__ = counted.__name__ = "staged_resplit_pipeline"
    counted.__code__ = counted.__code__.replace(co_filename=pipelines.__file__)
    monkeypatch.setattr(fuse_mod._Program, "run", refused)
    comm = _comm(4)
    auto = htt.autoshard(counted)
    assert auto.plan(comm) is not None
    with pytest.raises(RuntimeError, match="capturing staged_resplit_pipeline as a CUDA graph failed"):
        auto(comm)
    assert calls == []
    assert auto._programs[autoshard_mod._policy_key(comm)][0] == "fused"
    monkeypatch.undo()
    _assert_twin(pipelines.staged_resplit_pipeline(comm), auto(comm))
    assert len(calls) == 1


def test_decorator_forms_and_the_comm_of_an_array(pipelines):
    @htt.autoshard
    def bare(x):
        return htt.sqrt(x)

    assert isinstance(bare, autoshard_mod._AutoshardFunction) and bare.__name__ == "bare"
    donating = htt.autoshard(donate=True)(pipelines.fused_pipeline)
    assert donating._donate is True
    comm = _comm(2)
    x = htt.ones((8, 4), dtype=htt.float32, split=0, comm=comm)
    out = bare(x)
    # a parameter's shape is not static: the summary has no seam to price
    # and is complete, and the comm is the array's
    assert autoshard_mod._policy_key(comm) in bare._programs
    assert np.array_equal(out.numpy(), np.ones((8, 4), np.float32))
    assert htt.autoshard is autoshard_mod.autoshard and htt.core.autoshard is autoshard_mod.autoshard


# --------------------------------------------------------------------- #
# the override in resplit                                                #
# --------------------------------------------------------------------- #
def test_resplit_takes_the_override_and_resplit_in_place_does_not():
    comm = _comm(4)
    x = htt.ones((8, 4), dtype=htt.float32, split=0, comm=comm)
    decision = {"shape": (8, 4), "dtype": "float32", "src": 0, "requested": 1, "apply": None}
    with _tracing.applying_layout_plan([decision, decision, decision]):
        assert x.resplit(1).split is None  # the method form
        assert htt.resplit(x, 1).split is None  # the module form
        assert htt.resplit(x, -1).split is None  # the requested axis is sanitized first
        assert x.resplit(1).split == 1  # the queue is spent: as written
        y = htt.ones((8, 4), dtype=htt.float32, split=0, comm=comm)
        y.resplit_(1)
        assert y.split == 1  # in place: no plan
    with _tracing.applying_layout_plan([dict(decision, apply=0)]):
        same = x.resplit(1)  # an override equal to the split elides the hop
        assert same.split == 0 and np.array_equal(same.numpy(), x.numpy())
    assert getattr(x.dtype, "__name__") == "float32"


def test_a_grid_resplit_takes_no_override():
    grid = htt.grid_comm((2, 2), positions=["cpu"] * 4)
    x = htt.ones((8, 8), dtype=htt.float32, splits=(0, None), comm=grid)
    decision = {"shape": (8, 8), "dtype": "float32", "src": 0, "requested": 1, "apply": None}
    with _tracing.applying_layout_plan([decision]):
        out = htt.resplit(x, 1)
        assert out.splits == (None, 0)
        assert _tracing._state.plan[((8, 8), "float32", 0, 1)] == [None]


# --------------------------------------------------------------------- #
# the plan on every trace                                                #
# --------------------------------------------------------------------- #
def test_every_trace_of_a_program_applies_the_plan(pipelines):
    """On the card a program is traced twice, the warm-up and the capture,
    and each consumes the overrides it applies: the plan is entered afresh
    by each trace, so the captured graph runs the solved layout."""
    comm = _comm(4)
    auto = htt.autoshard(pipelines.staged_resplit_pipeline)
    plan = auto.plan(comm)
    fused = auto._programs[autoshard_mod._policy_key(comm)][2]
    seen = []
    real = htt.core.manipulations._planned_axis

    def spy(arr, axis):
        out = real(arr, axis)
        seen.append((arr.split, axis, out))
        return out

    htt.core.manipulations._planned_axis = spy
    try:
        fused(comm)
        program = next(p for k, p in fuse_mod._FUSE_CACHE.items() if k[2] == plan["fingerprint"])
        assert program.plan == plan["decisions"]
        before = len(seen)
        program.trace([])  # a second trace, as the capture after the warm-up
    finally:
        htt.core.manipulations._planned_axis = real
    # the solved layout, in the first trace and the second alike: the hop
    # 0 -> 1 is rerouted straight to None, and the hop None -> None elided
    elided = [d for d in plan["decisions"] if d["elide"]]
    assert len(elided) == 1
    assert seen[:before] == seen[before:]
    assert seen[:before] == [(0, 1, None), (None, None, None)]


def _staged_of(x):
    t = x.resplit(1)
    w = t.resplit(None)  # spmdlint: disable=SPMD502
    return w


def test_aot_bundles_carry_the_plan(pipelines):
    """An exported program keeps its plan's decisions, and the installed
    program traces under them."""
    import pickle

    from heat_tpu_torch.core import aot

    comm = _comm(4)
    plan = htt.autoshard(pipelines.staged_resplit_pipeline).plan(comm)
    x = htt.array(np.arange(2048, dtype=np.float32).reshape(64, 32), split=0, comm=comm)
    solved = htt.fuse(_staged_of, layout_plan=plan)
    with aot.capture_programs() as cap:
        want = solved(x)
    bundles = pickle.loads(pickle.dumps(aot.export_programs(cap)))
    assert len(bundles) == 1 and bundles[0]["plan"] == plan["decisions"]
    assert bundles[0]["plan_token"] == plan["fingerprint"]
    htt.fuse.clear_cache()
    assert aot.install_programs(bundles, comm=comm) == 1
    program = next(p for k, p in fuse_mod._FUSE_CACHE.items() if k[2] == plan["fingerprint"])
    assert program.plan == plan["decisions"]
    got = solved(x)
    assert got.split is None and np.array_equal(got.numpy(), want.numpy())
    assert np.array_equal(got.numpy(), x.numpy())


def test_fits_refuse_a_trace():
    """KMeans.fit and Lasso.fit read a value on the host every step: under
    a trace they raise FuseTraceError, the eager rung's signal."""
    comm = _comm(2)
    x = htt.array(np.arange(64, dtype=np.float32).reshape(16, 4), split=0, comm=comm)
    y = htt.array((np.arange(16) % 2).astype(np.float32), split=0, comm=comm)
    with htt.fuse.trace():
        with pytest.raises(htt.FuseTraceError, match="KMeans.fit"):
            htt.cluster.KMeans(n_clusters=2, max_iter=2, random_state=0).fit(x)
        with pytest.raises(htt.FuseTraceError, match="Lasso.fit"):
            htt.regression.Lasso(max_iter=2).fit(x, y)
    assert htt.cluster.KMeans(n_clusters=2, max_iter=2, random_state=0).fit(x).n_iter_ >= 1
    assert torch.is_tensor(x.larray)


def test_chip_smoke_carries_the_references_pipelines_with_only_the_import_changed():
    """``chip_smoke.py`` phase 18 runs copies of the fixture, of
    ``bench.py``'s ``_autoshard_bench_pipeline`` and of
    ``tests/test_autoshard.py``'s ``_loopy_pipeline`` (the card machine has
    no JAX): each is the same source but for its import line, suppression
    comments included."""
    import ast

    import chip_smoke

    assert chip_smoke.AUTOSHARD_PIPELINES == port_fixture_source()

    def source_of(path, name):
        text = open(os.path.join(REPO, path), encoding="utf-8").read()
        node = next(n for n in ast.parse(text).body if isinstance(n, ast.FunctionDef) and n.name == name)
        return ast.get_source_segment(text, node) + "\n"

    bench = source_of("bench.py", "_autoshard_bench_pipeline")
    assert bench.count("    import heat_tpu as ht\n") == 1
    assert chip_smoke.AUTOSHARD_BENCH == bench.replace("    import heat_tpu as ht\n",
                                                       "    import heat_tpu_torch as ht\n")
    assert "# spmdlint: disable=SPMD502,SPMD505" in chip_smoke.AUTOSHARD_BENCH
    assert chip_smoke.AUTOSHARD_LOOPY == source_of("tests/test_autoshard.py", "_loopy_pipeline")


def test_chip_smoke_phase_module_solves_the_bench_pipeline(tmp_path):
    """Phase 18's module, as the card imports it, on CPU positions: the
    bench pipeline solved bitwise its hand twin with one elided hop, the
    loopy pipeline unplanned."""
    import chip_smoke

    mod = chip_smoke.autoshard_module(str(tmp_path))
    assert sorted(mod.__all__) == PIPELINES
    for p in (4, 8):
        comm = _comm(p)
        auto = htt.autoshard(mod._autoshard_bench_pipeline)
        plan = auto.plan(comm)
        assert sum(d["elide"] for d in plan["decisions"]) == 1
        assert plan["modeled_wire_bytes"] < plan["hand_wire_bytes"]
        assert chip_smoke.twin_equal(auto(comm), htt.fuse(mod._autoshard_bench_pipeline)(comm))
    assert htt.autoshard(mod._loopy_pipeline).plan(_comm(4)) is None
