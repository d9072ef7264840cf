"""``htt.autoshard`` against the reference's ``ht.autoshard``: the same
plan, the same rung, the same results.

Both packages run the same fixture source: the reference its
``tests/splitflow_pipelines.py``, the port that file with its one import
line swapped to ``heat_tpu_torch`` (written under a temporary directory
and imported by path).  For all seven pipelines at 1, 2, 4 and 8
positions, under ``"f32"`` and ``"int8_block"``:

* **the plan**: ``plan(comm)`` is the reference's dict key for key
  (function, fingerprint, mesh, precision, overlap, every decision, the
  modeled and hand wire and exact bytes) but for the modeled times.  The
  two cost models differ in one number, the rate of a move between
  positions (``_costs.DEFAULT_ICI_GBPS``: a TPU link's figure in the
  reference, the card's roll in the port), so each modeled time is the
  reference's times the ratio of the rates; and the port's plan equals,
  exactly, the plan the reference's own solver gives the reference's
  summary at the port's rate;
* **the rung** (fused, eager or plain) is the reference's;
* **the results** of the solved call are the reference's solved results:
  bitwise where the earlier slices pin the computation bitwise (the
  factories, the elementwise ops, the resplits, GaussianNB's labels);
  the fits, KMeans' labels on a tie and the SVD to the tolerance of
  their existing parity tests (``tests/test_torch_lasso.py``,
  ``test_torch_estimators.py``, ``test_torch_slice.py``,
  ``test_torch_linalg.py``), named beside each below.
"""

import importlib
import importlib.util
import os

import jax
import numpy as np
import pytest

import heat_tpu as ht
from heat_tpu.comm import _costs as rcosts
from heat_tpu.core.communication import XlaCommunication

import heat_tpu_torch as htt
from heat_tpu_torch.comm import _costs as tcosts

import tests.splitflow_pipelines as rpipelines

from test_torch_reference_state import reference_state  # noqa: F401  (restores the JAX package's state)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "splitflow_pipelines.py")
MESHES = [1, 2, 4, 8]
PRECISIONS = ["f32", "int8_block"]
PIPELINES = sorted(rpipelines.__all__)
RATE_RATIO = rcosts.DEFAULT_ICI_GBPS / tcosts.DEFAULT_ICI_GBPS
tauto = importlib.import_module("heat_tpu_torch.core.autoshard")
rauto = importlib.import_module("heat_tpu.core.autoshard")


def port_fixture_source() -> str:
    with open(FIXTURE, encoding="utf-8") as fh:
        src = fh.read()
    assert src.count("\nimport heat_tpu as ht\n") == 1
    return src.replace("\nimport heat_tpu as ht\n", "\nimport heat_tpu_torch as ht\n")


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    path = tmp_path_factory.mktemp("parity") / "port_splitflow_pipelines.py"
    path.write_text(port_fixture_source(), encoding="utf-8")
    spec = importlib.util.spec_from_file_location("port_splitflow_pipelines", str(path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def on_cpu():
    prev = htt.core.devices._default
    htt.use_device("cpu")
    yield
    htt.use_device(prev)


def _comms(k):
    devs = jax.devices()
    if len(devs) < k:
        pytest.skip(f"mesh size {k} needs {k} devices, have {len(devs)}")
    return XlaCommunication(devs[:k]), htt.TorchCommunication(["cpu"] * k)


def _without_times(plan: dict) -> dict:
    out = {k: v for k, v in plan.items() if not k.endswith("critical_path_ms")}
    out["decisions"] = [{k: v for k, v in d.items() if k != "critical_path_ms"} for d in plan["decisions"]]
    return out


def _times(plan: dict) -> list:
    return [plan["modeled_critical_path_ms"], plan["hand_critical_path_ms"]] + [
        d["critical_path_ms"] for d in plan["decisions"]]


# --------------------------------------------------------------------- #
# the plan                                                               #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", PIPELINES)
def test_plan_equals_the_references(pipelines, name, mesh, precision):
    rcomm, tcomm = _comms(mesh)
    r = ht.autoshard(getattr(rpipelines, name))
    t = htt.autoshard(getattr(pipelines, name))
    with ht.comm.collective_precision(precision), htt.comm.collective_precision(precision):
        want = r.plan(rcomm)
        got = t.plan(tcomm)
        at_port_rate = rcosts.LayoutSolver(
            mesh, precision=precision, threshold=ht.comm.get_collective_threshold(),
            overlap=ht.comm.get_overlap() == "on", gbps=tcosts.DEFAULT_ICI_GBPS,
        ).solve(r._summarize())
    assert want is not None and got is not None
    assert _without_times(got) == _without_times(want)
    for mine, ref in zip(_times(got), _times(want)):
        for sched in ("serial", "overlap"):
            assert mine[sched] == pytest.approx(ref[sched] * RATE_RATIO, rel=1e-12, abs=0.0)
    assert got == at_port_rate
    if name == "staged_resplit_pipeline" and mesh > 1:
        assert sum(d["elide"] for d in got["decisions"]) == 1
        assert got["modeled_wire_bytes"] < got["hand_wire_bytes"]


def test_summaries_equal_the_references_but_for_their_file(pipelines):
    for name in PIPELINES:
        want = ht.autoshard(getattr(rpipelines, name))._summarize()
        got = htt.autoshard(getattr(pipelines, name))._summarize()
        assert want["path"] == "tests/splitflow_pipelines.py"
        assert got["path"].endswith("port_splitflow_pipelines.py")
        for key in ("path", "module"):
            want.pop(key), got.pop(key)
        assert got == want, name


def test_loopy_pipeline_falls_back_in_both():
    import tests.test_autoshard as rtest

    assert ht.autoshard(rtest._loopy_pipeline)._summarize() is None
    from test_torch_autoshard import _loopy_pipeline

    assert htt.autoshard(_loopy_pipeline)._summarize() is None


# --------------------------------------------------------------------- #
# the rung and the results                                               #
# --------------------------------------------------------------------- #
def _np(a) -> np.ndarray:
    return np.asarray(a.numpy())


def _hold_svd(got, want, **_):
    """tests/test_torch_linalg.py's rule for a factorization of a matrix
    this far from full rank (the fixture is rank 2: its other 30 singular
    values are float32 noise): S and the product U S V^T within 1e-4 of
    the largest entry."""
    a, u, s, v = (_np(x) for x in got)
    ra, ru, rs, rv = (_np(x) for x in want)
    assert a.tobytes() == ra.tobytes()
    scale = max(1.0, float(np.abs(ra).max()))
    np.testing.assert_allclose(s, rs, atol=1e-4 * scale, rtol=0)
    np.testing.assert_allclose(s[:2], rs[:2], rtol=1e-5)  # the two that are not noise
    np.testing.assert_allclose((u * s) @ v.T, (ru * rs) @ rv.T, atol=1e-4 * scale)


def _hold_kmeans(got, want, rcomm=None):
    """Labels equal but on rows whose two float64 distances to the fitted
    centers lie within cdist's parity rule of each other
    (tests/test_torch_slice.py: rtol 1e-5, float32 sums in another
    order): on such a tie each package's float32 ``cdist`` picks a side
    (the fixture's row 32 is equidistant from both centers)."""
    assert _np(got[0]).tobytes() == _np(want[0]).tobytes()
    mine, ref = _np(got[1]), _np(want[1])
    centers = np.asarray(ht.cluster.KMeans(n_clusters=2, max_iter=3, random_state=0).fit(
        rpipelines._features(rcomm)).cluster_centers_.numpy()).astype(np.float64)
    x = _np(got[0]).astype(np.float64)
    d = np.sqrt(((x[:, None, :] - centers[None]) ** 2).sum(-1))
    rows = np.nonzero(mine != ref)[0]
    for i in rows:
        assert abs(d[i, mine[i]] - d[i, ref[i]]) <= 1e-5 * d[i, ref[i]], (i, d[i])
    assert len(rows) <= 1


def _hold_lasso(got, want, **_):
    """tests/test_torch_lasso.py's rule for predict: rtol 1e-4, atol 1e-5."""
    for g, w in zip(got[:2], want[:2]):
        assert _np(g).tobytes() == _np(w).tobytes()
    np.testing.assert_allclose(_np(got[2]), _np(want[2]), rtol=1e-4, atol=1e-5)


def _hold_gnb(got, want, **_):
    """tests/test_torch_estimators.py's rule: labels bitwise, probabilities
    within 1e-6."""
    for g, w in zip(got[:3], want[:3]):
        assert _np(g).tobytes() == _np(w).tobytes()
    np.testing.assert_allclose(_np(got[3]), _np(want[3]), rtol=1e-6, atol=1e-6)


def _hold_bitwise(got, want, **_):
    for g, w in zip(got, want):
        assert _np(g).tobytes() == _np(w).tobytes()


HOLD = {"svd_pipeline": _hold_svd, "lasso_pipeline": _hold_lasso, "gnb_pipeline": _hold_gnb,
        "kmeans_pipeline": _hold_kmeans}


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", PIPELINES)
def test_solved_results_equal_the_references(pipelines, name, mesh, precision):
    rcomm, tcomm = _comms(mesh)
    r = ht.autoshard(getattr(rpipelines, name))
    t = htt.autoshard(getattr(pipelines, name))
    with ht.comm.collective_precision(precision), htt.comm.collective_precision(precision):
        want = r(rcomm)
        got = t(tcomm)
        r_rung = r._programs[rauto._policy_key(rcomm)][0]
        t_rung = t._programs[tauto._policy_key(tcomm)][0]
        assert t_rung == r_rung
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert (g.split, g.gshape, g.dtype.__name__) == (w.split, w.gshape, w.dtype.__name__)
        HOLD.get(name, _hold_bitwise)(got, want, rcomm=rcomm)
