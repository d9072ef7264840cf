"""KNN's predict in the reference's tie order and as one fused dispatch.

The reference picks the neighbours with ``lax.top_k(-d2, k)``
(``heat_tpu/classification/knn.py:35``): XLA's total order of ``-d2``,
ties to the lowest index, so a NaN distance (whose negation is -NaN)
comes last.  The port's ``_nearest`` keeps that order without sorting
whole rows.  Every prediction here is held **bitwise** to the
reference's on the same numpy inputs: the inputs are small integers
(and signed zeros), so both packages compute the same distances exactly
and only the tie order could tell them apart.
"""

import numpy as np
import pytest
import torch

import jax

import heat_tpu as ht
from heat_tpu.core.communication import XlaCommunication
from test_torch_reference_state import reference_state  # noqa: F401  (restores the JAX package's state)

import heat_tpu_torch as htt
from heat_tpu_torch.classification import knn as pknn
from heat_tpu_torch.telemetry import counting_dispatches

from heat_tpu.core._tracing import counting_dispatches as ref_counting

P = len(jax.devices())


def _comms(p):
    return htt.TorchCommunication(["cpu"] * p), XlaCommunication(jax.devices()[:p])


def _predict(mod, comm, train, labels, query, k, split=0, one_hot=False):
    y = mod.array(labels, split=split, comm=comm)
    if one_hot:
        y = mod.classification.KNN.label_to_one_hot(y)
    est = mod.classification.KNN(mod.array(train, split=split, comm=comm), y, k)
    out = est.predict(mod.array(query, split=split, comm=comm))
    return np.asarray(out.numpy()), out


# --------------------------------------------------------------------- #
# C9: the tie order                                                       #
# --------------------------------------------------------------------- #
C9_TRAIN = np.array([[0, 0], [0, 0], [0, 0], [3, 3], [0, 0], [4, 4], [0, 0], [5, 5]], np.float32)
C9_LABELS = np.array([1, 0, 0, 1, 1, 1, 0, 0])
C9_QUERY = np.zeros((8, 2), np.float32)


@pytest.mark.parametrize("p", [1, P])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_c9_ties_go_to_the_lowest_training_row(p, k):
    comm, rcomm = _comms(p)
    mine, out = _predict(htt, comm, C9_TRAIN, C9_LABELS, C9_QUERY, k)
    ref, _ = _predict(ht, rcomm, C9_TRAIN, C9_LABELS, C9_QUERY, k)
    np.testing.assert_array_equal(mine, ref)
    assert mine.dtype == np.int64 and out.split == 0
    if k == 1:
        assert (mine == 1).all()  # training row 0, as numpy's stable argsort


def _tied(seed, n=24, f=3, m=13, classes=3):
    """Small-integer rows with forced ties: duplicated training rows,
    queries equidistant from several rows, signed zeros."""
    rng = np.random.default_rng(seed)
    base = rng.integers(-2, 3, size=(n // 3, f)).astype(np.float32)
    train = base[rng.integers(0, len(base), size=n)]
    train[rng.random(train.shape) < 0.3] *= -1  # -0.0 where a value was 0
    query = np.concatenate([train[rng.integers(0, n, size=m // 2)],
                            rng.integers(-2, 3, size=(m - m // 2, f)).astype(np.float32)])
    query[query == 0] = np.float32(-0.0) if seed % 2 else np.float32(0.0)
    labels = rng.integers(0, classes, size=n)
    return train, labels, query


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("split", [None, 0])
def test_random_ties_bitwise_the_reference(seed, k, split):
    train, labels, query = _tied(seed)
    comm, rcomm = _comms(P)
    mine, _ = _predict(htt, comm, train, labels, query, k, split)
    ref, _ = _predict(ht, rcomm, train, labels, query, k, split)
    np.testing.assert_array_equal(mine, ref)


@pytest.mark.parametrize("where", ["query", "train"])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_nan_rows_bitwise_the_reference(where, k):
    """A NaN query row ties every training row (all distances NaN); a NaN
    training row is every query's farthest (-NaN ranks last)."""
    train, labels, query = _tied(5)
    if where == "query":
        query[2] = np.nan
    else:
        train[0] = np.nan
        train[5, 1] = np.nan
    comm, rcomm = _comms(P)
    mine, _ = _predict(htt, comm, train, labels, query, k)
    ref, _ = _predict(ht, rcomm, train, labels, query, k)
    np.testing.assert_array_equal(mine, ref)


@pytest.mark.parametrize("k", [1, 3])
def test_float64_and_one_hot_ties_bitwise_the_reference(k):
    train, labels, query = _tied(6)
    comm, rcomm = _comms(P)
    t64, q64 = train.astype(np.float64), query.astype(np.float64)
    mine, _ = _predict(htt, comm, t64, labels, q64, k, one_hot=True)
    ref, _ = _predict(ht, rcomm, t64, labels, q64, k, one_hot=True)
    np.testing.assert_array_equal(mine, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_nearest_is_a_stable_argsort_of_the_total_order(dtype):
    """``_nearest`` against numpy's stable argsort of the distances, with
    NaN last: the order ``lax.top_k(-d2)`` gives."""
    rng = np.random.default_rng(7)
    d2 = rng.integers(0, 4, size=(9, 40)).astype(np.float64)
    d2[3, 5] = d2[4, :] = np.nan
    want = np.argsort(np.where(np.isnan(d2), np.inf, d2), axis=1, kind="stable")
    want = np.where(np.isnan(np.take_along_axis(d2, want, 1)), -1, want)
    got = pknn._nearest(torch.from_numpy(d2).to(dtype), 40).numpy()
    nan_rank = np.isnan(np.take_along_axis(d2, got, 1))
    np.testing.assert_array_equal(np.where(nan_rank, -1, got), want)
    # NaNs come last, lowest column first among themselves
    np.testing.assert_array_equal(got[4], np.arange(40))


# --------------------------------------------------------------------- #
# C10: one fused dispatch                                                 #
# --------------------------------------------------------------------- #
def test_c10_warm_predict_is_one_dispatch():
    """ROADMAP C10's input: 64 x 4 training rows, 3 classes, k = 5, 16
    queries, split 0 at 8 positions."""
    rng = np.random.default_rng(10)
    train = rng.standard_normal((64, 4)).astype(np.float32)
    labels = rng.integers(0, 3, 64)
    query = rng.standard_normal((16, 4)).astype(np.float32)
    comm, rcomm = _comms(P)
    kt = htt.classification.KNN(htt.array(train, split=0, comm=comm), htt.array(labels, split=0, comm=comm), 5)
    kj = ht.classification.KNN(ht.array(train, split=0, comm=rcomm), ht.array(labels, split=0, comm=rcomm), 5)
    qt, qj = htt.array(query, split=0, comm=comm), ht.array(query, split=0, comm=rcomm)
    kt.predict(qt), kj.predict(qj)
    with counting_dispatches() as d:
        mine = kt.predict(qt)
    with ref_counting() as r:
        ref = kj.predict(qj)
    assert d.count == r.count == 1
    np.testing.assert_array_equal(mine.numpy(), np.asarray(ref.numpy()))
