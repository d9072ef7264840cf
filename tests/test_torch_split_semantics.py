"""The port's split-semantics registry held against the JAX package's:
the same names, kinds and params, declared by the same op modules and
entry points; and every declared op with a table entry run in both
packages on the same inputs at 1, 4 and 8 positions, its result's
``split`` equal to the reference's.  Everything is exact.
"""

import numpy as np
import pytest

import jax

import heat_tpu as ht
from heat_tpu.core import _split_semantics as rss
from heat_tpu.core.communication import XlaCommunication
from test_torch_reference_state import reference_state  # noqa: F401,E402  (restores the JAX package's state)

import heat_tpu_torch as htt
from heat_tpu_torch.core import _split_semantics as tss


def test_module_surface_and_tables_equal_the_references():
    assert tss.__all__ == rss.__all__
    assert tss.KINDS == rss.KINDS
    assert tss.KIND_LAYOUT_FREEDOM == rss.KIND_LAYOUT_FREEDOM
    for kind in sorted(rss.KINDS):
        for ndim, mesh_ndim in [(1, 1), (2, 1), (3, 1), (2, 2), (3, 2)]:
            assert tss.layout_alternatives(kind, ndim, mesh_ndim) == rss.layout_alternatives(kind, ndim, mesh_ndim)


def test_registry_equals_the_references_name_for_name():
    mine = {n: (s.kind, s.params) for n, s in tss.REGISTRY.items()}
    ref = {n: (s.kind, s.params) for n, s in rss.REGISTRY.items()}
    assert mine == ref
    for name, sem in tss.REGISTRY.items():
        assert sem.module.replace("heat_tpu_torch", "heat_tpu") == rss.REGISTRY[name].module, name


def test_declarations_check_their_kind_and_conflicts():
    with pytest.raises(ValueError, match="unknown split-semantics kind"):
        tss.declare_split_semantics("test_op_kind", "bogus")
    tss.declare_split_semantics("test_op_conflict", "elementwise", module="a")
    try:
        tss.declare_split_semantics("test_op_conflict", "elementwise", module="b")
        with pytest.raises(ValueError, match="conflicting split semantics"):
            tss.declare_split_semantics("test_op_conflict", "binary", module="c")
        fn = tss.split_semantics("reduction", name="test_op_deco", axis="0")(lambda x: x)
        assert fn.__split_semantics__.param("axis") == "0" and fn.__split_semantics__.param("nope", 3) == 3
    finally:
        tss.REGISTRY.pop("test_op_conflict", None)
        tss.REGISTRY.pop("test_op_deco", None)


# --------------------------------------------------------------------- #
# declared rules against observed splits                                 #
# --------------------------------------------------------------------- #
RNG = np.random.default_rng(17)
X = (RNG.random((8, 6)) * 0.8 + 0.1).astype(np.float32)
Y = (RNG.random((8, 6)) * 0.8 + 0.1).astype(np.float32)
I = RNG.integers(1, 9, size=(8, 6)).astype(np.int32)

#: how each declared name is called: ``f(pkg, name, x, y, i, comm)`` with
#: ``x``, ``y`` float DNDarrays (``x`` at the split under test, ``y`` at
#: another), ``i`` an int32 one at ``x``'s split
CALLS = {
    "elementwise": lambda pkg, n, x, y, i, c: getattr(pkg, n)(i if n == "invert" else x),
    "binary": lambda pkg, n, x, y, i, c: getattr(pkg, n)(*((i, i) if n in _INT_BINARY else (x, y))),
    "reduction": lambda pkg, n, x, y, i, c: getattr(pkg, n)(x, axis=1) if n != "median" else pkg.median(x, axis=1),
    "cumulative": lambda pkg, n, x, y, i, c: getattr(pkg, n)(x, axis=1),
    "matmul": lambda pkg, n, x, y, i, c: getattr(pkg, n)(x, y.T),
    "transpose": lambda pkg, n, x, y, i, c: pkg.transpose(x),
    "reshape": lambda pkg, n, x, y, i, c: pkg.reshape(x, (4, 12)),
    "concat": lambda pkg, n, x, y, i, c: (pkg.concatenate((x, x), axis=1) if n == "concatenate"
                                          else getattr(pkg, n)((x, x))),
    "stack": lambda pkg, n, x, y, i, c: pkg.stack((x, x), axis=0),
    "expand_dims": lambda pkg, n, x, y, i, c: pkg.expand_dims(x, 0),
    "squeeze": lambda pkg, n, x, y, i, c: pkg.squeeze(pkg.expand_dims(x, 1), 1),
    "flatten": lambda pkg, n, x, y, i, c: getattr(pkg, n)(x) if hasattr(pkg, n) else getattr(x, n)(),
    "resplit": lambda pkg, n, x, y, i, c: x.resplit_(1) if n == "resplit_" else pkg.resplit(x, 1),
    "factory": lambda pkg, n, x, y, i, c: _FACTORIES[n](pkg, c),
    "factory_like": lambda pkg, n, x, y, i, c: (getattr(pkg, n)(x, 2.0) if n == "full_like"
                                                else getattr(pkg, n)(x)),
}
_INT_BINARY = {"left_shift", "right_shift", "bitwise_and", "bitwise_or", "bitwise_xor", "floordiv", "fmod",
               "remainder", "mod"}
_FACTORIES = {
    "array": lambda pkg, c: pkg.array(X, split=0, comm=c),
    "arange": lambda pkg, c: pkg.arange(24, split=0, comm=c),
    "empty": lambda pkg, c: pkg.empty((8, 6), split=1, comm=c),
    "zeros": lambda pkg, c: pkg.zeros((8, 6), split=0, comm=c),
    "ones": lambda pkg, c: pkg.ones((8, 6), split=None, comm=c),
    "full": lambda pkg, c: pkg.full((8, 6), 3.0, split=1, comm=c),
    "eye": lambda pkg, c: pkg.eye(8, split=0, comm=c),
    "linspace": lambda pkg, c: pkg.linspace(0.0, 1.0, 24, split=0, comm=c),
    "logspace": lambda pkg, c: pkg.logspace(0.0, 1.0, 24, split=0, comm=c),
}
TABLE_KINDS = sorted(CALLS)


def _splits(res):
    if isinstance(res, (tuple, list)):
        return tuple(_splits(r) for r in res)
    return res.split


def _comms(p):
    if len(jax.devices()) < p:
        pytest.skip(f"needs {p} devices")
    return XlaCommunication(jax.devices()[:p]), htt.TorchCommunication(["cpu"] * p)


@pytest.mark.parametrize("kind", TABLE_KINDS)
@pytest.mark.parametrize("p", [1, 4, 8])
def test_declared_ops_give_the_references_split(kind, p):
    rcomm, tcomm = _comms(p)
    names = sorted(n for n, s in tss.REGISTRY.items() if s.kind == kind)
    assert names
    for split, other in {1: [(0, None)], 4: [(None, 0)], 8: [(0, 1)]}[p]:
        for name in names:
            got_want = []
            for pkg, comm in ((htt, tcomm), (ht, rcomm)):
                x = pkg.array(X, split=split, comm=comm)
                y = pkg.array(Y, split=other, comm=comm)
                i = pkg.array(I, split=split, comm=comm)
                got_want.append(_splits(CALLS[kind](pkg, name, x, y, i, comm)))
            assert got_want[0] == got_want[1], (name, split, got_want)


@pytest.mark.parametrize("p", [1, 4, 8])
def test_entry_points_give_the_references_splits(p):
    rcomm, tcomm = _comms(p)
    data = RNG.standard_normal((8 * p, 4)).astype(np.float32)
    for split in (0, 1, None):
        got_want = []
        for pkg, comm in ((htt, tcomm), (ht, rcomm)):
            x = pkg.array(data, split=split, comm=comm)
            q, r = pkg.linalg.qr(x)
            u, s, v = pkg.linalg.svd(x)
            gate = pkg.core.sanitation.sanitize_predict_in(x, 4)
            d = pkg.spatial.cdist(x, x)
            got_want.append((q.split, r.split, u.split, s.split, v.split, gate.split, d.split))
        assert got_want[0] == got_want[1], (split, got_want)
