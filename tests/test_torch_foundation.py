"""The port's foundation held against the JAX package: ``constants``,
``stride_tricks``, ``types`` (finfo/iinfo field by field, ``can_cast``
under every rule, ``result_type``, ``heat_type_of``, ``issubdtype``, the
type classes as casts), the ``sanitation`` helpers, ``memory``, and the
public surface of every module of this slice.

Cases come from the reference's ``test_types.py`` and
``test_core_utils.py``.  Everything here is exact.
"""

import importlib
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

import jax

import heat_tpu as ht
from test_torch_reference_state import reference_state  # noqa: F401,E402  (restores the JAX package's state)

import heat_tpu_torch as htt
from heat_tpu_torch.core import communication as tcomm


@pytest.fixture
def port():
    comm = htt.TorchCommunication(["cpu"] * len(jax.devices()))
    prev = tcomm._default_comm
    htt.use_comm(comm)
    yield comm
    htt.use_comm(prev)


TYPES = ["bool", "uint8", "int8", "int16", "int32", "int64", "float16", "bfloat16", "float32", "float64"]


# --------------------------------------------------------------------- #
# the public surface                                                      #
# --------------------------------------------------------------------- #
#: names of a reference module's __all__ that the port does not have yet,
#: each with the queue item of ROADMAP.md that brings it (none since
#: ``init_multihost``, A3b1)
WAITING = {}
#: names the port spells differently
RENAMED = {"communication": {"XlaCommunication": "TorchCommunication"}}
#: names only the port exports: its own ``neg`` (the reference's __neg__
#: multiplies by -1), the ``gpu`` device (the reference's is looked up
#: lazily), and the named tuples ``qr``/``svd`` return
PORT_ONLY = {"arithmetics": {"neg"}, "devices": {"gpu"}, "linalg.qr": {"QR"}, "linalg.svd": {"SVD"}}
#: every module of the port's core with a counterpart in the reference
PORTED_MODULES = [
    "constants", "stride_tricks", "types", "sanitation", "memory", "communication", "devices",
    "arithmetics", "factories", "indexing", "printing", "dndarray", "_operations", "base",
    "exponential", "logical", "relational", "rounding", "statistics", "trigonometrics", "random",
    "linalg.basics", "linalg.qr", "linalg.svd", "linalg.solver", "manipulations", "tiling",
    "io", "checkpoint", "_tracing", "_compile", "fuse", "aot", "_split_semantics", "autoshard",
]


#: the base layer's packages and modules, against the reference's
#: ``__all__`` less their ``WAITING`` names
BASE_MODULES = [
    "telemetry", "telemetry._core", "telemetry.hist", "telemetry.flight", "telemetry.slo",
    "telemetry.export", "telemetry.httpz", "net._base", "resilience", "resilience.faults",
    "resilience.guards", "resilience.incidents", "resilience.retry", "resilience.fixtures",
    "resilience.resume", "resilience.elastic", "io", "io.stream", "datasets", "obs", "native",
    "comm", "comm._costs", "comm.overlap", "comm.redistribute",
    "net", "net.wire", "serve", "serve.errors", "serve.registry", "serve.batcher", "serve.engine",
    "serve.loadgen", "serve.health", "serve.wfq", "serve.fleet", "serve.procfleet", "serve.ingress",
    "analysis", "analysis.core", "analysis.rules", "analysis.checkers", "analysis.baseline",
    "analysis.cache", "analysis.splitflow", "analysis.splitflow.domain",
    "analysis.splitflow.transfer", "analysis.splitflow.registry", "analysis.splitflow.engine",
    "analysis.splitflow.summary", "analysis.splitflow.report", "analysis.splitflow.checkers",
]


@pytest.mark.parametrize("name", BASE_MODULES)
def test_base_layer_surface_equals_reference_less_waiting_names(name):
    ref = importlib.import_module(f"heat_tpu.{name}")
    mine = importlib.import_module(f"heat_tpu_torch.{name}")
    want = set(ref.__all__) - set(WAITING.get(name, {}))
    assert set(mine.__all__) == want
    for n in mine.__all__:
        assert hasattr(mine, n), n


def test_package_exports_telemetry_and_resilience():
    assert htt.telemetry is importlib.import_module("heat_tpu_torch.telemetry")
    assert htt.resilience is importlib.import_module("heat_tpu_torch.resilience")
    assert htt.resilience.retry is importlib.import_module("heat_tpu_torch.resilience.retry")


def test_package_exports_io_checkpoints_datasets_and_obs():
    """``htt.io`` is the io package (as ``ht.io``), the flat loaders and
    the checkpoint functions sit in the flat namespace, and every such
    name of the reference's flat namespace is the port's."""
    assert htt.io is importlib.import_module("heat_tpu_torch.io")
    assert htt.io.stream is importlib.import_module("heat_tpu_torch.io.stream")
    assert htt.datasets is importlib.import_module("heat_tpu_torch.datasets")
    assert htt.obs is importlib.import_module("heat_tpu_torch.obs")
    names = set(ht.core.io.__all__) | set(ht.core.checkpoint.__all__)
    for n in names:
        assert getattr(htt, n) is getattr(htt.core, n), n
    assert htt.load is htt.io.load and htt.save_estimator is htt.core.checkpoint.save_estimator
    assert htt.BaseEstimator.save and htt.BaseEstimator.load


@pytest.mark.parametrize("name", PORTED_MODULES)
def test_surface_equals_reference_less_waiting_names(name):
    ref = importlib.import_module(f"heat_tpu.core.{name}")
    mine = importlib.import_module(f"heat_tpu_torch.core.{name}")
    renamed = RENAMED.get(name, {})
    want = {renamed.get(n, n) for n in ref.__all__} - set(WAITING.get(name, {}))
    assert set(mine.__all__) - PORT_ONLY.get(name, set()) == want
    for n in mine.__all__:
        assert hasattr(mine, n), n


#: the package-level names that differ on purpose (C11): the reference's
#: waiting names with the queue item that brings them, the names it leaks,
#: its communicator's name, and the port's own names
TOP_WAITING = {}
TOP_REF_LEAKS = {"basics", "solver"}
TOP_RENAMED = {"XlaCommunication": "TorchCommunication", "heat_tpu": "heat_tpu_torch"}
#: ``interop`` is imported by the port's package (the reference leaves
#: its module to an explicit import); ``gpu`` and ``neg`` as ``PORT_ONLY``
TOP_PORT_ONLY = {"gpu", "neg", "interop"}


def _fresh_names() -> tuple:
    """Both packages' public names as a fresh interpreter sees them after
    ``import``: in this process other test files import submodules (the
    port's ``kernels``, the reference's ``analysis``), which become
    package attributes."""
    code = ("import json, heat_tpu, heat_tpu_torch\n"
            "print(json.dumps([sorted(n for n in dir(m) if not n.startswith('_'))"
            " for m in (heat_tpu, heat_tpu_torch)]))")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=root, timeout=300, check=True)
    ref, mine = json.loads(out.stdout.strip().splitlines()[-1])
    return set(ref), set(mine)


def test_package_names_equal_the_references_less_the_listed_differences():
    ref, mine = _fresh_names()
    want = {TOP_RENAMED.get(n, n) for n in ref} - set(TOP_WAITING) - TOP_REF_LEAKS
    assert mine - TOP_PORT_ONLY == want
    assert htt.Device is htt.core.devices.Device and isinstance(htt.cpu, htt.Device)
    assert htt.__version__ == ht.__version__
    assert htt.version is importlib.import_module("heat_tpu_torch.version")
    for n in ("major", "minor", "micro", "extension", "__version__"):
        assert getattr(htt.version, n) == getattr(ht.version, n), n


def test_flat_namespace_exports_the_slice():
    for n in ("pi", "inf", "nan", "e", "Euler", "Infinity", "broadcast_shape", "sanitize_shape",
              "copy", "sanitize_memory_layout", "finfo", "iinfo", "can_cast", "result_type",
              "heat_type_of", "issubdtype", "flexible", "nonzero", "where", "get_printoptions",
              "set_printoptions", "asarray", "empty", "eye", "linspace", "logspace", "cumsum",
              "floordiv", "left_shift", "diff", "prod", "bitwise_not", "sanitize_out", "LocalIndex"):
        assert hasattr(htt, n), n


# --------------------------------------------------------------------- #
# constants and stride_tricks                                            #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["e", "Euler", "inf", "Inf", "Infty", "Infinity", "nan", "NaN", "pi",
                                  "INF", "NAN", "NINF", "PI", "E"])
def test_constants_equal_reference(name):
    a, b = getattr(htt.core.constants, name), getattr(ht.core.constants, name)
    assert type(a) is float
    assert a == b or (math.isnan(a) and math.isnan(b))


@pytest.mark.parametrize("a,b", [((3, 1), (1, 4)), ((5, 1, 4), (3, 1)), ((), (2, 3)), ((2, 3), (4, 3))])
def test_broadcast_shape(a, b):
    try:
        want = ht.broadcast_shape(a, b)
    except ValueError:
        with pytest.raises(ValueError):
            htt.broadcast_shape(a, b)
        return
    assert htt.broadcast_shape(a, b) == want


@pytest.mark.parametrize("shape,axis", [
    ((4, 5, 6), 1), ((4, 5, 6), -1), ((4, 5, 6), (0, -1)), ((4, 5, 6), [2, 0]), ((), 0), ((), -1),
    ((4, 5), None), ((4, 5), np.int64(1)), ((4, 5), 2), ((4, 5), -3), ((4, 5), (0, 0)), ((4, 5), 1.5),
    ((4, 5), (0, 1.0)), ((), (0,)),
])
def test_sanitize_axis(shape, axis):
    try:
        want = ht.core.stride_tricks.sanitize_axis(shape, axis)
    except (ValueError, TypeError) as exc:
        with pytest.raises(type(exc)):
            htt.core.stride_tricks.sanitize_axis(shape, axis)
        return
    assert htt.core.stride_tricks.sanitize_axis(shape, axis) == want
    assert htt.core.sanitation.sanitize_axis is htt.core.stride_tricks.sanitize_axis


@pytest.mark.parametrize("shape,lval", [(5, 0), ((2, 3), 0), ([4, 0], 0), (np.array([2, 2]), 0),
                                        ((2, -1), 0), ((0, 3), 1), ("ab", 0), ((2.0,), 0), (np.int32(3), 0)])
def test_sanitize_shape(shape, lval):
    try:
        want = ht.sanitize_shape(shape, lval)
    except (ValueError, TypeError) as exc:
        with pytest.raises(type(exc)):
            htt.sanitize_shape(shape, lval)
        return
    assert htt.sanitize_shape(shape, lval) == want


@pytest.mark.parametrize("sl,n", [(slice(None), 7), (slice(-3, None), 7), (slice(None, None, -2), 7),
                                  (slice(2, 100, 3), 5), (slice(10, 1, -1), 4)])
def test_sanitize_slice(sl, n):
    assert htt.sanitize_slice(sl, n) == ht.sanitize_slice(sl, n)
    with pytest.raises(TypeError):
        htt.sanitize_slice(3, n)


# --------------------------------------------------------------------- #
# types                                                                   #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", [t for t in TYPES if t not in ("bool",) and not t.startswith(("u", "i"))])
def test_finfo_fields_equal_reference(name):
    a, b = htt.finfo(getattr(htt, name)), ht.finfo(getattr(ht, name))
    for field in ("bits", "eps", "max", "min", "tiny"):
        assert getattr(a, field) == getattr(b, field), field
        assert type(getattr(a, field)) is type(getattr(b, field)), field
    assert a.dtype.__name__ == b.dtype.__name__
    with pytest.raises(TypeError):
        htt.finfo(htt.int32)


@pytest.mark.parametrize("name", ["bool", "uint8", "int8", "int16", "int32", "int64"])
def test_iinfo_fields_equal_reference(name):
    a, b = htt.iinfo(getattr(htt, name)), ht.iinfo(getattr(ht, name))
    assert (a.bits, a.min, a.max) == (b.bits, b.min, b.max)
    assert repr(a) == repr(b)
    with pytest.raises(TypeError):
        htt.iinfo(htt.float32)


@pytest.mark.parametrize("casting", ["no", "safe", "same_kind", "unsafe", "intuitive"])
def test_can_cast_matrix_equals_reference(casting):
    for src in TYPES:
        for dst in TYPES:
            want = ht.can_cast(getattr(ht, src), getattr(ht, dst), casting)
            assert htt.can_cast(getattr(htt, src), getattr(htt, dst), casting) == want, (src, dst)


def test_can_cast_values_and_errors():
    for value, dst in ((1, "int8"), (1.5, "int32"), (True, "float16"), ([1, 2], "float32")):
        assert htt.can_cast(value, getattr(htt, dst)) == ht.can_cast(value, getattr(ht, dst))
    with pytest.raises(ValueError):
        htt.can_cast(htt.int32, htt.float32, "bogus")
    with pytest.raises(TypeError):
        htt.can_cast(htt.int32, htt.float32, 1)


def test_promote_types_matrix_equals_reference():
    for a in TYPES:
        for b in TYPES:
            want = ht.promote_types(getattr(ht, a), getattr(ht, b)).__name__
            assert htt.promote_types(getattr(htt, a), getattr(htt, b)).__name__ == want, (a, b)


@pytest.mark.parametrize("operands", [
    ("int32", 1), ("int32", 1.0), ("int8", 1), (1, 2.0), ("uint8", "int8"), ("bool", 1),
    ("float16", "bfloat16"), ("int64", 2.5), (True, 3), ([1, 2], "int16"), ([1.5], "float16"),
])
def test_result_type_equals_reference(operands):
    mine = [getattr(htt, o) if isinstance(o, str) else o for o in operands]
    ref = [getattr(ht, o) if isinstance(o, str) else o for o in operands]
    assert htt.result_type(*mine).__name__ == ht.result_type(*ref).__name__


@pytest.mark.parametrize("obj", [
    True, 3, 2.5, [1, 2], [1.5, 2], [2 ** 40], [1e-300], [1e39], [[1, 2], [3, 4]], [],
    [np.int8(1), 2], [np.float16(1.0), 1e5], [np.int32(1), 2 ** 40], np.zeros(2, np.int16),
    np.float64(1.0), (1, 2.0),
])
def test_heat_type_of_equals_reference(obj):
    assert htt.heat_type_of(obj).__name__ == ht.heat_type_of(obj).__name__


def test_heat_type_of_arrays_and_errors(port):
    x = np.arange(4, dtype=np.int16)
    assert htt.heat_type_of(htt.array(x)) is htt.int16
    assert htt.heat_type_of(htt.array(x).larray) is htt.int16
    for bad in (object(), [[1], [2, 3]]):
        with pytest.raises((TypeError, ValueError)) as ref_exc:
            ht.heat_type_of(bad)
        with pytest.raises(ref_exc.type):
            htt.heat_type_of(bad)


@pytest.mark.parametrize("obj", [[1e-300], [2 ** 40], [np.float16(1.0), 1e5], [np.int32(1), 2 ** 40], 1e39,
                                 np.ones((), np.float32), np.float32(2.5), np.ones((3, 2))[:, 0]])
def test_array_infers_the_reference_type_and_shape(port, obj):
    """Found while porting: a list holding 1e-300 typed float32 (it
    flushes to zero there) and a 0-d numpy array came back 1-d (ROADMAP
    queue C, C4)."""
    a, b = htt.array(obj), ht.array(obj)
    assert a.dtype.__name__ == b.dtype.__name__ and a.shape == b.shape
    np.testing.assert_array_equal(a.numpy(), np.asarray(b.numpy()))


def test_issubdtype_and_hierarchy():
    pairs = [("int32", "integer"), ("int32", "floating"), ("bool", "number"), ("uint8", "unsignedinteger"),
             ("bfloat16", "floating"), ("float64", "number"), ("int8", "signedinteger"),
             ("float32", "flexible"), ("int64", "generic")]
    for a, b in pairs:
        assert htt.issubdtype(getattr(htt, a), getattr(htt, b)) == ht.issubdtype(getattr(ht, a), getattr(ht, b))
    assert htt.issubdtype("float32", htt.floating)
    with pytest.raises(TypeError):
        htt.issubdtype(object(), htt.integer)
    for alias, canon in (("bool_", "bool"), ("ubyte", "uint8"), ("byte", "int8"), ("short", "int16"),
                         ("int", "int32"), ("int_", "int32"), ("long", "int64"), ("half", "float16"),
                         ("float", "float32"), ("float_", "float32"), ("double", "float64")):
        assert getattr(htt, alias) is getattr(htt, canon)
        assert getattr(ht, alias).__name__ == canon
    assert [htt.types.canonical_heat_type(c).char() for c in (htt.int8, htt.float32, htt.bool, htt.bfloat16)] == \
        [ht.types.canonical_heat_type(c).char() for c in (ht.int8, ht.float32, ht.bool, ht.bfloat16)]


def test_type_classes_cast_like_the_reference(port):
    for name in ("float32", "int16", "bool", "float64"):
        a, b = getattr(htt, name)([1, 0, 2.7]), getattr(ht, name)([1, 0, 2.7])
        assert a.dtype.__name__ == b.dtype.__name__ == name
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert htt.int32().item() == 0 and htt.float32(1, 2).shape == (2,)
    for abstract in (htt.generic, htt.integer, htt.floating, htt.flexible):
        with pytest.raises(TypeError):
            abstract(1)


# --------------------------------------------------------------------- #
# sanitation and memory                                                   #
# --------------------------------------------------------------------- #
def test_sanitation_helpers_equal_reference(port):
    data = np.arange(12, dtype=np.float32).reshape(4, 3)
    for split in (None, 0, 1):
        a, b = htt.array(data, split=split), ht.array(data, split=split)
        assert htt.sanitize_sequence(a) == ht.sanitize_sequence(b)
        np.testing.assert_array_equal(htt.sanitize_in_tensor(a).numpy(), np.asarray(ht.sanitize_in_tensor(b)))
    for seq in ([1, 2], (1, 2), np.arange(3)):
        assert htt.sanitize_sequence(seq) == ht.sanitize_sequence(seq)
    with pytest.raises(TypeError):
        htt.sanitize_sequence({1, 2})
    for dtype in ("int8", "uint8", "int64", "float32", "bool"):
        x = htt.zeros((2,), dtype=getattr(htt, dtype))
        assert htt.sanitize_infinity(x) == ht.sanitize_infinity(ht.zeros((2,), dtype=getattr(ht, dtype)))
    assert htt.sanitize_infinity(3) == ht.sanitize_infinity(3)
    np.testing.assert_array_equal(htt.sanitize_in_tensor([1, 2]).numpy(), [1, 2])


def test_sanitize_lshape_and_out(port):
    import torch

    for split in (None, 0, 1):
        a, b = htt.zeros((9, 4), split=split), ht.zeros((9, 4), split=split)
        for shape in ((9, 4), (2, 4), (9, 2), (3, 3), (0, 4)):
            t = torch.zeros(shape)
            try:
                ht.sanitize_lshape(b, np.zeros(shape))
            except ValueError:
                with pytest.raises(ValueError):
                    htt.sanitize_lshape(a, t)
            else:
                htt.sanitize_lshape(a, t)
    out = htt.zeros((3, 2))
    htt.sanitize_out(out, (3, 2), None, out.device)
    with pytest.raises(ValueError):
        htt.sanitize_out(out, (2, 3), None, out.device)
    with pytest.raises(ValueError):
        htt.sanitize_out(out, (3, 2), None, htt.gpu)
    with pytest.raises(TypeError):
        htt.sanitize_out(np.zeros((3, 2)), (3, 2), None, None)


def test_scalar_to_1d(port):
    a, b = htt.sanitation.scalar_to_1d(htt.array(5.0)), ht.sanitation.scalar_to_1d(ht.array(5.0))
    assert a.shape == b.shape == (1,) and a.split is None and a.item() == b.item()
    v = htt.arange(3)
    assert htt.sanitation.scalar_to_1d(v) is v


@pytest.mark.parametrize("split", [None, 0, 1])
def test_memory_copy_is_independent(port, split):
    data = np.arange(26, dtype=np.float32).reshape(13, 2)
    a = htt.array(data, split=split)
    c = htt.copy(a)
    assert (c.shape, c.split, c.dtype, c.padshape) == (a.shape, a.split, a.dtype, a.padshape)
    c[0, 0] = 99
    assert a[0, 0].item() == 0 and c[0, 0].item() == 99
    np.testing.assert_array_equal(a.copy().numpy(), ht.array(data, split=split).copy().numpy())
    with pytest.raises(TypeError):
        htt.copy(data)
    for order in ("C", "F"):
        assert htt.sanitize_memory_layout(a, order) is a
    with pytest.raises(ValueError):
        htt.sanitize_memory_layout(a, "K")
