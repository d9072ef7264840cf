"""The port's file IO held against the JAX package's.

The same numpy arrays go through ``heat_tpu`` (8 CPU devices) and
``heat_tpu_torch`` (8 CPU positions), and each file is read by the other
package:

* HDF5, NetCDF-3 and CSV saves and loads, at ``split`` None, 0 and 1 and
  at ragged lengths, bitwise in both directions, with the extension
  dispatch of ``load``/``save`` and its errors;
* the missing-member error texts (``_named_member``) equal;
* the native CSV scanner's parses bitwise the reference's (float64), its
  library built under ``build/native`` of the checkout, never beside the
  sources;
* a seeded ``io_error`` at the open healed under the retry policy with
  the reference's incident sites, and a preemption between slab writes
  leaving the previous file byte-identical, at the reference's
  opportunity;
* the ``io:read``/``io:h2d`` byte ledger equal to the reference's;
* the bundled datasets equal to the reference's.

Every comparison is exact.
"""

import os

import numpy as np
import pytest

import jax

import heat_tpu as ht
from heat_tpu import native as rnative
from heat_tpu import telemetry as rtel
from heat_tpu.resilience import faults as rfaults
from heat_tpu.resilience import incidents as rincidents
from heat_tpu.resilience import retry as rretry
from test_torch_reference_state import reference_state  # noqa: F401,E402  (restores the JAX package's state)

import heat_tpu_torch as htt
from heat_tpu_torch import native
from heat_tpu_torch import telemetry as tel
from heat_tpu_torch.core import communication as tcomm
from heat_tpu_torch.resilience import faults, incidents, retry
from heat_tpu_torch.resilience.faults import Preempted

RNG = np.random.default_rng(12)


@pytest.fixture(autouse=True)
def port():
    """The port's default communicator: as many CPU positions as the
    reference has devices; no plan armed, no sleeping retries, telemetry
    off and empty incident logs in both packages."""
    comm = htt.TorchCommunication(["cpu"] * len(jax.devices()))
    prev = tcomm._default_comm
    htt.use_comm(comm)

    def scrub():
        for f, i, r, t in ((faults, incidents, retry, tel), (rfaults, rincidents, rretry, rtel)):
            f.clear()
            i.clear_incident_log()
            r.set_sleep(None)
            t.disable()
            t.reset()

    scrub()
    yield comm
    scrub()
    htt.use_comm(prev)


def _same(mine, ref):
    mine, ref = np.asarray(mine), np.asarray(ref)
    assert mine.dtype == ref.dtype and mine.shape == ref.shape
    np.testing.assert_array_equal(mine.view(np.uint8), ref.view(np.uint8))


def _data(shape, dtype):
    x = RNG.normal(size=shape) * 100
    return x.astype(dtype)


CASES = [((17, 5), np.float32, 0), ((16, 3), np.float64, 1), ((9,), np.int32, 0), ((7, 4), np.float32, None)]


@pytest.mark.parametrize("fmt", ["h5", "nc"])
@pytest.mark.parametrize("shape,dtype,split", CASES)
def test_files_cross_between_packages_bitwise(tmp_path, port, fmt, shape, dtype, split):
    x = _data(shape, dtype)
    name = "data"
    hdt, rdt = getattr(htt.types, np.dtype(dtype).name), getattr(ht.types, np.dtype(dtype).name)
    mine, ref = str(tmp_path / f"mine.{fmt}"), str(tmp_path / f"ref.{fmt}")
    htt.save(htt.array(x, split=split), mine, name)
    ht.save(ht.array(x, split=split), ref, name)
    for path in (mine, ref):
        got = htt.load(path, name, dtype=hdt, split=split)
        assert got.split == split and got.comm is port
        _same(got.numpy(), x)
        _same(np.asarray(ht.load(path, name, dtype=rdt, split=split).larray), x)


@pytest.mark.parametrize("split", [None, 0])
def test_csv_crosses_between_packages_bitwise(tmp_path, split):
    x = _data((23, 4), np.float32)
    mine, ref = str(tmp_path / "mine.csv"), str(tmp_path / "ref.csv")
    htt.save_csv(htt.array(x, split=split), mine, header_lines="a,b,c,d")
    ht.save_csv(ht.array(x, split=split), ref, header_lines="a,b,c,d")
    assert open(mine).read() == open(ref).read()
    for path in (mine, ref):
        _same(htt.load_csv(path, header_lines=1, split=split).numpy(), x)
        _same(np.asarray(ht.load_csv(path, header_lines=1, split=split).larray), x)
    fixed = str(tmp_path / "fixed.txt")
    htt.save(htt.array(x), fixed, decimals=3)
    ht.save(ht.array(x), str(tmp_path / "rfixed.txt"), decimals=3)
    assert open(fixed).read() == open(str(tmp_path / "rfixed.txt")).read()
    _same(htt.load(fixed).numpy(), np.asarray(ht.load(fixed).larray))


def test_ragged_sharded_load_pads_each_position(tmp_path, port):
    x = _data((13, 3), np.float32)
    path = str(tmp_path / "r.h5")
    ht.save_hdf5(ht.array(x), path, "x")
    got = htt.load_hdf5(path, "x", split=0)
    assert got.padshape == (16, 3) and not got._buffer[13:].any()
    assert got.lshape_map.tolist() == ht.load_hdf5(path, "x", split=0).lshape_map.tolist()


@pytest.mark.parametrize("loader,kind,ext", [("load_hdf5", "dataset", "h5"), ("load_netcdf", "variable", "nc")])
def test_missing_member_error_texts_equal(tmp_path, loader, kind, ext):
    path = str(tmp_path / f"m.{ext}")
    ht.save(ht.array(np.ones((3, 2), np.float32)), path, "present")
    errors = []
    for pkg in (ht, htt):
        with pytest.raises(ValueError) as e:
            getattr(pkg, loader)(path, "absent")
        errors.append(str(e.value))
    assert errors[0] == errors[1] == f"{path}: no {kind} named 'absent' (available: present)"


def test_dispatch_errors_equal(tmp_path):
    for pkg in (ht, htt):
        with pytest.raises(ValueError, match="Unsupported file extension .xyz"):
            pkg.load(str(tmp_path / "a.xyz"))
        with pytest.raises(ValueError, match="Unsupported file extension .xyz"):
            pkg.save(pkg.array([1.0]), str(tmp_path / "a.xyz"))
        with pytest.raises(TypeError):
            pkg.load(3)
        with pytest.raises(TypeError, match="NetCDF-3"):
            pkg.save_netcdf(pkg.array(np.ones(3, np.int64)), str(tmp_path / "i.nc"), "v")
        with pytest.raises(ValueError, match="1-D and 2-D"):
            pkg.save_csv(pkg.array(np.ones((2, 2, 2))), str(tmp_path / "c.csv"))


CSV_FORMS = [
    ("sci.csv", "1e-3;-2.5;+4\n0.5;nan;3\n", ";", 0),
    ("col.csv", "1\n2\n3\n", ",", 0),
    ("row.csv", "1,2,3\n", ",", 0),
    ("noeol.csv", "1,2\n3,4", ",", 0),
    ("blank.csv", "1,2\n\n3,4\n", ",", 0),
    ("head.csv", "x,y\n0.1,0.2\n0.30000000000000004,1e300\n", ",", 1),
    ("gaps.csv", "1,,3\n4,5,\n", ",", 0),
    ("ragged.csv", "1,2\n3\n", ",", 0),
]


@pytest.mark.parametrize("name,text,sep,head", CSV_FORMS, ids=[c[0] for c in CSV_FORMS])
def test_native_scanner_parses_bitwise_the_reference(tmp_path, name, text, sep, head):
    path = tmp_path / name
    path.write_text(text)
    mine = native.fastcsv_parse(str(path), header_lines=head, sep=sep)
    ref = rnative.fastcsv_parse(str(path), header_lines=head, sep=sep)
    if ref is None:
        # refused by the scanner: numpy parses, and rejects ragged rows
        assert mine is None
        for pkg in (htt, ht):
            with pytest.raises(ValueError, match="got 1 columns instead of 2"):
                pkg.load_csv(str(path), header_lines=head, sep=sep)
        return
    _same(mine, ref)
    _same(htt.load_csv(str(path), header_lines=head, sep=sep, dtype=htt.float64).numpy(),
          np.asarray(ht.load_csv(str(path), header_lines=head, sep=sep, dtype=ht.float64).larray))


def test_native_scanner_builds_under_build_native():
    assert native.fastcsv_available()
    lib = native._target()
    root = os.path.dirname(os.path.dirname(os.path.abspath(htt.__file__)))
    assert lib.exists() and lib.parent == native.BUILD_DIR
    assert str(lib).startswith(os.path.join(root, "build", "native"))
    assert not list((native._SRC.parent).glob("*.so"))


def test_large_csv_with_many_threads_bitwise(tmp_path):
    x = _data((3000, 9), np.float64)
    path = str(tmp_path / "big.csv")
    np.savetxt(path, x, delimiter=",", header="h", comments="")
    _same(native.fastcsv_parse(path, header_lines=1, nthreads=7), rnative.fastcsv_parse(path, header_lines=1))


@pytest.mark.parametrize("loader,ext", [("load_hdf5", "h5"), ("load_netcdf", "nc")])
def test_io_error_at_open_heals_with_the_reference_incidents(tmp_path, loader, ext):
    path = str(tmp_path / f"f.{ext}")
    x = _data((8, 3), np.float32)
    ht.save(ht.array(x), path, "x")
    logs = []
    for pkg, f, r, i in ((htt, faults, retry, incidents), (ht, rfaults, rretry, rincidents)):
        r.set_sleep(lambda s: None)
        with f.inject("io_error", nth=1, max_faults=1, seed=4):
            got = getattr(pkg, loader)(path, "x")
        _same(np.asarray(got.larray) if pkg is ht else got.numpy(), x)
        logs.append([(e.kind, e.site, e.action) for e in i.incident_log()])
    assert logs[0] == logs[1] and logs[0]


@pytest.mark.parametrize("nth", [1, 3])
def test_preempted_save_keeps_the_previous_file(tmp_path, nth):
    """A kill between two slab writes leaves the previous file
    byte-identical and no temporary behind, at the same opportunity in
    both packages."""
    old = _data((16, 2), np.float32)
    new = _data((16, 2), np.float32)
    for pkg, f in ((htt, faults), (ht, rfaults)):
        path = str(tmp_path / f"{pkg.__name__}.h5")
        pkg.save_hdf5(pkg.array(old), path, "x")
        before = open(path, "rb").read()
        with pytest.raises((Preempted, rfaults.Preempted)):
            with f.inject("preempt", site="save-slab", nth=nth):
                pkg.save_hdf5(pkg.array(new, split=0), path, "x")
        assert open(path, "rb").read() == before
        assert sorted(os.listdir(tmp_path)) == sorted(p for p in os.listdir(tmp_path) if ".tmp-" not in p)
    # one opportunity a position's slab: the 8th fires, a 9th never comes
    p = len(jax.devices())
    for pkg, f in ((htt, faults), (ht, rfaults)):
        with pytest.raises((Preempted, rfaults.Preempted)):
            with f.inject("preempt", site="save-slab", nth=p):
                pkg.save_hdf5(pkg.array(new, split=0), str(tmp_path / "last.h5"), "x")
        with f.inject("preempt", site="save-slab", nth=p + 1):
            pkg.save_hdf5(pkg.array(new, split=0), str(tmp_path / "ok.h5"), "x")


def test_load_credits_the_reference_byte_ledger(tmp_path):
    path = str(tmp_path / "t.h5")
    x = _data((32, 6), np.float32)
    ht.save_hdf5(ht.array(x), path, "x")
    counters = []
    for pkg, t in ((htt, tel), (ht, rtel)):
        t.enable()
        t.reset()
        pkg.load(path, "x", split=0)
        snap = t.snapshot()
        t.disable()
        counters.append({k: v for k, v in snap["counters"].items() if k.endswith((".read", ".h2d")) or k == "io.loads"})
        assert snap["spans"]["io:read"]["count"] >= 1 and snap["spans"]["io:h2d"]["count"] == 1
    assert counters[0] == counters[1] and counters[0]


def test_datasets_equal_the_reference():
    for a, b in zip(htt.datasets.load_iris_split(), ht.datasets.load_iris_split()):
        _same(a.numpy(), np.asarray(b.larray))
    _same(htt.datasets.load_iris(split=0).numpy(), np.asarray(ht.datasets.load_iris().larray))
    for a, b in zip(htt.datasets.load_diabetes(), ht.datasets.load_diabetes()):
        _same(a.numpy(), np.asarray(b.larray))
    assert htt.datasets.data_path("iris.csv") == ht.datasets.data_path("iris.csv")
