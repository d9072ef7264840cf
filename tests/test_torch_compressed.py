"""The port's compressed collectives held against the JAX package.

Same numpy inputs through ``heat_tpu.comm.compressed`` and
``heat_tpu_torch.comm.compressed``:

* ``quantize_blocks`` / ``dequantize_blocks`` must be BITWISE equal, at
  ``rows=32`` (the reference's Pallas kernel, interpret mode on the CPU)
  and ``rows=3`` (its jnp formulation), on random rows and on the special
  blocks: all-zero, NaN, +-Inf, the 1e36 saturation block, all-subnormal,
  and absmax in ``[FLT_MIN, 127*FLT_MIN)`` whose scale flushes to zero.
  The reference runs with subnormals flushed; the port reproduces that
  explicitly, and these cases pin it.  The same blocks, in the incoming
  payload and in the addend, pin the ring hop's one-launch form
  ``dequantize_add_quantize_blocks`` to the composition it replaces.
* ``ring_allreduce_q``, ``allreduce_q`` (with and without error feedback)
  and the all-gather must be BITWISE equal at 2, 4 and 8 positions: the
  same IEEE operations run in the same order.  Two facts about the
  reference make that hold only with the port's choices: its compiled
  programs scale by float32(1/127) rather than dividing by 127, and they
  contract each decode with the addition after it into one fused
  multiply-add.
* ``reduce_q`` / ``moments_q`` are held to the documented
  ``p * sum(absmax) / 254`` bound instead, because their local partial
  sums run in another order.

On the CPU the port's wrappers take the plain PyTorch versions of the
kernels; the kernels themselves are compared with those on the card
(``tests/test_torch_card.py`` and ``chip_smoke.py``).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec

import heat_tpu as ht
from heat_tpu.comm import compressed as jcq
from heat_tpu.core._jax_compat import shard_map
from heat_tpu.core.communication import XlaCommunication
from test_torch_reference_state import reference_state  # noqa: F401,E402  (restores the JAX package's state)

import torch

import heat_tpu_torch as htt
from heat_tpu_torch.comm import compressed as tcq
from heat_tpu_torch.core import communication as tcomm

FLT_MIN = np.finfo(np.float32).tiny
BLOCK = 128


def _bits(a) -> np.ndarray:
    """float32 array as its bit patterns (NaN payloads and signed zeros
    compare exactly)."""
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32)).view(np.uint32)


def _special_row(kind: str, rng) -> np.ndarray:
    row = rng.normal(size=BLOCK).astype(np.float32)
    if kind == "zero":
        return np.zeros(BLOCK, np.float32)
    if kind == "nan":
        row[5] = np.nan
    elif kind == "pinf":
        row[7] = np.inf
    elif kind == "ninf":
        row[9] = -np.inf
    elif kind == "nan_and_inf":
        row[3], row[4] = np.inf, np.nan
    elif kind == "saturate_1e36":
        row = (row * np.float32(1e36)).astype(np.float32)
    elif kind == "all_subnormal":
        row = (rng.uniform(-0.99, 0.99, size=BLOCK) * FLT_MIN).astype(np.float32)
    elif kind in ("absmax_1e-37", "absmax_1e-36", "absmax_below_127_flt_min"):
        amax = {"absmax_1e-37": 1e-37, "absmax_1e-36": 1e-36,
                "absmax_below_127_flt_min": 127 * FLT_MIN * 0.9999}[kind]
        row = (row / np.abs(row).max() * np.float32(amax)).astype(np.float32)
        row[10], row[11] = 0.0, np.float32(0.5 * FLT_MIN)
    elif kind == "normal_with_subnormals":
        row = (row / np.abs(row).max() * np.float32(200 * FLT_MIN)).astype(np.float32)
        row[:8] = (np.arange(8) * 0.12 * FLT_MIN).astype(np.float32)
    elif kind == "half_ties":
        row = np.zeros(BLOCK, np.float32)
        row[:6] = [127.0, 2.5, -3.5, 0.5, -0.5, 126.5]
    elif kind == "near_float_max":
        row = (row / np.abs(row).max() * np.float32(3e38)).astype(np.float32)
    return row


SPECIAL = [
    "zero", "nan", "pinf", "ninf", "nan_and_inf", "saturate_1e36", "all_subnormal",
    "absmax_1e-37", "absmax_1e-36", "absmax_below_127_flt_min",
    "normal_with_subnormals", "half_ties", "near_float_max",
]


def _payload(rows: int, kind, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, BLOCK)).astype(np.float32)
    if kind is not None:
        x[1 % rows] = _special_row(kind, rng)
    return x.reshape(-1)


#: The reference's quantization as its collectives run it: compiled.  (An
#: eager call on its jnp path divides by 127 exactly instead of scaling by
#: the float32 reciprocal; see test_reference_eager_path_differs_by_one_ulp.)
_jax_quantize = jax.jit(jcq.quantize_blocks)
_jax_dequantize = jax.jit(jcq.dequantize_blocks)


def _both_quantize(flat: np.ndarray):
    qj, sj = _jax_quantize(jnp.asarray(flat))
    dj = _jax_dequantize(qj, sj)
    qt, st = tcq.quantize_blocks(torch.from_numpy(flat.copy()))
    dt = tcq.dequantize_blocks(qt, st)
    return (np.asarray(qj), np.asarray(sj), np.asarray(dj)), (qt.numpy(), st.numpy(), dt.numpy())


# --------------------------------------------------------------------- #
# quantize / dequantize: bitwise                                         #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("rows", [1, 3, 32, 33, 64])
def test_quantize_random_rows_bitwise(rows):
    """rows 32 and 64 take the reference's Pallas kernel, the others its
    jnp formulation: both must equal the port bit for bit."""
    (qj, sj, dj), (qt, st, dt) = _both_quantize(_payload(rows, None, seed=rows))
    assert qt.dtype == np.int8 and qt.shape == (rows, BLOCK) and st.shape == (rows, 1)
    np.testing.assert_array_equal(qt, qj)
    np.testing.assert_array_equal(_bits(st), _bits(sj))
    np.testing.assert_array_equal(_bits(dt), _bits(dj))


@pytest.mark.parametrize("form", ["quantize", "hop"])
@pytest.mark.parametrize("rows", [3, 32])
@pytest.mark.parametrize("kind", SPECIAL)
def test_quantize_special_blocks_bitwise(kind, rows, form):
    """Zero, non-finite, saturating, subnormal and flushed-scale blocks:
    q, scale and the decoded values bitwise equal to the reference.
    ``hop``: with the block kind in both the incoming payload and the
    addend, the one-launch hop equals ``quantize(dequantize_fma(...))``
    of the plain versions bit for bit, and its quantize equals the
    reference's on the same decoded sum."""
    if form == "quantize":
        (qj, sj, dj), (qt, st, dt) = _both_quantize(_payload(rows, kind, seed=11))
        np.testing.assert_array_equal(qt, qj)
        np.testing.assert_array_equal(_bits(st), _bits(sj))
        np.testing.assert_array_equal(_bits(dt), _bits(dj))
        return
    q, s = tcq.quantize_blocks(torch.from_numpy(_payload(rows, kind, seed=12)))
    addend = torch.from_numpy(_payload(rows, kind, seed=11))
    qt, st = tcq.dequantize_add_quantize_blocks(q, s, addend)
    total = tcq.dequantize_fma_blocks_plain(q, s, addend)
    qp, sp = tcq.quantize_blocks_plain(total.reshape(rows, BLOCK))
    assert qt.dtype == torch.int8 and qt.shape == (rows, BLOCK) and st.shape == (rows, 1)
    np.testing.assert_array_equal(qt.numpy(), qp.numpy())
    np.testing.assert_array_equal(_bits(st.numpy()), _bits(sp.numpy()))
    qj, sj = _jax_quantize(jnp.asarray(total.numpy()))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(_bits(st.numpy()), _bits(sj))


def test_reference_eager_path_differs_by_one_ulp():
    """A fact about the reference the port records: called eagerly with a
    row count off its Pallas grid, ``quantize_blocks`` divides by 127
    exactly, while every compiled program (its rings, its Pallas kernel)
    scales by float32(1/127).  The two scales differ by at most one ulp,
    and the port follows the compiled programs."""
    flat = _payload(3, None, seed=5)
    for seed in range(40):
        flat = _payload(3, None, seed=seed)
        _, sj = jcq.quantize_blocks(jnp.asarray(flat))
        _, st = tcq.quantize_blocks(torch.from_numpy(flat.copy()))
        diff = np.abs(_bits(st).astype(np.int64) - _bits(np.asarray(sj)).astype(np.int64))
        assert diff.max() <= 1
        if diff.max() == 1:
            return
    pytest.fail("expected one of 40 seeds to show the one-ulp scale difference")


def test_flushed_scale_rules_are_the_references():
    """The rules the Motivation of the port records, pinned on the port
    alone: an all-subnormal block is an all-zero block (scale 1, q 0); an
    absmax whose absmax/127 is subnormal gives scale 0, q = 127/-128 on
    nonzero values, 0 on zeros, and decodes to signed zeros."""
    sub = _special_row("all_subnormal", np.random.default_rng(1))
    q, s = tcq.quantize_blocks(torch.from_numpy(sub))
    assert float(s) == 1.0 and not q.any()
    row = np.zeros(BLOCK, np.float32)
    row[0], row[1] = 1e-37, -3e-38
    q, s = tcq.quantize_blocks(torch.from_numpy(row))
    assert float(s) == 0.0
    assert q[0, :3].tolist() == [127, -128, 0]
    back = tcq.dequantize_blocks(q, s).numpy()
    assert not back.any() and np.signbit(back[1]) and not np.signbit(back[0])


@pytest.mark.parametrize("negate", [False, True])
@pytest.mark.parametrize("tiny", [2.0**-70, -(2.0**-70)])
def test_fused_decode_rounds_once(negate, tiny):
    """The fused decode: ``c +- q*s`` with ONE rounding, as the
    reference's compiled ring contracts it.  q*s = 3*(1 + 2^-23) lies
    exactly halfway between two float32 values and c nudges it off the
    tie by far less than a float64 ulp, the case a float64 sum rounded to
    float32 gets wrong.  Held against the reference's jitted ``q*s + c``
    and against the exact answer."""
    q = np.zeros((1, BLOCK), np.int8)
    q[0, 0] = 3
    s = np.full((1, 1), np.float32(1 + 2.0**-23), np.float32)
    c = np.zeros(BLOCK, np.float32)
    c[0] = np.float32(tiny)
    sign = -1.0 if negate else 1.0
    want = jax.jit(lambda q, s, c: c + sign * (q.astype(jnp.float32) * s).reshape(-1))(q, s, c)
    got = tcq.dequantize_fma_blocks(
        torch.from_numpy(q), torch.from_numpy(s), torch.from_numpy(c), negate=negate
    )
    # 3s = 3 + 1.5 ulp; c decides which neighbour of the tie is nearer
    away = (tiny > 0) != negate
    exact = sign * np.float32(3 + (2.0**-21 if away else 2.0**-22))
    assert got[0].item() == exact
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(np.asarray(want)))


def test_wrapper_raises_on_unsupported_device_and_shape():
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tcq.quantize_blocks(torch.zeros(BLOCK, device="meta"))
    with pytest.raises(ValueError, match="multiple of block"):
        tcq.quantize_blocks(torch.zeros(BLOCK + 1))
    with pytest.raises(ValueError, match="float32"):
        tcq.quantize_blocks(torch.zeros(BLOCK, dtype=torch.float64))
    with pytest.raises(ValueError, match="int8"):
        tcq.dequantize_blocks(torch.zeros((1, BLOCK)), torch.ones((1, 1)))
    q, s = torch.zeros((1, BLOCK), dtype=torch.int8), torch.ones((1, 1))
    with pytest.raises(ValueError, match="addend"):
        tcq.dequantize_fma_blocks(q, s, torch.zeros(BLOCK - 1))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tcq.dequantize_fma_blocks(q.to("meta"), s.to("meta"), torch.zeros(BLOCK, device="meta"))


_Q, _S, _A = torch.zeros((2, BLOCK), dtype=torch.int8), torch.ones((2, 1)), torch.zeros(2 * BLOCK)


@pytest.mark.parametrize("args, match", [
    ((_Q.float(), _S, _A), "int8"),
    ((_Q, _S.double(), _A), "int8"),
    ((_Q.reshape(-1), _S, _A), "int8"),
    ((_Q, torch.ones((2,)), _A), "int8"),
    ((_Q, torch.ones((3, 1)), _A), "int8"),
    ((_Q, _S, _A.double()), "addend"),
    ((_Q, _S, _A[:-1]), "addend"),
    ((_Q, _S, torch.zeros(2 * 64)), "addend"),
    ((_Q.to("meta"), _S.to("meta"), _A.to("meta")), "CUDA or CPU"),
    ((_Q, _S, _A.to("meta")), "CUDA or CPU"),
    ((_Q, _S.to("meta"), _A), "CUDA or CPU"),
], ids=["q_float", "scales_double", "q_flat", "scales_1d", "scales_rows", "addend_double",
        "addend_short", "addend_block_64", "meta", "addend_meta", "scales_meta"])
def test_hop_wrapper_rejects(args, match):
    """The one-launch hop checks dtypes, shapes and devices like its
    neighbours (a block other than 128 is refused on the card:
    ``tests/test_torch_card.py``)."""
    with pytest.raises(ValueError, match=match):
        tcq.dequantize_add_quantize_blocks(*args)


# --------------------------------------------------------------------- #
# rings: bitwise at 2, 4, 8 positions                                    #
# --------------------------------------------------------------------- #
def _sub_comm(p):
    devs = jax.devices()
    if len(devs) < p:
        pytest.skip(f"needs {p} JAX devices")
    return XlaCommunication(devs[:p])


def _jax_ring(stacked: np.ndarray, p: int, mode: str) -> np.ndarray:
    comm = _sub_comm(p)
    name = comm.axis_name

    def body(b):
        return jcq.ring_allreduce_q(jnp.squeeze(b, 0), name, size=p, mode=mode)

    fn = jax.jit(shard_map(body, mesh=comm.mesh, in_specs=PartitionSpec(name),
                           out_specs=PartitionSpec(), check_vma=False))
    return np.asarray(fn(jnp.asarray(stacked)))


SHAPES = [(37, 5), (1000,), (3,), (64, 33)]


@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("mode", ["int8_block", "bf16"])
def test_ring_allreduce_q_bitwise(p, shape, mode):
    stacked = np.random.default_rng(p).normal(size=(p,) + shape).astype(np.float32) * 3.0
    want = _jax_ring(stacked, p, mode)
    got = tcq.ring_allreduce_q(torch.from_numpy(stacked), size=p, mode=mode).numpy()
    assert got.shape == shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("with_error", [False, True])
def test_allreduce_q_bitwise(p, with_error):
    rng = np.random.default_rng(100 + p)
    stacked = rng.normal(size=(p, 300)).astype(np.float32)
    comm_j = _sub_comm(p)
    comm_t = htt.TorchCommunication(["cpu"] * p)
    if not with_error:
        want = np.asarray(jcq.allreduce_q(jnp.asarray(stacked), comm=comm_j, precision="int8_block"))
        got = tcq.allreduce_q(torch.from_numpy(stacked), comm=comm_t, precision="int8_block").numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want))
        return
    err = (rng.normal(size=(p, 300)) * 1e-2).astype(np.float32)
    rj, ej = jcq.allreduce_q(jnp.asarray(stacked), comm=comm_j, precision="int8_block",
                             error=jnp.asarray(err))
    rt, et = tcq.allreduce_q(torch.from_numpy(stacked), comm=comm_t, precision="int8_block",
                             error=torch.from_numpy(err))
    np.testing.assert_array_equal(_bits(rt.numpy()), _bits(rj))
    np.testing.assert_array_equal(_bits(et.numpy()), _bits(ej))


@pytest.mark.parametrize("p", [2, 4, 8])
def test_comm_allreduce_policy_seam_bitwise(p):
    """No call-site change: the communicator's allreduce under the
    int8_block policy is the quantized ring, bitwise the reference's."""
    stacked = np.random.default_rng(7 * p).normal(size=(p, 4096)).astype(np.float32)
    comm_t = htt.TorchCommunication(["cpu"] * p)
    with jcq.collective_precision("int8_block"):
        want = np.asarray(_sub_comm(p).allreduce(jnp.asarray(stacked), "sum"))
    with tcq.collective_precision("int8_block"):
        got = comm_t.allreduce(torch.from_numpy(stacked), "sum").numpy()
    exact = comm_t.allreduce(torch.from_numpy(stacked), "sum").numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert np.any(got != exact)  # the policy did compress


@pytest.mark.parametrize("p", [2, 4, 8])
def test_allgather_q_bitwise(p):
    data = np.random.default_rng(p).normal(size=(p * 6, 9)).astype(np.float32)
    comm_j = _sub_comm(p)
    want = np.asarray(jcq.allgather_q(comm_j.apply_sharding(jnp.asarray(data), 0), axis=0,
                                      comm=comm_j, precision="int8_block"))
    got = tcq.allgather_q(torch.from_numpy(data), axis=0, comm=htt.TorchCommunication(["cpu"] * p),
                          precision="int8_block").numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


# --------------------------------------------------------------------- #
# reductions under the policy: within the documented bound               #
# --------------------------------------------------------------------- #
def _bound(stacked: np.ndarray, p: int) -> float:
    return max(p * float(np.sum(np.max(np.abs(stacked.reshape(p, -1)), axis=1))) / 254.0, 1e-6)


@pytest.mark.parametrize("n", [64, 61, 103])
def test_sum_mean_reduce_q_within_bound(n):
    """``sum``/``mean`` over the split axis ride reduce_q; held to the
    ring bound of the per-position partial sums (the partials run in
    another order than the reference's, so bitwise is not expected)."""
    p = len(jax.devices())
    data = (np.random.default_rng(n).normal(size=(n, 7)) * 2.0 + 5.0).astype(np.float32)
    comm_t = htt.TorchCommunication(["cpu"] * p)
    xt = htt.array(data, split=0, comm=comm_t)
    xj = ht.array(data, split=0)
    parts = np.stack([data[sl].sum(axis=0) for sl in
                      (comm_t.chunk(data.shape, 0, r)[2][0] for r in range(p))])
    bound = _bound(parts, p)
    with jcq.collective_precision("int8_block"), tcq.collective_precision("int8_block"):
        sj, st = np.asarray(ht.sum(xj, axis=0).numpy()), htt.sum(xt, axis=0).numpy()
        mj, mt = np.asarray(ht.mean(xj, axis=0).numpy()), htt.mean(xt, axis=0).numpy()
    exact = data.astype(np.float64).sum(axis=0)
    assert np.max(np.abs(st - exact)) <= bound
    assert np.max(np.abs(st - sj)) <= 2 * bound
    assert np.max(np.abs(mt - exact / n)) <= bound / n
    assert np.max(np.abs(mt - mj)) <= 2 * bound / n


@pytest.mark.parametrize("kind", ["var", "std"])
def test_moments_q_within_reference_gate(kind):
    """var/std on non-centered data ride moments_q (centered second
    moments on the wire).  Gate: the reference's own, relative error
    under 5 % against the exact value, for both packages."""
    data = (np.random.default_rng(3).normal(size=(64, 7)) * 0.5 + 100.0).astype(np.float32)
    xt = htt.array(data, split=0, comm=htt.TorchCommunication(["cpu"] * len(jax.devices())))
    xj = ht.array(data, split=0)
    exact = getattr(np, kind)(data.astype(np.float64), axis=0)
    with jcq.collective_precision("int8_block"), tcq.collective_precision("int8_block"):
        got_t = getattr(htt, kind)(xt, axis=0).numpy()
        got_j = np.asarray(getattr(ht, kind)(xj, axis=0).numpy())
    assert np.max(np.abs(got_t - exact) / exact) < 0.05
    assert np.max(np.abs(got_j - exact) / exact) < 0.05


# --------------------------------------------------------------------- #
# policy                                                                 #
# --------------------------------------------------------------------- #
def test_policy_validation():
    with pytest.raises(ValueError, match="unknown collective precision"):
        tcq.set_collective_precision("int4")
    with pytest.raises(ValueError, match="non-negative"):
        tcq.set_collective_threshold(-1)
    assert tcq.get_collective_precision() == "f32"


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float64, torch.bool])
def test_explicit_compression_of_exact_dtype_raises(dtype):
    with pytest.raises(TypeError, match="SPMD203"):
        tcq.reduce_mode(dtype, 1 << 20, "int8_block")
    with tcq.collective_precision("int8_block"):
        assert tcq.reduce_mode(dtype, 1 << 20) is None


def test_auto_mode_thresholds_on_payload_bytes():
    prev = tcq.get_collective_threshold()
    try:
        tcq.set_collective_threshold(1 << 10)
        with tcq.collective_precision("auto"):
            assert tcq.reduce_mode(torch.float32, 1 << 10) == "int8_block"
            assert tcq.reduce_mode(torch.float32, (1 << 10) - 1) is None
    finally:
        tcq.set_collective_threshold(prev)


@pytest.mark.parametrize("p", [1, 2, 8])
@pytest.mark.parametrize("n", [1, 100, 4096])
def test_wire_model_matches_reference(p, n):
    for mode in (None, "bf16", "int8_block"):
        for op in ("allreduce", "allgather"):
            assert tcq.wire_model(n, p, mode, op=op) == jcq.wire_model(n, p, mode, op=op)


def test_positions_on_several_devices_raise():
    with pytest.raises(NotImplementedError, match="several devices"):
        tcomm.TorchCommunication(["cpu", "meta"])
