"""The port's attention slice held against the JAX package on the CPU.

The same numpy inputs (from a seed) go through ``heat_tpu.parallel`` and
``heat_tpu_torch.parallel``.  The JAX side runs as its own tests run it:
the Pallas kernels through the interpreter (``interpret=True`` or
``local_kernel="flash"``), on the 8-device CPU mesh of ``conftest.py``;
the port runs at as many positions, all on the CPU, where its kernel
wrappers take their plain versions.  Inputs are float32 or bfloat16 on
both sides (the JAX package turns on x64), compared in float32.

Tolerances, each with its reason:

* float32: 2e-5 against the JAX package and against float64 dense
  attention (the reference's own gate, ``test_flash_attention.py``);
* bfloat16/float16: 5e-2 (bf16 products and a bf16 ``p`` before PV);
* a chain of partial folds against the full kernel: 2e-6 (same algebra,
  same chunk order);
* trip counts, layouts and conformance: equal (integers and booleans).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import heat_tpu as ht
from heat_tpu.core.communication import XlaCommunication
from heat_tpu.parallel import flash_attention as jflash
from heat_tpu.parallel import flash_attention_partial as jpartial
from heat_tpu.parallel import primitives as jprim
from heat_tpu.parallel.flash_attention import _causal_chunk_bounds as jbounds
from heat_tpu.parallel.flash_attention import conforms as jconforms
from test_torch_reference_state import reference_state  # noqa: F401,E402  (restores the JAX package's state)

import torch

import heat_tpu_torch as htt
from heat_tpu_torch import interop
from heat_tpu_torch.core import communication as tcomm
from heat_tpu_torch.parallel import primitives as tprim
from heat_tpu_torch.parallel.flash_attention import (
    _causal_chunk_bounds as tbounds,
    conforms as tconforms,
    flash_attention as tflash,
    flash_attention_partial as tpartial,
    kernel_blocks,
)

F32, BF16 = 2e-5, 5e-2


@pytest.fixture
def p():
    """Positions of the port's communicator: the JAX package's device count."""
    return len(jax.devices())


@pytest.fixture
def port(p):
    """The port's default communicator: ``p`` positions on the CPU."""
    comm = htt.TorchCommunication(["cpu"] * p)
    prev = tcomm._default_comm
    htt.use_comm(comm)
    yield comm
    htt.use_comm(prev)


@pytest.fixture
def ref():
    return XlaCommunication(jax.devices())


def _inputs(shape, seed, n=3):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


def _dense(q, k, v, causal, q_base=0):
    """Dense float64 attention on (..., S, H, D)."""
    qt, kt, vt = (np.moveaxis(a, -2, -3).astype(np.float64) for a in (q, k, v))
    S, Sk = qt.shape[-2], kt.shape[-2]
    scores = qt @ np.swapaxes(kt, -1, -2) / np.sqrt(q.shape[-1])
    if causal:
        q_pos = q_base + np.arange(S)[:, None]
        scores = np.where(q_pos >= np.arange(Sk)[None, :], scores, -np.inf)
    w = np.exp(scores - scores.max(-1, keepdims=True))
    w /= w.sum(-1, keepdims=True)
    return np.moveaxis(w @ vt, -3, -2)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def _np(t):
    return t.float().numpy()


def _j(x, dtype=jnp.float32):
    return jnp.asarray(x, dtype)


# --------------------------------------------------------------------- #
# flash_attention / flash_attention_partial                               #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("batched", [False, True])
def test_flash_matches_reference(causal, batched):
    shape = (2, 256, 2, 32) if batched else (256, 2, 32)
    q, k, v = _inputs(shape, seed=1)
    got = _np(tflash(_t(q), _t(k), _t(v), causal=causal, block_q=128, block_k=128))
    want = np.asarray(jflash(_j(q), _j(k), _j(v), causal=causal, interpret=True,
                             block_q=128, block_k=128))
    np.testing.assert_allclose(got, want, atol=F32)
    np.testing.assert_allclose(got, _dense(q, k, v, causal), atol=F32)


@pytest.mark.parametrize("lo", [0, 128, 256, 384])
def test_flash_q_base_with_longer_kv(lo):
    q, k, v = _inputs((512, 2, 32), seed=2)
    kw = dict(causal=True, q_base=lo, block_q=128, block_k=128)
    got = _np(tflash(_t(q[lo:lo + 128]), _t(k), _t(v), **kw))
    want = np.asarray(jflash(_j(q[lo:lo + 128]), _j(k), _j(v), interpret=True, **kw))
    np.testing.assert_allclose(got, want, atol=F32)
    np.testing.assert_allclose(got, _dense(q, k, v, True)[lo:lo + 128], atol=F32)


def test_flash_bf16_matches_reference():
    q, k, v = _inputs((256, 2, 32), seed=3)
    got = tflash(_t(q, torch.bfloat16), _t(k, torch.bfloat16), _t(v, torch.bfloat16),
                 causal=True, block_q=128, block_k=128)
    want = jflash(_j(q, jnp.bfloat16), _j(k, jnp.bfloat16), _j(v, jnp.bfloat16),
                  causal=True, interpret=True, block_q=128, block_k=128)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), atol=BF16)
    np.testing.assert_allclose(_np(got), _dense(q, k, v, True), atol=BF16)


def test_flash_f16_close_to_dense():
    q, k, v = _inputs((256, 2, 32), seed=4)
    got = tflash(*(_t(x, torch.float16) for x in (q, k, v)), causal=True,
                 block_q=128, block_k=128)
    assert got.dtype == torch.float16
    np.testing.assert_allclose(_np(got), _dense(q, k, v, True), atol=BF16)


def test_flash_fallback_shapes_and_dtypes():
    # S=200 does not conform: both sides take the dense path, with q_base
    # and K/V longer than Q; float64 stays float64 (scale not rounded
    # through float32: D=48)
    q, k, v = _inputs((200, 2, 48), seed=5)
    got = _np(tflash(_t(q[120:]), _t(k), _t(v), causal=True, q_base=120))
    want = np.asarray(jflash(_j(q[120:]), _j(k), _j(v), causal=True, q_base=120))
    np.testing.assert_allclose(got, want, atol=F32)
    np.testing.assert_allclose(got, _dense(q, k, v, True)[120:], atol=F32)
    out64 = tflash(*(_t(x, torch.float64) for x in (q, k, v)))
    assert out64.dtype == torch.float64
    np.testing.assert_allclose(out64.numpy(), _dense(q, k, v, False), atol=1e-9)


@pytest.mark.parametrize("causal", [False, True])
def test_partial_chain_matches_full_and_reference(causal):
    BH, S, D = 4, 256, 32
    q, k, v = _inputs((BH, S, D), seed=6)
    full = _np(tflash(*(_t(np.moveaxis(x, 0, 1)) for x in (q, k, v)), causal=causal,
                      block_q=128, block_k=128)).transpose(1, 0, 2)
    m, l, acc = (torch.full((BH, S), -np.inf), torch.zeros(BH, S), torch.zeros(BH, S, D))
    jm, jl, jacc = (jnp.full((BH, S), -jnp.inf, jnp.float32), jnp.zeros((BH, S), jnp.float32),
                    jnp.zeros((BH, S, D), jnp.float32))
    seg = S // 2
    for r in range(2):
        ks, vs = k[:, r * seg:(r + 1) * seg], v[:, r * seg:(r + 1) * seg]
        m, l, acc = tpartial(_t(q), _t(ks), _t(vs), m, l, acc, q_base=0, k_base=r * seg,
                             causal=causal, block_q=128, block_k=128)
        jm, jl, jacc = jpartial(_j(q), _j(ks), _j(vs), jm, jl, jacc, q_base=0, k_base=r * seg,
                                causal=causal, interpret=True, block_q=128, block_k=128)
        np.testing.assert_array_equal(np.isfinite(m.numpy()), np.isfinite(np.asarray(jm)))
        for a, b in ((m, jm), (l, jl), (acc, jacc)):
            fin = np.isfinite(np.asarray(b))
            np.testing.assert_allclose(a.numpy()[fin], np.asarray(b)[fin], rtol=F32, atol=F32)
    out = (acc / torch.clamp_min(l, 1e-30)[..., None]).numpy()
    np.testing.assert_allclose(out, full, atol=2e-6)


def test_partial_per_position_bases_equal_separate_calls():
    # one call with a base per position == one call per position; a q
    # block wholly before its segment leaves the state untouched
    P, per, L, D = 3, 2, 128, 16
    q, k, v = _inputs((P * per, L, D), seed=7)
    st = (torch.full((P * per, L), -np.inf), torch.zeros(P * per, L), torch.zeros(P * per, L, D))
    qb, kb = [0, 256, 128], [128, 0, 128]
    m, l, acc = tpartial(_t(q), _t(k), _t(v), *st, q_base=qb, k_base=kb, causal=True,
                         block_q=128, block_k=128)
    for i in range(P):
        sl = slice(i * per, (i + 1) * per)
        mi, li, ai = tpartial(_t(q[sl]), _t(k[sl]), _t(v[sl]), *(t[sl] for t in st),
                              q_base=qb[i], k_base=kb[i], causal=True, block_q=128, block_k=128)
        for a, b in ((m[sl], mi), (l[sl], li), (acc[sl], ai)):
            assert torch.equal(a, b)
    # position 0: q rows [0, 128) before keys [128, 256): untouched
    assert torch.equal(m[:per], st[0][:per]) and torch.equal(acc[:per], st[2][:per])


# --------------------------------------------------------------------- #
# the plain versions at the CUDA kernel's tiles (kernel_blocks)           #
# --------------------------------------------------------------------- #
_TDT = {"float32": (torch.float32, jnp.float32, F32), "bfloat16": (torch.bfloat16, jnp.bfloat16, BF16)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_at_kernel_tiles_matches_reference(dtype, causal):
    # S = 384 (three query tiles) and D = 40 (padded by the kernel)
    tdt, jdt, tol = _TDT[dtype]
    bq, bk = kernel_blocks(tdt)
    q, k, v = _inputs((384, 2, 40), seed=20)
    got = tflash(*(_t(x, tdt) for x in (q, k, v)), causal=causal, block_q=bq, block_k=bk)
    want = jflash(*(_j(x, jdt) for x in (q, k, v)), causal=causal, interpret=True,
                  block_q=bq, block_k=bk)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), atol=tol)
    np.testing.assert_allclose(_np(got), _dense(q, k, v, causal), atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lo", [64, 192])
def test_flash_at_kernel_tiles_q_base_mid_tile(dtype, lo):
    # the diagonal crosses the middle of a 128-row query tile
    tdt, jdt, tol = _TDT[dtype]
    bq, bk = kernel_blocks(tdt)
    q, k, v = _inputs((384, 2, 32), seed=21)
    kw = dict(causal=True, q_base=lo, block_q=bq, block_k=bk)
    got = tflash(_t(q[lo:lo + 128], tdt), _t(k, tdt), _t(v, tdt), **kw)
    want = jflash(_j(q[lo:lo + 128], jdt), _j(k, jdt), _j(v, jdt), interpret=True, **kw)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), atol=tol)
    np.testing.assert_allclose(_np(got), _dense(q, k, v, True)[lo:lo + 128], atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_partial_at_kernel_tiles_matches_reference(dtype):
    # four positions, one base pair each, from a running state; position 0's
    # queries lie wholly before its keys and keep the state
    tdt, jdt, tol = _TDT[dtype]
    P, per, L, D = 4, 2, 256, 24
    bq, bk = kernel_blocks(tdt)
    qb, kb = [0, 256, 64, 128], [256, 0, 0, 64]
    q, k, v = _inputs((P * per, L, D), seed=22)
    rng = np.random.default_rng(23)
    m0 = rng.normal(size=(P * per, L)).astype(np.float32)
    l0 = (np.abs(rng.normal(size=(P * per, L))) + 1).astype(np.float32)
    acc0 = rng.normal(size=(P * per, L, D)).astype(np.float32)
    m, l, acc = tpartial(_t(q, tdt), _t(k, tdt), _t(v, tdt), _t(m0), _t(l0), _t(acc0),
                         q_base=qb, k_base=kb, causal=True, block_q=bq, block_k=bk)
    for i in range(P):
        sl = slice(i * per, (i + 1) * per)
        jm, jl, jacc = jpartial(_j(q[sl], jdt), _j(k[sl], jdt), _j(v[sl], jdt), _j(m0[sl]),
                                _j(l0[sl]), _j(acc0[sl]), q_base=qb[i], k_base=kb[i],
                                causal=True, interpret=True, block_q=bq, block_k=bk)
        np.testing.assert_allclose(m[sl].numpy(), np.asarray(jm), rtol=F32, atol=F32)
        np.testing.assert_allclose(l[sl].numpy(), np.asarray(jl), rtol=F32, atol=F32)
        out = (acc[sl] / l[sl][..., None]).numpy()
        np.testing.assert_allclose(out, np.asarray(jacc) / np.asarray(jl)[..., None], atol=tol)
    assert torch.equal(m[:per], _t(m0[:per])) and torch.equal(acc[:per], _t(acc0[:per]))


_BOUNDS_CASES = [
    (0, 1024, 128, 128, 8), (512, 1024, 512, 128, 8), (1024, 0, 128, 128, 8),
    (256, 0, 128, 256, 4), (128, 0, 128, 128, 8), (10_000, 0, 128, 128, 4),
    (-300, 0, 128, 64, 8), (5, 7, 64, 64, 3),
] + [(qi * b, 0, b, b, n) for n, b in [(4, 128), (8, 512), (32, 256)] for qi in range(n)]


@pytest.mark.parametrize("args", _BOUNDS_CASES)
def test_causal_chunk_bounds_equal_reference(args):
    want = tuple(int(x) for x in jbounds(*args))
    assert tuple(int(x) for x in tbounds(*args)) == want
    # traced/tensor offsets give the same integers
    got = tbounds(torch.tensor(args[0]), torch.tensor(args[1]), *args[2:])
    assert tuple(int(x) for x in got) == want


@pytest.mark.parametrize("name,expect", [
    ("float32", True), ("bfloat16", True), ("float16", True), ("int32", False),
    ("int8", False), ("bool", False), ("float64", False),
])
def test_conforms_on_dtypes(name, expect):
    assert tconforms(256, 32, getattr(torch, name)) is expect
    assert bool(jconforms(256, 32, getattr(jnp, name if name != "bool" else "bool_"))) is expect
    # the port's own rule: a positive 128-multiple, D a multiple of 8 up to 128
    assert not tconforms(200, 32, torch.float32) and not tconforms(0, 32, torch.float32)
    assert not tconforms(256, 12, torch.float32) and not tconforms(256, 136, torch.float32)


# --------------------------------------------------------------------- #
# ring / Ulysses at p positions                                          #
# --------------------------------------------------------------------- #
_RING_CASES = [
    # (local_kernel, causal, S per position) -> engine
    ("flash", False, 128),   # contiguous flash fold
    ("flash", True, 256),    # zig-zag flash fold (Lh = 128)
    ("flash", True, 128),    # causal, Lh = 64 does not conform: contiguous flash
    ("xla", False, 8),       # contiguous XLA fold
    ("xla", True, 8),        # zig-zag XLA fold
    ("xla", True, 5),        # causal, odd L: contiguous XLA fold
    ("auto", True, None),    # S not divisible: single-block branch
]


@pytest.mark.parametrize("local_kernel,causal,per", _RING_CASES)
def test_ring_attention_matches_reference(port, ref, p, local_kernel, causal, per):
    S = p * per if per else p * 4 + 1
    q, k, v = _inputs((S, 2, 16), seed=8)
    got = _np(htt.parallel.ring_attention(_t(q), _t(k), _t(v), causal=causal, comm=port,
                                          local_kernel=local_kernel))
    js = [ref.apply_sharding(_j(x), 0) for x in (q, k, v)]
    want = np.asarray(ht.parallel.ring_attention(*js, causal=causal, comm=ref,
                                                 local_kernel=local_kernel))
    np.testing.assert_allclose(got, want, atol=F32)
    np.testing.assert_allclose(got, _dense(q, k, v, causal), atol=F32)


def test_ring_attention_batched_dndarray(port):
    q, k, v = _inputs((2, 128 * port.size, 2, 16), seed=9)
    qd, kd, vd = (htt.array(x, split=1) for x in (q, k, v))
    got = htt.parallel.ring_attention(qd, kd, vd, causal=False, local_kernel="flash")
    np.testing.assert_allclose(_np(got), _dense(q, k, v, False), atol=F32)


def test_zigzag_ring_bf16(port, ref, p):
    q, k, v = _inputs((256 * p, 2, 16), seed=10)
    got = htt.parallel.ring_attention(*(_t(x, torch.bfloat16) for x in (q, k, v)),
                                      causal=True, comm=port, local_kernel="flash")
    js = [ref.apply_sharding(_j(x, jnp.bfloat16), 0) for x in (q, k, v)]
    want = ht.parallel.ring_attention(*js, causal=True, comm=ref, local_kernel="flash")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), atol=BF16)
    np.testing.assert_allclose(_np(got), _dense(q, k, v, True), atol=BF16)


@pytest.mark.parametrize("local_kernel", ["flash", "xla"])
@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_reference(port, ref, p, local_kernel, causal):
    S, H, D = 128 * p, 2 * p, 16
    q, k, v = _inputs((S, H, D), seed=11)
    got = _np(htt.parallel.ulysses_attention(_t(q), _t(k), _t(v), causal=causal, comm=port,
                                             local_kernel=local_kernel))
    js = [ref.apply_sharding(_j(x), 0) for x in (q, k, v)]
    want = np.asarray(ht.parallel.ulysses_attention(*js, causal=causal, comm=ref,
                                                    local_kernel=local_kernel))
    np.testing.assert_allclose(got, want, atol=F32)
    np.testing.assert_allclose(got, _dense(q, k, v, causal), atol=F32)


def test_flash_engines_reject_nonconforming(port, p):
    # L = 25 is never a 128-multiple: 'flash' raises, 'auto' falls back
    q = _t(_inputs((25 * p, 2 * p, 8), seed=12, n=1)[0])
    for fn in (htt.parallel.ring_attention, htt.parallel.ulysses_attention):
        with pytest.raises(ValueError, match="conforming"):
            fn(q, q, q, comm=port, local_kernel="flash")
        assert torch.isfinite(fn(q, q, q, comm=port, local_kernel="auto")).all()
    # a sequence the positions do not divide: the single-block 'flash' raises
    odd = _t(_inputs((p * 4 + 1, 2, 8), seed=13, n=1)[0])
    with pytest.raises(ValueError, match="conforming"):
        htt.parallel.ring_attention(odd, odd, odd, comm=port, local_kernel="flash")
    with pytest.raises(ValueError, match="auto|flash|xla"):
        htt.parallel.ring_attention(q, q, q, comm=port, local_kernel="pallas")


def test_ring_self_attention_with_weights_through_interop(port, ref, p):
    rng = np.random.default_rng(14)
    S, E, D = 128 * p, 32, 16
    x = rng.normal(size=(S, E)).astype(np.float32)
    w = [jnp.asarray((rng.normal(size=(E, D)) / np.sqrt(E)).astype(np.float32)) for _ in range(3)]
    want = np.asarray(ht.parallel.ring_self_attention(
        ref.apply_sharding(_j(x), 0), *w, causal=True, comm=ref))
    xd = interop.array_from_numpy(x, split=0)
    wd = [interop.array_from_numpy(np.asarray(t)) for t in w]
    got = htt.parallel.ring_self_attention(xd, *wd, causal=True)
    np.testing.assert_allclose(_np(got), want, atol=F32)


def test_interop_carries_bf16_bits():
    a = jnp.asarray(np.random.default_rng(15).normal(size=(64, 3)), jnp.bfloat16)
    t = interop.tensor_from_numpy(np.asarray(a))
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(), np.asarray(a).view(np.int16))
    d = interop.array_from_numpy(np.asarray(a), split=0, comm=htt.TorchCommunication(["cpu"] * 2))
    assert d.dtype is htt.bfloat16 and torch.equal(d.larray.view(torch.int16), t.view(torch.int16))


# --------------------------------------------------------------------- #
# primitives                                                              #
# --------------------------------------------------------------------- #
def test_zigzag_split_merge_layout(p):
    L, S = 4, 4 * p
    x = torch.arange(S, dtype=torch.float32).reshape(p, L, 1)
    lo, hi = tprim.zigzag_split(x, 1, p)
    for i in range(p):
        assert lo[i, :, 0].tolist() == list(range(i * 2, i * 2 + 2))
        c = 2 * p - 1 - i
        assert hi[i, :, 0].tolist() == list(range(c * 2, c * 2 + 2))
    assert torch.equal(tprim.zigzag_merge(lo, hi, 1, p), x)
    assert tprim.zigzag_perms(p) == jprim.zigzag_perms(p)
    assert tprim.zigzag_inverse_perms(p) == jprim.zigzag_inverse_perms(p)
    assert [tprim.zigzag_chunk_owner(c, p) for c in range(2 * p)] == [
        jprim.zigzag_chunk_owner(c, p) for c in range(2 * p)
    ]


def _pair_sums(stationary, rotating, r):
    return stationary.sum(0) * 10 + rotating.sum(0) + r


@pytest.mark.parametrize("n", [8 * 3, 8 * 3 + 5])
def test_ring_map_matches_reference(port, ref, n):
    x = np.random.default_rng(16).normal(size=(n, 3)).astype(np.float32)
    got = tprim.ring_map(_pair_sums, _t(x), comm=port)
    want = jprim.ring_map(_pair_sums, ref.apply_sharding(_j(x), 0), comm=ref)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)
    assert [tprim.ring_source(i, r, port.size) for i in range(3) for r in range(3)] == [
        jprim.ring_source(i, r, port.size) for i in range(3) for r in range(3)
    ]


@pytest.mark.parametrize("n,halo", [(8 * 4, 2), (8 * 4 - 3, 3)])
def test_halo_exchange_matches_reference(port, ref, n, halo):
    x = np.random.default_rng(17).normal(size=(n, 2)).astype(np.float32)
    got = tprim.halo_exchange(_t(x), halo, comm=port)
    want = jprim.halo_exchange(ref.apply_sharding(_j(x), 0), halo, comm=ref)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError):
        tprim.halo_exchange(_t(x), n, comm=port)


@pytest.mark.parametrize("op,n", [("sum", 8 * 5), ("sum", 8 * 5 + 3), ("prod", 8 * 2 + 1)])
def test_prefix_scan_matches_reference(port, ref, op, n):
    x = np.random.default_rng(18).uniform(0.5, 1.5, size=(n, 2)).astype(np.float32)
    got = tprim.prefix_scan(_t(x), op, comm=port)
    want = jprim.prefix_scan(ref.apply_sharding(_j(x), 0), op, comm=ref)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_all_to_all_resplit_is_identity_on_the_global_tensor(port):
    x = _t(_inputs((16, 8 * 2, 4), seed=19, n=1)[0])
    assert torch.equal(tprim.all_to_all_resplit(x, 0, 1, comm=port), x)
    assert port.alltoall(x[:, :13], split_axis=1, concat_axis=0).shape == (16, 16, 4)
