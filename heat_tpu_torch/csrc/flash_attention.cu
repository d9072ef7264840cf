// Exact (flash) attention, forward only, for Hopper (sm_90a).
//
// One templated body replaces the two TPU kernels of
// heat_tpu/parallel/flash_attention.py: _kernel, launched by
// flash_attention (the full form: normalized output in the input dtype),
// and _kernel_partial, launched by flash_attention_partial (the partial
// form: the running softmax state (m, l, acc) comes in and goes out
// un-normalized; the ring attention folds one K/V segment per round with
// it).
//
// What it computes, per query row, over the key tiles it visits (the same
// algebra as the reference's _stream_kv):
//   s      = (q . k) * scale                 f32, scale = float32(1/sqrt(D))
//   s      = -inf where masked               (causal: q_pos < k_pos)
//   m_new  = max(m, rowmax(s));  safe_m = isfinite(m_new) ? m_new : 0
//   p      = exp(s - safe_m), 0 where masked
//   corr   = isfinite(m) ? exp(m - safe_m) : 0
//   acc    = acc * corr + T(p) . v           (p cast to the input dtype T)
//   l      = l * corr + rowsum(p)            (the f32 p)
// The full form starts at (-inf, 0, 0) and writes acc / max(l, 1e-30) in T.
//
// Causal.  Key tiles [0, full) fold without a mask, [full, total) with the
// q_pos >= k_pos mask, and tiles at or after total are never loaded, with
// (full, total) from the reference's _causal_chunk_bounds rule at this
// kernel's tile sizes.  A query tile wholly before its key segment
// (total == 0, the ring's fully masked rounds) leaves the state untouched.
//
// Shape of the kernel.  One block of three warpgroups (384 threads) per
// (bh, 128-row query tile); query tiles are launched longest first.
//   Warpgroup 0 produces: it gives registers back (setmaxnreg.dec) and one
//     of its threads issues every TMA load -- the query tile once, then the
//     K and V tiles through a ring of 2 or 3 shared-memory stages, each
//     with a "full" mbarrier (TMA bytes landed) and an "empty" one (both
//     consumers done with the stage).
//   Warpgroups 1 and 2 consume: each takes registers (setmaxnreg.inc) and
//     owns 64 query rows.  The row state (m, l) and acc stay in f32
//     registers in the wgmma accumulator layout (thread t of warp w holds
//     rows 16w + t/4 and 16w + t/4 + 8, columns 2(t%4) and 2(t%4)+1 of
//     each 8-column tile).
// The tiles sit in shared memory as TMA writes them: D padded to DP (32,
// 64 or 128) by TMA's zero fill, split into 128-byte column boxes (64
// bytes for a 16-bit DP = 32), each box swizzled.
//   bf16 / f16: S = Q K^T is wgmma m64n128k16 with both operands in shared
//     memory (K-major); p is cast to T in registers and is the register A
//     operand of O += P V, wgmma m64nDPk16, with V read from its (keys, D)
//     tile through wgmma's transpose flag.  128-row K/V tiles.  Products
//     of 8- or 11-bit mantissas are exact in the f32 accumulator.
//   f32: 3xTF32 on the tensor cores, mma.sync m16n8k8 -- each operand
//     split as a = a_hi + a_lo (TF32 parts, round to nearest), and
//     a.b = a_hi.b_hi + a_hi.b_lo + a_lo.b_hi in f32, the counterpart of
//     the reference's HIGHEST precision (a multi-pass float32 emulation on
//     the TPU's matrix unit).  mma.sync, not wgmma: TF32 wgmma needs both
//     operands K-major, and V is MN-major for PV.  64-row K/V tiles (a
//     128-row f32 stage at D = 128 would not fit twice).
// The full form writes O through shared memory with a TMA store.  The
// partial form's f32 state (acc) comes in by TMA right behind the first
// K/V tile, into the ring's last stage, and goes out the same way by a TMA
// store; m and l are one float a row.
// exp is the IEEE expf (no fast math); the file builds with --fmad=true.
//
// Bases.  The partial form reads its (q_base, k_base) from a device int32
// tensor of shape (Z, 2), one row per position: program bh reads row
// bh / H.  One launch then folds a whole ring round, every position at
// its own offsets, with no host sync.
//
// What bounds it on this card: operations, 4*Sq*Sk*D per head (2 for QK^T,
// 2 for PV) over the visited tiles -- at 989 TFLOP/s on the bf16/f16
// tensor cores, 3 x that work at 495 TFLOP/s for 3xTF32.  Bytes (Q, K, V,
// O once each) stay below that at the main path's shapes, except at a ring
// round's short segments, where the partial form's f32 state in and out
// makes bytes the bound.  What this design leaves for later: ping-pong between
// the two consumer warpgroups, overlap of one tile's softmax with the next
// tile's QK^T, and a persistent grid.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBQ = 128;          // query rows per block: two consumers of 64
constexpr int kSmemLimit = 232448;  // shared memory a block may use (227 KB)
constexpr int kThreads = 384;     // warpgroup 0 produces, 1 and 2 consume
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// key rows per K/V tile
template <typename T>
__host__ __device__ constexpr int block_k() {
  return sizeof(T) == 4 ? 64 : 128;
}

// A rows x DP tile of T in shared memory as TMA lays it down: column boxes
// of kRowBytes, each a contiguous rows x kRowBytes sub-tile, swizzled.
template <typename T, int DP>
struct Tile {
  static constexpr int kElem = static_cast<int>(sizeof(T));
  static constexpr int kRowBytes = DP * kElem < 128 ? DP * kElem : 128;
  static constexpr int kBoxCols = kRowBytes / kElem;
  static constexpr int kBoxes = DP / kBoxCols;
  static constexpr int kLayout = kRowBytes == 128 ? 1 : 2;  // wgmma: 128 B / 64 B swizzle
  static __host__ __device__ constexpr int bytes(int rows) { return rows * DP * kElem; }
  static __host__ __device__ constexpr int box_bytes(int rows) { return rows * kRowBytes; }
  // Byte offset of element (row, col): the swizzle XORs the 16-byte chunk
  // index with bits 7.. of the offset inside the box.
  static __device__ int offset(int rows, int row, int col) {
    int o = row * kRowBytes + (col % kBoxCols) * kElem;
    o ^= ((o >> 7) & (kRowBytes == 128 ? 7 : 3)) << 4;
    return (col / kBoxCols) * box_bytes(rows) + o;
  }
};

// Byte offsets in the block's shared memory (base aligned to 1024 B): the
// query tile, kStages K tiles, kStages V tiles, the mbarriers.  The ring
// is 3 stages deep where that fits, else 2 (float32 at D = 128).  The
// partial form's f32 state (128 rows x DP) passes through the last
// stage's K and V tiles, which hold exactly its bytes: consumer c's 64
// rows in the K tile (c = 0) or the V tile (c = 1), as Tile<float, DP>.
template <typename T, int DP>
struct Smem {
  using G = Tile<T, DP>;
  using State = Tile<float, DP>;
  static constexpr int kBK = block_k<T>();
  static constexpr int kTileKV = G::bytes(kBK);
  static constexpr int kQ = 0;
  static constexpr int kK = G::bytes(kBQ);
  static constexpr int kStages = kK + 6 * kTileKV + 128 + 1024 <= kSmemLimit ? 3 : 2;
  static constexpr int kV = kK + kStages * kTileKV;
  // q, full[kStages], empty[kStages], state full, state empty
  static constexpr int kBar = kV + kStages * kTileKV;
  static constexpr int kAlloc = kBar + 128 + 1024;  // + room to align the base
  static_assert(State::bytes(kBQ / 2) == kTileKV, "the state half fits one ring tile");
  // consumer c's half of the state
  static __host__ __device__ constexpr int state(int c) {
    return (c == 0 ? kK : kV) + (kStages - 1) * kTileKV;
  }
};

struct Params {
  const float* m_in;       // partial form: (ZH, Lq); acc goes through tm_s / tm_o
  const float* l_in;
  float* m_out;
  float* l_out;
  const int* bases;        // partial form: (Z, 2) int32, else null
  int H;                   // bh = outer * H + h
  int Lq, Lk, d;
  int q_base;              // full form (k_base 0)
  float scale;
  int causal;
};

__device__ __forceinline__ int floordiv(int a, int b) {  // b > 0
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) { return __float2half_rn(x); }

// Two floats rounded to T, packed as one 32-bit register (lo in the low half).
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const T a = from_float<T>(lo), b = from_float<T>(hi);
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&a)) |
         (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&b)) << 16);
}

// ---- 3xTF32 (the f32 path)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float& c0, float& c1, float& c2, float& c3,
                                         const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c0), "+f"(c1), "+f"(c2), "+f"(c3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a.b in 3xTF32, the small cross terms first.
__device__ __forceinline__ void mma_3xtf32(float& c0, float& c1, float& c2, float& c3,
                                           const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2], const uint32_t (&bl)[2]) {
  mma_tf32(c0, c1, c2, c3, al, bh[0], bh[1]);
  mma_tf32(c0, c1, c2, c3, ah, bl[0], bl[1]);
  mma_tf32(c0, c1, c2, c3, ah, bh[0], bh[1]);
}

template <typename T>
__device__ __forceinline__ T smem_at(const unsigned char* smem, int byte) {
  return *reinterpret_cast<const T*>(smem + byte);
}

// S (this warpgroup's 64 rows x kBK keys) = Q K^T over the padded D.
template <typename T, int DP>
__device__ __forceinline__ void qk(float (&sc)[block_k<T>() / 2], const unsigned char* smem,
                                   uint32_t base, int stage, int c, int rl0, int g, int t) {
  using G = Tile<T, DP>;
  using S = Smem<T, DP>;
  constexpr int kBK = S::kBK;
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) sc[i] = 0.0f;
    const unsigned char* q = smem + S::kQ;
    const unsigned char* k = smem + S::kK + stage * S::kTileKV;
#pragma unroll
    for (int kc = 0; kc < DP / 8; ++kc) {
      float a[4] = {smem_at<float>(q, G::offset(kBQ, rl0, 8 * kc + t)),
                    smem_at<float>(q, G::offset(kBQ, rl0 + 8, 8 * kc + t)),
                    smem_at<float>(q, G::offset(kBQ, rl0, 8 * kc + t + 4)),
                    smem_at<float>(q, G::offset(kBQ, rl0 + 8, 8 * kc + t + 4))};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) split_tf32(a[r], ah[r], al[r]);
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        uint32_t bh[2], bl[2];
        split_tf32(smem_at<float>(k, G::offset(kBK, 8 * j + g, 8 * kc + t)), bh[0], bl[0]);
        split_tf32(smem_at<float>(k, G::offset(kBK, 8 * j + g, 8 * kc + t + 4)), bh[1], bl[1]);
        mma_3xtf32(sc[4 * j], sc[4 * j + 1], sc[4 * j + 2], sc[4 * j + 3], ah, al, bh, bl);
      }
    }
  } else {
    constexpr int kPerBox = G::kBoxCols / 16;
    const uint32_t qa = base + S::kQ + c * 64 * G::kRowBytes;
    const uint32_t ka = base + S::kK + stage * S::kTileKV;
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) fence_operand(sc[i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int box = kk / kPerBox, col = (kk % kPerBox) * 32;
      const uint64_t da = wgmma_desc(qa + box * G::box_bytes(kBQ) + col, 16,
                                     8 * G::kRowBytes, G::kLayout);
      const uint64_t db = wgmma_desc(ka + box * G::box_bytes(kBK) + col, 16,
                                     8 * G::kRowBytes, G::kLayout);
      wgmma_ss_n128<T>(sc, da, db, kk > 0 ? 1 : 0);  // the first overwrites sc
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) fence_operand(sc[i]);
  }
}

// acc += T(p) V for this warpgroup's 64 rows; p in the accumulator layout.
template <typename T, int DP>
__device__ __forceinline__ void pv(float (&acc)[DP / 2], const float (&sc)[block_k<T>() / 2],
                                   const unsigned char* smem, uint32_t base, int stage, int g,
                                   int t) {
  using G = Tile<T, DP>;
  using S = Smem<T, DP>;
  constexpr int kBK = S::kBK;
  if constexpr (std::is_same<T, float>::value) {
    const unsigned char* v = smem + S::kV + stage * S::kTileKV;
    // Keys 8kc + 2t and 8kc + 2t + 1 stand in the k slots t and t + 4 of
    // mma's A and B fragments, so p feeds A in its accumulator layout.
#pragma unroll
    for (int kc = 0; kc < kBK / 8; ++kc) {
      const float a[4] = {sc[4 * kc], sc[4 * kc + 2], sc[4 * kc + 1], sc[4 * kc + 3]};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) split_tf32(a[r], ah[r], al[r]);
#pragma unroll
      for (int nd = 0; nd < DP / 8; ++nd) {
        uint32_t bh[2], bl[2];
        split_tf32(smem_at<float>(v, G::offset(kBK, 8 * kc + 2 * t, 8 * nd + g)), bh[0], bl[0]);
        split_tf32(smem_at<float>(v, G::offset(kBK, 8 * kc + 2 * t + 1, 8 * nd + g)), bh[1],
                   bl[1]);
        mma_3xtf32(acc[4 * nd], acc[4 * nd + 1], acc[4 * nd + 2], acc[4 * nd + 3], ah, al, bh,
                   bl);
      }
    }
  } else {
    // p as wgmma's register A operand: k16 slice kk is accumulator tiles
    // 2kk and 2kk + 1.
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = pack2<T>(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
    }
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) fence_operand(acc[i]);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) fence_operand(pa[kk][r]);
    }
    wgmma_fence();
    const uint32_t va = base + S::kV + stage * S::kTileKV;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // MN-major V: leading offset = the next column box, stride offset =
      // the next 8 key rows
      const uint64_t db = wgmma_desc(va + kk * 16 * G::kRowBytes, G::box_bytes(kBK),
                                     8 * G::kRowBytes, G::kLayout);
      wgmma_rs_tb<T, DP>(acc, pa[kk], db, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) fence_operand(acc[i]);
  }
}

template <typename T, int DP, bool kPartial>
__global__ void __launch_bounds__(kThreads, 1)
    flash_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
                 const __grid_constant__ CUtensorMap tm_s, const Params p) {
  // tm_o: O (full form) or acc_out (partial form); tm_s: acc_in (partial)
  using G = Tile<T, DP>;
  using S = Smem<T, DP>;
  constexpr int kBK = S::kBK;
  constexpr int kStages = S::kStages;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t base = smem_addr(smem);
  const uint32_t bar_q = base + S::kBar;
  auto bar_full = [&](int s) { return bar_q + 8u * (1 + s); };
  auto bar_empty = [&](int s) { return bar_q + 8u * (1 + kStages + s); };
  const uint32_t bar_state_full = bar_q + 8u * (1 + 2 * kStages);
  const uint32_t bar_state_empty = bar_state_full + 8u;
  using St = typename S::State;

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // the longest causal tiles first
  const int h = bh % p.H;
  const int outer = bh / p.H;
  int q_base = p.q_base, k_base = 0;
  if (kPartial) {
    q_base = p.bases[2 * outer];
    k_base = p.bases[2 * outer + 1];
  }
  const int q_lo = q_base + qt * kBQ;
  const int nk = p.Lk / kBK;
  int full = nk, total = nk;
  if (p.causal) {  // _causal_chunk_bounds at (kBQ, kBK)
    full = clampi(floordiv(q_lo - k_base + 1, kBK), 0, nk);
    total = clampi(floordiv(q_lo + kBQ - 1 - k_base, kBK) + 1, 0, nk);
  }

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full(s), 1);
      mbar_init(bar_empty(s), 8);  // one arrival per consumer warp
    }
    mbar_init(bar_state_full, 1);
    mbar_init(bar_state_empty, 8);
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------- producer
    setmaxnreg_dec<kProducerRegs>();
    // the partial form's state, into the last stage: needed at the first
    // rescale, so it follows tile 0 (alone when no tile is folded)
    auto load_state = [&]() {
      mbar_arrive_expect_tx(bar_state_full, St::bytes(kBQ));
      for (int c = 0; c < 2; ++c) {
        for (int b = 0; b < St::kBoxes; ++b) {
          tma_load_4d(base + S::state(c) + b * St::box_bytes(kBQ / 2), &tm_s, bar_state_full,
                      b * St::kBoxCols, qt * kBQ + 64 * c, h, outer);
        }
      }
    };
    if (threadIdx.x == 0 && kPartial && total == 0) load_state();
    if (threadIdx.x == 0 && total > 0) {
      mbar_arrive_expect_tx(bar_q, G::bytes(kBQ));
      for (int b = 0; b < G::kBoxes; ++b) {
        tma_load_4d(base + S::kQ + b * G::box_bytes(kBQ), &tm_q, bar_q, b * G::kBoxCols,
                    qt * kBQ, h, outer);
      }
      for (int j = 0; j < total; ++j) {
        const int s = j % kStages;
        if (j >= kStages) {
          mbar_wait(bar_empty(s), (j / kStages - 1) & 1);
        } else if (kPartial && j == kStages - 1) {
          mbar_wait(bar_state_empty, 0);  // the consumers hold the state in registers
        }
        mbar_arrive_expect_tx(bar_full(s), 2 * S::kTileKV);
        for (int b = 0; b < G::kBoxes; ++b) {
          const int off = s * S::kTileKV + b * G::box_bytes(kBK);
          tma_load_4d(base + S::kK + off, &tm_k, bar_full(s), b * G::kBoxCols, j * kBK, h, outer);
          tma_load_4d(base + S::kV + off, &tm_v, bar_full(s), b * G::kBoxCols, j * kBK, h, outer);
        }
        if (kPartial && j == 0) load_state();
      }
    }
  } else {
    // ---------------- consumers
    setmaxnreg_inc<kConsumerRegs>();
    const int c = threadIdx.x / 128 - 1;  // q rows [64c, 64c + 64) of the tile
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int rl0 = 64 * c + 16 * warp + g;  // this thread's rows: rl0, rl0 + 8
    const int r0 = rl0 - 64 * c;              // ... within this consumer's 64
    const int64_t srow0 = static_cast<int64_t>(bh) * p.Lq + qt * kBQ + rl0;
    const int64_t srow1 = srow0 + 8;

    float m[2], l[2];
    float acc[DP / 2];
    // acc from the state's TMA copy, in the accumulator layout; the reads
    // are ordered before the producer's next TMA write into the stage
    auto take_state = [&]() {
      mbar_wait(bar_state_full, 0);
      const unsigned char* st = smem + S::state(c);
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const float2 x0 = smem_at<float2>(st, St::offset(kBQ / 2, r0, 8 * n + 2 * t));
        const float2 x1 = smem_at<float2>(st, St::offset(kBQ / 2, r0 + 8, 8 * n + 2 * t));
        acc[4 * n] = x0.x;
        acc[4 * n + 1] = x0.y;
        acc[4 * n + 2] = x1.x;
        acc[4 * n + 3] = x1.y;
      }
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_state_empty);
    };
    if (kPartial) {
      m[0] = p.m_in[srow0];
      m[1] = p.m_in[srow1];
      l[0] = p.l_in[srow0];
      l[1] = p.l_in[srow1];
    } else {
      m[0] = m[1] = -INFINITY;
      l[0] = l[1] = 0.0f;
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;
    }

    if (total > 0) mbar_wait(bar_q, 0);
    const int qp0 = q_lo + rl0, qp1 = qp0 + 8;
    for (int j = 0; j < total; ++j) {
      const int s = j % kStages;
      mbar_wait(bar_full(s), (j / kStages) & 1);

      float sc[kBK / 2];
      qk<T, DP>(sc, smem, base, s, c, rl0, g, t);

      // ---- online softmax on this thread's two rows.  Element i of the
      // accumulator is row (i >> 1) & 1, column 8 (i >> 2) + 2t + (i & 1);
      // maxima and sums run in two chains a row, alternate 8-column tiles.
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) sc[i] = __fmul_rn(sc[i], p.scale);
      if (p.causal && j >= full) {
        const int kp = k_base + j * kBK + 2 * t;
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) {
          if (((i >> 1) & 1 ? qp1 : qp0) < kp + 8 * (i >> 2) + (i & 1)) sc[i] = -INFINITY;
        }
      }
      float mx[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        float& x = mx[(i >> 1) & 1][(i >> 2) & 1];
        x = fmaxf(x, sc[i]);
      }
      float safe_m[2], corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float x = fmaxf(mx[r][0], mx[r][1]);
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        const float m_new = fmaxf(m[r], x);
        safe_m[r] = isfinite(m_new) ? m_new : 0.0f;
        corr[r] = isfinite(m[r]) ? expf(m[r] - safe_m[r]) : 0.0f;
        m[r] = m_new;
      }
      // masked scores are -inf and safe_m finite, so expf gives them 0
      float rs[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const int r = (i >> 1) & 1;
        sc[i] = expf(sc[i] - safe_m[r]);
        rs[r][(i >> 2) & 1] += sc[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float x = rs[r][0] + rs[r][1];
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        l[r] = __fadd_rn(__fmul_rn(l[r], corr[r]), x);
      }
      if (kPartial && j == 0) take_state();
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc[i] *= corr[(i >> 1) & 1];

      pv<T, DP>(acc, sc, smem, base, s, g, t);
      // f32 read the stage with ordinary loads: order them before the
      // producer's next TMA write into it (wgmma's reads are async already)
      if constexpr (std::is_same<T, float>::value) fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty(s));
    }
    if (kPartial && total == 0) take_state();

    // ---- write back
    if (kPartial) {
      if (t == 0) {
        p.m_out[srow0] = m[0];
        p.m_out[srow1] = m[1];
        p.l_out[srow0] = l[0];
        p.l_out[srow1] = l[1];
      }
      // acc back through the state's stage slots and a TMA store, once
      // both consumers are done with every stage
      named_barrier(3, 256);
      unsigned char* st = smem + S::state(c);
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        *reinterpret_cast<float2*>(st + St::offset(kBQ / 2, r0, 8 * n + 2 * t)) =
            make_float2(acc[4 * n], acc[4 * n + 1]);
        *reinterpret_cast<float2*>(st + St::offset(kBQ / 2, r0 + 8, 8 * n + 2 * t)) =
            make_float2(acc[4 * n + 2], acc[4 * n + 3]);
      }
      fence_proxy_async();
      named_barrier(1 + c, 128);
      if (tid == 0) {
        for (int b = 0; b < St::kBoxes; ++b) {
          tma_store_4d(&tm_o, base + S::state(c) + b * St::box_bytes(kBQ / 2), b * St::kBoxCols,
                       qt * kBQ + 64 * c, h, outer);
        }
        tma_store_commit_and_wait();
      }
    } else {
      // O in T into this warpgroup's rows of the (now unused) Q tile, in
      // the swizzled layout of tm_o's boxes, then one TMA store per box.
      const float den0 = fmaxf(l[0], 1e-30f), den1 = fmaxf(l[1], 1e-30f);
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const int col = 8 * n + 2 * t;
        const float a0 = __fdiv_rn(acc[4 * n], den0), a1 = __fdiv_rn(acc[4 * n + 1], den0);
        const float b0 = __fdiv_rn(acc[4 * n + 2], den1), b1 = __fdiv_rn(acc[4 * n + 3], den1);
        unsigned char* o0 = smem + S::kQ + G::offset(kBQ, rl0, col);
        unsigned char* o1 = smem + S::kQ + G::offset(kBQ, rl0 + 8, col);
        if constexpr (std::is_same<T, float>::value) {
          *reinterpret_cast<float2*>(o0) = make_float2(a0, a1);
          *reinterpret_cast<float2*>(o1) = make_float2(b0, b1);
        } else {
          *reinterpret_cast<uint32_t*>(o0) = pack2<T>(a0, a1);
          *reinterpret_cast<uint32_t*>(o1) = pack2<T>(b0, b1);
        }
      }
      fence_proxy_async();
      named_barrier(1 + c, 128);
      if (tid == 0) {
        for (int b = 0; b < G::kBoxes; ++b) {
          tma_store_4d(&tm_o, base + S::kQ + b * G::box_bytes(kBQ) + c * 64 * G::kRowBytes,
                       b * G::kBoxCols, qt * kBQ + 64 * c, h, outer);
        }
        tma_store_commit_and_wait();
      }
    }
  }
}

// ---------------------------------------------------------------- host side
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &sym, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(sym);
    }
  }
  return fn;
}

// A 4-D map over one operand viewed as (d, rows, H, outer), innermost
// first; st = its (outer, h, row) element strides.  The box is
// (kBoxCols, box_rows, 1, 1); columns at or past d read as zeros and are
// not written.  Returns 0, or 1000 + the CUresult of the encoding.
template <typename T, int DP>
int make_map(CUtensorMap* map, const void* ptr, const int64_t* st, int outer, int H, int rows,
             int d, int box_rows) {
  using G = Tile<T, DP>;
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return 1000 + static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const int64_t e = static_cast<int64_t>(sizeof(T));
  int64_t row_b = st[2] * e, h_b = st[1] * e, outer_b = st[0] * e;
  if (H == 1) h_b = row_b * rows;  // an axis of extent 1 is never stepped
  if (outer == 1) outer_b = h_b * H;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(row_b), static_cast<cuuint64_t>(h_b),
                                 static_cast<cuuint64_t>(outer_b)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(G::kBoxCols),
                             static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapDataType type = std::is_same<T, float>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                       : (std::is_same<T, __nv_bfloat16>::value
                                              ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                              : CU_TENSOR_MAP_DATA_TYPE_FLOAT16);
  const CUresult r = encode(
      map, type, 4, const_cast<void*>(ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      G::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + static_cast<int>(r);
}

// The operands' pointers, the launch parameters and the stream, as passed
// down to one instantiation.
struct Launch {
  const void *q, *k, *v, *acc_in;
  void *o, *acc_out;
  const int64_t* strides;
  Params p;
  int outer;
  cudaStream_t stream;
};

template <typename T, int DP, bool kPartial>
int launch_one(const Launch& a) {
  using S = Smem<T, DP>;
  const Params& p = a.p;
  const int64_t* strides = a.strides;
  const int outer = a.outer;
  CUtensorMap tq, tk, tv, to, ts;
  int rc = make_map<T, DP>(&tq, a.q, strides, outer, p.H, p.Lq, p.d, kBQ);
  if (rc == 0) rc = make_map<T, DP>(&tk, a.k, strides + 3, outer, p.H, p.Lk, p.d, S::kBK);
  if (rc == 0) rc = make_map<T, DP>(&tv, a.v, strides + 6, outer, p.H, p.Lk, p.d, S::kBK);
  if (kPartial) {
    // the f32 state (outer * H, Lq, d), contiguous, in and out in 64-row boxes
    const int64_t st[3] = {static_cast<int64_t>(p.H) * p.Lq * p.d,
                           static_cast<int64_t>(p.Lq) * p.d, p.d};
    if (rc == 0) rc = make_map<float, DP>(&ts, a.acc_in, st, outer, p.H, p.Lq, p.d, kBQ / 2);
    if (rc == 0) rc = make_map<float, DP>(&to, a.acc_out, st, outer, p.H, p.Lq, p.d, kBQ / 2);
  } else {
    if (rc == 0) rc = make_map<T, DP>(&to, a.o, strides + 9, outer, p.H, p.Lq, p.d, kBQ / 2);
    ts = tq;  // the full form reads no state: a copy, never used
  }
  if (rc != 0) return rc;
  auto kernel = flash_kernel<T, DP, kPartial>;
  static bool sized = false;  // once per instantiation, before any graph capture
  if (!sized) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kAlloc);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  kernel<<<dim3(static_cast<unsigned int>(outer * p.H), static_cast<unsigned int>(p.Lq / kBQ)),
           kThreads, S::kAlloc, a.stream>>>(tq, tk, tv, to, ts, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kPartial>
int launch_d(const Launch& a) {
  if (a.p.d <= 32) return launch_one<T, 32, kPartial>(a);
  if (a.p.d <= 64) return launch_one<T, 64, kPartial>(a);
  return launch_one<T, 128, kPartial>(a);
}

template <bool kPartial>
int launch_t(int dtype, const Launch& a) {
  switch (dtype) {
    case 0: return launch_d<float, kPartial>(a);
    case 1: return launch_d<__nv_bfloat16, kPartial>(a);
    case 2: return launch_d<__half, kPartial>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C interface, loaded with ctypes.
//   dtype: 0 float32, 1 bfloat16, 2 float16 (q, k, v and o share it).
//   partial: 0 the full form (o written, q_base used, bases ignored);
//            1 the partial form (m/l/acc in and out, bases (Z, 2) int32).
//   strides: 12 int64 element strides, (outer, h, row) for q, k, v, o; each
//            operand is viewed as (outer, H, rows, d), d with stride 1.  The
//            partial form's m/l (outer * H, Lq) and acc (outer * H, Lq, d)
//            are contiguous.
//   outer * H programs along x, Lq / 128 along y.  Lq is a multiple of
//   128, Lk of the K/V tile (128 rows; 64 for float32), d a multiple of 8
//   in [8, 128]; every pointer is 16-byte aligned and every stride a whole
//   number of 16-byte vectors.  Returns a CUDA error code (0: launched), or
//   1000 + a CUresult when a TMA tensor map cannot be encoded; neither
//   synchronises nor allocates.
extern "C" int flash_attention_launch(int dtype, int partial, int causal, const void* q,
                                      const void* k, const void* v, void* o, const void* m_in,
                                      const void* l_in, const void* acc_in, void* m_out,
                                      void* l_out, void* acc_out, const void* bases, int q_base,
                                      const int64_t* strides, int outer, int H, int Lq, int Lk,
                                      int d, float scale, void* stream) {
  const int bk = dtype == 0 ? block_k<float>() : block_k<__half>();
  if (d < 8 || d > 128 || d % 8 || Lq % kBQ || Lk % bk || Lq <= 0 || Lk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Launch a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.acc_in = acc_in;
  a.acc_out = acc_out;
  a.strides = strides;
  a.outer = outer;
  a.stream = static_cast<cudaStream_t>(stream);
  Params& p = a.p;
  p.m_in = static_cast<const float*>(m_in);
  p.l_in = static_cast<const float*>(l_in);
  p.m_out = static_cast<float*>(m_out);
  p.l_out = static_cast<float*>(l_out);
  p.bases = static_cast<const int*>(bases);
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.d = d;
  p.q_base = q_base;
  p.scale = scale;
  p.causal = causal;
  return partial ? launch_t<true>(dtype, a) : launch_t<false>(dtype, a);
}

// The tiles of dtype (codes as above): query rows per block and key rows per
// K/V tile.  The wrapper holds the plain versions at these.  Returns 0, or
// cudaErrorInvalidValue for an unknown dtype.
extern "C" int flash_attention_tiles(int dtype, int* block_q, int* block_k_rows) {
  if (dtype < 0 || dtype > 2) return static_cast<int>(cudaErrorInvalidValue);
  *block_q = kBQ;
  *block_k_rows = dtype == 0 ? block_k<float>() : block_k<__half>();
  return 0;
}
