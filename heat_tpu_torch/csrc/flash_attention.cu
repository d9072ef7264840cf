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
// q_pos >= k_pos mask, and tiles at or after total are never visited, with
// (full, total) from the reference's _causal_chunk_bounds rule at this
// kernel's tile sizes.  A query tile wholly before its key segment
// (total == 0, the ring's fully masked rounds) leaves the state untouched.
//
// Shape of the kernel.  One block of 4 warps per (bh, 64-row query tile);
// each warp owns 16 query rows.  The query tile, one 64-row K tile, one
// 64-row V tile and the warp's p tile sit in shared memory; the row state
// (m, l) and acc stay in f32 registers, in the m16n8 accumulator layout of
// mma.sync (thread t of a warp holds rows t/4 and t/4 + 8, columns
// 2(t%4) and 2(t%4)+1 of each 8-column tile).  A loop over key tiles
// inside the block takes the place of the TPU's sequential fold.  D is
// padded with zeros to 32, 64 or 128 in shared memory.
//   bf16 / f16: both products run on the tensor cores with
//     mma.sync.m16n8k16 and an f32 accumulator -- the operands are what
//     the reference feeds its matrix unit, and products of 8- or 11-bit
//     mantissas are exact in f32.
//   f32: FFMA only, in the same register layout, reading both operands
//     from shared memory.  No TF32 mma: the reference runs f32 at its
//     HIGHEST precision, and TF32 keeps 10 mantissa bits.
// exp is the IEEE expf (no fast math); the file builds with --fmad=true.
//
// Bases.  The partial form reads its (q_base, k_base) from a device int32
// tensor of shape (Z, 2), one row per position: program bh reads row
// bh / (B*H).  One launch then folds a whole ring round, every position at
// its own offsets, with no host sync.
//
// What bounds it on this card: operations, 4*Sq*Sk*D per head (2 for QK^T,
// 2 for PV) over the visited tiles -- at 989 TFLOP/s on the bf16/f16
// tensor cores, 67 TFLOP/s on the f32 FFMA path.  Bytes (Q, K, V, O once
// each) are two orders of magnitude below that at the main path's shapes.
// What this simple design leaves on the table: wgmma (mma.sync reaches a
// fraction of the tensor-core rate), TMA and cp.async loads overlapped
// with the math (the tiles are loaded synchronously here), warp
// specialisation, and a register-resident P for the PV product.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBQ = 64;             // query rows per block
constexpr int kBK = 64;             // key rows per K/V tile
constexpr int kWarps = kBQ / 16;    // 16 query rows per warp
constexpr int kThreads = kWarps * 32;

// Element strides of a (Z, B, H, S, D) view; D has stride 1.
struct Layout {
  int64_t z, b, h, s;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;                 // full form
  const float* m_in;       // partial form: (ZBH, Lq)
  const float* l_in;
  const float* acc_in;     // (ZBH, Lq, d)
  float* m_out;
  float* l_out;
  float* acc_out;
  const int* bases;        // partial form: (Z, 2) int32, else null
  Layout lq, lk, lv, lo;
  int B, H;                // bh = (z * B + b) * H + h
  int Lq, Lk, d;
  int q_base;              // full form (k_base 0)
  float scale;
  int causal;
};

template <typename T>
__host__ __device__ constexpr int pad_elems() { return 16 / static_cast<int>(sizeof(T)); }

template <typename T, int DP>
__host__ __device__ constexpr int smem_bytes() {
  return static_cast<int>(sizeof(T)) *
         ((kBQ + 2 * kBK) * (DP + pad_elems<T>()) + kBQ * (kBK + pad_elems<T>()));
}

__device__ __forceinline__ int floordiv(int a, int b) {  // b > 0
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) { return __float2half_rn(x); }

// Two 16-bit values as one 32-bit mma operand register, lower index low.
template <typename T>
__device__ __forceinline__ uint32_t pack2(T lo, T hi) {
  const uint16_t a = *reinterpret_cast<const uint16_t*>(&lo);
  const uint16_t b = *reinterpret_cast<const uint16_t*>(&hi);
  return static_cast<uint32_t>(a) | (static_cast<uint32_t>(b) << 16);
}

template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

__device__ __forceinline__ const char* row_ptr(const void* base, const Layout& l, int z, int b,
                                               int h, int s, int elem) {
  return static_cast<const char*>(base) +
         (static_cast<int64_t>(z) * l.z + static_cast<int64_t>(b) * l.b +
          static_cast<int64_t>(h) * l.h + static_cast<int64_t>(s) * l.s) *
             elem;
}

// rows x DP tile of T from global (row r at row_ptr(..., s0 + r)) into
// shared memory with row stride DP + pad; columns >= d are zero.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(T* dst, const void* base, const Layout& l, int z, int b,
                                          int h, int s0, int rows, int d) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kChunks = DP / kVec;
  constexpr int kStride = DP + pad_elems<T>();
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int col = (i % kChunks) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (col < d) {
      val = *reinterpret_cast<const uint4*>(row_ptr(base, l, z, b, h, s0 + r, sizeof(T)) +
                                            static_cast<int64_t>(col) * sizeof(T));
    }
    *reinterpret_cast<uint4*>(dst + r * kStride + col) = val;
  }
}

template <typename T, int DP, bool kPartial>
__global__ void __launch_bounds__(kThreads) flash_kernel(const Params p) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kStride = DP + pad_elems<T>();
  constexpr int kPStride = kBK + pad_elems<T>();
  constexpr int kNT = kBK / 8;   // 8-column tiles of a score row
  constexpr int kDT = DP / 8;    // 8-column tiles of an output row

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + kBQ * kStride;
  T* Vs = Ks + kBK * kStride;
  T* Ps = Vs + kBK * kStride;

  const int bh = blockIdx.x;
  const int qt = blockIdx.y;
  const int h = bh % p.H;
  const int b = (bh / p.H) % p.B;
  const int z = bh / (p.H * p.B);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;    // accumulator row within the warp's 16
  const int t = lane % 4;    // accumulator column pair
  const int r0 = warp * 16 + g;  // this thread's two rows of the q tile
  const int r1 = r0 + 8;

  int q_base = p.q_base, k_base = 0;
  if (kPartial) {
    q_base = p.bases[2 * z];
    k_base = p.bases[2 * z + 1];
  }
  const int q_lo = q_base + qt * kBQ;
  const int nk = p.Lk / kBK;
  int full = nk, total = nk;
  if (p.causal) {  // _causal_chunk_bounds at (kBQ, kBK)
    full = clampi(floordiv(q_lo - k_base + 1, kBK), 0, nk);
    total = clampi(floordiv(q_lo + kBQ - 1 - k_base, kBK) + 1, 0, nk);
  }

  // running state, f32, accumulator layout
  float m[2], l[2];
  float acc[kDT][4];
  const int64_t srow0 = static_cast<int64_t>(bh) * p.Lq + qt * kBQ + r0;
  const int64_t srow1 = srow0 + 8;
  if (kPartial) {
    m[0] = p.m_in[srow0];
    m[1] = p.m_in[srow1];
    l[0] = p.l_in[srow0];
    l[1] = p.l_in[srow1];
#pragma unroll
    for (int n = 0; n < kDT; ++n) {
      const int c = n * 8 + 2 * t;
      acc[n][0] = c < p.d ? p.acc_in[srow0 * p.d + c] : 0.0f;
      acc[n][1] = c + 1 < p.d ? p.acc_in[srow0 * p.d + c + 1] : 0.0f;
      acc[n][2] = c < p.d ? p.acc_in[srow1 * p.d + c] : 0.0f;
      acc[n][3] = c + 1 < p.d ? p.acc_in[srow1 * p.d + c + 1] : 0.0f;
    }
  } else {
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.0f;
#pragma unroll
    for (int n = 0; n < kDT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  }

  if (total > 0) {
    load_tile<T, DP>(Qs, p.q, p.lq, z, b, h, qt * kBQ, kBQ, p.d);
  }

  // Q fragments of the tensor-core path, loaded once
  uint32_t qf[kF32 ? 1 : DP / 16][4];

  for (int j = 0; j < total; ++j) {
    __syncthreads();  // the previous tile's readers are done (and Qs is in)
    load_tile<T, DP>(Ks, p.k, p.lk, z, b, h, j * kBK, kBK, p.d);
    load_tile<T, DP>(Vs, p.v, p.lv, z, b, h, j * kBK, kBK, p.d);
    __syncthreads();

    if constexpr (!kF32) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const int c = kk * 16 + 2 * t;
          qf[kk][0] = *reinterpret_cast<const uint32_t*>(Qs + r0 * kStride + c);
          qf[kk][1] = *reinterpret_cast<const uint32_t*>(Qs + r1 * kStride + c);
          qf[kk][2] = *reinterpret_cast<const uint32_t*>(Qs + r0 * kStride + c + 8);
          qf[kk][3] = *reinterpret_cast<const uint32_t*>(Qs + r1 * kStride + c + 8);
        }
      }
    }

    // ---- scores: s = Q . K^T over the padded D
    float s[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
    if constexpr (kF32) {
      for (int dd = 0; dd < DP; dd += 4) {
        const float4 qa = *reinterpret_cast<const float4*>(Qs + r0 * kStride + dd);
        const float4 qb = *reinterpret_cast<const float4*>(Qs + r1 * kStride + dd);
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          const float4 k0 = *reinterpret_cast<const float4*>(Ks + (n * 8 + 2 * t) * kStride + dd);
          const float4 k1 =
              *reinterpret_cast<const float4*>(Ks + (n * 8 + 2 * t + 1) * kStride + dd);
          s[n][0] = fmaf(qa.x, k0.x, s[n][0]);
          s[n][0] = fmaf(qa.y, k0.y, s[n][0]);
          s[n][0] = fmaf(qa.z, k0.z, s[n][0]);
          s[n][0] = fmaf(qa.w, k0.w, s[n][0]);
          s[n][1] = fmaf(qa.x, k1.x, s[n][1]);
          s[n][1] = fmaf(qa.y, k1.y, s[n][1]);
          s[n][1] = fmaf(qa.z, k1.z, s[n][1]);
          s[n][1] = fmaf(qa.w, k1.w, s[n][1]);
          s[n][2] = fmaf(qb.x, k0.x, s[n][2]);
          s[n][2] = fmaf(qb.y, k0.y, s[n][2]);
          s[n][2] = fmaf(qb.z, k0.z, s[n][2]);
          s[n][2] = fmaf(qb.w, k0.w, s[n][2]);
          s[n][3] = fmaf(qb.x, k1.x, s[n][3]);
          s[n][3] = fmaf(qb.y, k1.y, s[n][3]);
          s[n][3] = fmaf(qb.z, k1.z, s[n][3]);
          s[n][3] = fmaf(qb.w, k1.w, s[n][3]);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          const T* kr = Ks + (n * 8 + g) * kStride + kk * 16 + 2 * t;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + 8);
          mma16816<T>(s[n], qf[kk], b0, b1);
        }
      }
    }

    // ---- online softmax on this thread's two rows
    const bool masked = p.causal && j >= full;
    const int qp0 = q_lo + r0, qp1 = q_lo + r1;
    const int kp = k_base + j * kBK + 2 * t;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = s[n][e] * p.scale;
        if (masked) {
          const int qpos = e < 2 ? qp0 : qp1;
          if (qpos < kp + n * 8 + (e & 1)) v = -INFINITY;
        }
        s[n][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    }
    float safe_m[2], corr[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      safe_m[i] = isfinite(m_new) ? m_new : 0.0f;
      corr[i] = isfinite(m[i]) ? expf(m[i] - safe_m[i]) : 0.0f;
      m[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = s[n][e];
        const float pe = v == -INFINITY ? 0.0f : expf(v - safe_m[e >> 1]);
        s[n][e] = pe;
        rs[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l[i] = l[i] * corr[i] + rs[i];
    }
#pragma unroll
    for (int n = 0; n < kDT; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // ---- p, cast to the input dtype, to this warp's rows of Ps
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const int c = n * 8 + 2 * t;
      Ps[r0 * kPStride + c] = from_float<T>(s[n][0]);
      Ps[r0 * kPStride + c + 1] = from_float<T>(s[n][1]);
      Ps[r1 * kPStride + c] = from_float<T>(s[n][2]);
      Ps[r1 * kPStride + c + 1] = from_float<T>(s[n][3]);
    }
    __syncwarp();

    // ---- acc += P . V
    if constexpr (kF32) {
      for (int kk = 0; kk < kBK; ++kk) {
        const float pa = Ps[r0 * kPStride + kk];
        const float pb = Ps[r1 * kPStride + kk];
#pragma unroll
        for (int n = 0; n < kDT; ++n) {
          const float2 vv = *reinterpret_cast<const float2*>(Vs + kk * kStride + n * 8 + 2 * t);
          acc[n][0] = fmaf(pa, vv.x, acc[n][0]);
          acc[n][1] = fmaf(pa, vv.y, acc[n][1]);
          acc[n][2] = fmaf(pb, vv.x, acc[n][2]);
          acc[n][3] = fmaf(pb, vv.y, acc[n][3]);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const int c = kk * 16 + 2 * t;
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(Ps + r0 * kPStride + c);
        a[1] = *reinterpret_cast<const uint32_t*>(Ps + r1 * kPStride + c);
        a[2] = *reinterpret_cast<const uint32_t*>(Ps + r0 * kPStride + c + 8);
        a[3] = *reinterpret_cast<const uint32_t*>(Ps + r1 * kPStride + c + 8);
#pragma unroll
        for (int n = 0; n < kDT; ++n) {
          const T* vc = Vs + n * 8 + g;
          const uint32_t b0 = pack2<T>(vc[c * kStride], vc[(c + 1) * kStride]);
          const uint32_t b1 = pack2<T>(vc[(c + 8) * kStride], vc[(c + 9) * kStride]);
          mma16816<T>(acc[n], a, b0, b1);
        }
      }
    }
  }

  // ---- write back
  if (kPartial) {
    if (t == 0) {
      p.m_out[srow0] = m[0];
      p.m_out[srow1] = m[1];
      p.l_out[srow0] = l[0];
      p.l_out[srow1] = l[1];
    }
#pragma unroll
    for (int n = 0; n < kDT; ++n) {
      const int c = n * 8 + 2 * t;
      if (c < p.d) {  // d is a multiple of 8, so c + 1 < d too
        p.acc_out[srow0 * p.d + c] = acc[n][0];
        p.acc_out[srow0 * p.d + c + 1] = acc[n][1];
        p.acc_out[srow1 * p.d + c] = acc[n][2];
        p.acc_out[srow1 * p.d + c + 1] = acc[n][3];
      }
    }
  } else {
    const float den0 = fmaxf(l[0], 1e-30f), den1 = fmaxf(l[1], 1e-30f);
    T* o0 = reinterpret_cast<T*>(const_cast<char*>(
        row_ptr(p.o, p.lo, z, b, h, qt * kBQ + r0, sizeof(T))));
    T* o1 = reinterpret_cast<T*>(const_cast<char*>(
        row_ptr(p.o, p.lo, z, b, h, qt * kBQ + r1, sizeof(T))));
#pragma unroll
    for (int n = 0; n < kDT; ++n) {
      const int c = n * 8 + 2 * t;
      if (c < p.d) {
        o0[c] = from_float<T>(__fdiv_rn(acc[n][0], den0));
        o0[c + 1] = from_float<T>(__fdiv_rn(acc[n][1], den0));
        o1[c] = from_float<T>(__fdiv_rn(acc[n][2], den1));
        o1[c + 1] = from_float<T>(__fdiv_rn(acc[n][3], den1));
      }
    }
  }
}

template <typename T, int DP, bool kPartial>
int launch_one(const Params& p, int zbh, cudaStream_t stream) {
  auto kernel = flash_kernel<T, DP, kPartial>;
  constexpr int bytes = smem_bytes<T, DP>();
  static bool sized = false;  // once per instantiation, before any graph capture
  if (!sized) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  kernel<<<dim3(static_cast<unsigned int>(zbh), static_cast<unsigned int>(p.Lq / kBQ)), kThreads,
           bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kPartial>
int launch_d(const Params& p, int zbh, cudaStream_t stream) {
  if (p.d <= 32) return launch_one<T, 32, kPartial>(p, zbh, stream);
  if (p.d <= 64) return launch_one<T, 64, kPartial>(p, zbh, stream);
  return launch_one<T, 128, kPartial>(p, zbh, stream);
}

template <bool kPartial>
int launch_t(int dtype, const Params& p, int zbh, cudaStream_t stream) {
  switch (dtype) {
    case 0: return launch_d<float, kPartial>(p, zbh, stream);
    case 1: return launch_d<__nv_bfloat16, kPartial>(p, zbh, stream);
    case 2: return launch_d<__half, kPartial>(p, zbh, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C interface, loaded with ctypes.
//   dtype: 0 float32, 1 bfloat16, 2 float16 (q, k, v and o share it).
//   partial: 0 the full form (o written, q_base used, bases ignored);
//            1 the partial form (m/l/acc in and out, bases (Z, 2) int32).
//   strides: 16 int64 element strides, (z, b, h, s) for q, k, v, o.
//   Z*B*H programs along x, Lq / 64 along y.  Lq and Lk are multiples of
//   64, d a multiple of 8 in [8, 128]; every pointer and every row start
//   is 16-byte aligned.  Returns a CUDA error code (0: launched); neither
//   synchronises nor allocates.
extern "C" int flash_attention_launch(int dtype, int partial, int causal, const void* q,
                                      const void* k, const void* v, void* o, const void* m_in,
                                      const void* l_in, const void* acc_in, void* m_out,
                                      void* l_out, void* acc_out, const void* bases, int q_base,
                                      const int64_t* strides, int Z, int B, int H, int Lq, int Lk,
                                      int d, float scale, void* stream) {
  if (d < 8 || d > 128 || d % 8 || Lq % kBQ || Lk % kBK || Lq <= 0 || Lk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.m_in = static_cast<const float*>(m_in);
  p.l_in = static_cast<const float*>(l_in);
  p.acc_in = static_cast<const float*>(acc_in);
  p.m_out = static_cast<float*>(m_out);
  p.l_out = static_cast<float*>(l_out);
  p.acc_out = static_cast<float*>(acc_out);
  p.bases = static_cast<const int*>(bases);
  Layout* ls[4] = {&p.lq, &p.lk, &p.lv, &p.lo};
  for (int i = 0; i < 4; ++i) {
    ls[i]->z = strides[4 * i];
    ls[i]->b = strides[4 * i + 1];
    ls[i]->h = strides[4 * i + 2];
    ls[i]->s = strides[4 * i + 3];
  }
  p.B = B;
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.d = d;
  p.q_base = q_base;
  p.scale = scale;
  p.causal = causal;
  const int zbh = Z * B * H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return partial ? launch_t<true>(dtype, p, zbh, s) : launch_t<false>(dtype, p, zbh, s);
}
