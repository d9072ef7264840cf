// Block-scaled int8 quantization of collective payloads, for Hopper (sm_90a).
//
// Which TPU kernels each entry replaces (heat_tpu/comm/compressed.py):
//   blockquant_quantize                  _q_kernel (:230), launched by
//                                        quantize_blocks;
//   blockquant_dequantize                _dq_kernel (:249), launched by
//                                        dequantize_blocks;
//   blockquant_dequantize_fma            _dq_kernel fused with the addition
//                                        (or subtraction) after the decode;
//   blockquant_dequantize_add_quantize   _dq_kernel + the addition + _q_kernel:
//                                        one reduce-scatter hop of the ring
//                                        allreduce (decode the incoming
//                                        payload, add the local chunk,
//                                        re-quantize the sum for the next
//                                        hop), whose f32 sum nothing else
//                                        reads.
// They run on every hop of the int8_block ring allreduce and in the
// error-feedback round trip.
//
// What they compute, per row of 128 float32 values:
//   absmax = max |x|                     (NaN propagates)
//   scale  = absmax * (1/127)            if absmax is finite and > 0
//            1                           if absmax == 0
//            absmax                      if absmax is +-Inf
//            NaN (0x7fc00000)            if the row holds a NaN
//   q      = int8(round_half_even(x / scale)), saturating, NaN -> 0;
//            q = 1 on a row whose absmax is not finite
// and back: x' = float(q) * scale, or, fused, y = c + sign * float(q) * scale
// rounded once (sign +1: a reduce-scatter hop's decode-and-accumulate;
// sign -1: the error-feedback residual c - deQ(Q(c))).  The hop kernel
// quantizes y (sign +1) without writing it.
//
// Bit parity with the reference.  Its compiled programs scale by the
// float32 constant 1/127 (XLA rewrites the division by the constant 127
// into that product), divide x / scale exactly, and contract a decode
// followed by an addition or subtraction into one fused multiply-add
// (hence the fused kernels).  It runs with subnormals flushed to zero
// (inputs and results), so: subnormal inputs count as zero, and a scale
// below FLT_MIN becomes 0 -- then x/0 gives +-Inf and saturates to
// 127/-128, and 0/0 gives NaN and maps to 0.  This file compiles without
// --ftz and with --fmad=false, flushes explicitly where the reference
// does, multiplies, divides and fuses with __fmul_rn / __fdiv_rn /
// __fmaf_rn (IEEE round to nearest) and rounds with rintf (half to even),
// so the results equal the plain PyTorch versions beside the wrappers
// (heat_tpu_torch/comm/compressed.py) bit for bit.
//
// What bounds them: device-memory bytes.  Quantize reads 4 B and writes
// 1 + 4/128 B per value (5.03 B/value); dequantize the same the other
// way; dequantize_fma reads 4 B more (9.03 B/value); the hop kernel reads
// 4 + 1 + 4/128 B and writes 1 + 4/128 B (6.06 B/value).  A few tens of
// operations per value are far below the card's arithmetic rate, but not
// free: with the IEEE division, quantize's tail took about as long as the
// transfer.
//
// Design.  Dequantize only streams: one warp per 128-value row, each lane
// one 16-byte load, no shared memory; its writes are posted, so nothing
// waits on them.  Quantize must read a whole row before any of it can be
// written.  When every load of the payload is issued at once (one 16-byte
// load per thread, or one large copy per CTA), the memory system serves
// them interleaved, each lands near the end of the whole transfer, and
// every row's tail runs after it.  The quantize and hop kernels overlap
// the two instead:
//   * A grid sized to the card: at most kCtasPerSm CTAs per SM (fewer if
//     fewer fit), queried once per device, and never more CTAs than slabs
//     of kSlabRows rows; each CTA walks its slabs in a loop (a 4-row call
//     is one CTA).
//   * An asynchronous copy ring: one producer thread issues 1-D bulk
//     copies (cp.async.bulk, no tensor map) of each slab's rows -- and, for
//     the hop kernel, of its int8 payload rows -- in order, into a
//     kStages-deep ring in shared memory with full and empty mbarriers.  A
//     CTA's first slabs land early and are reduced while the rest fly.
//   * Consumer warps take turns: with 4-row slabs, warp w of kConsumerWarps
//     reduces the CTA's slabs w, w + kConsumerWarps, ...  8 lanes a row, 16
//     values a lane, 3 shuffles for the row's max.  A lane's float4 columns
//     are sub + 8 * ((j + rot) % 4): 8 lanes read 128 contiguous bytes (no
//     bank conflict), and the 4 rows of a warp read their int8 payload from
//     4 different banks.  A warp copies its rows into registers and
//     releases the stage (after fence.proxy.async) before its tail, so the
//     producer refills it meanwhile.  The int8 results go out as full
//     32-byte sectors (8 lanes x char4), the 4 scales of a warp as 16
//     contiguous bytes.
//   * A short tail: the max of |x| as integers (NaN above +Inf), the
//     quotient as RN(1/scale) * x with two exact FMA corrections (the IEEE
//     quotient, bit for bit: see quant_recip), and the rounding, clamp and
//     conversion in one cvt.rni.sat.s8.f32.
//   * Programmatic dependent launch: a launch's prologue (barriers, grid)
//     overlaps the end of the kernel before it on the stream when that
//     kernel lets its dependents start early, as these two do (PyTorch's
//     kernels do not, so on the ring, behind a roll, it overlaps
//     nothing); it touches global memory only after griddepcontrol.wait,
//     which returns once that kernel has completed and its writes are
//     visible -- the stream's order, kept.
// scripts/blockquant_variants.py times edited copies of this file: a
// register-only quantize (scripts/blockquant_registers.cuh: each warp
// loads 8 rows' float4s before it reduces any, no shared memory),
// __fdiv_rn for every quotient, other slab, stage, warp and CTA counts,
// and launches without programmatic dependent launch.

#include <cuda_runtime.h>

#include <float.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBlock = 128;        // values per row (one scale each)
constexpr float kInv127 = 1.0f / 127.0f;  // rounded to float32 at compile time
constexpr int kQuietNaN = 0x7fc00000;      // the scale of a row holding a NaN

// dequantize: one warp per row
constexpr int kLanesPerRow = 32;   // float4 per lane
constexpr int kRowsPerCta = 8;     // 256 threads per block
static_assert(kLanesPerRow * 4 == kBlock, "a warp covers one row");

// quantize and the hop: the slab ring
constexpr int kSlabRows = 4;       // rows per bulk copy (2 KB of f32)
constexpr int kStages = 16;        // slabs in flight per CTA
constexpr int kCtasPerSm = 2;      // the grid's cap, with the occupancy's
constexpr int kConsumerWarps = 8;  // plus one producer warp
constexpr int kStreamThreads = (kConsumerWarps + 1) * 32;
constexpr int kQLanes = 8;                  // lanes per row in the tail
constexpr int kSlots = kBlock / 4 / kQLanes;  // float4 per lane
constexpr int kRowsPerPass = 32 / kQLanes;   // rows a warp reduces at once
// The consumer warps split into groups of kWarpsPerSlab; group g takes the
// CTA's slabs g, g + kGroups, ...
constexpr int kWarpsPerSlab = kSlabRows / kRowsPerPass;
constexpr int kGroups = kConsumerWarps / kWarpsPerSlab;
constexpr int kMaxDevices = 64;
static_assert(kWarpsPerSlab * kRowsPerPass == kSlabRows && kGroups * kWarpsPerSlab == kConsumerWarps,
              "a slab is one pass of a whole group of warps");
static_assert(kSlots * kQLanes * 4 == kBlock && kRowsPerPass <= kSlots,
              "whole float4 slots; a warp's rows start on different slots");

template <bool kFused>
struct StreamSmem {
  static constexpr int kX = kSlabRows * kBlock * 4;           // f32 rows (the addend, fused)
  static constexpr int kQ = kFused ? kSlabRows * kBlock : 0;  // the incoming int8 payload
  static constexpr int kStage = kX + kQ;
  static constexpr int kBytes = kStages * kStage;
};

// Subnormal -> signed zero, as the reference's flush-to-zero does.
// NaN fails the comparison and passes through.
__device__ __forceinline__ float flush(float v) {
  return fabsf(v) < FLT_MIN ? copysignf(0.0f, v) : v;
}

// One NaN bit pattern: the GPU's arithmetic returns 0x7fffffff for a NaN
// result, the reference (and the plain versions) the quiet 0x7fc00000.
__device__ __forceinline__ float canon(float v) {
  return isnan(v) ? __int_as_float(kQuietNaN) : v;
}

// |v| as an unsigned integer: for non-negative floats the integers order
// like the values, and every NaN lies above +Inf, so an integer max is a
// max that propagates NaN.
__device__ __forceinline__ uint32_t abs_bits(float v) { return __float_as_uint(v) & 0x7fffffffu; }

__device__ __forceinline__ uint32_t abs_max4(float4 v) {
  return max(max(abs_bits(v.x), abs_bits(v.y)), max(abs_bits(v.z), abs_bits(v.w)));
}

// round_half_even(r) saturated to [-128, 127], NaN -> 0, in one
// conversion (cvt.rni.sat: round to nearest even, clamp, NaN to 0).
__device__ __forceinline__ signed char saturate(float r) {
  int q;
  asm("cvt.rni.sat.s8.f32 %0, %1;" : "=r"(q) : "f"(r));
  return static_cast<signed char>(q);
}

// round_half_even(flush(v) / scale), saturated, through the IEEE
// division: the path of a non-finite row (q = 1), a zero scale (+-Inf ->
// 127/-128, 0/0 -> 0) and a scale below kReciprocalMin.
__device__ __forceinline__ signed char quant(float v, float scale, bool finite) {
  return finite ? saturate(__fdiv_rn(flush(v), scale)) : 1;
}

// The same for a finite v and a scale in [kReciprocalMin, FLT_MAX], given
// y = RN(1/scale): two Newton corrections of v * y, each with the exact
// residual v - scale * q of a fused multiply-add.  The second starts
// within one ulp of v / scale, so by Markstein's theorem (y within half an
// ulp of 1/scale, q within one ulp of the quotient, the residual exact)
// it rounds to RN(v / scale): the IEEE quotient, bit for bit, in five
// branch-free instructions.  The residual is exact while its grid,
// 2^(e_scale + e_q - 46), stays above the subnormal floor 2^-149; a
// quotient under 1/2 rounds to 0 whatever its last bits, so e_q >= -1 and
// scale >= 2^-96 keep it there.  For the same reason v needs no flush
// here: a subnormal v over such a scale is far under 1/2.
constexpr float kReciprocalMin = 0x1p-96f;

__device__ __forceinline__ signed char quant_recip(float v, float scale, float y) {
  float q = __fmul_rn(v, y);
  q = __fmaf_rn(__fmaf_rn(-scale, q, v), y, q);
  q = __fmaf_rn(__fmaf_rn(-scale, q, v), y, q);
  return saturate(q);
}

// The decode-add prologue of the hop: fma(float(c), s, flush(a)) with s
// flushed, as dequantize_kernel<true> with sign +1.  Its flush of the sum
// happens in quantize_tail, and a NaN sum only makes the row's scale NaN
// (written canonical), so the bits of its NaN do not matter.
__device__ __forceinline__ float4 decode_add(float4 a, char4 c, float s) {
  return make_float4(__fmaf_rn(static_cast<float>(c.x), s, flush(a.x)),
                     __fmaf_rn(static_cast<float>(c.y), s, flush(a.y)),
                     __fmaf_rn(static_cast<float>(c.z), s, flush(a.z)),
                     __fmaf_rn(static_cast<float>(c.w), s, flush(a.w)));
}

// The float4 column of a row that a lane holds in slot j: 8 lanes cover
// 16 * kQLanes contiguous bytes per slot, and the rows of a warp (rot =
// lane / kQLanes) visit the slots in different orders.
__device__ __forceinline__ int column(int sub, int j, int rot) {
  return sub + kQLanes * ((j + rot) % kSlots);
}

// The tail of one row, on the 8 lanes that hold it (16 values each, in
// the slots of `column`): absmax over the 8 lanes, the scale, x / scale
// rounded and saturated; lanes of a live row store their 4 char4 and the
// row's first lane its scale.  Every lane of the warp must call it.
__device__ __forceinline__ void quantize_tail(const float4 (&v)[kSlots], char4* __restrict__ qrow,
                                              float* __restrict__ srow, int sub, int rot,
                                              bool live) {
  uint32_t mb = abs_max4(v[0]);
#pragma unroll
  for (int j = 1; j < kSlots; ++j) mb = max(mb, abs_max4(v[j]));
#pragma unroll
  for (int off = kQLanes / 2; off > 0; off >>= 1) {
    mb = max(mb, __shfl_xor_sync(0xffffffffu, mb, off));
  }
  // the max of the flushed values: flush is monotone in |x|
  const float m = flush(__uint_as_float(mb));

  const bool finite = isfinite(m);
  float s;
  if (isnan(m)) {
    s = __int_as_float(kQuietNaN);  // one NaN, whatever the input's payload
  } else if (!finite) {
    s = m;
  } else if (m > 0.0f) {
    s = flush(__fmul_rn(m, kInv127));
  } else {
    s = 1.0f;
  }
  if (!live) return;
  char4 out[kSlots];
  if (finite && s >= kReciprocalMin) {
    const float y = __frcp_rn(s);
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      out[j] = make_char4(quant_recip(v[j].x, s, y), quant_recip(v[j].y, s, y),
                          quant_recip(v[j].z, s, y), quant_recip(v[j].w, s, y));
    }
  } else {
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      out[j] = make_char4(quant(v[j].x, s, finite), quant(v[j].y, s, finite),
                          quant(v[j].z, s, finite), quant(v[j].w, s, finite));
    }
  }
#pragma unroll
  for (int j = 0; j < kSlots; ++j) qrow[column(sub, j, rot)] = out[j];
  if (sub == 0) *srow = s;
}

// Quantize (kFused false: x is the payload) or one ring hop (kFused true:
// x is the addend, q_in/s_in the incoming payload) over the slab ring.
template <bool kFused>
__global__ void __launch_bounds__(kStreamThreads)
quantize_stream_kernel(const float* __restrict__ x, const signed char* __restrict__ q_in,
                       const float* __restrict__ s_in, char4* __restrict__ q,
                       float* __restrict__ scale, int64_t rows) {
  using S = StreamSmem<kFused>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];  // full[kStages], then empty[kStages]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t slabs = (rows + kSlabRows - 1) / kSlabRows;
  const uint32_t full0 = smem_addr(bars);
  const uint32_t empty0 = full0 + 8 * kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kWarpsPerSlab);
    }
    fence_mbar_init();
  }
  __syncthreads();
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  if (warp == kConsumerWarps) {  // the producer: one thread issues every copy
    if (lane == 0) {
      int k = 0;
      for (int64_t slab = blockIdx.x; slab < slabs; slab += gridDim.x, ++k) {
        const int s = k % kStages;
        if (k >= kStages) mbar_wait(empty0 + 8 * s, (k / kStages - 1) & 1);
        const int64_t row0 = slab * kSlabRows;
        const uint32_t n =
            static_cast<uint32_t>(rows - row0 < kSlabRows ? rows - row0 : kSlabRows);
        const uint32_t dst = smem_addr(smem + s * S::kStage);
        mbar_arrive_expect_tx(full0 + 8 * s, n * (kBlock * 4 + (kFused ? kBlock : 0)));
        bulk_load(dst, x + row0 * kBlock, n * kBlock * 4, full0 + 8 * s);
        if constexpr (kFused) bulk_load(dst + S::kX, q_in + row0 * kBlock, n * kBlock, full0 + 8 * s);
      }
    }
    return;
  }

  const int rot = lane / kQLanes;
  const int r = (warp % kWarpsPerSlab) * kRowsPerPass + rot;  // row within the slab
  const int sub = lane % kQLanes;
  for (int k = warp / kWarpsPerSlab;; k += kGroups) {
    const int64_t slab = blockIdx.x + static_cast<int64_t>(k) * gridDim.x;
    if (slab >= slabs) break;
    const int s = k % kStages;
    const int64_t row = slab * kSlabRows + r;
    const bool live = row < rows;
    float sc = 0.0f;
    if constexpr (kFused) {
      if (live) sc = flush(s_in[row]);  // in flight while the slab lands
    }
    mbar_wait(full0 + 8 * s, (k / kStages) & 1);
    const unsigned char* stage = smem + s * S::kStage;
    const float4* xs = reinterpret_cast<const float4*>(stage) + r * (kBlock / 4);
    float4 v[kSlots];
    char4 c[kSlots];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      v[j] = xs[column(sub, j, rot)];
      if constexpr (kFused) {
        c[j] = reinterpret_cast<const char4*>(stage + S::kX)[r * (kBlock / 4) + column(sub, j, rot)];
      }
    }
    // the stage was read with ordinary loads: order them before the
    // producer's next bulk copy into it, then release it
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
    if constexpr (kFused) {
#pragma unroll
      for (int j = 0; j < kSlots; ++j) v[j] = decode_add(v[j], c[j], sc);
    }
    quantize_tail(v, q + row * (kBlock / 4), scale + row, sub, rot, live);
  }
}

// kFused == false: out = float(q) * scale.
// kFused == true:  out = flush(fma(sign * float(q), scale, flush(addend))).
// A NaN result is written as the quiet NaN 0x7fc00000.
template <bool kFused>
__global__ void __launch_bounds__(kRowsPerCta * kLanesPerRow)
dequantize_kernel(const char4* __restrict__ q, const float* __restrict__ scale,
                  const float4* __restrict__ addend, float sign,
                  float4* __restrict__ out, int64_t rows) {
  const int lane = threadIdx.x % kLanesPerRow;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerCta + threadIdx.x / kLanesPerRow;
  if (row >= rows) return;
  const int64_t i = row * kLanesPerRow + lane;

  const float s = flush(scale[row]);
  const char4 c = q[i];
  float4 r;
  if constexpr (kFused) {
    const float4 a = addend[i];
    r.x = canon(flush(__fmaf_rn(sign * static_cast<float>(c.x), s, flush(a.x))));
    r.y = canon(flush(__fmaf_rn(sign * static_cast<float>(c.y), s, flush(a.y))));
    r.z = canon(flush(__fmaf_rn(sign * static_cast<float>(c.z), s, flush(a.z))));
    r.w = canon(flush(__fmaf_rn(sign * static_cast<float>(c.w), s, flush(a.w))));
  } else {
    r.x = canon(__fmul_rn(static_cast<float>(c.x), s));
    r.y = canon(__fmul_rn(static_cast<float>(c.y), s));
    r.z = canon(__fmul_rn(static_cast<float>(c.z), s));
    r.w = canon(__fmul_rn(static_cast<float>(c.w), s));
  }
  out[i] = r;
}

inline dim3 grid_for(int64_t rows) {
  return dim3(static_cast<unsigned int>((rows + kRowsPerCta - 1) / kRowsPerCta));
}

// CTAs of `kernel` resident on the current device at once (per SM, at
// most cap_per_sm, x SMs), queried on a device's first call and cached;
// sets the kernel's dynamic shared memory limit first.  Returns a CUDA
// error code.
template <typename Kernel>
int resident_ctas(Kernel kernel, int threads, int smem, int cap_per_sm, int (&cache)[kMaxDevices],
                  int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices && cache[dev] > 0) {
    *out = cache[dev];
    return 0;
  }
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  *out = per_sm * sms > 0 ? per_sm * sms : 1;
  if (per_sm > cap_per_sm) *out = cap_per_sm * sms;
  if (dev < kMaxDevices) cache[dev] = *out;
  return 0;
}

// Launches quantize_stream_kernel<kFused> on `ctas` CTAs, with the
// programmatic-dependent-launch attribute.
template <bool kFused>
int launch_stream(int64_t ctas, cudaStream_t stream, const float* x, const signed char* q_in,
                  const float* s_in, char4* q, float* scale, int64_t rows) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(ctas));
  cfg.blockDim = dim3(kStreamThreads);
  cfg.dynamicSmemBytes = StreamSmem<kFused>::kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, quantize_stream_kernel<kFused>, x, q_in, s_in, q, scale, rows);
  return err != cudaSuccess ? static_cast<int>(err) : static_cast<int>(cudaGetLastError());
}

// The grid of a quantize (fused false) or hop (fused true) launch over
// `rows` rows: one CTA per slab, at most the CTAs resident at once.
template <bool kFused>
int stream_grid(int64_t rows, int64_t* ctas) {
  static int cache[kMaxDevices];
  int cap = 0;
  const int rc = resident_ctas(quantize_stream_kernel<kFused>, kStreamThreads,
                               StreamSmem<kFused>::kBytes, kCtasPerSm, cache, &cap);
  if (rc != 0) return rc;
  const int64_t slabs = (rows + kSlabRows - 1) / kSlabRows;
  *ctas = slabs < cap ? slabs : cap;
  return 0;
}

}  // namespace

// C interface, loaded with ctypes.  Pointers are device pointers (x,
// addend, out, and the hop kernel's q_in: 16-byte aligned; q: 4-byte
// aligned), rows >= 1, stream is the caller's cudaStream_t.  Each returns
// cudaGetLastError() after the launch (or the error of the first call's
// occupancy query); none synchronises or allocates.
extern "C" int blockquant_quantize(const void* x, void* q, void* scale, int64_t rows,
                                   void* stream) {
  int64_t ctas = 0;
  const int rc = stream_grid<false>(rows, &ctas);
  if (rc != 0) return rc;
  return launch_stream<false>(ctas, static_cast<cudaStream_t>(stream), static_cast<const float*>(x),
                              nullptr, nullptr, static_cast<char4*>(q), static_cast<float*>(scale),
                              rows);
}

extern "C" int blockquant_dequantize_add_quantize(const void* q_in, const void* s_in,
                                                  const void* addend, void* q, void* scale,
                                                  int64_t rows, void* stream) {
  int64_t ctas = 0;
  const int rc = stream_grid<true>(rows, &ctas);
  if (rc != 0) return rc;
  return launch_stream<true>(ctas, static_cast<cudaStream_t>(stream),
                             static_cast<const float*>(addend),
                             static_cast<const signed char*>(q_in), static_cast<const float*>(s_in),
                             static_cast<char4*>(q), static_cast<float*>(scale), rows);
}

// The grid of blockquant_quantize (fused == 0) or
// blockquant_dequantize_add_quantize (fused != 0) over `rows` rows, in
// CTAs; each CTA takes kSlabRows rows per step of its loop.
extern "C" int blockquant_grid(int64_t rows, int fused, int64_t* ctas, int* step_rows) {
  *step_rows = kSlabRows;
  return fused ? stream_grid<true>(rows, ctas) : stream_grid<false>(rows, ctas);
}

extern "C" int blockquant_dequantize(const void* q, const void* scale, void* out, int64_t rows,
                                     void* stream) {
  dequantize_kernel<false><<<grid_for(rows), kRowsPerCta * kLanesPerRow, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char4*>(q), static_cast<const float*>(scale), nullptr, 1.0f,
      static_cast<float4*>(out), rows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int blockquant_dequantize_fma(const void* q, const void* scale, const void* addend,
                                         float sign, void* out, int64_t rows, void* stream) {
  dequantize_kernel<true><<<grid_for(rows), kRowsPerCta * kLanesPerRow, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char4*>(q), static_cast<const float*>(scale),
      static_cast<const float4*>(addend), sign, static_cast<float4*>(out), rows);
  return static_cast<int>(cudaGetLastError());
}
