// Block-scaled int8 quantization of collective payloads, for Hopper (sm_90a).
//
// blockquant_quantize replaces the TPU kernel _q_kernel launched by
// quantize_blocks (heat_tpu/comm/compressed.py); blockquant_dequantize and
// blockquant_dequantize_fma replace _dq_kernel launched by
// dequantize_blocks (same file), the second fused with the addition that
// follows the decode.  They run on every hop of the int8_block ring
// allreduce and in the error-feedback round trip.
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
// sign -1: the error-feedback residual c - deQ(Q(c))).
//
// Bit parity with the reference.  Its compiled programs scale by the
// float32 constant 1/127 (XLA rewrites the division by the constant 127
// into that product), divide x / scale exactly, and contract a decode
// followed by an addition or subtraction into one fused multiply-add
// (hence the fused kernel).  It runs with
// subnormals flushed to zero (inputs and results), so: subnormal inputs
// count as zero, and a scale below FLT_MIN becomes 0 -- then x/0 gives
// +-Inf and saturates to 127/-128, and 0/0 gives NaN and maps to 0.  This
// file compiles without --ftz and flushes explicitly where the reference
// does, multiplies, divides and fuses with __fmul_rn / __fdiv_rn /
// __fmaf_rn (IEEE round to nearest) and rounds with rintf (half to even),
// so the results equal the plain PyTorch versions beside the wrappers
// (heat_tpu_torch/comm/compressed.py) bit for bit.
//
// What bounds them: device-memory bytes.  Quantize reads 4 B and writes
// 1 + 4/128 B per value (5.03 B/value); dequantize the same the other
// way; the fused form reads 4 B more (9.03 B/value).  A handful of
// operations per value is far below the card's
// arithmetic rate, so the design only has to stream: one warp per
// 128-value row, each lane one 16-byte float4 load (a warp reads 512
// contiguous bytes), a shuffle-xor max across the warp, one 32-bit store
// of four int8 per lane, lane 0 writes the scale.  No shared memory, no
// synchronisation beyond the warp, any row count >= 1.

#include <cuda_runtime.h>

#include <float.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;        // values per row (one scale each)
constexpr int kLanesPerRow = 32;   // one warp per row, float4 per lane
constexpr int kRowsPerCta = 8;     // 256 threads per block
constexpr float kInv127 = 1.0f / 127.0f;  // rounded to float32 at compile time
constexpr int kQuietNaN = 0x7fc00000;      // the scale of a row holding a NaN
static_assert(kLanesPerRow * 4 == kBlock, "a warp covers one row");

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

// max that propagates NaN (fmaxf would drop it).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

__device__ __forceinline__ signed char quant(float v, float scale, bool finite) {
  if (!finite) return 1;
  float r = __fdiv_rn(v, scale);
  if (isnan(r)) return 0;
  r = fminf(fmaxf(rintf(r), -128.0f), 127.0f);
  return static_cast<signed char>(static_cast<int>(r));
}

__global__ void __launch_bounds__(kRowsPerCta * kLanesPerRow)
quantize_kernel(const float4* __restrict__ x, char4* __restrict__ q,
                float* __restrict__ scale, int64_t rows) {
  const int lane = threadIdx.x % kLanesPerRow;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerCta + threadIdx.x / kLanesPerRow;
  if (row >= rows) return;  // uniform across the warp: row is per warp
  const int64_t i = row * kLanesPerRow + lane;

  float4 v = x[i];
  v.x = flush(v.x);
  v.y = flush(v.y);
  v.z = flush(v.z);
  v.w = flush(v.w);
  float m = nan_max(nan_max(fabsf(v.x), fabsf(v.y)), nan_max(fabsf(v.z), fabsf(v.w)));
#pragma unroll
  for (int off = kLanesPerRow / 2; off > 0; off >>= 1) {
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  }

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

  char4 out;
  out.x = quant(v.x, s, finite);
  out.y = quant(v.y, s, finite);
  out.z = quant(v.z, s, finite);
  out.w = quant(v.w, s, finite);
  q[i] = out;
  if (lane == 0) scale[row] = s;
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

}  // namespace

// C interface, loaded with ctypes.  Pointers are device pointers (x,
// addend, out: 16-byte aligned; q: 4-byte aligned), rows >= 1, stream is
// the caller's cudaStream_t.  Each returns cudaGetLastError() after the
// launch; none synchronises or allocates.
extern "C" int blockquant_quantize(const void* x, void* q, void* scale, int64_t rows,
                                   void* stream) {
  quantize_kernel<<<grid_for(rows), kRowsPerCta * kLanesPerRow, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<char4*>(q), static_cast<float*>(scale), rows);
  return static_cast<int>(cudaGetLastError());
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
