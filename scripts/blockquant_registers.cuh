// A register-only quantize: the design the slab ring of
// heat_tpu_torch/csrc/blockquant.cu is measured against.  Each warp
// loads kRegRows rows' float4s into registers before it reduces any of
// them, kRowsPerPass at a time, with no shared memory and a grid capped
// at the CTAs resident at once.
//
// Not part of the library: scripts/blockquant_variants.py (variant
// "registers") includes this file into an edited copy of blockquant.cu,
// inside its anonymous namespace, and routes blockquant_quantize and
// blockquant_grid(fused = 0) to quantize_registers and registers_grid.

constexpr int kRegRows = 8;  // rows a warp loads before its first tail
constexpr int kRegThreads = 256;
static_assert(kRegRows % kRowsPerPass == 0, "whole passes");

__global__ void __launch_bounds__(kRegThreads)
quantize_reg_kernel(const float4* __restrict__ x, char4* __restrict__ q,
                    float* __restrict__ scale, int64_t rows) {
  constexpr int kPasses = kRegRows / kRowsPerPass;
  const int lane = threadIdx.x % 32;
  const int rot = lane / kQLanes;
  const int sub = lane % kQLanes;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (kRegThreads / 32);
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * (kRegThreads / 32) + threadIdx.x / 32;
       g * kRegRows < rows; g += warps) {
    float4 v[kPasses][kSlots];
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int64_t row = g * kRegRows + p * kRowsPerPass + rot;
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        v[p][j] = row < rows ? x[row * (kBlock / 4) + column(sub, j, rot)] : make_float4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int64_t row = g * kRegRows + p * kRowsPerPass + rot;
      quantize_tail(v[p], q + row * (kBlock / 4), scale + row, sub, rot, row < rows);
    }
  }
}

int registers_grid(int64_t rows, int64_t* ctas, int* step_rows) {
  static int cache[kMaxDevices];
  int cap = 0;
  const int rc = resident_ctas(quantize_reg_kernel, kRegThreads, 0, 64, cache, &cap);
  if (rc != 0) return rc;
  *step_rows = kRegRows * (kRegThreads / 32);
  const int64_t steps = (rows + *step_rows - 1) / *step_rows;
  *ctas = steps < cap ? steps : cap;
  return 0;
}

int quantize_registers(const void* x, void* q, void* scale, int64_t rows, void* stream) {
  int64_t ctas = 0;
  int step = 0;
  const int rc = registers_grid(rows, &ctas, &step);
  if (rc != 0) return rc;
  quantize_reg_kernel<<<static_cast<unsigned int>(ctas), kRegThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<char4*>(q), static_cast<float*>(scale), rows);
  return static_cast<int>(cudaGetLastError());
}
