// Hopper (sm_90a) primitives for the hand-written kernels of this package:
// mbarriers, 1-D bulk copies, TMA tensor loads and stores, wgmma with its
// shared-memory descriptors and fences, and warpgroup register
// reallocation.  Each is a thin inline-PTX wrapper; the PTX ISA's names
// are kept so a reader can look each one up.  Included by csrc/*.cu (the
// library's hash covers it).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// One arrival that also announces `bytes` of TMA traffic on the barrier.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Returns once the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- bulk copy (1-D, no tensor map): `bytes` contiguous bytes from global
// to shared memory, completion counted on `bar`.  dst, src and bytes are
// multiples of 16.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// ---- TMA (a 4-D box between global and shared memory)
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit_and_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Orders this thread's ordinary shared-memory writes before later
// async-proxy (TMA, wgmma) accesses.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// bar.sync on a named barrier (id >= 1) over `threads` threads.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- warpgroup register reallocation (all four warps execute it)
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// ---- wgmma
// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle layout (1: 128 B, 2: 64 B).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes, uint32_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo_bytes >> 4) << 16) |
         (static_cast<uint64_t>(sbo_bytes >> 4) << 32) | (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pins the compiler's view of a register around the asynchronous wgmma:
// no read or write of `r` moves across this point.
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_operand(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// S = Q K^T: m64n128k16, A (Q) and B (K) from shared memory, both
// K-major; d (64 floats a thread) is the accumulator.
#define HOPPER_WGMMA_SS_N128(TY)                                                      \
  asm volatile(                                                                       \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                    \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"                   \
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"                        \
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"              \
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"              \
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"               \
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                                              \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                               \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                               \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                             \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                           \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                           \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                           \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                           \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),                           \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),                           \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),                           \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),                           \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),                           \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),                           \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),                           \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),                           \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                            \
      : "l"(da), "l"(db), "r"(scale_d))

// O += P V: m64n32k16, A (P) from registers, B (V) from shared memory,
// MN-major (the transpose flag); d (16 floats a thread) is the accumulator.
#define HOPPER_WGMMA_RS_TB_N32(TY)                                                    \
  asm volatile(                                                                       \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                                    \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {"                    \
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15"                         \
      "}, {%16,%17,%18,%19}, %20, p, 1, 1, 1;\n}\n"                                   \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                               \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                               \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                             \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])                            \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

// O += P V: m64n64k16, A (P) from registers, B (V) from shared memory,
// MN-major (the transpose flag); d (32 floats a thread) is the accumulator.
#define HOPPER_WGMMA_RS_TB_N64(TY)                                                    \
  asm volatile(                                                                       \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                    \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                    \
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"                        \
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"               \
      "}, {%32,%33,%34,%35}, %36, p, 1, 1, 1;\n}\n"                                   \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                               \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                               \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                             \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                           \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                           \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                           \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                           \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])                            \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

// O += P V: m64n128k16, A (P) from registers, B (V) from shared memory,
// MN-major (the transpose flag); d (64 floats a thread) is the accumulator.
#define HOPPER_WGMMA_RS_TB_N128(TY)                                                   \
  asm volatile(                                                                       \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                    \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"                   \
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"                        \
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"              \
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"              \
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"               \
      "}, {%64,%65,%66,%67}, %68, p, 1, 1, 1;\n}\n"                                   \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                               \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                               \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                             \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                           \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                           \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                           \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                           \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),                           \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),                           \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),                           \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),                           \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),                           \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),                           \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),                           \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),                           \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                            \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

// S = Q K^T for T = __nv_bfloat16 or __half.
template <typename T>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    HOPPER_WGMMA_SS_N128("bf16");
  } else {
    HOPPER_WGMMA_SS_N128("f16");
  }
}

// O += P V for T = __nv_bfloat16 or __half, N = 32, 64 or 128.
template <typename T, int N>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[N / 2], const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static_assert(N == 32 || N == 64 || N == 128, "wgmma_rs_tb: N is 32, 64 or 128");
  if constexpr (N == 32) {
    if constexpr (kBf16) {
      HOPPER_WGMMA_RS_TB_N32("bf16");
    } else {
      HOPPER_WGMMA_RS_TB_N32("f16");
    }
  } else if constexpr (N == 64) {
    if constexpr (kBf16) {
      HOPPER_WGMMA_RS_TB_N64("bf16");
    } else {
      HOPPER_WGMMA_RS_TB_N64("f16");
    }
  } else {
    if constexpr (kBf16) {
      HOPPER_WGMMA_RS_TB_N128("bf16");
    } else {
      HOPPER_WGMMA_RS_TB_N128("f16");
    }
  }
}

}  // namespace hopper
