// Hopper (sm_90a) building blocks shared by the TMA + wgmma kernels,
// attention_sm90.cu (forward), attention_bwd_sm90.cu (backward),
// attention_short_sm90.cu (K3), w4a8_sm90.cu (K5's prefill),
// w4a8_gemv_sm90.cu (K5's decode: mbarriers and TMA only),
// w8a8_sm90.cu (gemm_s8), gemm_bf16_sm90.cu (the bf16 denses of K1 and
// K4), window_attention_sm90.cu (K7), layernorm_sm90.cu and pool_sm90.cu
// (mbarriers and 1-D bulk copies only): mbarrier waits that trap instead
// of hanging, TMA tile loads (5-D, 4-D and 2-D) and 1-D bulk copies,
// 128-, 64- and 32-byte-swizzle wgmma descriptors, the wgmma forms the
// files use, and the tensor-map encoding through the runtime's driver
// entry point (no link against libcuda). Included by each .cu;
// kernels/__init__.py hashes it with the sources, so an edit rebuilds the
// library.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

// the low 32 bits of the global nanosecond timer: a difference of two
// readings is exact below 2^32 ns (4.3 s) across a wrap, and costs half
// the registers of the 64-bit timer (the producers run at 24)
__device__ __forceinline__ uint32_t global_ns_lo() {
  uint32_t t;
  asm volatile("mov.u32 %0, %%globaltimer_lo;" : "=r"(t));
  return t;
}

// Wait for the phase of `parity` to complete. A wait here lasts at most
// one tile's work; one that has not completed after a second means a
// broken pipeline, and traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t t0 = 0;
  for (uint32_t spin = 1;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if ((spin & 1023u) == 0) {
      const uint32_t now = global_ns_lo();
      if (t0 == 0) t0 = now;
      else if (now - t0 > 1000000000u) __trap();
    }
  }
}

// one box of a 4-D tensor map (coordinates innermost first) -> shared,
// completing its bytes on the mbarrier
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// the same for a 5-D tensor map
__device__ __forceinline__ void tma_load_5d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// one box of a 2-D tensor map (coordinates innermost first) -> shared
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1)
      : "memory");
}

// contiguous global bytes -> shared, completing on the mbarrier (a 1-D
// bulk copy, TMA without a tensor map: 16-byte aligned addresses, a
// multiple of 16 bytes)
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 =
// SWIZZLE_128B. K-major (rows along M or N, the reduction contiguous):
// the stride offset steps 8 rows (1024 bytes); the leading offset is
// unused. MN-major (rows along the reduction, M or N contiguous): the
// leading offset steps to the next 64 columns (the next box), the stride
// offset 8 rows.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// the same for a 32-byte-swizzled operand (layout 3 = SWIZZLE_32B), whose
// rows are 32 bytes (16 bf16, one k16 step): K-major, the stride offset
// steps 8 rows (256 bytes); MN-major (16 bf16 of M or N a row, rows along
// the reduction), the stride offset steps 8 reduction rows and the
// leading offset the next 16 columns of M or N
__device__ __forceinline__ uint64_t desc_sw32(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (3ull << 62);
}

// the same for a 64-byte-swizzled operand (layout 2 = SWIZZLE_64B), whose
// rows are 64 bytes (32 bf16, two k16 steps): K-major, the stride offset
// steps 8 rows (512 bytes); MN-major (32 bf16 of M or N a row), the
// stride offset steps 8 reduction rows and the leading offset the next
// 32 columns of M or N
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (2ull << 62);
}

// the descriptor of an operand whose rows are `cols` bf16 wide under the
// swizzle of that width (64 -> 128 bytes, 32 -> 64, 16 -> 32)
template <int COLS>
__device__ __forceinline__ uint64_t desc_cols(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  static_assert(COLS == 64 || COLS == 32 || COLS == 16, "box width");
  if constexpr (COLS == 64) return desc_sw128(addr, lbo, sbo);
  else if constexpr (COLS == 32) return desc_sw64(addr, lbo, sbo);
  else return desc_sw32(addr, lbo, sbo);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// Tie registers to this point, so that the compiler neither reads an
// accumulator before wgmma.wait_group nor reuses an A register while the
// product that reads it is in flight.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

#define VLS_D32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31}"

#define VLS_ACC32(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), \
  "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), \
  "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), \
  "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

#define VLS_OUT32(d) \
  "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), \
  "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), \
  "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), \
  "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), \
  "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), \
  "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])

#define VLS_D64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, " \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

#define VLS_ACC64(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), \
  "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), \
  "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), \
  "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), \
  "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
  "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), \
  "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
  "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), \
  "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), \
  "+f"(d[62]), "+f"(d[63])

#define VLS_OUT64(d) \
  "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), \
  "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), \
  "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), \
  "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), \
  "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), \
  "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]), \
  "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), \
  "=f"(d[37]), "=f"(d[38]), "=f"(d[39]), "=f"(d[40]), "=f"(d[41]), \
  "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), \
  "=f"(d[47]), "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), \
  "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]), "=f"(d[56]), \
  "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), \
  "=f"(d[62]), "=f"(d[63])

#define VLS_ACC8(d, o) \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), \
  "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])

#define VLS_D16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15}"

#define VLS_D40 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}"

#define VLS_D48 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, " \
  "%41, %42, %43, %44, %45, %46, %47}"

// Accumulator layout of a wgmma m64nN tile in a warpgroup: the thread of
// warp w, lane l holds rows r0 = 16 w + l / 4 and r0 + 8; d[4i + e] is
// (r0, 8i + 2 (l % 4) + e), d[4i + 2 + e] is (r0 + 8, the same column).
// The A fragment of a register-A wgmma over reduction columns
// [16kk, 16kk + 16) of such a tile, packed pairwise to bf16, is
// {pack(d[8kk], d[8kk+1]), pack(d[8kk+2], d[8kk+3]), pack(d[8kk+4],
// d[8kk+5]), pack(d[8kk+6], d[8kk+7])}.

// d = A B (the first k-step: d is only written) and d += A B,
// m64n128k16, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_first(float (&d)[64], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " VLS_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}"
      : VLS_OUT64(d)
      : "l"(da), "l"(db), "r"(0));
}
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " VLS_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}"
      : VLS_ACC64(d)
      : "l"(da), "l"(db), "r"(1));
}

// the same at m64n64k16 (a 64 x 64 score tile)
__device__ __forceinline__ void wgmma_ss64_first(float (&d)[32], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VLS_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}"
      : VLS_OUT32(d)
      : "l"(da), "l"(db), "r"(0));
}
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VLS_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}"
      : VLS_ACC32(d)
      : "l"(da), "l"(db), "r"(1));
}

// d += A B at m64n64k16 under the name the m64n128k16 form has, so a
// template on the score tile's width calls one name
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  wgmma_ss64(d, da, db);
}

// d = A B at m64n8k16, m64n16k16 and m64n32k16 (a score tile of 8, 16 or
// 32 keys over one k16 step), A and B K-major in shared memory; the
// accumulator's size picks the form
__device__ __forceinline__ void wgmma_ss_first(float (&d)[4], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %6, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "l"(da), "l"(db), "r"(0));
}
__device__ __forceinline__ void wgmma_ss_first(float (&d)[8], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %10, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
        "=f"(d[5]), "=f"(d[6]), "=f"(d[7])
      : "l"(da), "l"(db), "r"(0));
}
__device__ __forceinline__ void wgmma_ss_first(float (&d)[16], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
        "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
        "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
        "=f"(d[15])
      : "l"(da), "l"(db), "r"(0));
}
__device__ __forceinline__ void wgmma_ss_first(float (&d)[32], uint64_t da,
                                               uint64_t db) {
  wgmma_ss64_first(d, da, db);
}

// d += A B, m64n64k16, A K-major and B MN-major (the transpose bit) in
// shared memory
__device__ __forceinline__ void wgmma_ss64_tb(float (&d)[32], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VLS_D32
      ", %32, %33, p, 1, 1, 0, 1;\n}"
      : VLS_ACC32(d)
      : "l"(da), "l"(db), "r"(1));
}

// d = A B (scale_d 0) or d += A B (scale_d 1), m64n128k16, A K-major and
// B MN-major (the transpose bit) in shared memory: a dense's [in, out]
// weights as they sit in the tree
__device__ __forceinline__ void wgmma_ss_tb(float (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " VLS_D64
      ", %64, %65, p, 1, 1, 0, 1;\n}"
      : VLS_ACC64(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A B, m64n128k16, A (bf16 pairs) from registers, B MN-major in
// shared memory (the transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " VLS_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}"
      : VLS_ACC64(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// the same at N = 16, 32, 64, 80 and 96 (N = 2 x the accumulator's size
// picks the form): the O += P V step of a head dim, or of one box of it
__device__ __forceinline__ void wgmma_rs(float (&d)[8], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "1;\n}"
      : VLS_ACC8(d, 0)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[16], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " VLS_D16
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}"
      : VLS_ACC8(d, 0), VLS_ACC8(d, 8)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VLS_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
      : VLS_ACC32(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[40], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %45, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 " VLS_D40
      ", {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}"
      : VLS_ACC32(d), VLS_ACC8(d, 32)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[48], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %53, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 " VLS_D48
      ", {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}"
      : VLS_ACC32(d), VLS_ACC8(d, 32), VLS_ACC8(d, 40)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

#define VLS_D128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
  "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, " \
  "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, " \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, " \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, " \
  "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, " \
  "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, " \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, " \
  "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, " \
  "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, " \
  "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"

#define VLS_ACC128(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
  "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
  "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
  "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
  "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
  "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
  "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), \
  "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
  "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
  "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), \
  "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), \
  "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), \
  "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
  "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), \
  "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), \
  "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), \
  "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), \
  "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), \
  "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), \
  "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), \
  "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
  "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), \
  "+f"(d[125]), "+f"(d[126]), "+f"(d[127])

// d += A B, m64n256k16, A (bf16 pairs) from registers, B MN-major in
// shared memory (the transpose bit): the O += P V step of head dim 256,
// whose 256 columns of V span four 64-column boxes (the leading offset
// steps box to box)
__device__ __forceinline__ void wgmma_rs(float (&d)[128], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " VLS_D128
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}"
      : VLS_ACC128(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

#define VLS_IACC64(d) \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), \
  "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), \
  "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), \
  "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), \
  "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), \
  "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), \
  "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), \
  "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), \
  "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), \
  "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), \
  "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), \
  "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), \
  "+r"(d[62]), "+r"(d[63])

// d += A B in int32, m64n128k32, A (4 x 4 int8 a thread, the layout of
// mma.sync m16n8k32's A: rows lane / 4 and + 8 of the warp's 16, bytes
// 4 (lane % 4) .. + 3 and + 16) from registers, B K-major in shared
// memory. 8-bit wgmma has no transpose bit: both operands are K-major.
// No .satfinite: the callers' sums stay inside int32.
__device__ __forceinline__ void wgmma_rs_s8(uint32_t (&d)[64],
                                            const uint32_t* a,
                                            uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " VLS_D64
      ", {%64, %65, %66, %67}, %68, p;\n}"
      : VLS_IACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no link against libcuda
typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// cuTensorMapEncodeTiled on a thread with no current context returns
// CUDA_ERROR_INVALID_CONTEXT; autograd's backward thread has none until
// its first runtime call. cudaFree(nullptr) binds the device's primary
// context to the thread, and the encoding is tried once more.
template <typename Encode>
inline CUresult encode_bound(Encode encode) {
  CUresult r = encode();
  if (r == CUDA_ERROR_INVALID_CONTEXT) {
    cudaFree(nullptr);
    r = encode();
  }
  return r;
}

// geometry of one bf16 operand, as kernels.flash_sm90_tensor_map computes
// it: dims (D, S, H, B) innermost first, byte strides of S, H and B, box
constexpr int GEOM = 11;

// Encode one operand's tensor map with the given swizzle after checking
// its head dim and box (innermost first) against what the kernel was
// written for. A refused geometry returns the negated CUresult.
inline int encode_bf16_box(CUtensorMap* map, const void* ptr,
                           const long long* g, int d, const int (&box)[4],
                           CUtensorMapSwizzle swizzle) {
  if (g[0] != d) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 4; ++i)
    if (g[7 + i] != box[i]) return (int)cudaErrorInvalidValue;
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)g[0], (cuuint64_t)g[1],
                              (cuuint64_t)g[2], (cuuint64_t)g[3]};
  const cuuint64_t strides[3] = {(cuuint64_t)g[4], (cuuint64_t)g[5],
                                 (cuuint64_t)g[6]};
  const cuuint32_t bx[4] = {(cuuint32_t)g[7], (cuuint32_t)g[8],
                            (cuuint32_t)g[9], (cuuint32_t)g[10]};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode_bound([&] {
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
              const_cast<void*>(ptr), dims, strides, bx, elem,
              CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  });
  return r == CUDA_SUCCESS ? 0 : -(int)r;
}

// the 128-byte-swizzled map of one head and batch row: a box of box_cols
// columns by box_rows rows
inline int encode_bf16(CUtensorMap* map, const void* ptr, const long long* g,
                       int d, int box_cols, int box_rows) {
  const int box[4] = {box_cols, box_rows, 1, 1};
  return encode_bf16_box(map, ptr, g, d, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// geometry of one 2-D operand, as kernels.w4a8_sm90_geometry,
// gemm_s8_sm90_geometry and gemm_bf16_sm90_geometry compute it: byte
// offset of the map's base, dims (inner, outer) in elements, the outer
// byte stride, box (inner, outer)
constexpr int GEOM_2D = 6;

// Encode a 2-D tensor map of `type` at ptr + g[0] (128-byte swizzle
// unless another is named) after checking its box against what the
// kernel was written for. A refused geometry returns the negated
// CUresult.
inline int encode_2d(CUtensorMap* map, const void* ptr, const long long* g,
                     int box_inner, int box_outer, CUtensorMapDataType type,
                     CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  if (g[0] < 0 || g[4] != box_inner || g[5] != box_outer)
    return (int)cudaErrorInvalidValue;
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)g[1], (cuuint64_t)g[2]};
  const cuuint64_t strides[1] = {(cuuint64_t)g[3]};
  const cuuint32_t box[2] = {(cuuint32_t)g[4], (cuuint32_t)g[5]};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode_bound([&] {
    return fn(map, type, 2, (void*)((const char*)ptr + g[0]), dims, strides,
              box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  });
  return r == CUDA_SUCCESS ? 0 : -(int)r;
}

}  // namespace
