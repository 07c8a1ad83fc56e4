// Flash-attention forward for Hopper (sm_90a) at head dim 128: TMA loads
// into 128-byte-swizzled shared tiles with mbarrier completion, both
// products on wgmma, the softmax state in registers.
//
//   o[b, h, i] = softmax_j(scale * q[b,h,i] . k[b,h//g,j] + bias[b,j]) v[b,h//g,j]
//
// The same function as the online form of attention.cu: bf16 in and out,
// fp32 softmax state; GQA (kv head = q head // group); causal masking
// with the diagonal at the sequence ends (key j visible to query i iff
// j <= i + Skv - Sq); keys at j >= kv_len masked; an optional fp32
// per-key bias [B, Skv]; optionally the fp32 logsumexp lse [B, Hq, Sq]
// (natural-log units) that the flash backward (attention_bwd.cu) reads.
// A row with no visible key writes O = 0 and lse = 0. Q, K and V are read
// through (batch, head, sequence) strides with a contiguous last dim, so
// fused-qkv column slices and transposed views need no copy; O is written
// through its strides into the [B, S, H, D] buffer the wrapper allocates.
//
// Replaces video_llava_seg_tpu/ops/attention.py::_flash_kernel (K2) at
// head dim 128: the Llama-3-8B prefill and the train step's forward and
// recompute. attention.cu keeps the other head dims and the two-pass
// form (K3).
//
// Bound on the card: at the 5.2k causal prefill the two products are
// 2 * 2 * Hq * D * (Sq * Skv / 2) operations, ~0.22 ms at the bf16 peak,
// against ~0.01 ms for the bytes of Q, K, V and O: compute-bound. The
// design keeps the tensor cores fed and everything else off their path:
//
// - A block is 3 warpgroups (384 threads). Warpgroup 0 is the producer:
//   it gives up registers (setmaxnreg.dec) and one of its threads issues
//   every TMA load. Warpgroups 1 and 2 are consumers of 64 query rows
//   each (BQ = 128) and take the registers the producer gave up
//   (setmaxnreg.inc). One block per SM (160 KB of shared memory).
// - Shared memory: the Q tile (128 x 128 bf16, 32 KB, loaded once) and a
//   two-stage ring of K and V tiles of 128 keys (4 x 32 KB). A 128-wide
//   bf16 row is 256 bytes, so each tile is two TMA boxes of 64 columns,
//   each row of a box one 128-byte swizzle row; TMA zero-fills rows past
//   the sequence end.
// - mbarriers: a "full" barrier per tile takes the TMA transaction bytes,
//   an "empty" barrier per stage the consumers' release. K and V have
//   their own, so S = Q K^T starts while V is still in flight.
// - S = Q K^T is wgmma m64n128k16 with both operands K-major in shared
//   memory. O += P V is wgmma m64n128k16 with A = P from registers (the
//   fp32 score accumulator converts pairwise into the bf16 A fragment)
//   and B = V read MN-major through the transpose bit. S (64 registers a
//   thread), P (32) and O (64) never leave registers.
// - Online softmax in registers: a row lives on a quad of lanes, so its
//   max takes two shuffles (its sum is reduced once, at the end); the O
//   rescale is a register multiply; only tiles that cross the causal
//   diagonal or kv_len are masked.
//
// Masking and the per-key bias. Without a bias the scores are kept in
// log2 units (one multiply, then ex2). With a bias they stay in natural
// units, s = scale * q.k + bias, and are scaled by log2(e) only after the
// running max is subtracted: the mask value -0.7 * FLT_MAX of a left-pad
// key overflows to -inf if scaled first, and a query row that sees only
// such keys would get -inf - -inf = NaN. Kept finite, all of that row's
// scores are equal, it gets the mean of its visible V rows and its lse is
// the mask value, as attention.cu gives it. Keys masked by the causal
// diagonal or kv_len are -inf and excluded.
//
// Later work: overlapping one tile's softmax with the next tile's QK^T
// inside a warpgroup, ping-pong between the two consumers, a persistent
// grid, packing a GQA group into one block, head dims 64/80/96.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 128;
constexpr int BQ = 128;      // query rows per block, 64 per consumer
constexpr int BKV = 128;     // keys per tile
constexpr int STAGES = 2;
constexpr int NT = 384;      // producer + two consumer warpgroups
constexpr int BOX_COLS = 64; // 64 bf16 = one 128-byte swizzle row
constexpr uint32_t BOX_BYTES = 128 * BOX_COLS * 2;  // 16 KB
constexpr uint32_t TILE_BYTES = 2 * BOX_BYTES;      // 32 KB
constexpr uint32_t Q_OFF = 0;
constexpr uint32_t K_OFF = Q_OFF + TILE_BYTES;
constexpr uint32_t V_OFF = K_OFF + STAGES * TILE_BYTES;
constexpr uint32_t BAR_OFF = V_OFF + STAGES * TILE_BYTES;
// barriers: q full; per stage k full, v full, k empty, v empty
constexpr int N_BARS = 1 + 4 * STAGES;
// + 1024: the swizzled tiles start on a 1024-byte boundary
constexpr size_t SMEM_BYTES = BAR_OFF + N_BARS * 8 + 1024;
constexpr int CONSUMER_WARPS = 8;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Params {
  __nv_bfloat16* o;
  const float* bias;
  float* lse;
  long long o_sb, o_sh, o_ss;
  long long bias_sb;
  int hq, hkv, sq, skv, kv_len;
  float scale;
  int causal;
};

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

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait for the phase of `parity` to complete. A wait here lasts at most
// one tile's work; one that has not completed after a second means a
// broken pipeline, and traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t t0 = 0;
  for (uint32_t spin = 1;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if ((spin & 1023u) == 0) {
      const uint64_t now = global_ns();
      if (t0 == 0) t0 = now;
      else if (now - t0 > 1000000000ull) __trap();
    }
  }
}

// one box of a 4-D tensor map (coordinates innermost first) -> shared,
// completing `bytes` on the mbarrier
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

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 =
// SWIZZLE_128B. K-major (Q, K): the stride offset steps 8 rows (1024
// bytes); the leading offset is unused. MN-major (V): the leading offset
// steps to the next 64 columns (the next box), the stride offset 8 keys.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
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

#define VLS_D64                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63}"
#define VLS_ACC64(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),             \
  "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),         \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),         \
  "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),         \
  "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),         \
  "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),         \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),         \
  "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),         \
  "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),         \
  "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),         \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),         \
  "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

#define VLS_OUT64(d)                                                          \
  "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),   \
  "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]),             \
  "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),         \
  "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]),         \
  "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]),         \
  "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]),         \
  "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),         \
  "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]), "=f"(d[40]),         \
  "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]),         \
  "=f"(d[46]), "=f"(d[47]), "=f"(d[48]), "=f"(d[49]), "=f"(d[50]),         \
  "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),         \
  "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]),         \
  "=f"(d[61]), "=f"(d[62]), "=f"(d[63])

// d = A B (the first k-step: d is only written, so the score tile is not
// live across the PV product) and d += A B, m64n128k16, A and B K-major
// in shared memory
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

// d += A B, m64n128k16, A (bf16 pairs) from registers, B MN-major in
// shared memory
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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <bool HAS_BIAS>
__global__ void __launch_bounds__(NT, 1)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const Params p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base + Q_OFF;
  const uint32_t bars = base + BAR_OFF;
  const uint32_t full_q = bars;
  auto k_s = [&](int s) { return base + K_OFF + s * TILE_BYTES; };
  auto v_s = [&](int s) { return base + V_OFF + s * TILE_BYTES; };
  auto k_full = [&](int s) { return bars + 8u * (1 + s); };
  auto v_full = [&](int s) { return bars + 8u * (1 + STAGES + s); };
  auto k_empty = [&](int s) { return bars + 8u * (1 + 2 * STAGES + s); };
  auto v_empty = [&](int s) { return bars + 8u * (1 + 3 * STAGES + s); };

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  // last query block first: under a causal mask it walks the most kv
  // tiles, so the longest blocks start earliest and the tail is short
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const int off = p.skv - p.sq;  // causal diagonal offset
  const int kv_lim = min(p.kv_len, p.skv);
  int kv_end = kv_lim;
  if (p.causal) kv_end = min(kv_end, q0 + BQ + off);
  const int n_tiles = kv_end > 0 ? (kv_end + BKV - 1) / BKV : 0;

  if (tid == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), CONSUMER_WARPS);
      mbar_init(v_empty(s), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------- producer ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (tid == 0 && n_tiles > 0) {
      mbar_expect_tx(full_q, TILE_BYTES);
      tma_load(q_s, &tm_q, full_q, 0, q0, h, b);
      tma_load(q_s + BOX_BYTES, &tm_q, full_q, BOX_COLS, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        const uint32_t ph = (t / STAGES) & 1;
        const int j0 = t * BKV;
        // the first pass over the ring finds every stage free
        mbar_wait(k_empty(s), ph ^ 1);
        mbar_expect_tx(k_full(s), TILE_BYTES);
        tma_load(k_s(s), &tm_k, k_full(s), 0, j0, hk, b);
        tma_load(k_s(s) + BOX_BYTES, &tm_k, k_full(s), BOX_COLS, j0, hk, b);
        mbar_wait(v_empty(s), ph ^ 1);
        mbar_expect_tx(v_full(s), TILE_BYTES);
        tma_load(v_s(s), &tm_v, v_full(s), 0, j0, hk, b);
        tma_load(v_s(s) + BOX_BYTES, &tm_v, v_full(s), BOX_COLS, j0, hk, b);
      }
    }
  } else {
    // ---------------- consumers ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int cw = wg - 1;
    const int ltid = tid - 128 * wg;
    const int warp = ltid / 32, lane = ltid % 32;
    // this thread's rows of the warpgroup's 64 (r0 and r0 + 8) and the
    // first of its column pair in every 8-column block of the
    // accumulators: d[4i + e] is (r0, 8i + cq + e), d[4i + 2 + e] is
    // (r0 + 8, 8i + cq + e)
    const int r0 = warp * 16 + lane / 4;
    const int cq = 2 * (lane % 4);
    const int qw0 = q0 + cw * 64;
    const int qi0 = qw0 + r0, qi1 = qi0 + 8;
    const uint32_t q_wg = q_s + cw * 64 * 128;  // 64 rows of 128 bytes
    const float sc = HAS_BIAS ? p.scale : p.scale * LOG2E;
    const float f = HAS_BIAS ? LOG2E : 1.f;
    const float* bias = HAS_BIAS ? p.bias + b * p.bias_sb : nullptr;

    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    // running max (log2 units, or natural with a bias) and this thread's
    // part of the row sum, for rows r0 and r0 + 8
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    if (n_tiles > 0) mbar_wait(full_q, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES;
      const uint32_t ph = (t / STAGES) & 1;
      const int j0 = t * BKV;

      // S = Q K^T: 8 k-steps of 16 columns, 4 in each 64-column box
      float sacc[64];
      mbar_wait(k_full(s), ph);
      wg_fence();
      wgmma_ss_first(sacc, desc_sw128(q_wg, 16, 1024),
                     desc_sw128(k_s(s), 16, 1024));
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk) {
        const uint32_t koff = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
        wgmma_ss(sacc, desc_sw128(q_wg + koff, 16, 1024),
                 desc_sw128(k_s(s) + koff, 16, 1024));
      }
      wg_commit();
      float bv[32];
      if constexpr (HAS_BIAS) {
        // this thread's 32 keys of the bias, fetched while S runs; one
        // base pointer per tile and immediate offsets, so no per-key
        // address stays live across the loop
        const float* bt = bias + j0 + cq;
        const int lim = p.skv - j0 - cq;
#pragma unroll
        for (int i = 0; i < 16; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            bv[2 * i + e] = 8 * i + e < lim ? __ldg(bt + 8 * i + e) : 0.f;
      }
      wg_wait_all();
      pin(sacc);
      if (lane == 0) mbar_arrive(k_empty(s));

#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if constexpr (HAS_BIAS) {
            sacc[4 * i + e] = fmaf(sacc[4 * i + e], sc, bv[2 * i + e]);
            sacc[4 * i + 2 + e] = fmaf(sacc[4 * i + 2 + e], sc, bv[2 * i + e]);
          } else {
            sacc[4 * i + e] *= sc;
            sacc[4 * i + 2 + e] *= sc;
          }
        }
      // only tiles that cross kv_len or this warpgroup's causal diagonal
      if (j0 + BKV > kv_lim || (p.causal && j0 + BKV - 1 > qw0 + off)) {
        // column c = 8i + e of this thread's pairs is key j0 + cq + c:
        // visible below kv_lim and, under the causal mask, up to the row's
        // diagonal
        const int big = 1 << 30;
        const int lim = kv_lim - j0 - cq;
        const int d0 = min(lim - 1, p.causal ? qi0 + off - j0 - cq : big);
        const int d1 = min(lim - 1, p.causal ? qi1 + off - j0 - cq : big);
#pragma unroll
        for (int i = 0; i < 16; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (8 * i + e > d0) sacc[4 * i + e] = -INFINITY;
            if (8 * i + e > d1) sacc[4 * i + 2 + e] = -INFINITY;
          }
      }

      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        mx0 = fmaxf(mx0, fmaxf(sacc[4 * i], sacc[4 * i + 1]));
        mx1 = fmaxf(mx1, fmaxf(sacc[4 * i + 2], sacc[4 * i + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      // a row with no visible key so far keeps p = 0 (exp of -inf - 0)
      const float mu0 = mx0 == -INFINITY ? 0.f : mx0;
      const float mu1 = mx1 == -INFINITY ? 0.f : mx1;
      const float alpha0 = ex2((m0 - mu0) * f);
      const float alpha1 = ex2((m1 - mu1) * f);
      m0 = mx0;
      m1 = mx1;

      uint32_t pa[32];
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float p00 = ex2((sacc[4 * i] - mu0) * f);
        const float p01 = ex2((sacc[4 * i + 1] - mu0) * f);
        const float p10 = ex2((sacc[4 * i + 2] - mu1) * f);
        const float p11 = ex2((sacc[4 * i + 3] - mu1) * f);
        rs0 += p00 + p01;
        rs1 += p10 + p11;
        pa[2 * i] = pack_bf16(p00, p01);
        pa[2 * i + 1] = pack_bf16(p10, p11);
      }
      l0 = l0 * alpha0 + rs0;
      l1 = l1 * alpha1 + rs1;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        o[4 * i] *= alpha0;
        o[4 * i + 1] *= alpha0;
        o[4 * i + 2] *= alpha1;
        o[4 * i + 3] *= alpha1;
      }

      // O += P V: 8 k-steps of 16 keys (2048 bytes of V each); the A
      // fragment of keys [16kk, 16kk + 16) is pa[4kk .. 4kk + 3]
      mbar_wait(v_full(s), ph);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        wgmma_rs(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                 pa[4 * kk + 3], desc_sw128(v_s(s) + kk * 2048, BOX_BYTES,
                                            1024));
      wg_commit();
      wg_wait_all();
      pin(o);
      pin(pa);
      if (lane == 0) mbar_arrive(v_empty(s));
    }

    // epilogue: the quad's row sums, O / l straight from registers
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
    const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
    __nv_bfloat16* og = p.o + b * p.o_sb + h * p.o_sh;
    if (qi0 < p.sq) {
      __nv_bfloat16* row = og + (long long)qi0 * p.o_ss + cq;
#pragma unroll
      for (int i = 0; i < 16; ++i)
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * i) =
            __floats2bfloat162_rn(o[4 * i] * inv0, o[4 * i + 1] * inv0);
    }
    if (qi1 < p.sq) {
      __nv_bfloat16* row = og + (long long)qi1 * p.o_ss + cq;
#pragma unroll
      for (int i = 0; i < 16; ++i)
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * i) =
            __floats2bfloat162_rn(o[4 * i + 2] * inv1, o[4 * i + 3] * inv1);
    }
    if (p.lse && (lane & 3) == 0) {
      // natural-log units: the running max is in log2 units without a bias
      float* lrow = p.lse + ((long long)b * p.hq + h) * p.sq;
      if (qi0 < p.sq)
        lrow[qi0] = l0 > 0.f ? (HAS_BIAS ? m0 : m0 * LN2) + logf(l0) : 0.f;
      if (qi1 < p.sq)
        lrow[qi1] = l1 > 0.f ? (HAS_BIAS ? m1 : m1 * LN2) + logf(l1) : 0.f;
    }
  }
}

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no link against libcuda
typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiledFn encode_fn() {
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

// geometry of one operand, as kernels.flash_sm90_tensor_map computes it:
// dims (D, S, H, B) innermost first, byte strides of S, H and B, box
constexpr int GEOM = 11;

int encode(CUtensorMap* map, const void* ptr, const long long* g) {
  if (g[0] != D || g[7] != BOX_COLS || g[8] != BKV || g[9] != 1 || g[10] != 1)
    return (int)cudaErrorInvalidValue;
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)g[0], (cuuint64_t)g[1],
                              (cuuint64_t)g[2], (cuuint64_t)g[3]};
  const cuuint64_t strides[3] = {(cuuint64_t)g[4], (cuuint64_t)g[5],
                                 (cuuint64_t)g[6]};
  const cuuint32_t box[4] = {(cuuint32_t)g[7], (cuuint32_t)g[8],
                             (cuuint32_t)g[9], (cuuint32_t)g[10]};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  // a refused geometry: the negated driver error
  return r == CUDA_SUCCESS ? 0 : -(int)r;
}

}  // namespace

// geom: 3 x 11 int64 (q, k, v), each dims[4], byte strides[3], box[4]
extern "C" int vls_flash_fwd_sm90(
    const void* q, const void* k, const void* v, void* o, const void* bias,
    void* lse, const long long* geom, long long o_sb, long long o_sh,
    long long o_ss, long long bias_sb, int kv_len, int causal, float scale,
    void* stream) {
  const long long* gq = geom;
  const long long* gk = geom + GEOM;
  const long long* gv = geom + 2 * GEOM;
  const int batch = (int)gq[3];
  if (batch <= 0 || gq[1] <= 0) return 0;
  for (int i = 0; i < 4; ++i)
    if (gk[i] != gv[i]) return (int)cudaErrorInvalidValue;
  if (gk[3] != batch || gk[2] <= 0 || gq[2] % gk[2])
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  int e = encode(&tq, q, gq);
  if (e == 0) e = encode(&tk, k, gk);
  if (e == 0) e = encode(&tv, v, gv);
  if (e != 0) return e;
  Params p;
  p.o = (__nv_bfloat16*)o;
  p.bias = (const float*)bias;
  p.lse = (float*)lse;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.bias_sb = bias_sb;
  p.hq = (int)gq[2]; p.hkv = (int)gk[2];
  p.sq = (int)gq[1]; p.skv = (int)gk[1];
  p.kv_len = kv_len;
  p.scale = scale;
  p.causal = causal;
  auto kern = bias ? flash_fwd_sm90<true> : flash_fwd_sm90<false>;
  const cudaError_t a = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (a != cudaSuccess) return (int)a;
  dim3 grid((p.sq + BQ - 1) / BQ, p.hq, batch);
  kern<<<grid, NT, SMEM_BYTES, (cudaStream_t)stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}
