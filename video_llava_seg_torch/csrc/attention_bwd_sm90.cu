// Flash-attention backward for Hopper (sm_90a) at head dim 128: TMA loads
// into 128-byte-swizzled shared tiles with mbarrier completion, every
// product on wgmma, the score tiles in registers.
//
// The gradients of attention_sm90.cu's forward,
//
//   o[b, h, i] = softmax_j(scale * q[b,h,i] . k[b,h//g,j] + bias[b,j]) v[b,h//g,j]
//
// from its output O, its logsumexp lse (natural-log units) and dO:
//
//   delta_i = sum_d dO_id O_id                      (fp32)
//   p_ij    = exp(scale * q_i . k_j + bias_j - lse_i)
//   dp_ij   = dO_i . v_j
//   ds_ij   = p_ij (dp_ij - delta_i) scale          (rounded to bf16)
//   dQ_i    = sum_j ds_ij k_j                       (K6a)
//   dK_j    = sum_(h in group, i) ds_ij q_i         (K6b)
//   dV_j    = sum_(h in group, i) p_ij dO_i         (K6b, p rounded to bf16)
//
// The conventions of attention_bwd.cu, which keeps the other head dims:
// bf16 in and out, fp32 state; GQA (kv head = q head // group); causal
// masking with the diagonal at the sequence ends (key j visible to query
// i iff j <= i + Skv - Sq); an optional fp32 per-key bias [B, Skv]; Q, K,
// V and dO read through (batch, head, sequence) strides with a contiguous
// last dim, so fused-qkv column slices and the head-merge view of dO need
// no copy; dQ written into a [B, Sq, Hq, D] buffer and dK / dV into
// [B, Skv, Hkv, D] buffers that the wrappers allocate, through their
// strides. A key that the bias masks gets exactly 0 in dK and dV unless
// a query row sees no other key (then its p is 1, as in attention_bwd.cu).
//
// Replaces video_llava_seg_tpu/ops/attention.py::_bwd_dq_kernel (K6a)
// and ::_bwd_dkv_kernel (K6b) at head dim 128: the Llama-3-8B layers of
// the train step.
//
// Bound on the card: at the train step's causal S = 5,132 with 32 q
// heads, K6a's three products (S, dP, dQ) and K6b's four (S^T, dP^T, dV,
// dK) are 3 and 4 x 2 * Hq * D * S^2 / 2 operations, 0.33 and 0.44 ms at
// the bf16 peak, against ~0.01 ms for the bytes: compute-bound. The
// design keeps the tensor cores fed from shared memory that TMA fills:
//
// - A block is 3 warpgroups (384 threads). Warpgroup 0 is the producer:
//   it gives up registers (setmaxnreg.dec) and its thread 0 issues every
//   TMA load; in K6b its warp 1 also stages each query tile's lse and
//   delta in shared memory. Warpgroups 1 and 2 are consumers
//   (setmaxnreg.inc). One block per SM (129 KB of shared memory for K6a,
//   162 KB for K6b).
// - K6a (dQ): a block owns 128 query rows of one (batch, q head). Q and
//   dO are loaded once; the block walks a two-stage ring of 64-key K and V
//   tiles. The delta pre-pass is the consumers' prologue: each quad of
//   lanes sums dO * O over its two rows from global memory while the first
//   tiles load, keeps delta in registers and writes it out for K6b.
//   S = Q K^T and dP = dO V^T are wgmma m64n64k16 with both operands
//   K-major; dQ += dS K is m64n128k16 with dS from registers and K read
//   MN-major through the transpose bit (the forward's P V).
// - K6b (dK, dV): a block owns 64 keys of one (batch, kv head). K and V
//   are loaded once; the block walks the group's q heads and their 64-row
//   query tiles through a two-stage ring of Q, dO and lse / delta tiles,
//   so the GQA sum stays in the block (no atomics). The products are
//   formed transposed, the query as the N dimension: consumer 0 forms
//   S^T = K Q^T and P^T, consumer 1 dP^T = V dO^T and, from P^T, dS^T
//   (the same wgmma instructions with other operands, so neither issues
//   them on a divergent path). They hand P^T and dS^T over through
//   shared memory: bf16 in 128-byte-swizzled 64 x 64 tiles (the layout
//   TMA gives, so the usual descriptors read them) and P^T also in fp32
//   for dS^T, double-buffered by the walk's parity and ordered by named
//   barriers after a proxy fence. Each consumer then accumulates its
//   64-column half of dV += P^T dO and dK += dS^T Q, A K-major from the
//   hand-over tiles and B its half of dO and Q, MN-major.
// - Registers set that split. Holding all of dK and dV (128 fp32 a
//   thread) beside S^T, dP^T and their bf16 A fragments made ptxas spill
//   and serialize every wgmma of a 128-key K6b block; with halves of dK
//   and dV (64) beside one 64 x 64 tile (32), nothing spills. K6a holds
//   dQ (64) beside S and dP (64) and keeps dS in registers as the A
//   operand of dQ += dS K (the forward's P V). Every operand is loaded as
//   64 x 64 boxes (one 128-byte swizzle row of 64 bf16 columns), two per
//   64-row tile, four per 128-row tile.
// - In K6a, S is issued before dP and the exponentials of S overlap the
//   dP product; in K6b the two consumers' S^T and dP^T products run side
//   by side. Causal tiles that no row sees are skipped; only tiles that
//   cross the diagonal (or, in K6a, the key end) are masked. Query rows
//   past Sq get lse = +inf, so their p is exactly 0.
// - The longest blocks start first: K6a's last query tiles and K6b's
//   first key tiles walk the most tiles under a causal mask.
//
// The mask value. The exponent stays in natural units with a bias, as in
// the forward: (scale * q.k + bias - lse) * log2(e), so a left-pad row's
// lse of -0.7 * FLT_MAX cancels the biased scores it saw and p = 1, as
// attention_bwd.cu gives it. Folding log2(e) in first would overflow
// -0.7 * FLT_MAX to -inf and give -inf - -inf = NaN. Without a bias, lse
// is finite and log2(e) folds into the scale.
//
// Later work: a persistent grid, overlapping one tile's products with the
// next tile's exponentials (both kernels wait for every product of a tile
// before the next), a third ring stage, TMA stores of dQ / dK / dV.

#include "sm90.cuh"

namespace {

constexpr int D = 128;
constexpr int BM = 128;  // query rows a K6a block owns, 64 per consumer
constexpr int BN = 64;   // rows of a walked tile; the keys a K6b block owns
constexpr int STAGES = 2;
constexpr int NT = 384;  // producer + two consumer warpgroups
constexpr int CONSUMER_WARPS = 8;
constexpr int BOX_COLS = 64;  // 64 bf16 = one 128-byte swizzle row
constexpr int BOX_ROWS = 64;
constexpr uint32_t BOX_BYTES = BOX_ROWS * BOX_COLS * 2;  // 8 KB
// a tile of R rows x 128 columns is two 64-column halves of R x 128 bytes
constexpr uint32_t OWN_HALF = BM * 128;
constexpr uint32_t OWN_BYTES = 2 * OWN_HALF;    // 32 KB
constexpr uint32_t WALK_HALF = BN * 128;
constexpr uint32_t WALK_BYTES = 2 * WALK_HALF;  // 16 KB
constexpr uint32_t STAT_BYTES = 2 * BN * 4;     // lse and delta of 64 rows
// K6a: Q and dO of the block's rows, then per stage K and V
constexpr uint32_t A_OFF = 0;
constexpr uint32_t B_OFF = A_OFF + OWN_BYTES;
constexpr uint32_t X_OFF = B_OFF + OWN_BYTES;
constexpr uint32_t Y_OFF = X_OFF + STAGES * WALK_BYTES;
constexpr uint32_t DQ_BAR_OFF = Y_OFF + STAGES * WALK_BYTES;
// barriers: the owned tiles full; per stage full, empty
constexpr int N_BARS = 1 + 2 * STAGES;
// + 1024: the swizzled tiles start on a 1024-byte boundary
constexpr size_t DQ_SMEM = DQ_BAR_OFF + N_BARS * 8 + 1024;  // 129 KB
// K6b: K and V of the block's 64 keys, the ring of Q and dO tiles with
// their lse / delta, and per parity of the walk P^T and dS^T (bf16,
// swizzled, one 128-byte row per key) and P^T in fp32 (one word per
// thread and accumulator register)
constexpr uint32_t PS_BYTES = 64 * 64 * 2;   // 8 KB
constexpr uint32_t P32_BYTES = 64 * 64 * 4;  // 16 KB
constexpr uint32_t KB_K_OFF = 0;
constexpr uint32_t KB_V_OFF = KB_K_OFF + WALK_BYTES;
constexpr uint32_t KB_Q_OFF = KB_V_OFF + WALK_BYTES;
constexpr uint32_t KB_DO_OFF = KB_Q_OFF + STAGES * WALK_BYTES;
constexpr uint32_t KB_ST_OFF = KB_DO_OFF + STAGES * WALK_BYTES;
constexpr uint32_t KB_PT_OFF = KB_ST_OFF + 1024;
static_assert(STAGES * STAT_BYTES <= 1024, "stats overlap P^T");
constexpr uint32_t KB_DS_OFF = KB_PT_OFF + 2 * PS_BYTES;
constexpr uint32_t KB_P32_OFF = KB_DS_OFF + 2 * PS_BYTES;
constexpr uint32_t KB_BAR_OFF = KB_P32_OFF + 2 * P32_BYTES;
constexpr size_t DKV_SMEM = KB_BAR_OFF + N_BARS * 8 + 1024;  // 162 KB
// named barriers of K6b's hand-over, per parity: P^T written (consumer 0
// arrives, consumer 1 waits) and dS^T written (both wait); 0 is
// __syncthreads
constexpr int BAR_P = 1, BAR_DS = 3;

struct Params {
  const __nv_bfloat16* o;     // K6a: O and dO for delta
  const __nv_bfloat16* dout;
  const float* bias;
  const float* lse;           // [B, Hq, Sq]
  float* delta;               // [B, Hq, Sq]: K6a writes it, K6b reads it
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  long long o_sb, o_sh, o_ss;
  long long do_sb, do_sh, do_ss;
  long long dq_sb, dq_sh, dq_ss;
  long long dk_sb, dk_sh, dk_ss;
  long long dv_sb, dv_sh, dv_ss;
  long long bias_sb;
  int batch, hq, hkv, sq, skv;
  float scale;
  int causal;
};

// rows [row0, row0 + R) of one (head, batch row) -> shared, as R / 64 x 2
// boxes: column half c of row r lands at dst + c * R * 128 + r * 128, the
// layout one box of R rows would give; TMA zero-fills rows past the end
template <int R>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int row0, int h,
                                          int b) {
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int rb = 0; rb < R / BOX_ROWS; ++rb)
      tma_load(dst + c * R * 128 + rb * BOX_BYTES, map, bar, c * BOX_COLS,
               row0 + rb * BOX_ROWS, h, b);
}

// K-major operand: 64 rows from row r of an R-row tile, k-step kk (16
// columns: 32 bytes inside a swizzle row, the next half after 4 steps)
template <int R>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int r, int kk) {
  return desc_sw128(tile + (kk / 4) * R * 128 + r * 128 + (kk % 4) * 32, 16,
                    1024);
}

// MN-major B operand (N = the 128 columns) of a 64-row walked tile, k-step
// kk (16 rows, 2048 bytes); the leading offset steps to the other half
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  return desc_sw128(tile + kk * 2048, WALK_HALF, 1024);
}

// A thread's 64 x 64 accumulator fragment (rows r0, r0 + 8; column pairs
// 8i + cq), rounded to bf16, into a K-major 128-byte-swizzled tile: row r
// at r * 128, its 16-byte chunk c at (c ^ (r % 8)) * 16, as TMA would
// have written it and as a wgmma A operand reads it. The 8 rows of a warp
// land in 8 distinct chunks, so the stores are free of bank conflicts.
__device__ __forceinline__ void store_tile_sw128(uint32_t tile, int r0,
                                                 int cq,
                                                 const float (&v)[32]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t col = ((i ^ (r0 & 7)) * 16) + cq * 2;
    asm volatile("st.shared.b32 [%0], %1;" ::"r"(tile + r0 * 128 + col),
                 "r"(pack_bf16(v[4 * i], v[4 * i + 1])) : "memory");
    asm volatile("st.shared.b32 [%0], %1;" ::"r"(tile + (r0 + 8) * 128 + col),
                 "r"(pack_bf16(v[4 * i + 2], v[4 * i + 3])) : "memory");
  }
}

// shared-memory stores of this thread, visible to the tensor cores'
// reads once a barrier orders them
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// sum of a[c] * b[c] over 32 contiguous bf16 columns (16-byte loads)
__device__ __forceinline__ float dot32(const __nv_bfloat16* a,
                                       const __nv_bfloat16* b) {
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < 32; c += 8) {
    const uint4 av = *reinterpret_cast<const uint4*>(a + c);
    const uint4 bv = *reinterpret_cast<const uint4*>(b + c);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&av);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&bv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(a2[e]);
      const float2 y = __bfloat1622float2(b2[e]);
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
  }
  return acc;
}

__device__ __forceinline__ void init_barriers(uint32_t bars, uint32_t full_count) {
  mbar_init(bars, 1);
  for (int s = 0; s < STAGES; ++s) {
    mbar_init(bars + 8u * (1 + s), full_count);
    mbar_init(bars + 8u * (1 + STAGES + s), CONSUMER_WARPS);
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// a thread's two accumulator rows of a [64, 2N] fp32 tile -> bf16 rows
// of a strided [S, D] gradient
template <int N>
__device__ __forceinline__ void store_rows(__nv_bfloat16* g, long long ss,
                                           int i0, int i1, int n, int cq,
                                           const float (&acc)[N]) {
  if (i0 < n) {
    __nv_bfloat16* row = g + (long long)i0 * ss + cq;
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * i) =
          __floats2bfloat162_rn(acc[4 * i], acc[4 * i + 1]);
  }
  if (i1 < n) {
    __nv_bfloat16* row = g + (long long)i1 * ss + cq;
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * i) =
          __floats2bfloat162_rn(acc[4 * i + 2], acc[4 * i + 3]);
  }
}

// K6a: delta and dQ for 128 query rows of one (batch, q head)
template <bool HAS_BIAS>
__global__ void __launch_bounds__(NT, 1)
    flash_bwd_dq_sm90(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do,
                      const Params p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base + A_OFF;
  const uint32_t do_s = base + B_OFF;
  const uint32_t bars = base + DQ_BAR_OFF;
  const uint32_t own_full = bars;
  auto k_s = [&](int s) { return base + X_OFF + s * WALK_BYTES; };
  auto v_s = [&](int s) { return base + Y_OFF + s * WALK_BYTES; };
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + STAGES + s); };

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int heads = p.hq * p.batch;
  const int n_qt = (p.sq + BM - 1) / BM;
  // last query tile first: under a causal mask it walks the most key tiles
  const int q0 = (n_qt - 1 - (int)blockIdx.x / heads) * BM;
  const int h = (int)blockIdx.x % heads % p.hq;
  const int b = (int)blockIdx.x % heads / p.hq;
  const int hk = h / (p.hq / p.hkv);
  const int off = p.skv - p.sq;  // causal diagonal offset
  int kv_end = p.skv;
  if (p.causal) kv_end = min(kv_end, q0 + BM + off);
  const int n_tiles = kv_end > 0 ? (kv_end + BN - 1) / BN : 0;

  if (tid == 0) init_barriers(bars, 1);
  __syncthreads();

  if (wg == 0) {
    // ---------------- producer ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (tid == 0 && n_tiles > 0) {
      mbar_expect_tx(own_full, 2 * OWN_BYTES);
      load_tile<BM>(q_s, &tm_q, own_full, q0, h, b);
      load_tile<BM>(do_s, &tm_do, own_full, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        const uint32_t ph = (t / STAGES) & 1;
        // the first pass over the ring finds every stage free
        mbar_wait(empty(s), ph ^ 1);
        mbar_expect_tx(full(s), 2 * WALK_BYTES);
        load_tile<BN>(k_s(s), &tm_k, full(s), t * BN, hk, b);
        load_tile<BN>(v_s(s), &tm_v, full(s), t * BN, hk, b);
      }
    }
  } else {
    // ---------------- consumers ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int cw = wg - 1;
    const int ltid = tid - 128 * wg;
    const int warp = ltid / 32, lane = ltid % 32;
    // rows r0, r0 + 8 of the warpgroup's 64; first column of each pair
    const int r0 = warp * 16 + lane / 4;
    const int cq = 2 * (lane % 4);
    const int qw0 = q0 + cw * 64;
    const int qi0 = qw0 + r0, qi1 = qi0 + 8;
    const long long row = ((long long)b * p.hq + h) * p.sq;

    // delta of rows qi0, qi1: each lane of the quad sums 32 of the 128
    // columns, read from global memory while the first tiles load
    float dl0 = 0.f, dl1 = 0.f;
    {
      const int c0 = 32 * (lane % 4);
      const __nv_bfloat16* og = p.o + b * p.o_sb + h * p.o_sh + c0;
      const __nv_bfloat16* gg = p.dout + b * p.do_sb + h * p.do_sh + c0;
      if (qi0 < p.sq) dl0 = dot32(og + qi0 * p.o_ss, gg + qi0 * p.do_ss);
      if (qi1 < p.sq) dl1 = dot32(og + qi1 * p.o_ss, gg + qi1 * p.do_ss);
      dl0 += __shfl_xor_sync(0xffffffffu, dl0, 1);
      dl0 += __shfl_xor_sync(0xffffffffu, dl0, 2);
      dl1 += __shfl_xor_sync(0xffffffffu, dl1, 1);
      dl1 += __shfl_xor_sync(0xffffffffu, dl1, 2);
      if ((lane & 3) == 0) {
        if (qi0 < p.sq) p.delta[row + qi0] = dl0;
        if (qi1 < p.sq) p.delta[row + qi1] = dl1;
      }
    }
    // lse (+inf past Sq: p = 0), in log2 units without a bias
    const float sc = HAS_BIAS ? p.scale : p.scale * LOG2E;
    float lo0 = qi0 < p.sq ? p.lse[row + qi0] : INFINITY;
    float lo1 = qi1 < p.sq ? p.lse[row + qi1] : INFINITY;
    if (!HAS_BIAS) {
      lo0 *= LOG2E;
      lo1 *= LOG2E;
    }
    const float* bias = HAS_BIAS ? p.bias + b * p.bias_sb : nullptr;

    float dq[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dq[i] = 0.f;

    if (n_tiles > 0) mbar_wait(own_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES;
      const uint32_t ph = (t / STAGES) & 1;
      const int j0 = t * BN;
      mbar_wait(full(s), ph);
      // some row of this warpgroup sees a key of the tile
      if (qw0 < p.sq && (!p.causal || j0 <= qw0 + 63 + off)) {
        float sacc[32], dpacc[32];
        // S = Q K^T, then dP = dO V^T: 8 k-steps of 16 columns each
        wg_fence();
        wgmma_ss64_first(sacc, kmajor<BM>(q_s, cw * 64, 0),
                         kmajor<BN>(k_s(s), 0, 0));
#pragma unroll
        for (int kk = 1; kk < D / 16; ++kk)
          wgmma_ss64(sacc, kmajor<BM>(q_s, cw * 64, kk),
                     kmajor<BN>(k_s(s), 0, kk));
        wg_commit();
        wgmma_ss64_first(dpacc, kmajor<BM>(do_s, cw * 64, 0),
                         kmajor<BN>(v_s(s), 0, 0));
#pragma unroll
        for (int kk = 1; kk < D / 16; ++kk)
          wgmma_ss64(dpacc, kmajor<BM>(do_s, cw * 64, kk),
                     kmajor<BN>(v_s(s), 0, kk));
        wg_commit();
        // this thread's 16 keys of the bias, fetched while S runs
        float bv[16];
        if constexpr (HAS_BIAS) {
          const float* bt = bias + j0 + cq;
          const int lim = p.skv - j0 - cq;
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              bv[2 * i + e] = 8 * i + e < lim ? __ldg(bt + 8 * i + e) : 0.f;
        }
        wg_wait<1>();
        pin(sacc);

        // P = exp(s - lse), masked only on tiles that cross the key end or
        // this warpgroup's causal diagonal. Column 8i + e of this thread's
        // pairs is key j0 + cq + 8i + e.
        const bool edge = j0 + BN > p.skv ||
                          (p.causal && j0 + BN - 1 > qw0 + off);
        const int lim = p.skv - j0 - cq;
        const int big = 1 << 30;
        const int d0 = p.causal ? qi0 + off - j0 - cq : big;
        const int d1 = p.causal ? qi1 + off - j0 - cq : big;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x0 = sacc[4 * i + e], x1 = sacc[4 * i + 2 + e];
            if constexpr (HAS_BIAS) {
              x0 = (fmaf(x0, sc, bv[2 * i + e]) - lo0) * LOG2E;
              x1 = (fmaf(x1, sc, bv[2 * i + e]) - lo1) * LOG2E;
            } else {
              x0 = fmaf(x0, sc, -lo0);
              x1 = fmaf(x1, sc, -lo1);
            }
            if (edge) {
              const int c = 8 * i + e;
              if (c >= lim || c > d0) x0 = -INFINITY;
              if (c >= lim || c > d1) x1 = -INFINITY;
            }
            sacc[4 * i + e] = ex2(x0);
            sacc[4 * i + 2 + e] = ex2(x1);
          }
        wg_wait<0>();
        pin(dpacc);

        // dS = P (dP - delta) scale, packed into the A fragments of dQ's
        // product: keys [16kk, 16kk + 16) are da[4kk .. 4kk + 3]
        uint32_t da[16];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          da[2 * i] = pack_bf16(sacc[4 * i] * (dpacc[4 * i] - dl0) * p.scale,
                                sacc[4 * i + 1] * (dpacc[4 * i + 1] - dl0) *
                                    p.scale);
          da[2 * i + 1] =
              pack_bf16(sacc[4 * i + 2] * (dpacc[4 * i + 2] - dl1) * p.scale,
                        sacc[4 * i + 3] * (dpacc[4 * i + 3] - dl1) * p.scale);
        }
        // dQ += dS K: 4 k-steps of 16 keys, K read MN-major
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          wgmma_rs(dq, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2],
                   da[4 * kk + 3], mnmajor(k_s(s), kk));
        wg_commit();
        wg_wait<0>();
        pin(dq);
        pin(da);
      }
      if (lane == 0) mbar_arrive(empty(s));
    }

    store_rows(p.dq + b * p.dq_sb + h * p.dq_sh, p.dq_ss, qi0, qi1, p.sq, cq,
               dq);
  }
}

// K6b: dK and dV for 64 keys of one (batch, kv head), summed over the
// group's q heads and every query tile that sees them. Consumer 0 forms
// S^T and P^T, consumer 1 dP^T and dS^T; each accumulates its 64-column
// half of dK and dV.
template <bool HAS_BIAS>
__global__ void __launch_bounds__(NT, 1)
    flash_bwd_dkv_sm90(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do,
                       const Params p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);  // generic view of base
  const uint32_t k_s = base + KB_K_OFF;
  const uint32_t v_s = base + KB_V_OFF;
  const uint32_t bars = base + KB_BAR_OFF;
  const uint32_t own_full = bars;
  auto q_s = [&](int s) { return base + KB_Q_OFF + s * WALK_BYTES; };
  auto do_s = [&](int s) { return base + KB_DO_OFF + s * WALK_BYTES; };
  // lse [0, 64) and delta [64, 128) of a stage's query tile
  auto stats = [&](int s) {
    return reinterpret_cast<float*>(gbase + KB_ST_OFF + s * STAT_BYTES);
  };
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + STAGES + s); };

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int heads = p.hkv * p.batch;
  // first key tile first: under a causal mask the most query tiles see it
  const int k0 = ((int)blockIdx.x / heads) * BN;
  const int hk = (int)blockIdx.x % heads % p.hkv;
  const int b = (int)blockIdx.x % heads / p.hkv;
  const int group = p.hq / p.hkv;
  const int off = p.skv - p.sq;
  // first query tile with a row that sees key k0: 64t + 63 + off >= k0;
  // every later tile has one too
  int t_first = 0;
  if (p.causal) {
    const int lo = k0 - off - (BN - 1);
    t_first = lo > 0 ? (lo + BN - 1) / BN : 0;
  }
  const int n_qt = (p.sq + BN - 1) / BN;
  const int per_head = max(n_qt - t_first, 0);
  // the walk: tile it is query tile t_first + it % per_head of q head
  // hk * group + it / per_head
  const int n_tiles = group * per_head;

  // the full barrier takes the TMA bytes and warp 1's 32 stats arrivals
  if (tid == 0) init_barriers(bars, 1 + 32);
  __syncthreads();

  if (wg == 0) {
    // ---------------- producer ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (tid == 0 && n_tiles > 0) {
      mbar_expect_tx(own_full, 2 * WALK_BYTES);
      load_tile<BN>(k_s, &tm_k, own_full, k0, hk, b);
      load_tile<BN>(v_s, &tm_v, own_full, k0, hk, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        const uint32_t ph = (it / STAGES) & 1;
        const int h = hk * group + it / per_head;
        const int q0 = (t_first + it % per_head) * BN;
        mbar_wait(empty(s), ph ^ 1);
        mbar_expect_tx(full(s), 2 * WALK_BYTES);
        load_tile<BN>(q_s(s), &tm_q, full(s), q0, h, b);
        load_tile<BN>(do_s(s), &tm_do, full(s), q0, h, b);
      }
    } else if (tid / 32 == 1) {
      // lse and delta of the tile's 64 rows, two per lane; +inf and 0
      // past Sq, so those columns get p = 0
      const int lane = tid % 32;
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        const uint32_t ph = (it / STAGES) & 1;
        const int h = hk * group + it / per_head;
        const int q0 = (t_first + it % per_head) * BN;
        const long long row = ((long long)b * p.hq + h) * p.sq;
        mbar_wait(empty(s), ph ^ 1);
        float* st = stats(s);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * lane + e;
          const bool in = q0 + i < p.sq;
          st[i] = in ? p.lse[row + q0 + i] : INFINITY;
          st[BN + i] = in ? p.delta[row + q0 + i] : 0.f;
        }
        mbar_arrive(full(s));
      }
    }
  } else {
    // ---------------- consumers ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int cw = wg - 1;
    const int ltid = tid - 128 * wg;
    const int warp = ltid / 32, lane = ltid % 32;
    // key rows r0, r0 + 8 of the 64; first query column of each pair
    const int r0 = warp * 16 + lane / 4;
    const int cq = 2 * (lane % 4);
    const int kj0 = k0 + r0, kj1 = kj0 + 8;
    const float sc = HAS_BIAS ? p.scale : p.scale * LOG2E;
    float b0 = 0.f, b1 = 0.f;
    if constexpr (HAS_BIAS) {
      const float* bias = p.bias + b * p.bias_sb;
      if (kj0 < p.skv) b0 = bias[kj0];
      if (kj1 < p.skv) b1 = bias[kj1];
    }

    // this warpgroup's columns [64 cw, 64 cw + 64) of dK and dV
    float dk[32], dv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      dk[i] = 0.f;
      dv[i] = 0.f;
    }

    if (n_tiles > 0) mbar_wait(own_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % STAGES;
      const uint32_t ph = (it / STAGES) & 1;
      const int q0 = (t_first + it % per_head) * BN;
      // P^T and dS^T alternate between two buffers: a warpgroup rewrites
      // one only after the other has passed the next tile's dS^T barrier,
      // so after its products on the previous use have completed
      const int par = it & 1;
      const uint32_t pt_s = base + KB_PT_OFF + par * PS_BYTES;
      const uint32_t ds_s = base + KB_DS_OFF + par * PS_BYTES;
      float* p32 = reinterpret_cast<float*>(gbase + KB_P32_OFF +
                                            par * P32_BYTES) + ltid;
      const float* sl = stats(s);
      mbar_wait(full(s), ph);

      // consumer 0: S^T = K Q^T; consumer 1: dP^T = V dO^T. Both run the
      // same wgmma instructions (only the operands differ), so no
      // warpgroup issues them on a divergent path
      const uint32_t a_s = cw == 0 ? k_s : v_s;
      const uint32_t b_s = cw == 0 ? q_s(s) : do_s(s);
      float acc[32];
      wg_fence();
      wgmma_ss64_first(acc, kmajor<BN>(a_s, 0, 0), kmajor<BN>(b_s, 0, 0));
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk)
        wgmma_ss64(acc, kmajor<BN>(a_s, 0, kk), kmajor<BN>(b_s, 0, kk));
      wg_commit();
      wg_wait<0>();
      pin(acc);
      if (cw == 0) {
        // P^T = exp(s - lse): column 8i + e of this thread's pairs is
        // query q0 + cq + 8i + e, visible to key kj iff it is >= kj - off;
        // only tiles that cross the diagonal are masked
        const bool edge = p.causal && k0 + 63 > q0 + off;
        const int d0 = kj0 - off - q0 - cq, d1 = kj1 - off - q0 - cq;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float2 l2 = *reinterpret_cast<const float2*>(sl + 8 * i + cq);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float lse = e ? l2.y : l2.x;
            float x0 = acc[4 * i + e], x1 = acc[4 * i + 2 + e];
            if constexpr (HAS_BIAS) {
              x0 = (fmaf(x0, sc, b0) - lse) * LOG2E;
              x1 = (fmaf(x1, sc, b1) - lse) * LOG2E;
            } else {
              x0 = fmaf(x0, sc, -lse * LOG2E);
              x1 = fmaf(x1, sc, -lse * LOG2E);
            }
            if (edge) {
              const int c = 8 * i + e;
              if (c < d0) x0 = -INFINITY;
              if (c < d1) x1 = -INFINITY;
            }
            acc[4 * i + e] = ex2(x0);
            acc[4 * i + 2 + e] = ex2(x1);
          }
        }
        // P^T rounded to bf16 for the dV product, in fp32 for dS^T
        store_tile_sw128(pt_s, r0, cq, acc);
#pragma unroll
        for (int i = 0; i < 32; ++i) p32[i * 128] = acc[i];
        fence_async_smem();
        named_arrive(BAR_P + par, 256);
      } else {
        // dS^T = P^T (dP^T - delta) scale, once consumer 0 wrote P^T
        named_sync(BAR_P + par, 256);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float2 dl =
              *reinterpret_cast<const float2*>(sl + BN + 8 * i + cq);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[4 * i + e] = p32[(4 * i + e) * 128] *
                             (acc[4 * i + e] - (e & 1 ? dl.y : dl.x)) *
                             p.scale;
        }
        store_tile_sw128(ds_s, r0, cq, acc);
        fence_async_smem();
      }
      named_sync(BAR_DS + par, 256);

      // dV[:, half] += P^T dO[:, half] and dK[:, half] += dS^T Q[:, half]:
      // 4 k-steps of 16 queries, A K-major from the hand-over tiles, B the
      // warpgroup's 64-column box of dO and Q read MN-major
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_ss64_tb(dv, desc_sw128(pt_s + kk * 32, 16, 1024),
                      mnmajor(do_s(s) + cw * WALK_HALF, kk));
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_ss64_tb(dk, desc_sw128(ds_s + kk * 32, 16, 1024),
                      mnmajor(q_s(s) + cw * WALK_HALF, kk));
      wg_commit();
      wg_wait<0>();
      pin(dv);
      pin(dk);
      if (lane == 0) mbar_arrive(empty(s));
    }

    store_rows(p.dk + b * p.dk_sb + hk * p.dk_sh + 64 * cw, p.dk_ss, kj0,
               kj1, p.skv, cq, dk);
    store_rows(p.dv + b * p.dv_sb + hk * p.dv_sh + 64 * cw, p.dv_ss, kj0,
               kj1, p.skv, cq, dv);
  }
}

// the tensor maps of q, k, v and dO and the shape fields of p, from the
// 4 x GEOM geometry kernels.flash_bwd_sm90_geometry builds
int prepare(const void* q, const void* k, const void* v, const void* dout,
            const long long* geom, CUtensorMap (&maps)[4], Params& p) {
  const long long* gq = geom;
  const long long* gk = geom + GEOM;
  const long long* gv = geom + 2 * GEOM;
  const long long* gd = geom + 3 * GEOM;
  for (int i = 0; i < 4; ++i)
    if (gk[i] != gv[i] || gd[i] != gq[i]) return (int)cudaErrorInvalidValue;
  if (gq[1] <= 0 || gq[3] <= 0 || gk[1] <= 0 || gk[2] <= 0 ||
      gk[3] != gq[3] || gq[2] % gk[2])
    return (int)cudaErrorInvalidValue;
  const void* ptrs[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i) {
    const int e = encode_bf16(&maps[i], ptrs[i], geom + i * GEOM, D,
                              BOX_COLS, BOX_ROWS);
    if (e != 0) return e;
  }
  p.batch = (int)gq[3];
  p.hq = (int)gq[2];
  p.hkv = (int)gk[2];
  p.sq = (int)gq[1];
  p.skv = (int)gk[1];
  // dO's element strides, for K6a's delta pre-pass
  p.do_ss = gd[4] / 2;
  p.do_sh = gd[5] / 2;
  p.do_sb = gd[6] / 2;
  return 0;
}

template <typename Kern>
int launch(Kern kern, size_t smem, long long blocks,
           const CUtensorMap (&m)[4], const Params& p, void* stream) {
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaError_t a = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (a != cudaSuccess) return (int)a;
  kern<<<(unsigned)blocks, NT, smem, (cudaStream_t)stream>>>(
      m[0], m[1], m[2], m[3], p);
  return (int)cudaGetLastError();
}

}  // namespace

// K6a: delta (written to `delta`, which the K6b entry then reads) and dQ.
// geom: 4 x 11 int64 (q, k, v, dO), each dims[4], byte strides[3], box[4]
extern "C" int vls_flash_bwd_dq_sm90(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* bias, const void* lse, void* delta,
    void* dq, const long long* geom, long long o_sb, long long o_sh,
    long long o_ss, long long dq_sb, long long dq_sh, long long dq_ss,
    long long bias_sb, float scale, int causal, void* stream) {
  CUtensorMap maps[4];
  Params p = {};
  const int e = prepare(q, k, v, dout, geom, maps, p);
  if (e != 0) return e;
  p.o = (const __nv_bfloat16*)o;
  p.dout = (const __nv_bfloat16*)dout;
  p.bias = (const float*)bias;
  p.lse = (const float*)lse;
  p.delta = (float*)delta;
  p.dq = (__nv_bfloat16*)dq;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.dq_sb = dq_sb; p.dq_sh = dq_sh; p.dq_ss = dq_ss;
  p.bias_sb = bias_sb;
  p.scale = scale;
  p.causal = causal;
  const long long blocks =
      (long long)((p.sq + BM - 1) / BM) * p.hq * p.batch;
  return launch(bias ? flash_bwd_dq_sm90<true> : flash_bwd_dq_sm90<false>,
                DQ_SMEM, blocks, maps, p, stream);
}

// K6b: dK and dV, from the delta the K6a entry wrote
extern "C" int vls_flash_bwd_dkv_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const void* bias, const void* lse, const void* delta, void* dk,
    void* dv, const long long* geom, long long dk_sb, long long dk_sh,
    long long dk_ss, long long dv_sb, long long dv_sh, long long dv_ss,
    long long bias_sb, float scale, int causal, void* stream) {
  CUtensorMap maps[4];
  Params p = {};
  const int e = prepare(q, k, v, dout, geom, maps, p);
  if (e != 0) return e;
  p.bias = (const float*)bias;
  p.lse = (const float*)lse;
  p.delta = (float*)delta;
  p.dk = (__nv_bfloat16*)dk;
  p.dv = (__nv_bfloat16*)dv;
  p.dk_sb = dk_sb; p.dk_sh = dk_sh; p.dk_ss = dk_ss;
  p.dv_sb = dv_sb; p.dv_sh = dv_sh; p.dv_ss = dv_ss;
  p.bias_sb = bias_sb;
  p.scale = scale;
  p.causal = causal;
  const long long blocks =
      (long long)((p.skv + BN - 1) / BN) * p.hkv * p.batch;
  return launch(bias ? flash_bwd_dkv_sm90<true> : flash_bwd_dkv_sm90<false>,
                DKV_SMEM, blocks, maps, p, stream);
}
