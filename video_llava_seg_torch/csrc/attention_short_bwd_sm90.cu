// Short-KV flash-attention backward for Hopper (sm_90a) at head dim 16:
// dQ, dK and dV in one pass over a persistent grid, K/V resident in
// shared memory, Q, O and dO streamed through a TMA + mbarrier ring.
//
// The gradients of attention_short_sm90.cu's forward,
//
//   o[b, h, i] = softmax_j(scale * q[b,h,i] . k[b,h//g,j] + bias[b,j]) v[b,h//g,j]
//
// from its output O, its logsumexp lse (natural-log units) and dO:
//
//   delta_i = sum_d dO_id O_id                      (fp32)
//   p_ij    = exp(scale * q_i . k_j + bias_j - lse_i)   (masked keys: 0)
//   dp_ij   = dO_i . v_j
//   ds_ij   = p_ij (dp_ij - delta_i) scale          (rounded to bf16)
//   dQ_i    = sum_j ds_ij k_j
//   dK_j    = sum_(h in group, i) ds_ij q_i
//   dV_j    = sum_(h in group, i) p_ij dO_i         (p rounded to bf16)
//
// The conventions of attention_bwd.cu: bf16 in and out, fp32 state; GQA
// (kv head = q head // group); causal masking with the diagonal at the
// sequence ends (key j visible to query i iff j <= i + Skv - Sq); an
// optional fp32 per-key bias [B, Skv]; a row that sees no key gets p = 0
// and contributes nothing. A key that the bias masks gets exactly 0 in dK
// and dV unless a query row sees no other key (then its p is 1, as in
// attention_bwd.cu). Q, K, V, O and dO are read through (batch, head,
// sequence) strides with a contiguous last dim (the mask decoder's
// [B, S, H, 16] buffers viewed [B, H, S, 16], no copy); dQ is written into
// the [B, Sq, Hq, 16] buffer and dK / dV into the [B, Skv, Hkv, 16]
// buffers that the wrapper allocates, through their strides.
//
// Replaces video_llava_seg_tpu/ops/attention.py::_bwd_dq_kernel (K6a) and
// ::_bwd_dkv_kernel (K6b) where the keys are few (head dim 16, Skv <= 64,
// K/V of a batch row within the resident slot: what attention_short_sm90.cu
// covers forward): the SAM2 mask decoder's image->token attention in the
// train step, 4096 image queries x 8 heads of 16 against ~7 prompt
// tokens. attention_bwd.cu keeps the other shapes at head dims below 128.
//
// Bound on the card: ~7 keys give almost no work per byte. The call must
// read Q, O and dO (32 bytes a row each) and lse (4) and write dQ (32):
// bound by those bytes, ~0.083 ms at the train shape q [64, 8, 4096, 16]
// on an H100 (3.35 TB/s). attention_bwd.cu's pair moved them three times
// (a delta pre-pass, K6a, K6b re-reading Q and dO) in ~33k short blocks
// and 512 long ones. This design reads each once in one launch:
//
// - Work units are (batch row b, chunk c of its 64-row q tiles, q head h),
//   h fastest, one unit a block at a time over a persistent grid of three
//   blocks an SM (the 8- and 16-key instances): block i takes units i,
//   i + grid, ... A block is one consumer warpgroup, which takes the
//   unit's items (its q tiles) in order, and one producer warp.
//   The blocks running at once hold neighbouring units, the heads of the
//   same q rows, so each 256-byte row of the decoder's [B, S, H, 16]
//   buffers comes from device memory once (TMA's 256-byte L2 promotion)
//   and the other heads' boxes find it in L2 (contiguous shares of two
//   units a block, one head after the other, read the rows twice). The
//   wrapper picks the chunks per batch row so that the busiest block gets
//   the fewest q tiles.
// - K/V resident: for each unit the producer loads K and V of all kv
//   heads of its batch row (each a TMA box of max(N, 16) keys, rows past
//   Skv zero-filled) into one of two slots, so the next unit's load
//   overlaps the last items of this one.
// - Q, O and dO streamed: one thread of the producer warp keeps a ring of
//   STAGES stages in flight, each the three 64-row boxes of one item, 2 KB
//   each, 32-byte rows under the 32-byte swizzle.
//   lse comes per item from global memory (two floats a thread, fetched
//   before the stage is waited for). delta is formed from the O and dO
//   rows already in shared memory while the first products run: no
//   pre-pass and no delta round trip through device memory.
// - S = Q K^T and dP = dO V^T are wgmma m64nNk16 (N = keys rounded up to
//   8, 16, 32 or 64), both operands K-major; P and dS stay in the
//   accumulator registers. dQ = dS K is a register-A wgmma m64n16k16 with
//   K MN-major through the transpose bit (the forward's P V), keys padded
//   to 16 with zeros; dQ goes out once per item as bf16 pairs (each
//   quad of lanes writes a row's 32 bytes).
// - dK / dV reduce over the 64 query rows of an item with the rows as the
//   reduction dimension: per warp (its 16 rows), dK^T += Q^T dS and
//   dV^T += dO^T P as mma.sync m16n8k16 (M = the 16 head-dim columns,
//   N = 8 keys a tile). The wgmma accumulator fragment of P / dS is the
//   transpose of the B fragment these products take: movmatrix.trans
//   turns each 8 x 8 bf16 block of the packed accumulator into it in
//   registers, and ldmatrix.trans reads Q^T / dO^T as the A fragments
//   from the stage (undoing the 32-byte swizzle in its row addresses).
//   The fp32 sums stay in registers over the unit's items.
// - Deterministic reduction: at the end of a unit the four warps' sums
//   meet in shared memory and are added in warp order into the
//   unit's [2, N, 16] fp32 partial in a workspace. A second, small launch
//   adds the partials of each (b, kv head) in chunk order, then group
//   order, and writes dK / dV as bf16. No float atomics: two calls on the
//   same inputs give bit-identical dK / dV.
//
// Masking and the per-key bias follow attention_bwd_sm90.cu: with a bias
// the exponent stays in natural units until lse is subtracted, so a
// left-pad row whose lse is the mask value cancels its biased scores and
// gets p = 1, as attention_bwd.cu gives it; without one, log2(e) folds
// into the scale. Keys past Skv, keys behind the causal diagonal and rows
// past Sq get p = 0.

#include "sm90.cuh"

namespace {

constexpr int D = 16;
constexpr int BQ = 64;                      // query rows per item
constexpr int ROW_BYTES = D * 2;            // one 32-byte swizzle row
constexpr int MAX_KEYS = 64;
// the ring's depth and the blocks an SM (min_blocks) as measured fastest
// at the train shape on an H100: six items in flight an SM; more (deeper
// rings, more blocks, a second consumer warpgroup) ran slower, fewer too
constexpr int STAGES = 2;
// one consumer warpgroup, then one producer warp
constexpr int NT = 128 + 32;
constexpr uint32_t BOX_BYTES = BQ * ROW_BYTES;          // 2 KB
constexpr uint32_t STAGE_BYTES = 3 * BOX_BYTES;         // Q, O, dO
constexpr uint32_t RING_BYTES = STAGES * STAGE_BYTES;   // 12 KB
// barriers: per stage full, empty; per K/V slot full, empty
constexpr int N_BARS = 2 * STAGES + 4;
constexpr int SMEM_LIMIT = 232448;
constexpr int REDUCE_THREADS = 256;

// blocks an SM: three at 8 and 16 keys (launch bounds: at most 65536 /
// (3 * NT) = 136 registers a thread), fewer for the wider tiles'
// registers
__host__ __device__ constexpr int min_blocks(int n) {
  return n <= 16 ? 3 : n == 32 ? 2 : 1;
}
// keys a head's K and V boxes hold: the score tile, at least one k16 step
// of dQ's product
__host__ __device__ constexpr int kv_rows(int n) { return n < 16 ? 16 : n; }

struct Params {
  __nv_bfloat16* dq;
  float* ws;
  const float* bias;
  const float* lse;
  long long dq_sb, dq_sh, dq_ss;
  long long bias_sb;
  int batch, hq, hkv, sq, skv, ntq, chunks;
  float scale;
  int causal;
};

inline int key_tile(int skv) {
  int n = 8;
  while (n < skv) n *= 2;
  return n;
}

// ring, two K/V slots, the four consumer warps' dK / dV sums of a unit,
// barriers
inline size_t smem_bytes(int hkv, int n) {
  return 1024 + RING_BYTES + 2 * (2 * (size_t)hkv * kv_rows(n) * ROW_BYTES) +
         (size_t)4 * 2 * D * n * 4 + N_BARS * 8;
}

__device__ __forceinline__ uint2 lds64(uint32_t addr) {
  uint2 v;
  asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];"
               : "=r"(v.x), "=r"(v.y) : "r"(addr) : "memory");
  return v;
}

// sum of the products of four bf16 pairs' elements
__device__ __forceinline__ float dot4(uint2 a, uint2 b) {
  const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
  const float2 x0 = __bfloat1622float2(a2[0]), x1 = __bfloat1622float2(a2[1]);
  const float2 y0 = __bfloat1622float2(b2[0]), y1 = __bfloat1622float2(b2[1]);
  return fmaf(x1.y, y1.y, fmaf(x1.x, y1.x, fmaf(x0.y, y0.y, x0.x * y0.x)));
}

// four 8 x 8 bf16 matrices, transposed, as an mma.sync A fragment: lanes
// 8m .. 8m + 7 give the row addresses of matrix m
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// the transpose of an 8 x 8 bf16 block held as an accumulator-layout pair
// (lane l: row l / 4, columns 2 (l % 4) and + 1)
__device__ __forceinline__ uint32_t movm_trans(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;"
               : "=r"(d) : "r"(a));
  return d;
}

// c += A B, mma.sync m16n8k16, bf16 in, fp32 sums
__device__ __forceinline__ void mma_16816(float* c, const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 128;" ::: "memory");
}

template <int N, bool HAS_BIAS>
__global__ void __launch_bounds__(NT, min_blocks(N))
    attention_short_bwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                                    const __grid_constant__ CUtensorMap tm_k,
                                    const __grid_constant__ CUtensorMap tm_v,
                                    const __grid_constant__ CUtensorMap tm_o,
                                    const __grid_constant__ CUtensorMap tm_do,
                                    const Params p) {
  constexpr int VB = kv_rows(N);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t head_bytes = VB * ROW_BYTES;
  const uint32_t k_bytes = p.hkv * head_bytes;
  const uint32_t slot_bytes = 2 * k_bytes;
  const uint32_t kv_base = base + RING_BYTES;
  const uint32_t sums = kv_base + 2 * slot_bytes;
  const uint32_t bars = sums + 4 * 2 * D * N * 4;
  float* sums_f = reinterpret_cast<float*>(smem_raw + (sums - raw));
  auto stage = [&](int s) { return base + s * STAGE_BYTES; };
  auto k_s = [&](int slot) { return kv_base + slot * slot_bytes; };
  auto v_s = [&](int slot) { return kv_base + slot * slot_bytes + k_bytes; };
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (STAGES + s); };
  auto kv_full = [&](int slot) { return bars + 8u * (2 * STAGES + slot); };
  auto kv_empty = [&](int slot) {
    return bars + 8u * (2 * STAGES + 2 + slot);
  };

  const int tid = threadIdx.x;
  // the units u = (b, chunk c, h), h fastest; this block takes u =
  // blockIdx.x, + gridDim.x, ..., so the blocks running at a time hold
  // neighbouring units: the heads of the same rows. Chunk c of a batch row
  // holds its q tiles [c ntq / chunks, (c + 1) ntq / chunks).
  const int per_b = p.chunks * p.hq;
  const int total = per_b * p.batch;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4);
    }
    for (int slot = 0; slot < 2; ++slot) {
      mbar_init(kv_full(slot), 1);
      mbar_init(kv_empty(slot), 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128) {
    // ---------------- producer: one thread issues every TMA load ------
    if (tid == 128) {
      int li = 0;
      for (int u = blockIdx.x, ul = 0; u < total; u += gridDim.x, ++ul) {
        const int b = u / per_b, rem = u - b * per_b;
        const int c = rem / p.hq, h = rem - c * p.hq, slot = ul & 1;
        // K and V of every kv head of the unit's batch row; the first use
        // of each slot finds it free
        mbar_wait(kv_empty(slot), ((ul >> 1) & 1) ^ 1);
        mbar_expect_tx(kv_full(slot), slot_bytes);
        tma_load(k_s(slot), &tm_k, kv_full(slot), 0, 0, 0, b);
        tma_load(v_s(slot), &tm_v, kv_full(slot), 0, 0, 0, b);
        const int t1 = (int)((long long)(c + 1) * p.ntq / p.chunks);
        for (int t = (int)((long long)c * p.ntq / p.chunks); t < t1;
             ++t, ++li) {
          const int s = li % STAGES;
          mbar_wait(empty(s), ((li / STAGES) & 1) ^ 1);
          mbar_expect_tx(full(s), STAGE_BYTES);
          tma_load(stage(s), &tm_q, full(s), 0, t * BQ, h, b);
          tma_load(stage(s) + BOX_BYTES, &tm_o, full(s), 0, t * BQ, h, b);
          tma_load(stage(s) + 2 * BOX_BYTES, &tm_do, full(s), 0, t * BQ, h,
                   b);
        }
      }
    }
    return;
  }

  // ---------------- the consumer warpgroup ----------------
  const int warp = tid / 32, lane = tid % 32;
  // this thread's rows of the item's 64 (r0 and r0 + 8) and the first of
  // its column pair in every 8-column block of the accumulators: d[4i + e]
  // is (r0, 8i + cq + e), d[4i + 2 + e] is (r0 + 8, 8i + cq + e)
  const int r0 = warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  // the row address this lane gives ldmatrix for the warp's 16 rows x 16
  // columns of a box, as four 8 x 8 matrices (rows 0-7 / 8-15 by columns
  // 0-7 / 8-15 of the A fragments of Q^T and dO^T): the 32-byte swizzle
  // swaps the two 16-byte halves of a row where bit 2 of the row is set
  const int lm = lane / 8;
  const int lrow = warp * 16 + (lm >> 1) * 8 + (lane & 7);
  const uint32_t lm_off =
      lrow * ROW_BYTES + (((lm & 1) ^ ((lrow >> 2) & 1)) << 4);
  const float sc2 = p.scale * LOG2E;
  const int group = p.hq / p.hkv;
  const int off = p.skv - p.sq;  // causal diagonal offset
  const int big = 1 << 30;

  int li = 0;
  for (int u = blockIdx.x, ul = 0; u < total; u += gridDim.x, ++ul) {
    const int b = u / per_b, rem = u - b * per_b;
    const int c = rem / p.hq, h = rem - c * p.hq, slot = ul & 1;
    // this thread's keys of the bias
    float bv[N / 4];
    if constexpr (HAS_BIAS) {
      const float* bias = p.bias + b * p.bias_sb;
#pragma unroll
      for (int i8 = 0; i8 < N / 8; ++i8)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 8 * i8 + cq + e;
          bv[2 * i8 + e] = j < p.skv ? __ldg(bias + j) : 0.f;
        }
    }
    const int hk = h / group;
    const uint32_t kh = k_s(slot) + hk * head_bytes;
    const uint32_t vh = v_s(slot) + hk * head_bytes;
    const float* lrow_g = p.lse + ((long long)b * p.hq + h) * p.sq;
    __nv_bfloat16* dqg = p.dq + b * p.dq_sb + h * p.dq_sh;
    // this warp's dK^T / dV^T sums over the unit: [16 columns x N keys]
    // as N / 8 mma.sync C fragments, d[4i + e] (column lane / 4, key
    // 8i + cq + e), d[4i + 2 + e] (column lane / 4 + 8)
    float dkt[N / 2], dvt[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) dkt[i] = dvt[i] = 0.f;

    // the unit's items are its q tiles [t0, t1); the lse of this thread's
    // two rows is loaded one item ahead (a load from device memory
    // outlasts an item's work)
    const int t0 = (int)((long long)c * p.ntq / p.chunks);
    const int t1 = (int)((long long)(c + 1) * p.ntq / p.chunks);
    auto lse_at = [&](int qi) {
      return qi < p.sq ? __ldg(lrow_g + qi) : 0.f;
    };
    float next0 = lse_at(t0 * BQ + r0), next1 = lse_at(t0 * BQ + r0 + 8);
    mbar_wait(kv_full(slot), (ul >> 1) & 1);
    for (int t = t0; t < t1; ++t, ++li) {
      const int s = li % STAGES;
      const uint32_t qs = stage(s), os = qs + BOX_BYTES,
                     gs = qs + 2 * BOX_BYTES;
      const int qi0 = t * BQ + r0, qi1 = qi0 + 8;
      const float lse0 = next0, lse1 = next1;
      if (t + 1 < t1) {
        next0 = lse_at(qi0 + BQ);
        next1 = lse_at(qi1 + BQ);
      }

      // S = Q K^T and dP = dO V^T: one k16 step over the whole head dim
      float sacc[N / 2], pacc[N / 2];
      mbar_wait(full(s), (li / STAGES) & 1);
      wg_fence();
      wgmma_ss_first(sacc, desc_sw32(qs, 16, 256), desc_sw32(kh, 16, 256));
      wgmma_ss_first(pacc, desc_sw32(gs, 16, 256), desc_sw32(vh, 16, 256));
      wg_commit();
      // delta of rows r0, r0 + 8 while the products run: each lane of
      // the quad takes 8 bytes of both 32-byte rows (the swizzle moves
      // O's and dO's halves of a row alike, so the pairs match)
      const uint32_t q8 = (lane % 4) * 8;
      float dl0 = dot4(lds64(os + r0 * ROW_BYTES + q8),
                       lds64(gs + r0 * ROW_BYTES + q8));
      float dl1 = dot4(lds64(os + (r0 + 8) * ROW_BYTES + q8),
                       lds64(gs + (r0 + 8) * ROW_BYTES + q8));
      dl0 += __shfl_xor_sync(0xffffffffu, dl0, 1);
      dl0 += __shfl_xor_sync(0xffffffffu, dl0, 2);
      dl1 += __shfl_xor_sync(0xffffffffu, dl1, 1);
      dl1 += __shfl_xor_sync(0xffffffffu, dl1, 2);
      wg_wait<0>();
      pin(sacc);
      pin(pacc);

      // P and dS in place of S and dP. Key j is visible to a row up to
      // its last visible key (Skv - 1, and the causal diagonal); rows
      // past Sq see none.
      const int d0 = qi0 < p.sq ? min(p.skv - 1, p.causal ? qi0 + off : big)
                                : -1;
      const int d1 = qi1 < p.sq ? min(p.skv - 1, p.causal ? qi1 + off : big)
                                : -1;
      const float nl0 = -lse0 * LOG2E, nl1 = -lse1 * LOG2E;
#pragma unroll
      for (int i8 = 0; i8 < N / 8; ++i8)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 8 * i8 + cq + e;
          float x0 = sacc[4 * i8 + e], x1 = sacc[4 * i8 + 2 + e];
          if constexpr (HAS_BIAS) {
            x0 = (fmaf(x0, p.scale, bv[2 * i8 + e]) - lse0) * LOG2E;
            x1 = (fmaf(x1, p.scale, bv[2 * i8 + e]) - lse1) * LOG2E;
          } else {
            x0 = fmaf(x0, sc2, nl0);
            x1 = fmaf(x1, sc2, nl1);
          }
          const float p0 = j <= d0 ? ex2(x0) : 0.f;
          const float p1 = j <= d1 ? ex2(x1) : 0.f;
          sacc[4 * i8 + e] = p0;
          sacc[4 * i8 + 2 + e] = p1;
          pacc[4 * i8 + e] = p0 * (pacc[4 * i8 + e] - dl0) * p.scale;
          pacc[4 * i8 + 2 + e] = p1 * (pacc[4 * i8 + 2 + e] - dl1) * p.scale;
        }
      // P and dS as bf16 pairs: pa[2i] / pa[2i + 1] is rows r0 / r0 + 8
      // of keys 8i + cq, + 1; ds over VB keys (zero past N) is also the
      // A fragment of dQ's product, keys [16kk, 16kk + 16) in
      // ds[4kk .. 4kk + 3]
      uint32_t pa[N / 4], ds[VB / 4];
#pragma unroll
      for (int j = 0; j < N / 4; ++j)
        pa[j] = pack_bf16(sacc[2 * j], sacc[2 * j + 1]);
#pragma unroll
      for (int j = 0; j < VB / 4; ++j)
        ds[j] = j < N / 4 ? pack_bf16(pacc[2 * j], pacc[2 * j + 1]) : 0u;

      // dQ = dS K over VB keys, K's rows 16 keys (512 bytes) a k-step
      float dqa[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) dqa[i] = 0.f;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < VB / 16; ++kk)
        wgmma_rs(dqa, ds[4 * kk], ds[4 * kk + 1], ds[4 * kk + 2],
                 ds[4 * kk + 3], desc_sw32(kh + kk * 512, 512, 256));
      wg_commit();

      // under it, dK^T += Q^T dS and dV^T += dO^T P over this warp's 16
      // rows: A = Q^T / dO^T from the stage, B = the transposed 8 x 8
      // blocks of the packed dS / P
      uint32_t qa[4], ga[4];
      ldsm_x4_trans(qa, qs + lm_off);
      ldsm_x4_trans(ga, gs + lm_off);
      // every read of the stage is issued: S and dP are done, the
      // ldmatrix results are in registers
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
#pragma unroll
      for (int i8 = 0; i8 < N / 8; ++i8) {
        mma_16816(dkt + 4 * i8, qa, movm_trans(ds[2 * i8]),
                  movm_trans(ds[2 * i8 + 1]));
        mma_16816(dvt + 4 * i8, ga, movm_trans(pa[2 * i8]),
                  movm_trans(pa[2 * i8 + 1]));
      }
      wg_wait<0>();
      pin(dqa);
      pin(ds);

      if (qi0 < p.sq) {
        __nv_bfloat16* row = dqg + (long long)qi0 * p.dq_ss + cq;
#pragma unroll
        for (int i8 = 0; i8 < 2; ++i8)
          *reinterpret_cast<__nv_bfloat162*>(row + 8 * i8) =
              __floats2bfloat162_rn(dqa[4 * i8], dqa[4 * i8 + 1]);
      }
      if (qi1 < p.sq) {
        __nv_bfloat16* row = dqg + (long long)qi1 * p.dq_ss + cq;
#pragma unroll
        for (int i8 = 0; i8 < 2; ++i8)
          *reinterpret_cast<__nv_bfloat162*>(row + 8 * i8) =
              __floats2bfloat162_rn(dqa[4 * i8 + 2], dqa[4 * i8 + 3]);
      }
    }

    // the unit's partial: the four warps' sums, [warp][dK, dV][column]
    // [key] in shared memory, added in warp order into ws[u] as
    // [dK, dV][key][column]
#pragma unroll
    for (int i8 = 0; i8 < N / 8; ++i8) {
      const int col = lane / 4, key = 8 * i8 + cq;
      float* wk = sums_f + ((warp * 2 + 0) * D + col) * N + key;
      float* wv = sums_f + ((warp * 2 + 1) * D + col) * N + key;
      *reinterpret_cast<float2*>(wk) =
          make_float2(dkt[4 * i8], dkt[4 * i8 + 1]);
      *reinterpret_cast<float2*>(wk + 8 * N) =
          make_float2(dkt[4 * i8 + 2], dkt[4 * i8 + 3]);
      *reinterpret_cast<float2*>(wv) =
          make_float2(dvt[4 * i8], dvt[4 * i8 + 1]);
      *reinterpret_cast<float2*>(wv + 8 * N) =
          make_float2(dvt[4 * i8 + 2], dvt[4 * i8 + 3]);
    }
    consumer_sync();
    float* wsu = p.ws + (long long)u * (2 * N * D);
    for (int e = tid; e < 2 * N * D; e += 128) {
      const int which = e / (N * D), key = (e / D) % N, col = e % D;
      const float* src = sums_f + (which * D + col) * N + key;
      float acc = src[0];
#pragma unroll
      for (int w = 1; w < 4; ++w) acc += src[w * 2 * D * N];
      wsu[e] = acc;
    }
    consumer_sync();
    __syncwarp();
    if (lane == 0) mbar_arrive(kv_empty(slot));
  }
}

// dK / dV of (b, key j, kv head hk, column d): the partials of the units
// (b, c, h) for h in the kv head's group, added in chunk order, then group
// order; one thread a (b, j, hk, d), the column fastest
__global__ void __launch_bounds__(REDUCE_THREADS)
    short_bwd_reduce_kernel(const float* ws, __nv_bfloat16* dk,
                            __nv_bfloat16* dv, long long dk_sb,
                            long long dk_sh, long long dk_ss, long long dv_sb,
                            long long dv_sh, long long dv_ss, int batch,
                            int hq, int hkv, int skv, int n, int chunks) {
  const long long idx = blockIdx.x * (long long)REDUCE_THREADS + threadIdx.x;
  if (idx >= (long long)batch * skv * hkv * D) return;
  const int d = (int)(idx % D);
  const int hk = (int)((idx / D) % hkv);
  const int j = (int)((idx / ((long long)D * hkv)) % skv);
  const long long b = idx / ((long long)D * hkv * skv);
  const int group = hq / hkv;
  float sk = 0.f, sv = 0.f;
  for (int c = 0; c < chunks; ++c)
    for (int g = 0; g < group; ++g) {
      const float* w =
          ws + ((b * chunks + c) * hq + hk * group + g) * (2LL * n * D);
      sk += w[j * D + d];
      sv += w[(n + j) * D + d];
    }
  dk[b * dk_sb + hk * dk_sh + j * dk_ss + d] = __float2bfloat16(sk);
  dv[b * dv_sb + hk * dv_sh + j * dv_ss + d] = __float2bfloat16(sv);
}

typedef void (*KernelFn)(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap,
                         CUtensorMap, Params);

template <int N>
KernelFn kernel_for(bool has_bias) {
  return has_bias ? attention_short_bwd_sm90_kernel<N, true>
                  : attention_short_bwd_sm90_kernel<N, false>;
}

}  // namespace

// geom: 5 x 11 int64 (q, k, v, o, dout), each dims[4] (D, S, H, B), byte
// strides[3], box[4]: q, o, dout (16, 64, 1, 1); k and v (16, max(N, 16),
// Hkv, 1) with N = Skv rounded up to 8, 16, 32 or 64. ws: fp32
// [B * chunks * Hq, 2, N, 16], the units' partials (every element is
// written before the second launch reads it). dq [B, Sq, Hq, 16], dk / dv
// [B, Skv, Hkv, 16] through their (batch, head, sequence) strides.
extern "C" int vls_attention_short_bwd_sm90(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* bias, const void* lse, void* dq, void* dk,
    void* dv, void* ws, const long long* geom, long long dq_sb,
    long long dq_sh, long long dq_ss, long long dk_sb, long long dk_sh,
    long long dk_ss, long long dv_sb, long long dv_sh, long long dv_ss,
    long long bias_sb, int chunks, int causal, float scale, void* stream) {
  const long long* gq = geom;
  const long long* gk = geom + GEOM;
  const long long* gv = geom + 2 * GEOM;
  const long long* go = geom + 3 * GEOM;
  const long long* gd = geom + 4 * GEOM;
  const int batch = (int)gq[3];
  if (batch <= 0) return 0;
  for (int i = 0; i < 4; ++i)
    if (gk[i] != gv[i] || go[i] != gq[i] || gd[i] != gq[i])
      return (int)cudaErrorInvalidValue;
  const int hkv = (int)gk[2], skv = (int)gk[1], hq = (int)gq[2];
  const int sq = (int)gq[1];
  const int ntq = (sq + BQ - 1) / BQ;
  if (gk[3] != batch || hkv <= 0 || hq % hkv || skv <= 0 ||
      skv > MAX_KEYS || sq <= 0 || chunks < 1 || chunks > ntq)
    return (int)cudaErrorInvalidValue;
  const int n = key_tile(skv);
  const size_t smem = smem_bytes(hkv, n);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const int qbox[4] = {D, BQ, 1, 1};
  const int kbox[4] = {D, kv_rows(n), hkv, 1};
  CUtensorMap tq, tk, tv, to, td;
  int e = encode_bf16_box(&tq, q, gq, D, qbox, CU_TENSOR_MAP_SWIZZLE_32B);
  if (e == 0)
    e = encode_bf16_box(&tk, k, gk, D, kbox, CU_TENSOR_MAP_SWIZZLE_32B);
  if (e == 0)
    e = encode_bf16_box(&tv, v, gv, D, kbox, CU_TENSOR_MAP_SWIZZLE_32B);
  if (e == 0)
    e = encode_bf16_box(&to, o, go, D, qbox, CU_TENSOR_MAP_SWIZZLE_32B);
  if (e == 0)
    e = encode_bf16_box(&td, dout, gd, D, qbox, CU_TENSOR_MAP_SWIZZLE_32B);
  if (e != 0) return e;
  Params p;
  p.dq = (__nv_bfloat16*)dq;
  p.ws = (float*)ws;
  p.bias = (const float*)bias;
  p.lse = (const float*)lse;
  p.dq_sb = dq_sb; p.dq_sh = dq_sh; p.dq_ss = dq_ss;
  p.bias_sb = bias_sb;
  p.batch = batch;
  p.hq = hq; p.hkv = hkv;
  p.sq = sq; p.skv = skv;
  p.ntq = ntq;
  p.chunks = chunks;
  p.scale = scale;
  p.causal = causal;
  const bool has_bias = bias != nullptr;
  const int ni = n == 8 ? 0 : n == 16 ? 1 : n == 32 ? 2 : 3;
  KernelFn kern = ni == 0 ? kernel_for<8>(has_bias)
                  : ni == 1 ? kernel_for<16>(has_bias)
                  : ni == 2 ? kernel_for<32>(has_bias)
                            : kernel_for<64>(has_bias);
  // the host's cost of a launch is a large part of a call at the mask
  // decoder's shapes: the shared-memory attribute is raised once per
  // instance and size, the SM count read once per device
  static size_t smem_set[4][2];
  static int sm_count[64];
  size_t& set = smem_set[ni][has_bias];
  if (smem > set) {
    const cudaError_t a = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (a != cudaSuccess) return (int)a;
    set = smem;
  }
  int dev = 0;
  cudaError_t a = cudaGetDevice(&dev);
  if (a != cudaSuccess) return (int)a;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (sm_count[dev] == 0) {
    a = cudaDeviceGetAttribute(&sm_count[dev],
                               cudaDevAttrMultiProcessorCount, dev);
    if (a != cudaSuccess) return (int)a;
  }
  // a persistent grid: as many blocks on each SM as the instance's
  // registers (launch bounds) and the shared memory (228 KB an SM, 1 KB
  // of it reserved per block) allow
  const int by_smem = (int)(233472 / (smem + 1024));  // >= 1: SMEM_LIMIT
  const int per_sm = by_smem < min_blocks(n) ? by_smem : min_blocks(n);
  const long long total = (long long)batch * chunks * hq;
  const long long want = (long long)sm_count[dev] * per_sm;
  const int grid = (int)(total < want ? total : want);
  cudaStream_t st = (cudaStream_t)stream;
  kern<<<grid, NT, smem, st>>>(tq, tk, tv, to, td, p);
  a = cudaGetLastError();
  if (a != cudaSuccess) return (int)a;
  const long long outs = (long long)batch * skv * hkv * D;
  short_bwd_reduce_kernel<<<(unsigned)((outs + REDUCE_THREADS - 1) /
                                       REDUCE_THREADS),
                            REDUCE_THREADS, 0, st>>>(
      (const float*)ws, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, dk_sb, dk_sh,
      dk_ss, dv_sb, dv_sh, dv_ss, batch, hq, hkv, skv, n, chunks);
  return (int)cudaGetLastError();
}
