// Short-KV attention for Hopper (sm_90a) at head dim 16: a persistent
// grid, K/V resident in shared memory, Q streamed through a TMA +
// mbarrier ring, both products on wgmma, the softmax in registers.
//
//   o[b, h, i] = softmax_j(scale * q[b,h,i] . k[b,h//g,j] + bias[b,j]) v[b,h//g,j]
//
// The same function as attention.cu's two-pass form: bf16 in and out,
// fp32 softmax; GQA (kv head = q head // group); causal masking with the
// diagonal at the sequence ends (key j visible to query i iff
// j <= i + Skv - Sq); keys at j >= kv_len masked; an optional fp32
// per-key bias [B, Skv]; optionally the fp32 logsumexp lse [B, Hq, Sq]
// (natural-log units) that the flash backward reads. A row with no
// visible key writes O = 0 and lse = 0. Q, K and V are read through
// (batch, head, sequence) strides with a contiguous last dim, O is
// written through its strides into the [B, S, H, D] buffer the wrapper
// allocates.
//
// Replaces video_llava_seg_tpu/ops/attention.py::_flash_kernel_single
// (K3: one kv block, plain softmax) where all keys fit one wgmma N tile
// (Skv <= 64): the SAM2 mask decoder's image->token attention, 4096 image
// queries x 8 heads of 16 against the ~7 prompt tokens, in serving and in
// the train step (with lse). attention.cu keeps the two-pass form at the
// other head dims and lengths.
//
// Bound on the card: ~7 keys give almost no work per byte; the call
// moves Q in and O out (32 bytes a row each), so it is bound by those
// bytes. The design pays each fixed cost once per block, not once per
// 64-row tile, and keeps Q's reads in flight:
//
// - Work items are (b, 64-row q tile, q head), the head fastest, so the
//   8 heads of one token block (its whole 256-byte rows of the mask
//   decoder's [B, S, H, D] buffer) are asked for back to back. A
//   persistent grid of up to three blocks per SM (the 8- and 16-key
//   instances) splits the items into contiguous shares.
// - K/V resident: a share spans one or a few batch rows. For each, the
//   producer loads K and V of all kv heads (each a TMA box of N keys, or
//   max(N, 16) for V, rows past Skv zero-filled) into one of two slots,
//   so the next batch row's load overlaps the last items of this one.
// - Q streamed: one thread of a producer warp keeps a ring of STAGES
//   64-row boxes (2 KB each, 32-byte rows) in flight; two consumer
//   warpgroups take alternate items.
// - A head-dim-16 row is 32 bytes: every tile uses the 32-byte swizzle
//   (its rows are one k16 step), so the TMA box is the real 32 bytes a
//   row and no tensor-core work is padded along the head dim.
// - S = Q K^T is wgmma m64nNk16 (N = keys rounded up to 8, 16, 32 or 64),
//   both operands K-major. The single-tile plain softmax runs on the
//   accumulator: mask and scale, the exact row max and sum by quad
//   shuffles, no second walk and no rescale. P, packed to bf16 in
//   registers with zero columns up to 16 keys, is the A operand of
//   O = P V, wgmma m64n16k16, V MN-major through the transpose bit.
//
// Masking and the per-key bias follow attention_sm90.cu: without a bias
// the scores are in log2 units; with one they stay natural until the row
// max is subtracted, so a row that sees only bias-masked keys gets the
// mean of its visible V rows and the mask value as its lse. Keys masked
// by the causal diagonal or kv_len are -inf.
//
// On an H100 (chip_smoke's device times): 0.40-0.42 / 0.52-0.54 of the
// byte bound at the serving / train shapes. Later work: a box of four
// heads' Q (128-byte rows of the decoder's buffer under the 128-byte
// swizzle, one head per 32-byte k16 column), two items in flight in each
// consumer, O through a TMA store.

#include "sm90.cuh"

namespace {

constexpr int D = 16;
constexpr int BQ = 64;                   // query rows per item
constexpr int ROW_BYTES = D * 2;         // one 32-byte swizzle row
constexpr int MAX_KEYS = 64;
constexpr int STAGES = 16;
constexpr int NC = 2;                    // consumer warpgroups
// the consumer warpgroups, then one producer warp (a whole producer
// warpgroup would hold registers that bound the blocks an SM takes)
constexpr int NT = 128 * NC + 32;
// blocks an SM takes at the 8- and 16-key instances' registers (launch
// bounds: at most 65536 / (3 * NT) = 75 a thread); the wider tiles need
// more and take one
__host__ __device__ constexpr int min_blocks(int n) {
  return n <= 16 ? 3 : 1;
}
constexpr uint32_t Q_BOX_BYTES = BQ * ROW_BYTES;      // 2 KB
constexpr uint32_t RING_BYTES = STAGES * Q_BOX_BYTES;  // 32 KB
// barriers: per stage full, empty; per K/V slot full, empty
constexpr int N_BARS = 2 * STAGES + 4;
constexpr int SMEM_LIMIT = 232448;

struct Params {
  __nv_bfloat16* o;
  const float* bias;
  float* lse;
  long long o_sb, o_sh, o_ss;
  long long bias_sb;
  int batch, hq, hkv, sq, skv, kv_len, ntq;
  float scale;
  int causal;
};

__host__ __device__ constexpr int v_rows(int n) { return n < 16 ? 16 : n; }

// keys rounded up to the score tile's width: 8, 16, 32 or 64
inline int key_tile(int skv) {
  int n = 8;
  while (n < skv) n *= 2;
  return n;
}

inline size_t smem_bytes(int hkv, int n) {
  return 1024 + RING_BYTES + 2 * (size_t)hkv * (n + v_rows(n)) * ROW_BYTES +
         N_BARS * 8;
}

template <int N, bool HAS_BIAS>
__global__ void __launch_bounds__(NT, min_blocks(N))
    attention_short_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v,
                                const Params p) {
  constexpr int VB = v_rows(N);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_bytes = p.hkv * N * ROW_BYTES;
  const uint32_t slot_bytes = k_bytes + p.hkv * VB * ROW_BYTES;
  const uint32_t kv_base = base + RING_BYTES;
  const uint32_t bars = kv_base + 2 * slot_bytes;
  auto q_s = [&](int s) { return base + s * Q_BOX_BYTES; };
  auto k_s = [&](int slot) { return kv_base + slot * slot_bytes; };
  auto v_s = [&](int slot) { return kv_base + slot * slot_bytes + k_bytes; };
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (STAGES + s); };
  auto kv_full = [&](int slot) { return bars + 8u * (2 * STAGES + slot); };
  auto kv_empty = [&](int slot) {
    return bars + 8u * (2 * STAGES + 2 + slot);
  };

  const int tid = threadIdx.x;
  const int wg = tid / 128;  // NC: the producer warp
  // this block's share [start, end) of the items (b, q tile, h), h
  // fastest; it spans the batch rows b0 .. b0 + n_rows - 1
  const long long per_b = (long long)p.ntq * p.hq;
  const long long total = per_b * p.batch;
  const long long start = total * blockIdx.x / gridDim.x;
  const long long end = total * (blockIdx.x + 1) / gridDim.x;
  const int b0 = (int)(start / per_b);
  const int n_rows = (int)((end - 1) / per_b) - b0 + 1;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4);
    }
    for (int slot = 0; slot < 2; ++slot) {
      mbar_init(kv_full(slot), 1);
      mbar_init(kv_empty(slot), 4 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (start >= end) return;

  if (wg == NC) {
    // ---------------- producer: one thread issues every TMA load ------
    if (tid == 128 * NC) {
      for (int r = 0; r < n_rows; ++r) {
        const int b = b0 + r, slot = r & 1;
        // the first use of each slot finds it free
        mbar_wait(kv_empty(slot), ((r >> 1) & 1) ^ 1);
        mbar_expect_tx(kv_full(slot), slot_bytes);
        tma_load(k_s(slot), &tm_k, kv_full(slot), 0, 0, 0, b);
        tma_load(v_s(slot), &tm_v, kv_full(slot), 0, 0, 0, b);
        const long long lo = max(start, b * per_b);
        const long long hi = min(end, (b + 1) * per_b);
        for (long long i = lo; i < hi; ++i) {
          const int li = (int)(i - start);
          const int s = li % STAGES;
          const int rem = (int)(i - b * per_b);
          const int qt = rem / p.hq;
          mbar_wait(empty(s), ((li / STAGES) & 1) ^ 1);
          mbar_expect_tx(full(s), Q_BOX_BYTES);
          tma_load(q_s(s), &tm_q, full(s), 0, qt * BQ, rem - qt * p.hq, b);
        }
      }
    }
    return;
  }

  // ---------------- consumers ----------------
  const int cw = wg;
  const int ltid = tid - 128 * wg;
  const int warp = ltid / 32, lane = ltid % 32;
  // this thread's rows of the item's 64 (r0 and r0 + 8) and the first of
  // its column pair in every 8-column block of the accumulators: d[4i + e]
  // is (r0, 8i + cq + e), d[4i + 2 + e] is (r0 + 8, 8i + cq + e)
  const int r0 = warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const float sc = HAS_BIAS ? p.scale : p.scale * LOG2E;
  const float f = HAS_BIAS ? LOG2E : 1.f;
  const int group = p.hq / p.hkv;
  const int off = p.skv - p.sq;  // causal diagonal offset
  const int kv_lim = min(p.kv_len, p.skv);
  const int big = 1 << 30;

  for (int r = 0; r < n_rows; ++r) {
    const int b = b0 + r, slot = r & 1;
    const long long lo = max(start, b * per_b);
    const long long hi = min(end, (b + 1) * per_b);
    const float* bias = HAS_BIAS ? p.bias + b * p.bias_sb : nullptr;
    // every consumer waits for and releases every batch row of the share,
    // items or none, so each slot's phases count all of them
    mbar_wait(kv_full(slot), (r >> 1) & 1);
    const int skip = (int)(((cw - (lo - start)) % NC + NC) % NC);
    for (long long i = lo + skip; i < hi; i += NC) {
      const int li = (int)(i - start);
      const int s = li % STAGES;
      const int rem = (int)(i - b * per_b);
      const int qt = rem / p.hq;
      const int h = rem - qt * p.hq;
      const int hk = h / group;
      const int qi0 = qt * BQ + r0, qi1 = qi0 + 8;

      // S = Q K^T: one k16 step over the whole head dim
      float sacc[N / 2];
      mbar_wait(full(s), (li / STAGES) & 1);
      wg_fence();
      wgmma_ss_first(sacc, desc_sw32(q_s(s), 16, 256),
                     desc_sw32(k_s(slot) + hk * N * ROW_BYTES, 16, 256));
      wg_commit();
      float bv[N / 4];
      if constexpr (HAS_BIAS) {
        // this thread's keys of the bias, fetched while S runs
#pragma unroll
        for (int i8 = 0; i8 < N / 8; ++i8)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = 8 * i8 + cq + e;
            bv[2 * i8 + e] = j < p.skv ? __ldg(bias + j) : 0.f;
          }
      }
      wg_wait<0>();
      pin(sacc);
      if (lane == 0) mbar_arrive(empty(s));

      // scale, bias, mask: key j is visible to a row up to its last
      // visible key (kv_lim - 1, and the causal diagonal)
      const int d0 = min(kv_lim - 1, p.causal ? qi0 + off : big);
      const int d1 = min(kv_lim - 1, p.causal ? qi1 + off : big);
#pragma unroll
      for (int i8 = 0; i8 < N / 8; ++i8)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 8 * i8 + cq + e;
          float s0 = sacc[4 * i8 + e], s1 = sacc[4 * i8 + 2 + e];
          if constexpr (HAS_BIAS) {
            s0 = fmaf(s0, sc, bv[2 * i8 + e]);
            s1 = fmaf(s1, sc, bv[2 * i8 + e]);
          } else {
            s0 *= sc;
            s1 *= sc;
          }
          sacc[4 * i8 + e] = j <= d0 ? s0 : -INFINITY;
          sacc[4 * i8 + 2 + e] = j <= d1 ? s1 : -INFINITY;
        }

      // the exact row max and sum (a row lives on a quad of lanes)
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int i8 = 0; i8 < N / 8; ++i8) {
        mx0 = fmaxf(mx0, fmaxf(sacc[4 * i8], sacc[4 * i8 + 1]));
        mx1 = fmaxf(mx1, fmaxf(sacc[4 * i8 + 2], sacc[4 * i8 + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      // a row with no visible key gets p = 0 everywhere (exp of -inf - 0)
      const float mu0 = mx0 == -INFINITY ? 0.f : mx0;
      const float mu1 = mx1 == -INFINITY ? 0.f : mx1;
      float l0 = 0.f, l1 = 0.f;
#pragma unroll
      for (int i8 = 0; i8 < N / 8; ++i8)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sacc[4 * i8 + e] = ex2((sacc[4 * i8 + e] - mu0) * f);
          sacc[4 * i8 + 2 + e] = ex2((sacc[4 * i8 + 2 + e] - mu1) * f);
          l0 += sacc[4 * i8 + e];
          l1 += sacc[4 * i8 + 2 + e];
        }
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      // P as bf16 pairs: the A fragment of keys [16kk, 16kk + 16) is
      // pa[4kk .. 4kk + 3]; keys N .. 15 of an 8-key tile are zero
      uint32_t pa[VB / 4];
#pragma unroll
      for (int j = 0; j < VB / 4; ++j)
        pa[j] = j < N / 4 ? pack_bf16(sacc[2 * j], sacc[2 * j + 1]) : 0u;

      // O = P V over VB keys, V's rows 16 keys (512 bytes) a k-step
      float oacc[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) oacc[t] = 0.f;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < VB / 16; ++kk)
        wgmma_rs(oacc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                 pa[4 * kk + 3],
                 desc_sw32(v_s(slot) + hk * VB * ROW_BYTES + kk * 512, 512,
                           256));
      wg_commit();
      wg_wait<0>();
      pin(oacc);
      pin(pa);

      const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
      const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
      __nv_bfloat16* og = p.o + b * p.o_sb + h * p.o_sh;
      if (qi0 < p.sq) {
        __nv_bfloat16* row = og + (long long)qi0 * p.o_ss + cq;
#pragma unroll
        for (int i8 = 0; i8 < 2; ++i8)
          *reinterpret_cast<__nv_bfloat162*>(row + 8 * i8) =
              __floats2bfloat162_rn(oacc[4 * i8] * inv0,
                                    oacc[4 * i8 + 1] * inv0);
      }
      if (qi1 < p.sq) {
        __nv_bfloat16* row = og + (long long)qi1 * p.o_ss + cq;
#pragma unroll
        for (int i8 = 0; i8 < 2; ++i8)
          *reinterpret_cast<__nv_bfloat162*>(row + 8 * i8) =
              __floats2bfloat162_rn(oacc[4 * i8 + 2] * inv1,
                                    oacc[4 * i8 + 3] * inv1);
      }
      if (p.lse && (lane & 3) == 0) {
        // natural-log units: the row max is in log2 units without a bias
        float* lrow = p.lse + ((long long)b * p.hq + h) * p.sq;
        if (qi0 < p.sq)
          lrow[qi0] = l0 > 0.f ? (HAS_BIAS ? mx0 : mx0 * LN2) + logf(l0)
                               : 0.f;
        if (qi1 < p.sq)
          lrow[qi1] = l1 > 0.f ? (HAS_BIAS ? mx1 : mx1 * LN2) + logf(l1)
                               : 0.f;
      }
    }
    if (lane == 0) mbar_arrive(kv_empty(slot));
  }
}

typedef void (*KernelFn)(CUtensorMap, CUtensorMap, CUtensorMap, Params);

template <int N>
KernelFn kernel_for(bool has_bias) {
  return has_bias ? attention_short_sm90_kernel<N, true>
                  : attention_short_sm90_kernel<N, false>;
}

}  // namespace

// geom: 3 x 11 int64 (q, k, v), each dims[4] (D, S, H, B), byte
// strides[3], box[4]: q (16, 64, 1, 1); k (16, N, Hkv, 1) and v (16,
// max(N, 16), Hkv, 1) with N = Skv rounded up to 8, 16, 32 or 64
extern "C" int vls_attention_short_sm90(
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
  const int hkv = (int)gk[2], skv = (int)gk[1];
  if (gk[3] != batch || hkv <= 0 || gq[2] % hkv || skv <= 0 ||
      skv > MAX_KEYS)
    return (int)cudaErrorInvalidValue;
  const int n = key_tile(skv);
  const size_t smem = smem_bytes(hkv, n);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const int qbox[4] = {D, BQ, 1, 1};
  const int kbox[4] = {D, n, hkv, 1};
  const int vbox[4] = {D, v_rows(n), hkv, 1};
  CUtensorMap tq, tk, tv;
  int e = encode_bf16_box(&tq, q, gq, D, qbox, CU_TENSOR_MAP_SWIZZLE_32B);
  if (e == 0)
    e = encode_bf16_box(&tk, k, gk, D, kbox, CU_TENSOR_MAP_SWIZZLE_32B);
  if (e == 0)
    e = encode_bf16_box(&tv, v, gv, D, vbox, CU_TENSOR_MAP_SWIZZLE_32B);
  if (e != 0) return e;
  Params p;
  p.o = (__nv_bfloat16*)o;
  p.bias = (const float*)bias;
  p.lse = (float*)lse;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.bias_sb = bias_sb;
  p.batch = batch;
  p.hq = (int)gq[2]; p.hkv = hkv;
  p.sq = (int)gq[1]; p.skv = skv;
  p.kv_len = kv_len;
  p.ntq = (p.sq + BQ - 1) / BQ;
  p.scale = scale;
  p.causal = causal;
  const bool has_bias = bias != nullptr;
  const int ni = n == 8 ? 0 : n == 16 ? 1 : n == 32 ? 2 : 3;
  KernelFn kern = ni == 0 ? kernel_for<8>(has_bias)
                  : ni == 1 ? kernel_for<16>(has_bias)
                  : ni == 2 ? kernel_for<32>(has_bias)
                            : kernel_for<64>(has_bias);
  // the host's cost of a launch is most of a call at the mask decoder's
  // shapes: the shared-memory attribute is raised once per instance and
  // size, the SM count read once per device
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
  const long long total = (long long)batch * p.ntq * p.hq;
  const long long want = (long long)sm_count[dev] * per_sm;
  const int grid = (int)(total < want ? total : want);
  kern<<<grid, NT, smem, (cudaStream_t)stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}
