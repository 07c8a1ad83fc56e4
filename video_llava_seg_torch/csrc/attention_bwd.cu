// Flash-attention backward, bf16 in and out, fp32 state: the gradients of
//
//   o[b, h, i] = softmax_j(scale * q[b,h,i] . k[b,h//g,j] + bias[b,j]) v[b,h//g,j]
//
// (attention.cu's forward) from the forward's output O, its per-row
// logsumexp lse and the incoming dO, recomputing the probabilities tile
// by tile instead of keeping them:
//
//   delta_i = sum_d dO_id O_id                      (fp32, one pre-pass)
//   p_ij    = exp(scale * q_i . k_j + bias_j - lse_i)
//   dp_ij   = dO_i . v_j
//   ds_ij   = p_ij (dp_ij - delta_i) scale          (rounded to bf16)
//   dQ_i    = sum_j ds_ij k_j                       (K6a)
//   dK_j    = sum_(h in group, i) ds_ij q_i         (K6b)
//   dV_j    = sum_(h in group, i) p_ij dO_i         (K6b, p rounded to bf16)
//
// with the forward's masking: GQA (kv head = q head // group), causal
// with the diagonal at the sequence ends (key j visible to query i iff
// j <= i + Skv - Sq), an optional fp32 additive per-key bias [B, Skv]
// (a masked key's p underflows to exactly 0, so its dK and dV are exactly
// 0). Every operand is addressed through (batch, head, sequence) strides
// with a contiguous last dim.
//
// Replaces the TPU kernels
//   video_llava_seg_tpu/ops/attention.py::_bwd_dq_kernel   (K6a)
//   video_llava_seg_tpu/ops/attention.py::_bwd_dkv_kernel  (K6b)
// at every head dim but 128 (the mask decoder's 16 among them), and takes
// their math, not their block layout: the TPU grid walks the reduction
// axis in order and carries the sum in VMEM scratch; here one block owns
// its output tile and walks the reduction in a loop. At head dim 128, the
// LLM's, `kernels.attention_bwd_entry` routes to the TMA + wgmma kernels
// of attention_bwd_sm90.cu; this file's D = 128 instance stays only as
// the yardstick chip_smoke.py and the CUDA tests time and compare beside
// them.
//
// Bound on the card: at the LLM's causal S ~ 5.1k, D = 128 both kernels
// are bound by tensor-core operations (3 products of the QK^T size for
// K6a, 4 for K6b); at the mask decoder's 4096 queries over 7 keys, D = 16
// by the bytes of Q, O, dO and dQ.
//
// What this simple version does:
//   K6a: a block owns 64 query rows of one (batch, q head); Q and dO stay
//     in shared memory while it walks 64-key tiles (causal tiles past the
//     diagonal skipped whole); each of the 4 warps owns 16 query rows of
//     the score, dP and dS tiles and of the fp32 dQ accumulator.
//   K6b: a block owns 64 keys of one (batch, kv head); K and V stay in
//     shared memory while it walks the group's q heads and their 64-row
//     query tiles (causal tiles before the diagonal skipped whole), so
//     the GQA sum happens in the block: no [B, Hq, Skv, D] temporaries,
//     no atomics. The scores are formed transposed (K Q^T), so each warp
//     owns 16 key rows of every tile and of the fp32 dK / dV accumulators.
//   Products run on the tensor cores through WMMA 16x16x16 bf16
//   fragments, as in attention.cu. Nothing [Sq, Skv]-sized leaves a block;
//   device traffic is one read of Q, K, V, O, dO per walk and one write
//   of each gradient.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int NT = 128;       // 4 warps, 16 rows each
constexpr int LDS = BKV + 4;  // fp32 64-wide tile row
constexpr int LDP = BKV + 8;  // bf16 64-wide tile row

struct BwdParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* bias;
  const float* lse;    // [B, Hq, Sq]
  float* delta;        // [B, Hq, Sq]
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  long long do_sb, do_sh, do_ss;
  long long dq_sb, dq_sh, dq_ss;
  long long dk_sb, dk_sh, dk_ss;
  long long dv_sb, dv_sh, dv_ss;
  long long bias_sb;
  int hq, hkv, sq, skv;
  float scale;
  int causal;
};

__host__ __device__ constexpr size_t round128(size_t x) {
  return (x + 127) / 128 * 128;
}

template <int D>
struct DqLayout {
  static constexpr int LDQ = D + 8;  // bf16 Q/dO/K/V row
  static constexpr int LDA = D + 4;  // fp32 accumulator row
  static constexpr size_t q_off = 0;
  static constexpr size_t do_off = q_off + round128((size_t)BQ * LDQ * 2);
  static constexpr size_t k_off = do_off + round128((size_t)BQ * LDQ * 2);
  static constexpr size_t v_off = k_off + round128((size_t)BKV * LDQ * 2);
  static constexpr size_t s_off = v_off + round128((size_t)BKV * LDQ * 2);
  static constexpr size_t dp_off = s_off + round128((size_t)BQ * LDS * 4);
  static constexpr size_t ds_off = dp_off + round128((size_t)BQ * LDS * 4);
  static constexpr size_t acc_off = ds_off + round128((size_t)BQ * LDP * 2);
  static constexpr size_t lse_off = acc_off + round128((size_t)BQ * LDA * 4);
  static constexpr size_t delta_off = lse_off + round128((size_t)BQ * 4);
  static constexpr size_t bytes = delta_off + round128((size_t)BQ * 4);
};

template <int D>
struct DkvLayout {
  static constexpr int LDQ = D + 8;
  static constexpr int LDA = D + 4;
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = k_off + round128((size_t)BKV * LDQ * 2);
  static constexpr size_t q_off = v_off + round128((size_t)BKV * LDQ * 2);
  static constexpr size_t do_off = q_off + round128((size_t)BQ * LDQ * 2);
  static constexpr size_t s_off = do_off + round128((size_t)BQ * LDQ * 2);
  static constexpr size_t dp_off = s_off + round128((size_t)BKV * LDS * 4);
  static constexpr size_t p_off = dp_off + round128((size_t)BKV * LDS * 4);
  static constexpr size_t ds_off = p_off + round128((size_t)BKV * LDP * 2);
  static constexpr size_t dk_off = ds_off + round128((size_t)BKV * LDP * 2);
  static constexpr size_t dv_off = dk_off + round128((size_t)BKV * LDA * 4);
  static constexpr size_t lse_off = dv_off + round128((size_t)BKV * LDA * 4);
  static constexpr size_t delta_off = lse_off + round128((size_t)BQ * 4);
  static constexpr size_t bytes = delta_off + round128((size_t)BQ * 4);
};

// rows [r0, r0 + rows) of a strided [S, D] operand -> shared [rows, D + 8],
// zero-filled past `limit`
template <int D>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long stride, int r0, int rows,
                                          int limit) {
  constexpr int CH = D / 8;
  constexpr int LD = D + 8;
  for (int c = threadIdx.x; c < rows * CH; c += NT) {
    const int r = c / CH, cc = (c % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * stride + cc);
    *reinterpret_cast<uint4*>(dst + r * LD + cc) = val;
  }
}

// C[this warp's 16 rows][0, 64) = A[rows][0, D) . B[0, 64)[0, D)^T
// A, B bf16 with row stride D + 8; C fp32 with row stride LDS
template <int D>
__device__ __forceinline__ void warp_abt(const __nv_bfloat16* A,
                                         const __nv_bfloat16* B, float* C,
                                         int warp) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int j = 0; j < BKV / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
      wmma::load_matrix_sync(a, A + (warp * 16) * LD + kk * 16, LD);
      wmma::load_matrix_sync(b, B + (j * 16) * LD + kk * 16, LD);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(C + (warp * 16) * LDS + j * 16, acc, LDS,
                            wmma::mem_row_major);
  }
}

// Acc[this warp's 16 rows][0, D) += A[rows][0, 64) . B[0, 64)[0, D)
// A bf16 with row stride LDP; B bf16 with row stride D + 8; Acc fp32 with
// row stride D + 4
template <int D>
__device__ __forceinline__ void warp_acc_ab(const __nv_bfloat16* A,
                                            const __nv_bfloat16* B,
                                            float* Acc, int warp) {
  constexpr int LDB = D + 8;
  constexpr int LDA = D + 4;
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    float* aptr = Acc + (warp * 16) * LDA + j * 16;
    wmma::load_matrix_sync(acc, aptr, LDA, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < 64 / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
      wmma::load_matrix_sync(a, A + (warp * 16) * LDP + kk * 16, LDP);
      wmma::load_matrix_sync(b, B + (kk * 16) * LDB + j * 16, LDB);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(aptr, acc, LDA, wmma::mem_row_major);
  }
}

// scaled, biased score of query qi and key j, or -inf where the forward
// masked it (causal, or past either sequence)
__device__ __forceinline__ float bwd_score(const BwdParams& p, float raw,
                                           const float* bias, int qi, int j) {
  bool ok = j < p.skv && qi < p.sq;
  if (p.causal) ok = ok && j <= qi + (p.skv - p.sq);
  if (!ok) return -INFINITY;
  float s = raw * p.scale;
  if (bias) s += bias[j];
  return s;
}

// delta[b, h, i] = sum_d dO[b, h, i, d] * O[b, h, i, d] in fp32, one row
// per thread (16-byte loads along the row)
__global__ void delta_kernel(BwdParams p, int batch, int d) {
  const long long row = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (row >= (long long)batch * p.hq * p.sq) return;
  const int i = (int)(row % p.sq);
  const long long bh = row / p.sq;
  const int h = (int)(bh % p.hq);
  const long long b = bh / p.hq;
  const __nv_bfloat16* o = p.o + b * p.o_sb + h * p.o_sh + i * p.o_ss;
  const __nv_bfloat16* g = p.dout + b * p.do_sb + h * p.do_sh + i * p.do_ss;
  float acc = 0.f;
  for (int c = 0; c < d; c += 8) {
    const uint4 ov = *reinterpret_cast<const uint4*>(o + c);
    const uint4 gv = *reinterpret_cast<const uint4*>(g + c);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(o2[e]);
      const float2 y = __bfloat1622float2(g2[e]);
      acc += x.x * y.x + x.y * y.y;
    }
  }
  p.delta[row] = acc;
}

// K6a: dQ for 64 query rows of one (batch, q head)
template <int D>
__global__ void __launch_bounds__(NT) dq_kernel(BwdParams p) {
  using L = DqLayout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + L::q_off);
  __nv_bfloat16* dOs = reinterpret_cast<__nv_bfloat16*>(smem + L::do_off);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + L::k_off);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + L::v_off);
  float* S = reinterpret_cast<float*>(smem + L::s_off);
  float* dP = reinterpret_cast<float*>(smem + L::dp_off);
  __nv_bfloat16* dS = reinterpret_cast<__nv_bfloat16*>(smem + L::ds_off);
  float* Acc = reinterpret_cast<float*>(smem + L::acc_off);
  float* lse_sh = reinterpret_cast<float*>(smem + L::lse_off);
  float* delta_sh = reinterpret_cast<float*>(smem + L::delta_off);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // last query tile first: under a causal mask it walks the most kv tiles
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const long long row0 = (b * p.hq + h) * (long long)p.sq;
  const __nv_bfloat16* kg = p.k + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vg = p.v + b * p.v_sb + hk * p.v_sh;
  const float* bias = p.bias ? p.bias + b * p.bias_sb : nullptr;

  load_rows<D>(Qs, p.q + b * p.q_sb + h * p.q_sh, p.q_ss, q0, BQ, p.sq);
  load_rows<D>(dOs, p.dout + b * p.do_sb + h * p.do_sh, p.do_ss, q0, BQ,
               p.sq);
  for (int i = tid; i < BQ * L::LDA; i += NT) Acc[i] = 0.f;
  for (int i = tid; i < BQ; i += NT) {
    const bool in = q0 + i < p.sq;
    lse_sh[i] = in ? p.lse[row0 + q0 + i] : 0.f;
    delta_sh[i] = in ? p.delta[row0 + q0 + i] : 0.f;
  }
  int kv_end = p.skv;
  if (p.causal) kv_end = min(kv_end, q0 + BQ + (p.skv - p.sq));
  const int n_tiles = kv_end > 0 ? (kv_end + BKV - 1) / BKV : 0;
  __syncthreads();

  const int lrow = warp * 16 + (lane >> 1);
  const int qi = q0 + lrow;
  const int c0 = (lane & 1) * (BKV / 2);
  const float lse_r = lse_sh[lrow], delta_r = delta_sh[lrow];

  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * BKV;
    load_rows<D>(Ks, kg, p.k_ss, j0, BKV, p.skv);
    load_rows<D>(Vs, vg, p.v_ss, j0, BKV, p.skv);
    __syncthreads();
    warp_abt<D>(Qs, Ks, S, warp);
    warp_abt<D>(dOs, Vs, dP, warp);
    __syncwarp();
    for (int c = c0; c < c0 + BKV / 2; ++c) {
      const float s = bwd_score(p, S[lrow * LDS + c], bias, qi, j0 + c);
      const float pv = (s == -INFINITY) ? 0.f : __expf(s - lse_r);
      dS[lrow * LDP + c] =
          __float2bfloat16(pv * (dP[lrow * LDS + c] - delta_r) * p.scale);
    }
    __syncwarp();
    warp_acc_ab<D>(dS, Ks, Acc, warp);
    __syncthreads();
  }

  __syncwarp();
  if (qi < p.sq) {
    __nv_bfloat16* dqg = p.dq + b * p.dq_sb + h * p.dq_sh + (long long)qi * p.dq_ss;
    for (int c = (lane & 1) * (D / 2); c < ((lane & 1) + 1) * (D / 2); ++c)
      dqg[c] = __float2bfloat16(Acc[lrow * L::LDA + c]);
  }
}

// K6b: dK and dV for 64 keys of one (batch, kv head), summed over the
// group's q heads and every query tile that sees them
template <int D>
__global__ void __launch_bounds__(NT) dkv_kernel(BwdParams p) {
  using L = DkvLayout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + L::k_off);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + L::v_off);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + L::q_off);
  __nv_bfloat16* dOs = reinterpret_cast<__nv_bfloat16*>(smem + L::do_off);
  float* St = reinterpret_cast<float*>(smem + L::s_off);
  float* dPt = reinterpret_cast<float*>(smem + L::dp_off);
  __nv_bfloat16* Pt = reinterpret_cast<__nv_bfloat16*>(smem + L::p_off);
  __nv_bfloat16* dSt = reinterpret_cast<__nv_bfloat16*>(smem + L::ds_off);
  float* dKacc = reinterpret_cast<float*>(smem + L::dk_off);
  float* dVacc = reinterpret_cast<float*>(smem + L::dv_off);
  float* lse_sh = reinterpret_cast<float*>(smem + L::lse_off);
  float* delta_sh = reinterpret_cast<float*>(smem + L::delta_off);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // first key tile first: under a causal mask it is seen by the most
  // query tiles
  const int k0 = blockIdx.x * BKV;
  const int hk = blockIdx.y;
  const long long b = blockIdx.z;
  const int group = p.hq / p.hkv;
  const float* bias = p.bias ? p.bias + b * p.bias_sb : nullptr;

  load_rows<D>(Ks, p.k + b * p.k_sb + hk * p.k_sh, p.k_ss, k0, BKV, p.skv);
  load_rows<D>(Vs, p.v + b * p.v_sb + hk * p.v_sh, p.v_ss, k0, BKV, p.skv);
  for (int i = tid; i < BKV * L::LDA; i += NT) {
    dKacc[i] = 0.f;
    dVacc[i] = 0.f;
  }
  // first query tile with a row that sees key k0: t * BQ + BQ - 1 +
  // (Skv - Sq) >= k0
  int t_first = 0;
  if (p.causal) {
    const int lo = k0 - (p.skv - p.sq) - (BQ - 1);
    t_first = lo > 0 ? (lo + BQ - 1) / BQ : 0;
  }
  const int n_qt = (p.sq + BQ - 1) / BQ;

  const int lrow = warp * 16 + (lane >> 1);
  const int kj = k0 + lrow;
  const int c0 = (lane & 1) * (BQ / 2);

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const long long row0 = (b * p.hq + h) * (long long)p.sq;
    const __nv_bfloat16* qg = p.q + b * p.q_sb + h * p.q_sh;
    const __nv_bfloat16* dog = p.dout + b * p.do_sb + h * p.do_sh;
    for (int t = t_first; t < n_qt; ++t) {
      const int q0 = t * BQ;
      __syncthreads();  // the previous tile's readers are done
      load_rows<D>(Qs, qg, p.q_ss, q0, BQ, p.sq);
      load_rows<D>(dOs, dog, p.do_ss, q0, BQ, p.sq);
      for (int i = tid; i < BQ; i += NT) {
        const bool in = q0 + i < p.sq;
        lse_sh[i] = in ? p.lse[row0 + q0 + i] : 0.f;
        delta_sh[i] = in ? p.delta[row0 + q0 + i] : 0.f;
      }
      __syncthreads();
      warp_abt<D>(Ks, Qs, St, warp);
      warp_abt<D>(Vs, dOs, dPt, warp);
      __syncwarp();
      for (int c = c0; c < c0 + BQ / 2; ++c) {
        const float s = bwd_score(p, St[lrow * LDS + c], bias, q0 + c, kj);
        const float pv = (s == -INFINITY) ? 0.f : __expf(s - lse_sh[c]);
        Pt[lrow * LDP + c] = __float2bfloat16(pv);
        dSt[lrow * LDP + c] = __float2bfloat16(
            pv * (dPt[lrow * LDS + c] - delta_sh[c]) * p.scale);
      }
      __syncwarp();
      warp_acc_ab<D>(Pt, dOs, dVacc, warp);
      warp_acc_ab<D>(dSt, Qs, dKacc, warp);
    }
  }

  __syncthreads();
  if (kj < p.skv) {
    __nv_bfloat16* dkg = p.dk + b * p.dk_sb + hk * p.dk_sh + (long long)kj * p.dk_ss;
    __nv_bfloat16* dvg = p.dv + b * p.dv_sb + hk * p.dv_sh + (long long)kj * p.dv_ss;
    for (int c = (lane & 1) * (D / 2); c < ((lane & 1) + 1) * (D / 2); ++c) {
      dkg[c] = __float2bfloat16(dKacc[lrow * L::LDA + c]);
      dvg[c] = __float2bfloat16(dVacc[lrow * L::LDA + c]);
    }
  }
}

template <typename Kern>
int set_smem(Kern kern, size_t smem) {
  if (smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return 0;
}

template <int D>
int launch_dq(const BwdParams& p, int batch, cudaStream_t stream) {
  const size_t smem = DqLayout<D>::bytes;
  const int e = set_smem(dq_kernel<D>, smem);
  if (e) return e;
  dim3 grid((p.sq + BQ - 1) / BQ, p.hq, batch);
  dq_kernel<D><<<grid, NT, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const BwdParams& p, int batch, cudaStream_t stream) {
  const size_t smem = DkvLayout<D>::bytes;
  const int e = set_smem(dkv_kernel<D>, smem);
  if (e) return e;
  dim3 grid((p.skv + BKV - 1) / BKV, p.hkv, batch);
  dkv_kernel<D><<<grid, NT, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

int dispatch_dq(const BwdParams& p, int batch, int d, cudaStream_t s) {
  switch (d) {
    case 16: return launch_dq<16>(p, batch, s);
    case 32: return launch_dq<32>(p, batch, s);
    case 64: return launch_dq<64>(p, batch, s);
    case 96: return launch_dq<96>(p, batch, s);
    case 128: return launch_dq<128>(p, batch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch_dkv(const BwdParams& p, int batch, int d, cudaStream_t s) {
  switch (d) {
    case 16: return launch_dkv<16>(p, batch, s);
    case 32: return launch_dkv<32>(p, batch, s);
    case 64: return launch_dkv<64>(p, batch, s);
    case 96: return launch_dkv<96>(p, batch, s);
    case 128: return launch_dkv<128>(p, batch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

void set_common(BwdParams& p, const void* q, const void* k, const void* v,
                const void* dout, const void* bias, const void* lse,
                void* delta, long long q_sb, long long q_sh, long long q_ss,
                long long k_sb, long long k_sh, long long k_ss,
                long long v_sb, long long v_sh, long long v_ss,
                long long do_sb, long long do_sh, long long do_ss,
                long long bias_sb, int hq, int hkv, int sq, int skv,
                float scale, int causal) {
  p.q = (const __nv_bfloat16*)q;
  p.k = (const __nv_bfloat16*)k;
  p.v = (const __nv_bfloat16*)v;
  p.dout = (const __nv_bfloat16*)dout;
  p.bias = (const float*)bias;
  p.lse = (const float*)lse;
  p.delta = (float*)delta;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.do_sb = do_sb; p.do_sh = do_sh; p.do_ss = do_ss;
  p.bias_sb = bias_sb;
  p.hq = hq; p.hkv = hkv; p.sq = sq; p.skv = skv;
  p.scale = scale;
  p.causal = causal;
}

}  // namespace

// K6a: the delta pre-pass (written to `delta`, which the K6b entry then
// reads) and dQ
extern "C" int vls_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* bias, const void* lse, void* delta,
    void* dq, long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    long long do_sb, long long do_sh, long long do_ss, long long dq_sb,
    long long dq_sh, long long dq_ss, long long bias_sb, int batch, int hq,
    int hkv, int sq, int skv, int d, float scale, int causal, void* stream) {
  if (batch <= 0 || sq <= 0) return 0;
  BwdParams p = {};
  set_common(p, q, k, v, dout, bias, lse, delta, q_sb, q_sh, q_ss, k_sb,
             k_sh, k_ss, v_sb, v_sh, v_ss, do_sb, do_sh, do_ss, bias_sb, hq,
             hkv, sq, skv, scale, causal);
  p.o = (const __nv_bfloat16*)o;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.dq = (__nv_bfloat16*)dq;
  p.dq_sb = dq_sb; p.dq_sh = dq_sh; p.dq_ss = dq_ss;
  cudaStream_t s = (cudaStream_t)stream;
  const long long rows = (long long)batch * hq * sq;
  delta_kernel<<<(unsigned)((rows + 255) / 256), 256, 0, s>>>(p, batch, d);
  const int e = (int)cudaGetLastError();
  if (e) return e;
  return dispatch_dq(p, batch, d, s);
}

// K6b: dK and dV, from the delta the K6a entry wrote
extern "C" int vls_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* bias, const void* lse, const void* delta, void* dk, void* dv,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long do_sb, long long do_sh, long long do_ss,
    long long dk_sb, long long dk_sh, long long dk_ss, long long dv_sb,
    long long dv_sh, long long dv_ss, long long bias_sb, int batch, int hq,
    int hkv, int sq, int skv, int d, float scale, int causal, void* stream) {
  if (batch <= 0 || skv <= 0) return 0;
  BwdParams p = {};
  set_common(p, q, k, v, dout, bias, lse, (void*)delta, q_sb, q_sh, q_ss,
             k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, do_sb, do_sh, do_ss,
             bias_sb, hq, hkv, sq, skv, scale, causal);
  p.dk = (__nv_bfloat16*)dk;
  p.dk_sb = dk_sb; p.dk_sh = dk_sh; p.dk_ss = dk_ss;
  p.dv = (__nv_bfloat16*)dv;
  p.dv_sb = dv_sb; p.dv_sh = dv_sh; p.dv_ss = dv_ss;
  return dispatch_dkv(p, batch, d, (cudaStream_t)stream);
}
