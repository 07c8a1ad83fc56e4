// Flash-style attention forward, bf16 in and out, fp32 softmax state.
//
//   o[b, h, i] = softmax_j(scale * q[b,h,i] . k[b,h//g,j] + bias[b,j]) v[b,h//g,j]
//
// with GQA (kv head = q head // group), causal masking with the diagonal
// aligned to the sequence ends (key j visible to query i iff
// j <= i + Skv - Sq), keys at j >= kv_len masked, and an optional fp32
// additive per-key bias [B, Skv]. Optionally it also writes each row's
// logsumexp lse[b, h, i] = log sum_j exp(s_ij) (fp32, [B, Hq, Sq]
// contiguous), the residual the flash backward (attention_bwd.cu)
// recomputes the probabilities from; a row with no visible key writes 0.
// Every operand is addressed through
// (batch, head, sequence) strides with a contiguous last dim, so window
// batches, fused-qkv column slices and [B, S, H, D] outputs need no copy.
//
// Replaces the TPU kernels
//   video_llava_seg_tpu/ops/attention.py::_flash_kernel         (K2, online
//       softmax over kv blocks) at head dims below 128: the per-op Hiera
//       trunk's global blocks. The online form at head dim 128 (the LLM
//       prefill, Skv ~5.1k causal, and the train step) moved to
//       attention_sm90.cu (TMA + wgmma); its instance here is no longer
//       routed to.
//   video_llava_seg_tpu/ops/attention.py::_flash_kernel_single  (K3, one kv
//       block, plain softmax; mask-decoder image->token attention)
// and the SDPA stage inside
//   video_llava_seg_tpu/ops/vit_block.py::_vit_kernel     (K1)
//   video_llava_seg_tpu/ops/hiera_block.py::_block_kernel (K4, windowed
//       and global attention).
//
// Bound on the card: K2 at a 5k causal prefill is compute-bound (the
// score and context products); K3 is bound by the bytes of its 4096-row
// Q and O, since its ~7 keys give almost no work per byte.
//
// What this simple version does: a block owns 64 query rows and walks
// 64-key tiles; Q stays in shared memory for the whole walk and K/V
// tiles are read once per block, so device traffic is the one read of
// Q, K, V and one write of O (nothing [Sq, Skv]-sized ever leaves the
// block). Products run on the tensor cores through WMMA 16x16x16 bf16
// fragments; each of the 4 warps owns 16 query rows of the score, P and
// fp32 output tiles, so the softmax bookkeeping needs only warp-level
// synchronisation. Causal tiles past the diagonal and tiles past kv_len
// are skipped whole.
//   TWO_PASS = false: online softmax (running max and sum, rescaling the
//     fp32 output tile), the K2 form.
//   TWO_PASS = true: plain softmax, the K3 form. A first walk takes the
//     exact row max, the second accumulates exp(s - max) without any
//     rescale; when all keys fit one tile (the mask-decoder case) it is
//     the single-tile plain softmax of _flash_kernel_single.
// Head dims 16, 32, 64, 80 (RADIO ViT-H: five 16-deep k-steps; Layout<80>
// keeps every WMMA tile 32-byte aligned: rows of 88 bf16 / 84 fp32), 96 and
// 128 are instantiated; at 128, kernels.attention sends only the two-pass
// form here.
// wgmma for these head dims is later work (attention_sm90.cu does it at 128).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int NT = 128;  // 4 warps, 16 query rows each
constexpr int LDS = BKV + 4;  // fp32 score row
constexpr int LDP = BKV + 8;  // bf16 probability row

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  const float* bias;
  float* lse;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  long long bias_sb;
  int hq, hkv, sq, skv, kv_len;
  float scale;
  int causal;
};

__host__ __device__ constexpr size_t round128(size_t x) {
  return (x + 127) / 128 * 128;
}

template <int D>
struct Layout {
  static constexpr int LDQ = D + 8;  // bf16 Q/K/V row
  static constexpr int LDO = D + 4;  // fp32 output row
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + round128((size_t)BQ * LDQ * 2);
  static constexpr size_t v_off = k_off + round128((size_t)BKV * LDQ * 2);
  static constexpr size_t s_off = v_off + round128((size_t)BKV * LDQ * 2);
  static constexpr size_t p_off = s_off + round128((size_t)BQ * LDS * 4);
  static constexpr size_t o_off = p_off + round128((size_t)BQ * LDP * 2);
  static constexpr size_t m_off = o_off + round128((size_t)BQ * LDO * 4);
  static constexpr size_t l_off = m_off + round128((size_t)BQ * 4);
  static constexpr size_t bytes = l_off + round128((size_t)BQ * 4);
};

// rows [r0, r0 + rows) of a strided [S, D] operand -> shared [rows, LDQ],
// zero-filled past `limit`
template <int D>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long stride, int r0, int rows,
                                          int limit) {
  constexpr int CH = D / 8;
  for (int c = threadIdx.x; c < rows * CH; c += NT) {
    const int r = c / CH, cc = (c % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * stride + cc);
    *reinterpret_cast<uint4*>(dst + r * Layout<D>::LDQ + cc) = val;
  }
}

// this warp's 16 rows of S = Q K^T for the resident K tile
template <int D>
__device__ __forceinline__ void warp_scores(const __nv_bfloat16* Qs,
                                            const __nv_bfloat16* Ks, float* S,
                                            int warp) {
  constexpr int LDQ = Layout<D>::LDQ;
#pragma unroll
  for (int j = 0; j < BKV / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
      wmma::load_matrix_sync(a, Qs + (warp * 16) * LDQ + kk * 16, LDQ);
      wmma::load_matrix_sync(b, Ks + (j * 16) * LDQ + kk * 16, LDQ);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(S + (warp * 16) * LDS + j * 16, acc, LDS,
                            wmma::mem_row_major);
  }
}

// masked, scaled, biased score of key column c of the tile; -inf if masked
__device__ __forceinline__ float masked_score(const Params& p, const float* S,
                                              const float* bias, int lrow,
                                              int qi, int j0, int c,
                                              int kv_lim) {
  const int j = j0 + c;
  bool ok = j < kv_lim;
  if (p.causal) ok = ok && j <= qi + (p.skv - p.sq);
  if (!ok) return -INFINITY;
  float s = S[lrow * LDS + c] * p.scale;
  if (bias) s += bias[j];
  return s;
}

template <int D, bool TWO_PASS>
__global__ void __launch_bounds__(NT) attention_kernel(Params p) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + L::q_off);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + L::k_off);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + L::v_off);
  float* S = reinterpret_cast<float*>(smem + L::s_off);
  __nv_bfloat16* P = reinterpret_cast<__nv_bfloat16*>(smem + L::p_off);
  float* O = reinterpret_cast<float*>(smem + L::o_off);
  float* m_sh = reinterpret_cast<float*>(smem + L::m_off);
  float* l_sh = reinterpret_cast<float*>(smem + L::l_off);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // last query block first: under a causal mask it walks the most kv
  // tiles, so the longest blocks start earliest and the tail is short
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const __nv_bfloat16* qg = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = p.k + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vg = p.v + b * p.v_sb + hk * p.v_sh;
  __nv_bfloat16* og = p.o + b * p.o_sb + h * p.o_sh;
  const float* bias = p.bias ? p.bias + b * p.bias_sb : nullptr;

  load_rows<D>(Qs, qg, p.q_ss, q0, BQ, p.sq);
  for (int i = tid; i < BQ * L::LDO; i += NT) O[i] = 0.f;
  for (int i = tid; i < BQ; i += NT) {
    m_sh[i] = -INFINITY;
    l_sh[i] = 0.f;
  }

  // keys this block can see: kv_len, then the causal diagonal of its
  // last query row
  const int kv_lim = min(p.kv_len, p.skv);
  int kv_end = kv_lim;
  if (p.causal) kv_end = min(kv_end, q0 + BQ + (p.skv - p.sq));
  const int n_tiles = kv_end > 0 ? (kv_end + BKV - 1) / BKV : 0;
  __syncthreads();

  const int row = lane >> 1, half = lane & 1;
  const int lrow = warp * 16 + row;
  const int qi = q0 + lrow;
  const int c0 = half * (BKV / 2);

  if (TWO_PASS) {
    // walk 1: exact row max over every visible key
    float m_run = -INFINITY;
    for (int t = 0; t < n_tiles; ++t) {
      load_rows<D>(Ks, kg, p.k_ss, t * BKV, BKV, p.skv);
      __syncthreads();
      warp_scores<D>(Qs, Ks, S, warp);
      __syncwarp();
      for (int c = c0; c < c0 + BKV / 2; ++c)
        m_run = fmaxf(m_run, masked_score(p, S, bias, lrow, qi, t * BKV, c, kv_lim));
      __syncthreads();
    }
    m_run = fmaxf(m_run, __shfl_xor_sync(0xffffffffu, m_run, 1));
    if (half == 0) m_sh[lrow] = m_run;
    __syncthreads();
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * BKV;
    load_rows<D>(Ks, kg, p.k_ss, j0, BKV, p.skv);
    load_rows<D>(Vs, vg, p.v_ss, j0, BKV, p.skv);
    __syncthreads();
    warp_scores<D>(Qs, Ks, S, warp);
    __syncwarp();

    const float m_old = m_sh[lrow];
    float m_new = m_old;
    if (!TWO_PASS) {
      float tmax = -INFINITY;
      for (int c = c0; c < c0 + BKV / 2; ++c)
        tmax = fmaxf(tmax, masked_score(p, S, bias, lrow, qi, j0, c, kv_lim));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      m_new = fmaxf(m_old, tmax);
    }
    float rsum = 0.f;
    for (int c = c0; c < c0 + BKV / 2; ++c) {
      const float s = masked_score(p, S, bias, lrow, qi, j0, c, kv_lim);
      const float e = (s == -INFINITY) ? 0.f : __expf(s - m_new);
      rsum += e;
      P[lrow * LDP + c] = __float2bfloat16(e);
    }
    rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
    if (!TWO_PASS) {
      const float alpha =
          (m_old == -INFINITY) ? 1.f : __expf(m_old - m_new);
      for (int c = half * (D / 2); c < (half + 1) * (D / 2); ++c)
        O[lrow * L::LDO + c] *= alpha;
      __syncwarp();
      if (half == 0) {
        m_sh[lrow] = m_new;
        l_sh[lrow] = l_sh[lrow] * alpha + rsum;
      }
    } else {
      __syncwarp();
      if (half == 0) l_sh[lrow] += rsum;
    }
    __syncwarp();

    // O[warp rows] += P V
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      float* optr = O + (warp * 16) * L::LDO + j * 16;
      wmma::load_matrix_sync(acc, optr, L::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, P + (warp * 16) * LDP + kk * 16, LDP);
        wmma::load_matrix_sync(bv, Vs + (kk * 16) * L::LDQ + j * 16, L::LDQ);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(optr, acc, L::LDO, wmma::mem_row_major);
    }
    __syncthreads();
  }

  __syncwarp();
  if (qi < p.sq) {
    const float l = l_sh[lrow];
    const float inv = l > 0.f ? 1.f / l : 0.f;
    for (int c = half * (D / 2); c < (half + 1) * (D / 2); ++c)
      og[(long long)qi * p.o_ss + c] = __float2bfloat16(O[lrow * L::LDO + c] * inv);
    // both forms hold the row max in m_sh and the sum relative to it in l_sh
    if (p.lse && half == 0)
      p.lse[(b * p.hq + h) * (long long)p.sq + qi] =
          l > 0.f ? m_sh[lrow] + logf(l) : 0.f;
  }
}

template <int D, bool TWO_PASS>
int launch(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = Layout<D>::bytes;
  auto kern = attention_kernel<D, TWO_PASS>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((p.sq + BQ - 1) / BQ, p.hq, batch);
  kern<<<grid, NT, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool TWO_PASS>
int dispatch_dim(const Params& p, int batch, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<16, TWO_PASS>(p, batch, stream);
    case 32: return launch<32, TWO_PASS>(p, batch, stream);
    case 64: return launch<64, TWO_PASS>(p, batch, stream);
    case 80: return launch<80, TWO_PASS>(p, batch, stream);
    case 96: return launch<96, TWO_PASS>(p, batch, stream);
    case 128: return launch<128, TWO_PASS>(p, batch, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int vls_attention_bf16(
    const void* q, const void* k, const void* v, void* o, const void* bias,
    void* lse, long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    long long bias_sb, int batch, int hq, int hkv, int sq, int skv, int d,
    int kv_len, float scale, int causal, int two_pass, void* stream) {
  if (batch <= 0 || sq <= 0) return 0;
  Params p;
  p.q = (const __nv_bfloat16*)q;
  p.k = (const __nv_bfloat16*)k;
  p.v = (const __nv_bfloat16*)v;
  p.o = (__nv_bfloat16*)o;
  p.bias = (const float*)bias;
  p.lse = (float*)lse;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.bias_sb = bias_sb;
  p.hq = hq; p.hkv = hkv; p.sq = sq; p.skv = skv; p.kv_len = kv_len;
  p.scale = scale;
  p.causal = causal;
  cudaStream_t s = (cudaStream_t)stream;
  return two_pass ? dispatch_dim<true>(p, batch, d, s)
                  : dispatch_dim<false>(p, batch, d, s);
}
