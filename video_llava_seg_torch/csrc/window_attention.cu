// Windowed multi-head attention read straight from the fused-qkv map.
//
//   o[b, wr*qs + i/qs, wc*qs + i%qs, h] = sum_j softmax_j(scale q_i . k_j) v_j
//
// over the ws x ws window (wr, wc) of qkv [B, H, W, 3C], whose last axis is
// [q | k | v] with heads major inside each (head h = columns h*hd..h*hd+hd),
// so key j of the window is the pixel (wr*ws + j/ws, wc*ws + j%ws). With ps
// = 2 the queries are the 2x2 max pools of q inside the window (qs = ws/2
// per side) and the output is the pooled map [B, H/2, W/2, C]; with ps = 1,
// qs = ws and the output is [B, H, W, C]. H and W are multiples of ws (the
// caller zero-pads the map before its qkv dense).
//
// Replaces the TPU kernel
//   video_llava_seg_tpu/ops/window_attention.py::_win_kernel (K7)
// which tiles rows of windows into VMEM and forms each window with
// in-VMEM reshapes and transposes. Here a block owns 64 queries of one
// (image, window, head): it gathers its q rows (taking the 2x2 max while
// loading, so no pooled map is written), k and v rows through the map's
// strides into shared memory, so neither the partitioned windows nor the
// pooled q ever exist in device memory. All of a window's keys (at most
// 256) fit in shared memory at once, so the softmax is the plain one of
// the TPU kernel: exact row max, exp, divide by the row sum, round the
// probabilities to bf16, one P V product. Keys are padded to a multiple of
// 16 with zero rows and masked; a head dim that is not a multiple of 16
// (Hiera-L's 72) is zero-padded to the next instantiated width (80), which
// changes no product.
//
// Bound on the card: bytes. Each window reads its q, k and v rows once (q
// rows four times under pooling, each read taking the max of four pixels)
// and writes its output once; the products are 4 * nq * nk * hd per head,
// far under the tensor cores' rate at these window sizes. Products run on
// WMMA 16x16x16 bf16 fragments; each of the 4 warps owns 16 query rows;
// v overwrites k in shared memory once the scores exist. Per-window
// smem is sized at launch from the key count (52 KB for 64 keys at hd 96,
// 139 KB for 196 keys), so small windows keep several blocks on an SM.
// Later work: several windows per block for the 16-key windows, mma.sync
// fragments in registers, cp.async loads.
//
// Contract (checked by the Python wrapper): qkv contiguous bf16, hd % 8 ==
// 0, hd <= 128, ws * ws <= 256, ps in {1, 2} dividing ws.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;
constexpr int NT = 128;  // 4 warps, 16 query rows each

struct Params {
  const __nv_bfloat16* qkv;
  __nv_bfloat16* o;
  int H, W, C, heads, hd, ws, ps, n_wc, nk, nkp;
  float scale;
};

__host__ __device__ constexpr size_t round128(size_t x) {
  return (x + 127) / 128 * 128;
}

template <int D>
struct Layout {
  static constexpr int LDQ = D + 8;  // bf16 q / k / v row
  static constexpr int LDO = D + 4;  // fp32 output row
  int lds, ldp;                      // fp32 score row, bf16 probability row
  size_t kv_off, s_off, p_off, bytes;
  __host__ __device__ explicit Layout(int nkp) {
    lds = nkp + 4;
    ldp = nkp + 8;
    kv_off = round128((size_t)BQ * LDQ * 2);
    s_off = kv_off + round128((size_t)nkp * LDQ * 2);
    size_t s_bytes = (size_t)BQ * lds * 4;
    const size_t o_bytes = (size_t)BQ * LDO * 4;
    if (o_bytes > s_bytes) s_bytes = o_bytes;
    p_off = s_off + round128(s_bytes);
    bytes = p_off + round128((size_t)BQ * ldp * 2);
  }
};

__device__ __forceinline__ uint4 max8(uint4 a, uint4 b) {
  __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = __hmax2(x[i], y[i]);
  return a;
}

__device__ __forceinline__ uint4 ld16(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// rows [0, nkp) of the window's k (which = 1) or v (which = 2) slice ->
// shared [nkp, LDQ], zero past the window's keys and past hd
template <int D>
__device__ __forceinline__ void load_kv(__nv_bfloat16* dst,
                                        const __nv_bfloat16* img,
                                        const Params& p, int wr, int wc,
                                        int h, int which) {
  constexpr int DCH = D / 8;
  const int ch = p.hd / 8;
  const long long c3 = 3LL * p.C;
  for (int c = threadIdx.x; c < p.nkp * DCH; c += NT) {
    const int r = c / DCH, cc = c % DCH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < p.nk && cc < ch) {
      const int y = wr * p.ws + r / p.ws, x = wc * p.ws + r % p.ws;
      val = ld16(img + ((long long)y * p.W + x) * c3 + which * p.C
                 + h * p.hd + cc * 8);
    }
    *reinterpret_cast<uint4*>(dst + r * Layout<D>::LDQ + cc * 8) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(NT) window_attention_kernel(Params p) {
  constexpr int LDQ = Layout<D>::LDQ, LDO = Layout<D>::LDO;
  constexpr int DCH = D / 8;
  const Layout<D> L(p.nkp);
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* KVs = reinterpret_cast<__nv_bfloat16*>(smem + L.kv_off);
  float* S = reinterpret_cast<float*>(smem + L.s_off);
  float* O = S;  // the scores are dead once P exists
  __nv_bfloat16* P = reinterpret_cast<__nv_bfloat16*>(smem + L.p_off);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qs = p.ws / p.ps, nq = qs * qs;
  const int q0 = blockIdx.x * BQ;
  const int win = blockIdx.y / p.heads, h = blockIdx.y % p.heads;
  const int wr = win / p.n_wc, wc = win % p.n_wc;
  const long long b = blockIdx.z;
  const long long c3 = 3LL * p.C;
  const __nv_bfloat16* img = p.qkv + b * p.H * p.W * c3;
  const int ch = p.hd / 8;

  // q rows of this block's queries (2x2 max of the four pixels if pooled)
  for (int c = tid; c < BQ * DCH; c += NT) {
    const int r = c / DCH, cc = c % DCH, i = q0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (i < nq && cc < ch) {
      const int y = wr * p.ws + (i / qs) * p.ps;
      const int x = wc * p.ws + (i % qs) * p.ps;
      const __nv_bfloat16* src =
          img + ((long long)y * p.W + x) * c3 + h * p.hd + cc * 8;
      val = ld16(src);
      if (p.ps == 2) {
        const long long row = (long long)p.W * c3;
        val = max8(val, ld16(src + c3));
        val = max8(val, ld16(src + row));
        val = max8(val, ld16(src + row + c3));
      }
    }
    *reinterpret_cast<uint4*>(Qs + r * LDQ + cc * 8) = val;
  }
  load_kv<D>(KVs, img, p, wr, wc, h, 1);
  __syncthreads();

  // warps whose 16 rows hold no query skip the products
  const bool active = q0 + warp * 16 < nq;
  if (active) {
    for (int j = 0; j < p.nkp / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> bk;
        wmma::load_matrix_sync(a, Qs + (warp * 16) * LDQ + kk * 16, LDQ);
        wmma::load_matrix_sync(bk, KVs + (j * 16) * LDQ + kk * 16, LDQ);
        wmma::mma_sync(acc, a, bk, acc);
      }
      wmma::store_matrix_sync(S + (warp * 16) * L.lds + j * 16, acc, L.lds,
                              wmma::mem_row_major);
    }
  }
  __syncthreads();  // every warp is done with k: v takes its place
  load_kv<D>(KVs, img, p, wr, wc, h, 2);

  if (active) {
    // softmax of this warp's rows: two lanes per row, alternate columns
    __syncwarp();
    const int lrow = warp * 16 + (lane >> 1), half = lane & 1;
    const float* srow = S + lrow * L.lds;
    float m = -INFINITY;
    for (int c = half; c < p.nk; c += 2) m = fmaxf(m, srow[c] * p.scale);
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    float l = 0.f;
    for (int c = half; c < p.nk; c += 2) l += expf(srow[c] * p.scale - m);
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    __nv_bfloat16* prow = P + lrow * L.ldp;
    for (int c = half; c < p.nkp; c += 2)
      prow[c] = __float2bfloat16_rn(
          c < p.nk ? __fdiv_rn(expf(srow[c] * p.scale - m), l) : 0.f);
  }
  __syncthreads();  // v in place, P complete

  if (active) {
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < p.nkp / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bv;
        wmma::load_matrix_sync(a, P + (warp * 16) * L.ldp + kk * 16, L.ldp);
        wmma::load_matrix_sync(bv, KVs + (kk * 16) * LDQ + j * 16, LDQ);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(O + (warp * 16) * LDO + j * 16, acc, LDO,
                              wmma::mem_row_major);
    }
    __syncwarp();
    // this warp's rows to the (pooled) map, 8 channels per store
    const int ho = p.H / p.ps, wo = p.W / p.ps;
    for (int c = lane; c < 16 * ch; c += 32) {
      const int r = c / ch, cc = c % ch, i = q0 + warp * 16 + r;
      if (i >= nq) continue;
      const int y = wr * qs + i / qs, x = wc * qs + i % qs;
      const float* src = O + (warp * 16 + r) * LDO + cc * 8;
      uint4 out;
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&out);
#pragma unroll
      for (int k = 0; k < 8; ++k) e[k] = __float2bfloat16_rn(src[k]);
      *reinterpret_cast<uint4*>(
          p.o + ((b * ho + y) * wo + x) * p.C + h * p.hd + cc * 8) = out;
    }
  }
}

template <int D>
int launch(const Params& p, int batch, cudaStream_t stream) {
  const Layout<D> L(p.nkp);
  auto kern = window_attention_kernel<D>;
  if (L.bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int nq = (p.ws / p.ps) * (p.ws / p.ps);
  const int n_win = (p.H / p.ws) * p.n_wc;
  dim3 grid((nq + BQ - 1) / BQ, n_win * p.heads, batch);
  kern<<<grid, NT, L.bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vls_window_attention(const void* qkv, void* o, int batch,
                                    int H, int W, int C, int heads, int ws,
                                    int ps, float scale, void* stream) {
  if (batch <= 0 || H <= 0 || W <= 0) return 0;
  Params p;
  p.qkv = (const __nv_bfloat16*)qkv;
  p.o = (__nv_bfloat16*)o;
  p.H = H; p.W = W; p.C = C; p.heads = heads; p.hd = C / heads;
  p.ws = ws; p.ps = ps; p.n_wc = W / ws;
  p.nk = ws * ws;
  p.nkp = (p.nk + 15) / 16 * 16;
  p.scale = scale;
  cudaStream_t s = (cudaStream_t)stream;
  const int hd = p.hd;
  if (hd <= 32) return launch<32>(p, batch, s);
  if (hd <= 64) return launch<64>(p, batch, s);
  if (hd <= 80) return launch<80>(p, batch, s);
  if (hd <= 96) return launch<96>(p, batch, s);
  if (hd <= 128) return launch<128>(p, batch, s);
  return (int)cudaErrorInvalidValue;
}
