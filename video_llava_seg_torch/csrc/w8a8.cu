// W8A8 building blocks of the int8 ViT layer: per-row int8 quantization of
// activations (optionally after a LayerNorm) and an int8 x int8 product on
// the tensor cores with the dense epilogue of the int8 layer.
//
//   ln_quant_rows:  y = bf16(LayerNorm_f32(x)); q = rint(y / s), s = amax / 127
//   quant_rows:     the same without the norm
//   gemm_s8:        acc = xq @ W (int32), then either acc itself (int32 mode)
//                   or y = bf16((float(acc) * a_scale[r]) * w_scale[c])
//                          [+ bias] [* bf16(scale) | act_f32(.) ] [+ residual]
//                   each step rounded to bf16, as the TPU kernel does it
//
// Replaces the TPU kernel video_llava_seg_tpu/ops/vit_block.py::_vit_kernel_i8
// (K8) together with attention.cu: `_ln_f32(...).astype(dtype)` followed by
// `_quant_rows_f32` (vit_block.py:196-203, 240-243), `_quant_rows_f32` of the
// attention context and of the fc1 output (vit_block.py:300-301, 322), and
// `_dense_i8` (vit_block.py:206-213) with the q scale (:247-249), the
// activation (:321) and the residuals (:303, :324) fused into its epilogue.
// The int32 mode serves `ops/int4.int_matmul`, the int8 product of every
// `kernel_qa` dense outside the layer.
//
// Quantization is bit-equal to ops/quantization.quantize_activations_rowwise
// on the same bf16 rows: the row max is exact, the scale is one IEEE fp32
// division amax / 127, each value is one IEEE division x / scale
// (__fdiv_rn, never a reciprocal multiply) rounded half to even (rintf, as
// torch.round) and clamped to [-127, 127]. This source must not be built
// with --use_fast_math. The epilogue uses __fmul_rn / __fadd_rn so that no
// multiply-add is contracted: its first two steps equal nn.dense's
// `(acc.float() * a_scale * kernel_scale).to(bf16) + bias` bit for bit.
//
// Bound on the card. The row kernels are bound by bytes (one bf16 read, one
// int8 write; one warp per row, three to four passes over the row from L1).
// They serve only the widths w8a8_rows_sm90.cu refuses
// (kernels.quant_rows_entry: cols % 8, more than 1280 columns after a
// LayerNorm, more than 5120 without), none of K8's CLIP-L / RADIO-H calls,
// and route="vls_quant_rows" for tests and timing; gemm_s8 here serves
// the shapes w8a8_sm90.cu refuses (K or N % 16).
// gemm_s8 at the ViT shapes is bound by int8 tensor-core operations: 128 x
// 128 output tiles over 8 warps (64 x 32 each), mma.sync m16n8k32
// s8.s8.s32, 64 deep per step as two 32-deep shared-memory planes. The
// weights are the JAX tree's `kernel_qa` [in, out] with out contiguous;
// there is no ldmatrix.trans for 8-bit types, so the loader transposes 4 x
// 4 byte blocks in registers (the tile code of w4a8.cu without its nibble
// unpack) and stores [n][k] rows, the layout the B fragment wants. The
// next K slice is loaded into registers while the current one multiplies.
// wgmma + TMA are later work.
//
// Contract (checked by the Python wrappers): operands contiguous; cols % 8
// == 0 for the row kernels; K % 4 == 0 and N % 4 == 0 for gemm_s8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MB = 128, NB = 128, KB = 64;
constexpr int SW = 12;  // 32-bit words per shared-memory row: 32 B + 16 pad

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float bf(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ __nv_bfloat16 rbf(float v) {
  return __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------------------
// per-row quantization, optionally after a LayerNorm
// ---------------------------------------------------------------------------

template <bool LN>
__global__ void __launch_bounds__(THREADS)
quant_rows_kernel(const __nv_bfloat16* __restrict__ x,
                  const float* __restrict__ gamma,
                  const float* __restrict__ beta, int8_t* __restrict__ q,
                  float* __restrict__ scale, long long rows, int cols,
                  float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (THREADS / 32)
                        + (threadIdx.x >> 5);
  if (row >= rows) return;
  const __nv_bfloat16* xr = x + row * cols;
  float mean = 0.f, rstd = 1.f;
  if (LN) {
    float sum = 0.f;
    for (int c = lane * 8; c < cols; c += 256) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i) sum += bf(e[i]);
    }
    mean = warp_sum(sum) / cols;
    float sq = 0.f;
    for (int c = lane * 8; c < cols; c += 256) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float d = bf(e[i]) - mean;
        sq += d * d;
      }
    }
    rstd = rsqrtf(warp_sum(sq) / cols + eps);
  }
  // the row's values as the product sees them: bf16 (normalised in fp32,
  // then rounded to bf16 when LN)
  auto values = [&](int c, float v[8]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float y = bf(e[i]);
      if (LN)
        y = bf(rbf(__fadd_rn(__fmul_rn(__fmul_rn(y - mean, rstd),
                                       gamma[c + i]),
                             beta[c + i])));
      v[i] = y;
    }
  };
  float amax = 0.f;
  for (int c = lane * 8; c < cols; c += 256) {
    float v[8];
    values(c, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(v[i]));
  }
  amax = warp_max(amax);
  const float s = amax == 0.f ? 1.f : __fdiv_rn(amax, 127.f);
  int8_t* qr = q + row * cols;
  for (int c = lane * 8; c < cols; c += 256) {
    float v[8];
    values(c, v);
    uint2 out;
    int8_t* o = reinterpret_cast<int8_t*>(&out);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float r = fminf(fmaxf(rintf(__fdiv_rn(v[i], s)), -127.f), 127.f);
      o[i] = (int8_t)(int)r;
    }
    *reinterpret_cast<uint2*>(qr + c) = out;
  }
  if (lane == 0) scale[row] = s;
}

// ---------------------------------------------------------------------------
// int8 x int8 -> int32 on the tensor cores, dense epilogue
// ---------------------------------------------------------------------------

struct GemmParams {
  const int8_t* a;                  // [M, K]
  const float* a_scale;             // [M] (dense mode)
  const int8_t* b;                  // [K, N]
  const float* w_scale;             // [N] (dense mode)
  const __nv_bfloat16* bias;        // [N] or null
  const __nv_bfloat16* residual;    // [M, N] or null
  void* y;                          // int32 or bf16 [M, N]
  int M, N, K;
  int dense;                        // 0: int32 out; 1: bf16 epilogue
  int act;                          // 0 none, 1 quick_gelu, 2 gelu (erf)
  float qscale;                     // 0: none; else multiply by bf16(qscale)
};

__device__ __forceinline__ void transpose4x4(const uint32_t r[4],
                                             uint32_t c[4]) {
  // r[i] byte j = (row i, column j)  ->  c[j] byte i
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4],
                                       const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float activation(int act, float v) {
  if (act == 1) return v * (1.f / (1.f + expf(-1.702f * v)));
  if (act == 2) return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  return v;
}

__global__ void __launch_bounds__(THREADS) gemm_s8_kernel(GemmParams p) {
  // [plane][row][k word]: A rows are activation rows, B rows are output
  // columns (the transposed weight tile); plane 1 holds k + 32
  __shared__ __align__(16) uint32_t As[2][MB * SW];
  __shared__ __align__(16) uint32_t Bs[2][NB * SW];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * MB, n0 = blockIdx.x * NB;
  const int M = p.M, N = p.N, K = p.K;
  // loader mapping: A rows a_row + 32 i, word a_word of a 32-byte slice;
  // B: 4 weight rows (b_k4) x 4 columns (b_n4) per thread and plane
  const int a_row = tid >> 3, a_word = tid & 7;
  const int b_k4 = tid & 7, b_n4 = tid >> 3;

  uint32_t ra[2][4], rb[2][4];
  auto load = [&](int kk) {
#pragma unroll
    for (int pl = 0; pl < 2; ++pl) {
      const int k = kk + 32 * pl + 4 * a_word;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + a_row + 32 * i;
        const bool ok = k < K && m < M;
        ra[pl][i] = ok ? ld32(p.a + (size_t)m * K + k) : 0u;
      }
      const int n = n0 + 4 * b_n4;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kr = kk + 32 * pl + 4 * b_k4 + i;
        rb[pl][i] = (n < N && kr < K) ? ld32(p.b + (size_t)kr * N + n) : 0u;
      }
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  load(0);
  for (int kk = 0; kk < K; kk += KB) {
#pragma unroll
    for (int pl = 0; pl < 2; ++pl) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        As[pl][(a_row + 32 * i) * SW + a_word] = ra[pl][i];
      uint32_t c[4];
      transpose4x4(rb[pl], c);
#pragma unroll
      for (int j = 0; j < 4; ++j) Bs[pl][(4 * b_n4 + j) * SW + b_k4] = c[j];
    }
    __syncthreads();
    if (kk + KB < K) load(kk + KB);
#pragma unroll
    for (int pl = 0; pl < 2; ++pl) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm * 64 + mi * 16 + g;
        af[mi][0] = As[pl][r * SW + t];
        af[mi][1] = As[pl][(r + 8) * SW + t];
        af[mi][2] = As[pl][r * SW + 4 + t];
        af[mi][3] = As[pl][(r + 8) * SW + 4 + t];
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int nn = wn * 32 + ni * 8 + g;
        bfr[ni][0] = Bs[pl][nn * SW + t];
        bfr[ni][1] = Bs[pl][nn * SW + 4 + t];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bfr[ni]);
    }
    __syncthreads();
  }

  const float qs = p.qscale != 0.f ? bf(rbf(p.qscale)) : 0.f;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 64 + mi * 16 + g + 8 * h;
      if (m >= M) continue;
      const float as = p.dense ? p.a_scale[m] : 0.f;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * 32 + ni * 8 + 2 * t + e;
          if (n >= N) continue;
          const size_t idx = (size_t)m * N + n;
          const int a = acc[mi][ni][2 * h + e];
          if (!p.dense) {
            reinterpret_cast<int*>(p.y)[idx] = a;
            continue;
          }
          float v = bf(rbf(__fmul_rn(__fmul_rn(__int2float_rn(a), as),
                                     p.w_scale[n])));
          if (p.bias) v = bf(rbf(__fadd_rn(v, bf(p.bias[n]))));
          if (qs != 0.f) v = bf(rbf(__fmul_rn(v, qs)));
          if (p.act) v = bf(rbf(activation(p.act, v)));
          if (p.residual) v = __fadd_rn(v, bf(p.residual[idx]));
          reinterpret_cast<__nv_bfloat16*>(p.y)[idx] = rbf(v);
        }
      }
    }
  }
}

}  // namespace

extern "C" int vls_quant_rows(const void* x, const void* gamma,
                              const void* beta, void* q, void* scale,
                              long long rows, int cols, float eps, int ln,
                              void* stream) {
  if (rows <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
  const __nv_bfloat16* xp = (const __nv_bfloat16*)x;
  if (ln)
    quant_rows_kernel<true><<<(unsigned)blocks, THREADS, 0, st>>>(
        xp, (const float*)gamma, (const float*)beta, (int8_t*)q,
        (float*)scale, rows, cols, eps);
  else
    quant_rows_kernel<false><<<(unsigned)blocks, THREADS, 0, st>>>(
        xp, nullptr, nullptr, (int8_t*)q, (float*)scale, rows, cols, eps);
  return (int)cudaGetLastError();
}

extern "C" int vls_gemm_s8(const void* a, const void* a_scale, const void* b,
                           const void* w_scale, const void* bias,
                           const void* residual, void* y, int M, int N, int K,
                           int dense, int act, float qscale, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  GemmParams p;
  p.a = (const int8_t*)a;
  p.a_scale = (const float*)a_scale;
  p.b = (const int8_t*)b;
  p.w_scale = (const float*)w_scale;
  p.bias = (const __nv_bfloat16*)bias;
  p.residual = (const __nv_bfloat16*)residual;
  p.y = y;
  p.M = M; p.N = N; p.K = K;
  p.dense = dense; p.act = act; p.qscale = qscale;
  const dim3 grid((N + NB - 1) / NB, (M + MB - 1) / MB);
  gemm_s8_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
