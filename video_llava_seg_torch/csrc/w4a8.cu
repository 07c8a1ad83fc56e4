// W4A8 product: int8 activations x packed int4 weights -> int32, scaled by
// the activation row scale and the weight column scale.
//
//   y[r, n] = float(sum_k xq[r, k] * W[k, n]) * a_scale[r] * w_scale[n]
//
// W is packed two values per byte in the JAX package's "halves" layout:
// byte (i, n) of packed [in/2, out] holds W[i, n] in its low nibble and
// W[i + in/2, n] in its high nibble.
//
// Replaces the TPU kernel video_llava_seg_tpu/ops/int4.py::_w4a8_kernel
// (K5), which runs every LLM dense of the W4A8 serving tree.
//
// Arithmetic. Each nibble plane is formed as 16 x its signed value, exact
// in int8: the high plane is `p & 0xF0` per byte, the low plane
// `(p << 4) & 0xF0` per byte, so no per-byte sign extension is needed.
// The int32 sums are then 16 x the true sums (|sum| <= 16 * in * 127 * 8 <
// 2^31 for in <= 131072, checked by the wrapper) and an arithmetic shift
// by 4 recovers them exactly. The epilogue is (float(acc) * a_scale) *
// w_scale, two round-to-nearest fp32 multiplies in that order, then one
// round-to-nearest cast, which is what the plain PyTorch version does: the
// two agree bit for bit.
//
// Two regimes, as the TPU wrapper has:
// - rows <= 8 (decode): bound by the bytes of the packed weights (one
//   byte per two weights, read once). Where in/2 and out are multiples of
//   16 and rows x in <= 128 KiB (every Llama-3-8B decode dense and
//   lm_head) the TMA weight stream of w4a8_gemv_sm90.cu serves these
//   rows instead; this GEMV keeps the other widths, and
//   kernels.w4a8_matmul(..., route="vls_w4a8") names it for the tests and
//   for timing beside the new kernel. A GEMV: each thread takes 4 columns
//   (one 32-bit word per packed row, so a warp reads 128 contiguous
//   bytes), byte-transposes 4 packed rows x 4 columns and feeds __dp4a
//   with 4 k-values per column. The 8 warps of a block split K and reduce
//   in shared memory; when there are few column tiles (out / 128), blocks
//   also split K and a second kernel sums the int32 partials (exact, any
//   order) and applies the epilogue.
// - rows > 8 (prefill): bound by int8 tensor-core operations. 128 x 128
//   output tiles over 8 warps (64 x 32 each), mma.sync m16n8k32
//   s8.s8.s32. The packed operand is [in/2, out] with out contiguous and
//   there is no ldmatrix.trans for 8-bit types, so the loader
//   byte-transposes 4 x 4 blocks in registers and stores both nibble
//   planes to shared memory as [n][k], the layout the B fragment wants.
//   The next K slice is loaded into registers while the current one
//   multiplies. Where TMA can address the operands (in/2 and out
//   multiples of 16: every Llama-3-8B dense) the prefill runs the TMA +
//   wgmma kernel of w4a8_sm90.cu instead; this tile keeps the other
//   widths (kernels.w4a8_entry names the route).
//
// Contract (checked by the Python wrapper): all operands contiguous,
// in % 8 == 0, out % 4 == 0, in <= 131072; a_scale fp32 [rows],
// w_scale fp32 [out]; y bf16 or fp32 [rows, out].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int GV_COLS = 128;  // GEMV columns per block (4 per lane)
constexpr int MB = 128, NB = 128, KB = 32;
constexpr int SW = 12;  // 32-bit words per shared-memory row: 32 B + 16 pad

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

// 16 x the signed low / high nibble of every byte
__device__ __forceinline__ uint32_t lo16(uint32_t w) {
  return (w << 4) & 0xF0F0F0F0u;
}
__device__ __forceinline__ uint32_t hi16(uint32_t w) {
  return w & 0xF0F0F0F0u;
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float epilogue(int acc16, float as, float ws) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc16 >> 4), as), ws);
}

// ---------------------------------------------------------------------------
// rows <= 8: GEMV with __dp4a
// ---------------------------------------------------------------------------

template <int R, typename T>
__global__ void __launch_bounds__(THREADS)
w4a8_gemv_kernel(const int8_t* __restrict__ xq,
                 const float* __restrict__ a_scale,
                 const int8_t* __restrict__ packed,
                 const float* __restrict__ w_scale, T* __restrict__ y,
                 int* __restrict__ work, int in_dim, int out,
                 int kg_per_split, int ksplit) {
  __shared__ __align__(16) int red[THREADS / 32][R][GV_COLS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int half = in_dim >> 1;
  const int n = blockIdx.x * GV_COLS + lane * 4;
  const int split = blockIdx.y;
  const int kg_total = half >> 2;  // groups of 4 packed rows
  const int kg0 = split * kg_per_split;
  const int kg1 = min(kg_total, kg0 + kg_per_split);

  int acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0;

  if (n < out) {
    for (int kg = kg0 + warp; kg < kg1; kg += THREADS / 32) {
      const int8_t* wp = packed + (size_t)(4 * kg) * out + n;
      uint32_t rw[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) rw[i] = ld32(wp + (size_t)i * out);
      transpose4x4(rw, c);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int8_t* xr = xq + (size_t)r * in_dim + 4 * kg;
        const int xlo = (int)ld32(xr);
        const int xhi = (int)ld32(xr + half);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[r][j] = __dp4a(xlo, (int)lo16(c[j]), acc[r][j]);
          acc[r][j] = __dp4a(xhi, (int)hi16(c[j]), acc[r][j]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    *reinterpret_cast<int4*>(&red[warp][r][lane * 4]) =
        make_int4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * GV_COLS; idx += THREADS) {
    const int r = idx / GV_COLS, col = idx % GV_COLS;
    const int nn = blockIdx.x * GV_COLS + col;
    if (nn >= out) continue;
    int s = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) s += red[w][r][col];
    if (ksplit == 1)
      y[(size_t)r * out + nn] = from_float<T>(epilogue(s, a_scale[r],
                                                       w_scale[nn]));
    else
      work[((size_t)split * R + r) * out + nn] = s;
  }
}

template <typename T>
__global__ void w4a8_splitk_epilogue_kernel(const int* __restrict__ work,
                                            const float* __restrict__ a_scale,
                                            const float* __restrict__ w_scale,
                                            T* __restrict__ y, int rows,
                                            int out, int ksplit) {
  const long long total = (long long)rows * out;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int r = (int)(idx / out), n = (int)(idx % out);
    int s = 0;
    for (int k = 0; k < ksplit; ++k) s += work[(long long)k * total + idx];
    y[idx] = from_float<T>(epilogue(s, a_scale[r], w_scale[n]));
  }
}

// ---------------------------------------------------------------------------
// rows > 8: int8 tensor cores, mma.sync m16n8k32
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4],
                                       const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
w4a8_mma_kernel(const int8_t* __restrict__ xq,
                const float* __restrict__ a_scale,
                const int8_t* __restrict__ packed,
                const float* __restrict__ w_scale, T* __restrict__ y, int M,
                int in_dim, int N) {
  // [plane][row][k word]: A rows are activation rows, B rows are output
  // columns (the transposed weight tile)
  __shared__ __align__(16) uint32_t As[2][MB * SW];
  __shared__ __align__(16) uint32_t Bs[2][NB * SW];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * MB, n0 = blockIdx.x * NB;
  const int half = in_dim >> 1;
  // loader mapping: A rows a_row + 32 i, word a_word of the 32-byte slice;
  // B: 4 packed rows (b_k4) x 4 columns (b_n4) per thread
  const int a_row = tid >> 3, a_word = tid & 7;
  const int b_k4 = tid & 7, b_n4 = tid >> 3;

  uint32_t ra[2][4], rb[4];
  auto load = [&](int kk) {
    const bool kin = kk + 4 * a_word < half;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + a_row + 32 * i;
      const bool ok = kin && m < M;
      const int8_t* p = xq + (size_t)(ok ? m : 0) * in_dim + kk + 4 * a_word;
      ra[0][i] = ok ? ld32(p) : 0u;
      ra[1][i] = ok ? ld32(p + half) : 0u;
    }
    const int n = n0 + 4 * b_n4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = kk + 4 * b_k4 + i;
      rb[i] = (n < N && k < half) ? ld32(packed + (size_t)k * N + n) : 0u;
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
  for (int kk = 0; kk < half; kk += KB) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      As[0][(a_row + 32 * i) * SW + a_word] = ra[0][i];
      As[1][(a_row + 32 * i) * SW + a_word] = ra[1][i];
    }
    uint32_t c[4];
    transpose4x4(rb, c);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      Bs[0][(4 * b_n4 + j) * SW + b_k4] = lo16(c[j]);
      Bs[1][(4 * b_n4 + j) * SW + b_k4] = hi16(c[j]);
    }
    __syncthreads();
    if (kk + KB < half) load(kk + KB);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm * 64 + mi * 16 + g;
        af[mi][0] = As[p][r * SW + t];
        af[mi][1] = As[p][(r + 8) * SW + t];
        af[mi][2] = As[p][r * SW + 4 + t];
        af[mi][3] = As[p][(r + 8) * SW + 4 + t];
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int nn = wn * 32 + ni * 8 + g;
        bf[ni][0] = Bs[p][nn * SW + t];
        bf[ni][1] = Bs[p][nn * SW + 4 + t];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 64 + mi * 16 + g + 8 * h;
      if (m >= M) continue;
      const float as = a_scale[m];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * 32 + ni * 8 + 2 * t + e;
          if (n < N)
            y[(size_t)m * N + n] = from_float<T>(
                epilogue(acc[mi][ni][2 * h + e], as, w_scale[n]));
        }
      }
    }
  }
}

template <typename T>
int launch(const int8_t* xq, const float* as, const int8_t* packed,
           const float* ws, T* y, int* work, int rows, int in_dim, int out,
           int ksplit, cudaStream_t st) {
  if (rows <= 8) {
    const int kg_total = in_dim / 8;
    const int kg_per = (kg_total + ksplit - 1) / ksplit;
    const dim3 grid((out + GV_COLS - 1) / GV_COLS, ksplit);
#define VLS_GEMV(R)                                                       \
  case R:                                                                 \
    w4a8_gemv_kernel<R, T><<<grid, THREADS, 0, st>>>(                     \
        xq, as, packed, ws, y, work, in_dim, out, kg_per, ksplit);        \
    break;
    switch (rows) {
      VLS_GEMV(1) VLS_GEMV(2) VLS_GEMV(3) VLS_GEMV(4)
      VLS_GEMV(5) VLS_GEMV(6) VLS_GEMV(7) VLS_GEMV(8)
    }
#undef VLS_GEMV
    if (ksplit > 1) {
      const long long total = (long long)rows * out;
      long long blocks = (total + THREADS - 1) / THREADS;
      if (blocks > 65535) blocks = 65535;
      w4a8_splitk_epilogue_kernel<T><<<(unsigned)blocks, THREADS, 0, st>>>(
          work, as, ws, y, rows, out, ksplit);
    }
  } else {
    const dim3 grid((out + NB - 1) / NB, (rows + MB - 1) / MB);
    w4a8_mma_kernel<T><<<grid, THREADS, 0, st>>>(xq, as, packed, ws, y, rows,
                                                 in_dim, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vls_w4a8(const void* xq, const void* a_scale,
                        const void* packed, const void* w_scale, void* y,
                        void* work, int rows, int in_dim, int out, int out_f32,
                        int ksplit, void* stream) {
  if (rows <= 0 || out <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const int8_t* x = (const int8_t*)xq;
  const int8_t* p = (const int8_t*)packed;
  const float* as = (const float*)a_scale;
  const float* ws = (const float*)w_scale;
  if (out_f32)
    return launch<float>(x, as, p, ws, (float*)y, (int*)work, rows, in_dim,
                         out, ksplit, st);
  return launch<__nv_bfloat16>(x, as, p, ws, (__nv_bfloat16*)y, (int*)work,
                               rows, in_dim, out, ksplit, st);
}
