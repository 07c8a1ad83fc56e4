// Per-row int8 quantization of activations for Hopper (sm_90a), after a
// LayerNorm or not: a persistent stream of row tiles through shared memory
// by 1-D bulk copies (TMA without a tensor map), each row held in
// registers from its one read to its int8 store.
//
//   ln_quant_rows:  y = bf16(((x - mean) * rsqrt(var + eps)) * gamma + beta)
//   quant_rows:     y = x
//   then            s = amax(|y|) == 0 ? 1 : amax / 127
//                   q = clamp(rint(y / s), -127, 127)
//
// x bf16 [rows, cols]; q int8 [rows, cols]; s fp32 [rows]. mean and var
// (the mean of the squared deviations) in fp32, exactly two-pass; gamma
// and beta bf16 or fp32 as the tree stores them, widened to fp32 in the
// kernel (exactly what `.float()` gives); the affine steps by __fmul_rn /
// __fadd_rn, so that no multiply-add is contracted: the formula of the
// plain twin, quantize_activations_rowwise(nn.layer_norm(...)), and of
// w8a8.cu's quant_rows_kernel<LN>.
//
// Replaces the same TPU kernel as w8a8.cu's row quantizers, inside K8
// (video_llava_seg_tpu/ops/vit_block.py::_vit_kernel_i8):
// `_ln_f32(...).astype(dtype)` followed by `_quant_rows_f32`
// (vit_block.py:196-203, 240-243) and `_quant_rows_f32` of the attention
// context and of the fc1 output (vit_block.py:300-301, 322).
// kernels.quant_rows_entry names the route; w8a8.cu keeps the widths the
// plan refuses.
//
// Quantization is bit-equal to the twin on the same bf16 rows: the row
// max is exact, the scale one IEEE fp32 division amax / 127, each value
// the IEEE quotient y / s rounded half to even and clamped. The quotient
// is __fdiv_rn's, computed from one correctly rounded reciprocal a row
// and a Markstein correction (`code`: four instructions an element with
// an exact power-of-two prescale, instead of the division's ~9), never a
// bare reciprocal multiply. The rounding is the clamped quotient plus 1.5
// x 2^23 (one fp32 add rounds it to the nearest integer, half to even, as
// rintf; the low byte of the sum is that integer in two's complement),
// which takes the place of rintf and the float-to-int conversion. This
// source must not be built with --use_fast_math.
//
// Bound on the card: bytes. x is read once (2 bytes an element), q
// written once (1 byte) and s (4 bytes a row); gamma and beta, 2 x cols
// values, once a block. Each element also costs the quotient, a clamp,
// the rounding add, a byte pack and, after a LayerNorm, ~10 more
// operations: an instruction bound near the byte bound after a LayerNorm
// (with __fdiv_rn a value and the row held as bf16 it was above it: 31
// SASS instructions a lane-element, chip_smoke phase 1), under it
// without.
// The design, after layernorm_sm90.cu:
//
// - A persistent grid (kernels.quant_rows_sm90_plan): two blocks an SM
//   where two rings fit (cols <= 1280), one on a long stream and at fc1's
//   widths. Block b takes the tiles b, b + grid, ... of TR = 8 x 32 / G
//   contiguous rows.
// - One producer thread (warp 8, lane 0) copies each whole tile with one
//   cp.async.bulk (TR x cols x 2 bytes, the last tile shorter) into a ring
//   of 3 stages on full / empty mbarriers (2 at 5120 columns, whose 80 KB
//   stages do not fit 3 in a block).
// - Eight consumer warps. A row belongs to a group of G lanes (32 from
//   256 columns), each lane holding NV of the row's 16-byte vectors (lane
//   i of the group: vectors i, i + G, ...): after a LayerNorm NV <= 5,
//   widened to fp32 (40 registers); without, NV <= 20 as raw bf16 (80
//   registers a lane at 5120 columns). A lane reads its vectors from the
//   stage once and the warp releases the stage right then, before any
//   arithmetic.
// - LayerNorm: the sum and then the sum of squared deviations from the
//   registers, each a log2(G)-step shuffle in the group; y normalised in
//   registers, rounded to bf16 and widened back in place.
// - amax: a group shuffle-max over the bf16 values; s once a row; the
//   codes from the registers. Each lane stores 8 int8 bytes a vector; the
//   group's lanes sit on adjacent vectors, so a warp's stores fill whole
//   32-byte sectors. Lane 0 of the group writes s.
// - gamma and beta are widened into shared memory once a block, by the
//   consumers while the producer's first copies are in flight.
// - Every mbarrier wait traps after 1 s (sm90.cuh).
//
// Contract (checked by the Python wrapper and the C entry): x and q
// contiguous [rows, cols], 16-byte aligned, cols % 8 == 0,
// ceil(cols / 8 / G) <= NV (NV <= 5 after a LayerNorm: cols <= 1280; <=
// 20 without: cols <= 5120); s contiguous fp32 [rows]; gamma and beta
// contiguous [cols], both bf16 or both fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int WARPS = 8;              // consumer warps
constexpr int NT = 32 * (WARPS + 1);  // and the producer warp
constexpr int LN_MAX_NV = 5;          // 16-byte vectors a lane, LayerNorm
constexpr int MAX_NV = 20;            // and without
constexpr int MIN_STAGES = 2;
constexpr int MAX_STAGES = 8;
constexpr int SMEM_MAX = 232448;
constexpr uint32_t ALIGN = 128;
constexpr uint32_t BAR_BYTES = 16 * MAX_STAGES;
constexpr float ROUND_MAGIC = 12582912.f;  // 1.5 x 2^23

// gamma and beta widened to fp32, rounded up to 128 bytes
__host__ __device__ constexpr uint32_t gb_bytes(int cols) {
  return (8u * (uint32_t)cols + 127u) & ~127u;
}

uint32_t smem_bytes(int cols, int group, int stages, bool ln) {
  return ALIGN + BAR_BYTES + (ln ? gb_bytes(cols) : 0u) +
         (uint32_t)stages * (WARPS * (32 / group)) * 2u * (uint32_t)cols;
}

__device__ __forceinline__ float group_sum(float v, int group) {
  for (int o = group >> 1; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float group_max(float v, int group) {
  for (int o = group >> 1; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// the two bf16 of a 32-bit word, widened exactly
__device__ __forceinline__ float lo_f(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_f(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// element i of gamma or beta, fp32 (GF32) or bf16, widened exactly
template <bool GF32>
__device__ __forceinline__ float param(const void* p, int i) {
  return GF32 ? static_cast<const float*>(p)[i]
              : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

// the 8 bf16 of a vector, widened exactly
__device__ __forceinline__ void unpack8(const uint4& v, float* f) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = lo_f(w[k]);
    f[2 * k + 1] = hi_f(w[k]);
  }
}

// A row's divisor: s and 2^k with s 2^k in [2^-100, 2^120] (k = 0 but
// for amax < 127 x 2^-100 or > 127 x 2^120), and rc = RN(1 / (s 2^k)).
struct Divisor {
  float p2, s2, rc;
};

__device__ __forceinline__ Divisor divisor(float s) {
  const float p2 = s < 0x1p-100f ? 0x1p64f : s > 0x1p120f ? 0x1p-64f : 1.f;
  const float s2 = s * p2;
  return {p2, s2, __frcp_rn(s2)};
}

// The code of y: clamp(rint(y / s), -127, 127) in the low byte, with the
// quotient IEEE division gives. y / s = (y 2^k) / (s 2^k) and the scaling
// is exact (or leaves |y / s| < 2^-40 where y 2^-64 underflows). From rc:
// q0 = RN(y' rc) is within an ulp of y' / s', its residual y' - s' q0 is
// exact in one fma, and RN(q0 + residual x rc) is the correctly rounded
// quotient (Markstein's correction), three instructions for the
// division's ~9 (reciprocal, refinement, range check). The residual is
// exact where |y'| >= 2^-103 (its last bit a representable fp32 bit);
// with s' >= 2^-100 every smaller y' has |y' / s'| < 1/8, whose code is 0
// either way; s' <= 2^120 keeps rc normal. The CPU tests check the
// arithmetic over every bf16 value at 1,000+ scales, a card test the
// kernel's codes against the IEEE division at 2,000+. The rounding: the
// clamped quotient plus 1.5 x 2^23 (the add rounds half to even, and
// rounding the clamped quotient is rounding then clamping, as both ends
// are integers).
__device__ __forceinline__ uint32_t code(float y, const Divisor& d) {
  const float y2 = __fmul_rn(y, d.p2);
  const float q0 = __fmul_rn(y2, d.rc);
  const float qt = __fmaf_rn(__fmaf_rn(-d.s2, q0, y2), d.rc, q0);
  const float r = fminf(fmaxf(qt, -127.f), 127.f);
  return __float_as_uint(__fadd_rn(r, ROUND_MAGIC));
}

// the 8 codes of a vector, packed little-endian
__device__ __forceinline__ uint2 codes8(const float* y, const Divisor& d) {
  uint32_t c2[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    c2[k] = __byte_perm(code(y[2 * k], d), code(y[2 * k + 1], d), 0x0040);
  return make_uint2(__byte_perm(c2[0], c2[1], 0x5410),
                    __byte_perm(c2[2], c2[3], 0x5410));
}

template <int NV, bool LN, bool GF32>
__global__ void __launch_bounds__(NT, NV <= LN_MAX_NV ? 2 : 1)
    quant_rows_sm90_kernel(const __nv_bfloat16* __restrict__ x,
                           const void* __restrict__ gamma,
                           const void* __restrict__ beta,
                           int8_t* __restrict__ q, float* __restrict__ scale,
                           long long rows, int cols, int group, int stages,
                           float eps) {
  extern __shared__ uint8_t smem_raw[];
  // aligned by an offset from smem_raw, so the compiler keeps the
  // pointers in the shared window (LDS, not generic loads)
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + (ALIGN - 1)) & ~(ALIGN - 1);
  uint8_t* const base_ptr = smem_raw + (base - raw);
  const int vecs = cols >> 3;
  const int rpw = 32 / group;
  const int trows = WARPS * rpw;
  const uint32_t row_bytes = 2u * (uint32_t)cols;
  const uint32_t stage_bytes = (uint32_t)trows * row_bytes;
  const uint32_t ring = BAR_BYTES + (LN ? gb_bytes(cols) : 0u);
  auto full = [&](int s) { return base + 8u * s; };
  auto empty = [&](int s) { return base + 8u * (MAX_STAGES + s); };
  const long long tiles = (rows + trows - 1) / trows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == WARPS) {
    // ---------------- producer ----------------
    if (lane == 0) {
      int it = 0;
      for (long long t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
        const int s = it % stages;
        // the first pass over the ring finds every stage free
        mbar_wait(empty(s), ((it / stages) & 1) ^ 1);
        const long long r0 = t * trows;
        const long long n = rows - r0 < trows ? rows - r0 : trows;
        const uint32_t bytes = (uint32_t)n * row_bytes;
        mbar_expect_tx(full(s), bytes);
        bulk_load(base + ring + s * stage_bytes, x + r0 * cols, bytes,
                  full(s));
      }
    }
    return;
  }

  // ---------------- consumers ----------------
  // gamma and beta, widened, into shared memory while the first copies
  // fly (the consumer warps alone: named barrier 1)
  const float* const gb = reinterpret_cast<const float*>(base_ptr + BAR_BYTES);
  if (LN) {
    float* const dst = reinterpret_cast<float*>(base_ptr + BAR_BYTES);
    for (int i = tid; i < 2 * cols; i += 32 * WARPS)
      dst[i] = i < cols ? param<GF32>(gamma, i)
                        : param<GF32>(beta, i - cols);
    asm volatile("bar.sync 1, %0;" :: "n"(32 * WARPS) : "memory");
  }
  const int li = lane & (group - 1);           // lane in the row's group
  const int wrow = warp * rpw + lane / group;  // row in the tile
  const float fcols = (float)cols;
  int it = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
    const int s = it % stages;
    const long long row = t * trows + wrow;
    // a row past the end (the last tile) computes on zeros, so that its
    // lanes still take part in the group's shuffles, and stores nothing
    const bool valid = row < rows;
    mbar_wait(full(s), (it / stages) & 1);
    const uint4* src = reinterpret_cast<const uint4*>(
        base_ptr + ring + s * stage_bytes + wrow * row_bytes);
    // the row's values: fp32 after a LayerNorm (the statistics and the
    // affine read them four times), else raw bf16 (up to 20 vectors a lane)
    float f[LN ? NV * 8 : 1];
    uint4 v[LN ? 1 : NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = j * group + li;
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (valid && c < vecs) w = src[c];
      if constexpr (LN) unpack8(w, f + 8 * j);
      else v[j] = w;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));

    float amax = 0.f;
    if constexpr (LN) {
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < NV * 8; ++i) sum += f[i];
      const float mean = group_sum(sum, group) / fcols;
      float sq = 0.f;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if (j * group + li < vecs) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float d = f[8 * j + e] - mean;
            sq += d * d;
          }
        }
      }
      const float rstd = rsqrtf(group_sum(sq, group) / fcols + eps);
      // y in place of x, rounded to bf16 and widened back
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int c = j * group + li;
        if (c < vecs) {
          const float4* g4 = reinterpret_cast<const float4*>(gb + 8 * c);
          const float4* b4 =
              reinterpret_cast<const float4*>(gb + cols + 8 * c);
          const float4 ga = g4[0], gc = g4[1], ba = b4[0], bc = b4[1];
          const float g[8] = {ga.x, ga.y, ga.z, ga.w, gc.x, gc.y, gc.z, gc.w};
          const float b[8] = {ba.x, ba.y, ba.z, ba.w, bc.x, bc.y, bc.z, bc.w};
#pragma unroll
          for (int e = 0; e < 8; e += 2) {
            float* const y = f + 8 * j + e;
            const __nv_bfloat162 h = __floats2bfloat162_rn(
                __fadd_rn(__fmul_rn(__fmul_rn(y[0] - mean, rstd), g[e]),
                          b[e]),
                __fadd_rn(__fmul_rn(__fmul_rn(y[1] - mean, rstd), g[e + 1]),
                          b[e + 1]));
            y[0] = __low2float(h);
            y[1] = __high2float(h);
            amax = fmaxf(amax, fmaxf(fabsf(y[0]), fabsf(y[1])));
          }
        }
      }
    } else {
      // vectors past the row are zeros: they leave amax as it is
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        float y[8];
        unpack8(v[j], y);
#pragma unroll
        for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(y[e]));
      }
    }
    amax = group_max(amax, group);
    const float sc = amax == 0.f ? 1.f : __fdiv_rn(amax, 127.f);
    if (!valid) continue;
    // the codes from the registers, 8 bytes a vector
    int8_t* const dst = q + row * cols;
    const Divisor dv = divisor(sc);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = j * group + li;
      if (c < vecs) {
        float y[8];
        if constexpr (LN) {
#pragma unroll
          for (int e = 0; e < 8; ++e) y[e] = f[8 * j + e];
        } else {
          unpack8(v[j], y);
        }
        *reinterpret_cast<uint2*>(dst + 8 * c) = codes8(y, dv);
      }
    }
    if (li == 0) scale[row] = sc;
  }
}

template <int N>
struct Vecs {
  static constexpr int value = N;
};

template <int NV, bool LN, bool GF32>
int launch(const void* x, const void* gamma, const void* beta, void* q,
           void* scale, long long rows, int cols, int group, int stages,
           int grid, float eps, uint32_t smem, cudaStream_t st) {
  auto kern = quant_rows_sm90_kernel<NV, LN, GF32>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, NT, smem, st>>>(
      (const __nv_bfloat16*)x, gamma, beta,
      (int8_t*)q, (float*)scale, rows, cols, group, stages, eps);
  return (int)cudaGetLastError();
}

// the instances, K8's widths: NV 4 / 5 (1024 / 1280 columns at 32 lanes
// a row) after a LayerNorm (gamma / beta bf16 or fp32), and 4 / 5 / 16 /
// 20 (also 4096 / 5120) without; the plan rounds NV up to one of them
template <bool LN, bool GF32>
int dispatch(int nv, const void* x, const void* gamma, const void* beta,
             void* q, void* scale, long long rows, int cols, int group,
             int stages, int grid, float eps, uint32_t smem,
             cudaStream_t st) {
  auto run = [&](auto kern_nv) {
    return launch<decltype(kern_nv)::value, LN, GF32>(
        x, gamma, beta, q, scale, rows, cols, group, stages, grid, eps, smem,
        st);
  };
  if (nv == 4) return run(Vecs<4>{});
  if (nv == 5) return run(Vecs<5>{});
  if constexpr (!LN) {
    if (nv == 16) return run(Vecs<16>{});
    if (nv == 20) return run(Vecs<20>{});
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// group (G, lanes a row), vecs (NV, the instance), stages and grid from
// kernels.quant_rows_sm90_plan; the entry checks that they describe a
// launch the kernel can run. ln: LayerNorm first (gamma, beta and eps);
// gamma_fp32: gamma and beta are fp32 (else bf16).
extern "C" int vls_quant_rows_sm90(const void* x, const void* gamma,
                                   const void* beta, void* q, void* scale,
                                   long long rows, int cols, float eps,
                                   int ln, int gamma_fp32, int group,
                                   int vecs, int stages, int grid,
                                   void* stream) {
  if (rows <= 0) return 0;
  if (cols <= 0 || cols % 8 || group < 1 || group > 32 ||
      (group & (group - 1)) || stages < MIN_STAGES || stages > MAX_STAGES ||
      grid < 1 || ((uintptr_t)x | (uintptr_t)q) % 16 ||
      (uintptr_t)scale % 4)
    return (int)cudaErrorInvalidValue;
  const int need = (cols / 8 + group - 1) / group;
  if (vecs < need || vecs > (ln ? LN_MAX_NV : MAX_NV))
    return (int)cudaErrorInvalidValue;
  if (ln && (gamma == nullptr || beta == nullptr ||
             ((uintptr_t)gamma | (uintptr_t)beta) % (gamma_fp32 ? 4 : 2)))
    return (int)cudaErrorInvalidValue;
  const uint32_t smem = smem_bytes(cols, group, stages, ln != 0);
  if (smem > (uint32_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (!ln)
    return dispatch<false, false>(vecs, x, nullptr, nullptr, q, scale, rows,
                                  cols, group, stages, grid, 0.f, smem, st);
  if (gamma_fp32)
    return dispatch<true, true>(vecs, x, gamma, beta, q, scale, rows, cols,
                                 group, stages, grid, eps, smem, st);
  return dispatch<true, false>(vecs, x, gamma, beta, q, scale, rows, cols,
                               group, stages, grid, eps, smem, st);
}
