// Row LayerNorm for Hopper (sm_90a): a persistent stream of row blocks
// through shared memory by 1-D bulk copies (TMA without a tensor map).
//
//   y[r, :] = bf16(((x[r, :] - mean) * rsqrt(var + eps)) * gamma + beta)
//
// x, gamma, beta and y bf16; mean and var (the mean of the squared
// deviations from mean) in fp32, exactly two-pass; gamma and beta taken
// in fp32; one rounding to bf16 at the end: the formula of the plain twin
// video_llava_seg_torch/ops/nn.py::layer_norm.
//
// Replaces the LayerNorm stages inside two TPU kernels: LN1 / LN2 of
// video_llava_seg_tpu/ops/vit_block.py::_vit_kernel (K1; nn.layer_norm in
// its XLA twin) and norm1 / norm2 of
// video_llava_seg_tpu/ops/hiera_block.py::_block_kernel / _mlp_tail (K4;
// _ln_f32). layernorm.cu keeps the widths this kernel refuses
// (kernels.layernorm_entry names the route).
//
// Bound on the card: bytes. x is read once and y written once (gamma and
// beta are 4 x cols bytes a block); ~12 fp32 operations an element are
// far under the SM's rate. What it takes is enough bytes in flight on
// every SM (~25 GB/s an SM times ~1 us of latency under load) and no
// second read of a row. The design:
//
// - A persistent grid (kernels.layernorm_sm90_plan): two blocks an SM,
//   one on a long stream (Hiera's first two stages). Block b takes the
//   tiles b, b + grid, ... of TR = 8 x 32 / G contiguous rows (G below).
// - One producer thread (warp 8, lane 0) copies each whole tile with one
//   cp.async.bulk (TR x cols x 2 bytes, a multiple of 16 as cols % 8 ==
//   0; the last tile shorter) into a ring of 3 stages of <= 20 KB on
//   full / empty mbarriers (the entry takes up to 8): 36-120 KB an SM in
//   flight. Deeper rings, up to ~190 KB an SM, ran slower on an H100
//   (scripts/probe_row_streams.py), and two blocks an SM on the long
//   streams slower than one.
// - Eight consumer warps. A row belongs to a group of G lanes (G = 4 at
//   96 columns, 8 at 192, 16 at 384, 32 from 768), each lane holding NV
//   <= 5 of the row's 16-byte vectors (lane i of the group: vectors i, i
//   + G, ...), so a warp holds 32 / G rows and the eight warps one tile.
//   A lane reads its vectors from the stage once into fp32 registers, and
//   the warp releases the stage right then (its empty barrier), before
//   any arithmetic. Both statistics come from the registers: the sum,
//   then the sum of squared deviations, each a log2(G)-step shuffle in
//   the group; no row is read twice.
// - gamma and beta are copied into shared memory once a block, by the
//   consumers while the producer's first copies are in flight.
// - y leaves by 16-byte stores from registers: a warp's store writes
//   whole 32-byte sectors (G lanes of a row on adjacent vectors, the
//   warp's rows adjacent). A bulk store from the stage would hold the
//   stage until the store had read it (cp.async.bulk.wait_group.read),
//   taking one or two stages from the read ring; the register path
//   frees the stage as soon as the rows are loaded.
// - Every mbarrier wait traps after 1 s (sm90.cuh).
//
// Contract (checked by the Python wrapper and the C entry): x and y
// contiguous [rows, cols] bf16, 16-byte aligned, cols % 8 == 0 and
// ceil(cols / 8 / G) <= 5 (cols <= 1280 at G = 32); gamma and beta
// contiguous bf16 [cols].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int WARPS = 8;              // consumer warps
constexpr int NT = 32 * (WARPS + 1);  // and the producer warp
constexpr int MAX_NV = 5;             // 16-byte vectors a lane holds
constexpr int MIN_STAGES = 3;
constexpr int MAX_STAGES = 8;
constexpr int SMEM_MAX = 232448;
constexpr uint32_t ALIGN = 128;
constexpr uint32_t BAR_BYTES = 16 * MAX_STAGES;

// gamma and beta, bf16, rounded up to 128 bytes
__host__ __device__ constexpr uint32_t gb_bytes(int cols) {
  return (4u * (uint32_t)cols + 127u) & ~127u;
}

uint32_t smem_bytes(int cols, int group, int stages) {
  return ALIGN + BAR_BYTES + gb_bytes(cols) +
         (uint32_t)stages * (WARPS * (32 / group)) * 2u * (uint32_t)cols;
}

__device__ __forceinline__ float group_sum(float v, int group) {
  for (int o = group >> 1; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void unpack8(const uint4& w, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 p = __bfloat1622float2(h[k]);
    f[2 * k] = p.x;
    f[2 * k + 1] = p.y;
  }
}

template <int NV>
__global__ void __launch_bounds__(NT, 2)
    layernorm_sm90_kernel(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ gamma,
                          const __nv_bfloat16* __restrict__ beta,
                          __nv_bfloat16* __restrict__ y, long long rows,
                          int cols, int group, int stages, float eps) {
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
  const uint32_t ring = BAR_BYTES + gb_bytes(cols);
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
  // gamma and beta into shared memory while the first copies fly (the
  // consumer warps alone: named barrier 1)
  uint4* const gb = reinterpret_cast<uint4*>(base_ptr + BAR_BYTES);
  for (int i = tid; i < 2 * vecs; i += 32 * WARPS)
    gb[i] = i < vecs ? reinterpret_cast<const uint4*>(gamma)[i]
                     : reinterpret_cast<const uint4*>(beta)[i - vecs];
  asm volatile("bar.sync 1, %0;" :: "n"(32 * WARPS) : "memory");
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
    float v[NV * 8];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = j * group + li;
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (valid && c < vecs) w = src[c];
      unpack8(w, v + 8 * j);
#pragma unroll
      for (int e = 0; e < 8; ++e) sum += v[8 * j + e];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));

    const float mean = group_sum(sum, group) / fcols;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (j * group + li < vecs) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float d = v[8 * j + e] - mean;
          sq += d * d;
        }
      }
    }
    const float rstd = rsqrtf(group_sum(sq, group) / fcols + eps);
    if (valid) {
      uint4* const dst = reinterpret_cast<uint4*>(y + row * cols);
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int c = j * group + li;
        if (c < vecs) {
          float g[8], b[8];
          unpack8(gb[c], g);
          unpack8(gb[vecs + c], b);
          uint4 o;
          __nv_bfloat162* oh = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int e = 8 * j + 2 * k;
            oh[k] = __floats2bfloat162_rn(
                (v[e] - mean) * rstd * g[2 * k] + b[2 * k],
                (v[e + 1] - mean) * rstd * g[2 * k + 1] + b[2 * k + 1]);
          }
          dst[c] = o;
        }
      }
    }
  }
}

template <int NV>
int launch(const void* x, const void* gamma, const void* beta, void* y,
           long long rows, int cols, int group, int stages, int grid,
           float eps, uint32_t smem, cudaStream_t st) {
  auto kern = layernorm_sm90_kernel<NV>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, NT, smem, st>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)gamma,
      (const __nv_bfloat16*)beta, (__nv_bfloat16*)y, rows, cols, group,
      stages, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// group (G, lanes a row), stages and grid from kernels.layernorm_sm90_plan;
// the entry checks that they describe a launch the kernel can run.
extern "C" int vls_layernorm_sm90(const void* x, const void* gamma,
                                  const void* beta, void* y, long long rows,
                                  int cols, float eps, int group, int stages,
                                  int grid, void* stream) {
  if (rows <= 0) return 0;
  if (cols <= 0 || cols % 8 || group < 1 || group > 32 ||
      (group & (group - 1)) || stages < MIN_STAGES || stages > MAX_STAGES ||
      grid < 1 || ((uintptr_t)x | (uintptr_t)y | (uintptr_t)gamma |
                   (uintptr_t)beta) % 16)
    return (int)cudaErrorInvalidValue;
  const int nv = (cols / 8 + group - 1) / group;
  const uint32_t smem = smem_bytes(cols, group, stages);
  if (nv > MAX_NV || smem > (uint32_t)SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (nv) {
    case 1:
      return launch<1>(x, gamma, beta, y, rows, cols, group, stages, grid,
                       eps, smem, st);
    case 2:
      return launch<2>(x, gamma, beta, y, rows, cols, group, stages, grid,
                       eps, smem, st);
    case 3:
      return launch<3>(x, gamma, beta, y, rows, cols, group, stages, grid,
                       eps, smem, st);
    case 4:
      return launch<4>(x, gamma, beta, y, rows, cols, group, stages, grid,
                       eps, smem, st);
    default:
      return launch<5>(x, gamma, beta, y, rows, cols, group, stages, grid,
                       eps, smem, st);
  }
}
