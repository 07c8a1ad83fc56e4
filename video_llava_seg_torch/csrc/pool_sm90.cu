// 2x2 max pool (kernel == stride == 2, VALID: an odd last row or column
// is dropped) over an NHWC bf16 map, for Hopper (sm_90a): a persistent
// stream of input row pieces through shared memory by 1-D bulk copies
// (TMA without a tensor map).
//
//   y[n, oy, ox, :] = max of x[n, 2oy + {0, 1}, 2ox + {0, 1}, :]
//
// Bit-equal to the plain twin (ops/hiera_block.py::max_pool_2x2): a max
// rounds nothing (finite inputs; which of -0 / +0 a window of both keeps
// is not specified).
//
// Replaces the shortcut max-pool (and the q max-pool where the chain
// pools q outside the attention) inside the TPU kernel
// video_llava_seg_tpu/ops/hiera_block.py::_block_kernel (K4), at the
// stage-transition (q-pool) blocks. pool.cu keeps the maps this kernel
// refuses (kernels.maxpool_entry names the route).
//
// Bound on the card: bytes (x read once, y written once: 5/4 of x).
// The design:
//
// - A work item is one output row (n, oy) times a chunk of CW output
//   columns (kernels.maxpool_sm90_plan: CW a power of two with 8 CW C <=
//   24 KB). Its input rows 2oy and 2oy + 1 are each contiguous over 2 CW
//   x C elements, so one item is two bulk copies into one stage.
// - A persistent grid (two blocks an SM, one on a long stream, as
//   layernorm_sm90.cu) takes the items b, b + grid, ...; one producer
//   thread (warp 8, lane 0) keeps a ring of 3 stages of <= 24 KB full on
//   full / empty mbarriers (72 KB a block in flight; the entry takes up
//   to 8 stages).
// - Eight consumer warps: thread t takes the item's 16-byte output
//   vectors t and t + 256 (at most 512 = CW x C / 8), reads the four
//   input vectors of each window from the stage, __hmax2 over them, and
//   the warp releases the stage before it stores. The stage offset of an
//   output vector is computed once a thread (one 32-bit division), the
//   item's row and chunk once an item: no per-element division.
// - y leaves by 16-byte stores, thread t on vector t of a contiguous
//   output run: whole sectors.
// - Every mbarrier wait traps after 1 s (sm90.cuh).
//
// Contract (checked by the Python wrapper and the C entry): x contiguous
// [n, h, w, c] bf16, y contiguous [n, h / 2, w / 2, c], both 16-byte
// aligned, c % 8 == 0, CW x c <= 4096, n x h / 2 x chunks < 2^31.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int WARPS = 8;              // consumer warps
constexpr int CT = 32 * WARPS;        // consumer threads
constexpr int NT = CT + 32;           // and the producer warp
constexpr int MAXV = 2;               // output vectors a thread an item
constexpr int MIN_STAGES = 3;
constexpr int MAX_STAGES = 8;
constexpr int SMEM_MAX = 232448;
constexpr uint32_t ALIGN = 128;
constexpr uint32_t BAR_BYTES = 16 * MAX_STAGES;

uint32_t smem_bytes(int c, int cw, int stages) {
  return ALIGN + BAR_BYTES + (uint32_t)stages * 8u * (uint32_t)cw * c;
}

__device__ __forceinline__ uint32_t max4(uint32_t a, uint32_t b, uint32_t c,
                                         uint32_t d) {
  const __nv_bfloat162 m = __hmax2(
      __hmax2(*reinterpret_cast<const __nv_bfloat162*>(&a),
              *reinterpret_cast<const __nv_bfloat162*>(&b)),
      __hmax2(*reinterpret_cast<const __nv_bfloat162*>(&c),
              *reinterpret_cast<const __nv_bfloat162*>(&d)));
  return *reinterpret_cast<const uint32_t*>(&m);
}

__global__ void __launch_bounds__(NT, 2)
    maxpool2x2_sm90_kernel(const __nv_bfloat16* __restrict__ x,
                           __nv_bfloat16* __restrict__ y, int h, int w,
                           int c, int oh, int ow, int cw, int chunks,
                           int items, int stages) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + (ALIGN - 1)) & ~(ALIGN - 1);
  uint8_t* const base_ptr = smem_raw + (base - raw);
  const int cvec = c >> 3;                    // 16-byte vectors a pixel
  const uint32_t piece = 4u * cw * c;         // one input row's bytes
  const uint32_t stage_bytes = 2u * piece;
  auto full = [&](int s) { return base + 8u * s; };
  auto empty = [&](int s) { return base + 8u * (MAX_STAGES + s); };
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
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
        const int s = it % stages;
        // the first pass over the ring finds every stage free
        mbar_wait(empty(s), ((it / stages) & 1) ^ 1);
        const int r = item / chunks, ox0 = (item - r * chunks) * cw;
        const int n = r / oh, oy = r - n * oh;
        const uint32_t bytes = 4u * (uint32_t)min(cw, ow - ox0) * c;
        const __nv_bfloat16* src =
            x + (((long long)n * h + 2 * oy) * w + 2 * ox0) * c;
        const uint32_t dst = base + BAR_BYTES + s * stage_bytes;
        mbar_expect_tx(full(s), 2 * bytes);
        bulk_load(dst, src, bytes, full(s));
        bulk_load(dst + piece, src + (long long)w * c, bytes, full(s));
      }
    }
    return;
  }

  // ---------------- consumers ----------------
  // output vector k of an item (pixel k / cvec, channel vector k % cvec)
  // reads input vectors off and off + cvec of both row pieces
  int off[MAXV];
#pragma unroll
  for (int m = 0; m < MAXV; ++m) {
    const int k = tid + m * CT;
    off[m] = k + (k / cvec) * cvec;
  }
  int it = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
    const int s = it % stages;
    const int r = item / chunks, ox0 = (item - r * chunks) * cw;
    const int nvec = min(cw, ow - ox0) * cvec;
    mbar_wait(full(s), (it / stages) & 1);
    const uint4* p0 = reinterpret_cast<const uint4*>(
        base_ptr + BAR_BYTES + s * stage_bytes);
    const uint4* p1 = p0 + piece / 16;
    uint4 out[MAXV];
#pragma unroll
    for (int m = 0; m < MAXV; ++m) {
      if (tid + m * CT < nvec) {
        const uint4 a = p0[off[m]], b = p0[off[m] + cvec];
        const uint4 c2 = p1[off[m]], d = p1[off[m] + cvec];
        out[m] = make_uint4(max4(a.x, b.x, c2.x, d.x),
                            max4(a.y, b.y, c2.y, d.y),
                            max4(a.z, b.z, c2.z, d.z),
                            max4(a.w, b.w, c2.w, d.w));
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
    uint4* const dst =
        reinterpret_cast<uint4*>(y + ((long long)r * ow + ox0) * c);
#pragma unroll
    for (int m = 0; m < MAXV; ++m)
      if (tid + m * CT < nvec) dst[tid + m * CT] = out[m];
  }
}

}  // namespace

// cw (output columns an item), stages and grid from
// kernels.maxpool_sm90_plan; the entry checks that they describe a launch
// the kernel can run.
extern "C" int vls_maxpool2x2_sm90(const void* x, void* y, int n, int h,
                                   int w, int c, int cw, int stages,
                                   int grid, void* stream) {
  const int oh = h / 2, ow = w / 2;
  if (n <= 0 || oh <= 0 || ow <= 0 || c <= 0) return 0;
  if (c % 8 || cw < 1 || cw > ow || (long long)cw * (c / 8) > CT * MAXV ||
      stages < MIN_STAGES || stages > MAX_STAGES || grid < 1 ||
      ((uintptr_t)x | (uintptr_t)y) % 16)
    return (int)cudaErrorInvalidValue;
  const int chunks = (ow + cw - 1) / cw;
  const long long items = (long long)n * oh * chunks;
  const uint32_t smem = smem_bytes(c, cw, stages);
  if (items > INT_MAX || smem > (uint32_t)SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      maxpool2x2_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  maxpool2x2_sm90_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (__nv_bfloat16*)y, h, w, c, oh, ow, cw,
      chunks, (int)items, stages);
  return (int)cudaGetLastError();
}
