// W4A8 decode product (at most 8 activation rows) for Hopper (sm_90a): the
// packed int4 weights streamed by TMA through an mbarrier ring, one block
// an SM, split-K inside the one launch (a cluster's distributed shared
// memory).
//
//   y[r, n] = (float(sum_k xq[r, k] * W[k, n]) * a_scale[r]) * w_scale[n]
//
// W is packed two values per byte in the JAX package's "halves" layout:
// byte (i, n) of packed [in/2, out] holds W[i, n] in its low nibble and
// W[i + in/2, n] in its high nibble, so the low plane multiplies
// xq[:, :in/2] and the high plane xq[:, in/2:].
//
// Replaces video_llava_seg_tpu/ops/int4.py::_w4a8_kernel (K5) at <= 8
// rows where the widths suit TMA (in/2 and out multiples of 16) and the
// activation rows fit shared memory (rows x in <= 128 KiB): every W4A8
// dense of a Llama-3-8B decode step and the lm_head of prefill and
// decode. w4a8.cu's GEMV keeps the other widths; w4a8_sm90.cu takes more
// than 8 rows (kernels.w4a8_entry names the route).
//
// Arithmetic, bit for bit that of w4a8.cu and of w4a8_matmul_plain: each
// nibble plane is formed as 16 x its signed value (exact in int8), the
// int32 sums are 16 x the true sums (below 2^31 for in <= 131072) and an
// arithmetic shift by 4 recovers them; integer sums are exact in any
// order, so any split of K keeps the bits. The epilogue is (float(acc) *
// a_scale) * w_scale, two round-to-nearest fp32 multiplies in that order
// (__fmul_rn: no contraction), then one round-to-nearest cast to bf16 or
// fp32.
//
// Bound on the card: the bytes of the packed weight, read once (>= 99.7 %
// of the call's bytes at every Llama-3-8B width; xq, the scales and y are
// the rest). At 2 rows the integer work is ~3 operations a weight byte,
// well under the SM's rate. The design keeps weight bytes in flight on
// every SM from the first microsecond to the last, reads the weight in
// bands of rows that the blocks running together share (DRAM pages), and
// ends a call in as few steps as it can:
//
// - The weight is cut into boxes of BK = 64 packed rows by BN = 256
//   columns (16 KB; 256-byte rows read better than 128 x 128 boxes on an
//   H100: scripts/probe_w4a8_gemv.py), column tiles of BN columns by
//   k_boxes boxes down K (kernels.w4a8_gemv_plan). One producer thread
//   (warp 8) first bulk-copies the block's K range of the R activation
//   rows into shared memory (once a block, not once a box), then walks
//   the block's boxes: each is one TMA load of a 2-D map over packed
//   [in/2, out] (no swizzle: the consumers read 4-byte words along a row,
//   lane l word l, so a warp's load is 128 bytes of one row,
//   conflict-free) into a ring of 4-8 stages (as many as shared memory
//   holds beside the activations: 64-128 KB in flight an SM) with full /
//   empty mbarriers.
// - Few column tiles (the layer denses): each tile's K is split into
//   `parts` (2-8) runs of boxes, one block each, the grid tiles x parts
//   (<= one block an SM) in clusters of `parts` blocks, as many parts as
//   let every cluster run at once (vls_w4a8_gemv_sm90_clusters: a second
//   wave ran ~1.4x slower on an H100). Many (the lm_head, w_gateup):
//   one block an SM, persistent, taking whole tiles in rounds (tile q G +
//   i in round q), so the blocks of a round read adjacent columns of the
//   same rows. Blocks that run out of tiles early leave the bandwidth to
//   the others.
// - Eight consumer warps; warp (cg, rg) takes 128 columns and WARP_ROWS =
//   16 packed rows of every box, four groups of 4 rows. A lane reads its
//   column word of the 4 rows, byte-transposes the 4 x 4 block (4 columns
//   x 4 k values), splits each column word into its two nibble planes
//   and feeds __dp4a with the activations' 4 k values of each plane, read
//   as one 16-byte shared load per plane, row and 16 rows. __dp4a rather
//   than int8 mma: at R <= 8 rows a tensor-core tile would be >= 87 %
//   padding, and dp4a at ~2-6 issue slots a weight byte keeps ahead of
//   the ring.
// - The end of a unit: the warps add their sums into a [R][BN] int32
//   buffer in shared memory (atomics: each lane its 4 columns, so no
//   buffer per warp). A whole tile writes y from it. A split tile reduces
//   through the cluster's distributed shared memory: a cluster barrier,
//   then block q of the cluster adds the parts' buffers over its 1/parts
//   share of the tile's columns (mapa + ld.shared::cluster), applies the
//   epilogue and writes y; a second barrier keeps the buffers alive until
//   all have read them. No workspace, no atomics in global memory, no
//   second kernel, nothing left behind: a CUDA graph replays it as is.
//
// Contract (checked by the Python wrapper and the C entry): 1 <= rows <=
// 8; xq int8 [rows, in] contiguous, 16-byte aligned, rows x in <= 128 KiB;
// packed int8 [in/2, out] contiguous with in/2 and out multiples of 16;
// a_scale fp32 [rows]; w_scale fp32 [out]; y bf16 or fp32 [rows, out],
// contiguous.

#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int BK = 64;  // packed rows a box
constexpr int BN = 256;  // output columns a box (bytes of a packed row)
constexpr int WARPS = 8;  // consumer warps
constexpr int NT = 32 * (WARPS + 1);  // + the producer warp
// a warp reads 128 bytes of a row (a 4-byte word a lane): COL_GROUPS
// warps across a box's columns, ROW_GROUPS down its rows
constexpr int COL_GROUPS = BN / 128;
constexpr int ROW_GROUPS = WARPS / COL_GROUPS;
constexpr int WARP_ROWS = BK / ROW_GROUPS;  // packed rows a warp a box
constexpr uint32_t BOX_BYTES = BK * BN;
constexpr int MIN_STAGES = 4;
constexpr int MAX_STAGES = 8;
constexpr int MAX_ROWS = 8;
constexpr int SMEM_MAX = 232448;
constexpr int ALIGN = 128;  // TMA destinations: 128-byte aligned
constexpr int BAR_CONSUMERS = 1;  // named barrier of the 256 consumers
constexpr int MAX_PARTS = 8;  // blocks a cluster (portable)
// one TMA load a box (a box dim holds at most 256 elements)
static_assert(BN % 128 == 0 && BN <= 256 && WARPS % COL_GROUPS == 0,
              "box columns");
static_assert(WARP_ROWS % 16 == 0, "a warp's rows: 16-byte activation loads");

// Shared memory from a 128-byte-aligned base: the ring, the activation
// rows (+ BK bytes: the high plane's reads past in/2 in a K-tail box land
// there and meet zero weights), the [R][BN] int32 sums, the barriers
// (full, empty per stage, the activations'). kernels.w4a8_gemv_smem
// mirrors it.
__host__ __device__ constexpr uint32_t x_bytes(int rows, int in_dim) {
  return ((uint32_t)(rows * in_dim + BK) + 15u) & ~15u;
}
__host__ __device__ constexpr uint32_t red_off(int stages, int rows,
                                               int in_dim) {
  return stages * BOX_BYTES + x_bytes(rows, in_dim);
}
__host__ __device__ constexpr uint32_t bar_off(int stages, int rows,
                                               int in_dim) {
  return red_off(stages, rows, in_dim) + rows * BN * 4;
}
__host__ __device__ constexpr uint32_t smem_bytes(int stages, int rows,
                                                  int in_dim) {
  return ALIGN + bar_off(stages, rows, in_dim) + (2 * stages + 1) * 8;
}

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
__device__ __forceinline__ int lo16(uint32_t w) {
  return (int)((w << 4) & 0xF0F0F0F0u);
}
__device__ __forceinline__ int hi16(uint32_t w) {
  return (int)(w & 0xF0F0F0F0u);
}

__device__ __forceinline__ int word(const uint4& v, int i) {
  return (int)(i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w);
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ float epilogue(int acc16, float as, float ws) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc16 >> 4), as), ws);
}

// y at element i of a tile's [R][BN] sums (red's order: column 128 cg + 4
// lane + j at i = r BN + 128 cg + 32 j + lane), columns past out skipped
template <int R, typename T>
__device__ __forceinline__ void store_y(T* y, const float* a_scale,
                                        const float* w_scale, int out,
                                        int tile, int i, int v) {
  const int r = i / BN, c = i % BN;
  const int n = tile * BN + (c & ~127) + 4 * (c % 32) + (c / 32) % 4;
  if (n < out) {
    const float f = epilogue(v, __ldg(a_scale + r), __ldg(w_scale + n));
    if constexpr (std::is_same_v<T, float>) y[(size_t)r * out + n] = f;
    else y[(size_t)r * out + n] = __float2bfloat16_rn(f);
  }
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// every thread of every block of the cluster (each warp converged first:
// the barrier is .aligned): the writes to shared memory before it are
// seen by the reads after it, in any block of the cluster
__device__ __forceinline__ void cluster_sync() {
  __syncwarp();
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// the int32 at shared address `addr` of block `rank` of the cluster
__device__ __forceinline__ int ld_cluster(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  int v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.u32 %0, [%1];"
               : "=r"(v) : "r"(remote) : "memory");
  return v;
}

// A block's units in order, f(tile, first K box, end K box). parts == 1:
// whole column tiles, tile q G + i in round q (the blocks of a round read
// adjacent columns of the same rows). parts > 1: the grid is tiles x parts
// in clusters of `parts` blocks, block i part i % parts of K of tile i /
// parts. kernels.w4a8_gemv_units mirrors it.
template <typename F>
__device__ __forceinline__ void for_each_unit(int tiles, int k_boxes,
                                              int parts, F&& f) {
  const int g = (int)gridDim.x, i = (int)blockIdx.x;
  if (parts == 1) {
    for (int t = i; t < tiles; t += g) f(t, 0, k_boxes);
  } else {
    const int p = i % parts;
    f(i / parts, p * k_boxes / parts, (p + 1) * k_boxes / parts);
  }
}

template <int R, bool F32>
__global__ void __launch_bounds__(NT, 1)
    w4a8_gemv_sm90_kernel(const __grid_constant__ CUtensorMap tm_w,
                          const int8_t* __restrict__ xq,
                          const float* __restrict__ a_scale,
                          const float* __restrict__ w_scale,
                          void* __restrict__ y_, int half, int out,
                          int tiles, int k_boxes, int parts, int stages) {
  using T = std::conditional_t<F32, float, __nv_bfloat16>;
  T* const y = reinterpret_cast<T*>(y_);
  extern __shared__ uint8_t smem_raw[];
  // aligned by an offset from smem_raw, so the compiler keeps the
  // pointers in the shared window (LDS, not generic loads)
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + (ALIGN - 1)) & ~(uint32_t)(ALIGN - 1);
  uint8_t* const base_ptr = smem_raw + (base - raw);
  const int in_dim = 2 * half;
  const uint32_t x_off = stages * BOX_BYTES;
  const uint8_t* const xs = base_ptr + x_off;
  const uint32_t red_addr = base + red_off(stages, R, in_dim);
  int* const red = reinterpret_cast<int*>(
      base_ptr + red_off(stages, R, in_dim));
  const uint32_t bars = base + bar_off(stages, R, in_dim);
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (stages + s); };
  const uint32_t x_bar = bars + 16u * stages;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), WARPS);
    }
    mbar_init(x_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = tid; i < R * BN; i += NT) red[i] = 0;
  __syncthreads();

  if (warp == WARPS) {
    // ---------------- producer ----------------
    if (lane == 0) {
      // the activations of the block's K range (all of it unless split),
      // both planes, at their offsets in the rows
      int kx0 = 0, kx1 = k_boxes;
      if (parts > 1) {
        const int p = (int)blockIdx.x % parts;
        kx0 = p * k_boxes / parts;
        kx1 = (p + 1) * k_boxes / parts;
      }
      const int c0 = kx0 * BK, bytes = min(kx1 * BK, half) - c0;
      mbar_expect_tx(x_bar, (uint32_t)(2 * R * bytes));
      for (int r = 0; r < R; ++r)
        for (int plane = 0; plane < 2; ++plane) {
          const int off = r * in_dim + plane * half + c0;
          bulk_load(base + x_off + off, xq + off, (uint32_t)bytes, x_bar);
        }
      int it = 0;
      for_each_unit(tiles, k_boxes, parts, [&](int tile, int k0, int k1) {
        for (int kb = k0; kb < k1; ++kb, ++it) {
          const int s = it % stages;
          // the first pass over the ring finds every stage free
          mbar_wait(empty(s), ((it / stages) & 1) ^ 1);
          mbar_expect_tx(full(s), BOX_BYTES);
          tma_load_2d(base + s * BOX_BYTES, &tm_w, full(s), tile * BN,
                      kb * BK);
        }
      });
    }
  } else {
    // ---------------- consumers ----------------
    // warp (cg, rg): columns 128 cg .. + 127 (lane l: 4 l .. 4 l + 3) of
    // rows WARP_ROWS rg .. of every box
    const int cg = warp % COL_GROUPS, rg = warp / COL_GROUPS;
    const uint32_t w_off = WARP_ROWS * rg * BN + cg * 128 + 4 * lane;
    mbar_wait(x_bar, 0);
    int it = 0;
    for_each_unit(tiles, k_boxes, parts, [&](int tile, int k0, int k1) {
      int acc[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = 0;

      for (int kb = k0; kb < k1; ++kb, ++it) {
        const int s = it % stages;
        mbar_wait(full(s), (it / stages) & 1);
        const int x0 = kb * BK + WARP_ROWS * rg;
        const uint8_t* const wp = base_ptr + s * BOX_BYTES + w_off;
#pragma unroll
        for (int h = 0; h < WARP_ROWS / 16; ++h) {
          // the activations' k values of these 16 rows, both planes
          uint4 xl[R], xh[R];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const uint8_t* const xr = xs + r * in_dim + x0 + 16 * h;
            xl[r] = *reinterpret_cast<const uint4*>(xr);
            xh[r] = *reinterpret_cast<const uint4*>(xr + half);
          }
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            uint32_t rw[4], c[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              rw[i] = *reinterpret_cast<const uint32_t*>(
                  wp + (16 * h + 4 * g + i) * BN);
            transpose4x4(rw, c);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int lo = lo16(c[j]), hi = hi16(c[j]);
#pragma unroll
              for (int r = 0; r < R; ++r) {
                acc[r][j] = __dp4a(word(xl[r], g), lo, acc[r][j]);
                acc[r][j] = __dp4a(word(xh[r], g), hi, acc[r][j]);
              }
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(s));
      }

      // the unit's sums: red[r][cg][j][lane] holds column 128 cg + 4 lane
      // + j of row r
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          atomicAdd(&red[r * BN + cg * 128 + j * 32 + lane], acc[r][j]);
      named_sync(BAR_CONSUMERS, 32 * WARPS);
      if (parts == 1) {
        // a whole tile: write y from red, and clear it for the next tile
        for (int i = tid; i < R * BN; i += 32 * WARPS) {
          store_y<R, T>(y, a_scale, w_scale, out, tile, i, red[i]);
          red[i] = 0;
        }
        named_sync(BAR_CONSUMERS, 32 * WARPS);
      }
    });
  }
  if (parts > 1) {
    // the tile's parts: every block of the cluster holds its sums in red;
    // block q adds up its share of the tile's columns over the cluster
    // and writes y; the second barrier keeps every block's red alive
    // until all have read it
    cluster_sync();
    const int tile = (int)blockIdx.x / parts;
    const int q = (int)cluster_rank();
    const int i0 = q * R * BN / parts, i1 = (q + 1) * R * BN / parts;
    for (int i = i0 + tid; i < i1; i += NT) {
      int v = 0;
      for (int rank = 0; rank < parts; ++rank)
        v += ld_cluster(red_addr + 4u * i, (uint32_t)rank);
      store_y<R, T>(y, a_scale, w_scale, out, tile, i, v);
    }
    cluster_sync();
  }
}

template <int R, bool F32>
int launch(const CUtensorMap& tm, const int8_t* xq, const float* as,
           const float* ws, void* y, int half, int out, int tiles,
           int k_boxes, int parts, int grid, int stages, uint32_t smem,
           cudaStream_t st) {
  auto kern = w4a8_gemv_sm90_kernel<R, F32>;
  // the attribute once a device and instance (the call is on the hot path)
  static unsigned long long set_on = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !((set_on >> dev) & 1ull)) {
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) set_on |= 1ull << dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = parts;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  // whole tiles need no cluster
  cfg.numAttrs = parts > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kern, tm, xq, as, ws, y, half, out, tiles,
                         k_boxes, parts, stages);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <bool F32>
int launch_rows(int rows, const CUtensorMap& tm, const int8_t* xq,
                const float* as, const float* ws, void* y, int half, int out,
                int tiles, int k_boxes, int parts, int grid, int stages,
                uint32_t smem, cudaStream_t st) {
#define VLS_GEMV_ROWS(R)                                                   \
  case R:                                                                  \
    return launch<R, F32>(tm, xq, as, ws, y, half, out, tiles, k_boxes,    \
                          parts, grid, stages, smem, st);
  switch (rows) {
    VLS_GEMV_ROWS(1) VLS_GEMV_ROWS(2) VLS_GEMV_ROWS(3) VLS_GEMV_ROWS(4)
    VLS_GEMV_ROWS(5) VLS_GEMV_ROWS(6) VLS_GEMV_ROWS(7) VLS_GEMV_ROWS(8)
  }
#undef VLS_GEMV_ROWS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// geom: GEOM_2D int64 of the packed map (byte offset 0, dims (out, in/2),
// the row stride out, box (BN, BK)), as kernels.w4a8_gemv_sm90_geometry
// computes it; parts, grid and stages from kernels.w4a8_gemv_plan (grid
// tiles x parts where parts > 1, a cluster of parts blocks each tile). The
// tensor map is encoded here from the pointer and that geometry.
extern "C" int vls_w4a8_gemv_sm90(const void* xq, const void* a_scale,
                                  const void* packed, const void* w_scale,
                                  void* y, const long long* geom, int rows,
                                  int half, int out, int out_f32, int parts,
                                  int grid, int stages, void* stream) {
  if (rows <= 0 || out <= 0) return 0;
  if (rows > MAX_ROWS || half <= 0 || half % 16 || out % 16 ||
      stages < MIN_STAGES || stages > MAX_STAGES || geom[0] != 0 ||
      geom[1] != out || geom[2] != half || geom[3] != out ||
      (long long)rows * 2 * half > (128 << 10))
    return (int)cudaErrorInvalidValue;
  const int k_boxes = (half + BK - 1) / BK;
  const int tiles = (out + BN - 1) / BN;
  const uint32_t smem = smem_bytes(stages, rows, 2 * half);
  if (parts < 1 || parts > MAX_PARTS || parts > k_boxes ||
      (parts > 1 ? grid != tiles * parts : grid < 1 || grid > tiles) ||
      smem > (uint32_t)SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm;
  const int e = encode_2d(&tm, packed, geom, BN, BK,
                          CU_TENSOR_MAP_DATA_TYPE_UINT8,
                          CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e != 0) return e;
  const cudaStream_t st = (cudaStream_t)stream;
  const int8_t* x = (const int8_t*)xq;
  const float* as = (const float*)a_scale;
  const float* ws = (const float*)w_scale;
  if (out_f32)
    return launch_rows<true>(rows, tm, x, as, ws, y, half, out, tiles,
                             k_boxes, parts, grid, stages, smem, st);
  return launch_rows<false>(rows, tm, x, as, ws, y, half, out, tiles,
                            k_boxes, parts, grid, stages, smem, st);
}

// How many clusters of `parts` blocks of `smem` bytes each the device can
// hold at once (cudaOccupancyMaxActiveClusters); kernels.w4a8_gemv_plan
// keeps a split grid within one such wave. Negative: a CUDA error.
extern "C" int vls_w4a8_gemv_sm90_clusters(int parts, int smem) {
  if (parts < 1 || parts > MAX_PARTS || smem < 0 || smem > SMEM_MAX)
    return -(int)cudaErrorInvalidValue;
  auto kern = w4a8_gemv_sm90_kernel<2, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(parts);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = parts;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
  return e == cudaSuccess ? clusters : -(int)e;
}
