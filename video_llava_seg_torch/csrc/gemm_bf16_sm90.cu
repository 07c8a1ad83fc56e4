// bf16 product with a fused epilogue for Hopper (sm_90a): TMA loads into
// 128-byte-swizzled shared tiles with mbarrier completion, the products on
// wgmma with the [in, out] weights read MN-major, a persistent grid whose
// two consumer warpgroups take turns (one runs a tile's products while
// the other runs its epilogue), and TMA stores of the result.
//
//   C[M, N] = act((A[M, K] @ B[K, N] + bias[N]) * scale) + residual[M, N]
//
// bf16 operands, fp32 sums, the epilogue in fp32 in gemm_bf16.cu's order
// and formulas (quick_gelu x sigmoid(1.702 x) with __expf, erf-GELU with
// erff), one rounding to bf16 at the end.
//
// Replaces, with layernorm.cu, attention_sm90.cu and pool.cu, the dense
// products inside two TPU kernels: video_llava_seg_tpu/ops/vit_block.py::
// _vit_kernel (K1: q / k / v with the q scale, the out projection with the
// residual, fc1 with quick_gelu or GELU, fc2 with the residual) and
// video_llava_seg_tpu/ops/hiera_block.py::_block_kernel / _mlp_tail (K4:
// the shortcut projection, qkv, the attention projection with the
// shortcut, fc1 with erf-GELU, fc2 with the residual). gemm_bf16.cu (WMMA
// fragments, a two-stage cp.async ring, one tile a block, one 2-byte store
// an element) keeps the calls kernels.gemm_bf16_entry refuses.
//
// Bound on the card: at CLIP-L and RADIO-H (18,464 rows, K and N
// 1,024-5,120) and at Hiera stages 3-4 the tensor-core operations; at
// Hiera stages 1-2 (131,072-524,288 rows, K 96 / 192) the bytes: stage 1's
// qkv writes 302 MB for 29 GFLOP, its fc2 reads a 100 MB residual. What
// the design does about it:
//
// - Operands: A [M, K] row-major is K-major; B [K, N] (N contiguous) is
//   the MN-major B operand of `wgmma .bf16` through its transpose bit, so
//   the tree's weights are read as they are (no transposed copy). One
//   stage is an A box of 128 rows by 64 columns of K and two B boxes of 64
//   rows of K by 64 columns of N, each one 128-byte swizzle row wide; five
//   stages of 32 KB. TMA zero-fills past M, K and N, so ragged edges add
//   zeros; only the stores are clipped (by TMA).
// - Schedule: one block of 3 warpgroups (384 threads) per SM walks output
//   tiles of 128 x 128. Warpgroup 0 is the producer (setmaxnreg.dec 40):
//   one thread keeps the ring full, tile after tile. Warpgroups 1 and 2
//   (setmaxnreg.inc 232) take the block's tiles in turn, each a whole
//   tile: per stage eight m64n128k16 wgmmas (two 64-row halves) into 128
//   fp32 accumulator registers, one group in flight while the next stage
//   is awaited, the stage released on its empty mbarrier once its group
//   has retired. The two take turns on the ring (an mbarrier each hands
//   the turn over once a tile's products are issued), so while one
//   warpgroup runs its tile's products the other runs its epilogue, which
//   the products hide where they take longer (not at Hiera's erf-GELU
//   fc1, K 96-768, where the activation's instructions bound the call).
// - Epilogue: at a tile's start its residual (four 64 x 64 boxes) is
//   loaded by TMA into the warpgroup's four staging boxes, and its bias
//   (128 columns) into registers, under the tile's products. Then the
//   bias (from shared memory), scale, activation and residual apply to
//   the accumulator, packed to bf16 into the same staging positions
//   under the 128-byte swizzle (conflict-free: a store's eight rows sit
//   on eight chunks), and four TMA stores write the tile (16-byte rows,
//   clipped at M and N).
// - Raster: groups of 16 row tiles, row tiles fastest, so the blocks in
//   flight share a few A row blocks and B column blocks in L2.
//
// Later work: the products reach ~0.55 of the tensor peak at every
// operation-bound shape, with six stages as with five: 2-CTA clusters
// with TMA multicast of B (a quarter less L2 traffic per product); one
// grouped launch for K1's q / k / v, which read the same A; the erf-GELU
// epilogue spread over more warps.
//
// Contract (checked by the Python wrapper and again here): M > 0; K > 0
// and K, N multiples of 8 (16-byte row strides); A, B, C and the residual
// 16-byte aligned with those row strides; bias bf16 [N] or null; residual
// bf16 [M, N] or null.

#include "sm90.cuh"

namespace {

constexpr int BM = 128;  // rows per tile: two 64-row wgmma halves
constexpr int BN = 128;  // columns per tile: two 64-column boxes
constexpr int BK = 64;   // K per stage: one 128-byte swizzle row of A
constexpr int BOX = 64;  // rows and columns of a B, staging or store box
constexpr int NT = 384;  // producer + two consumer warpgroups
constexpr int STAGES = 5;
constexpr int GROUP_M = 16;
constexpr uint32_t A_BYTES = BM * BK * 2;         // 16 KB
constexpr uint32_t B_BOX = BK * BOX * 2;          // 8 KB: 64 K rows x 64 cols
constexpr uint32_t STAGE = A_BYTES + 2 * B_BOX;   // 32 KB
constexpr uint32_t EPI_BOX = BOX * BOX * 2;       // 8 KB: 64 rows x 64 cols
constexpr uint32_t EPI_OFF = STAGES * STAGE;
// four staging boxes per consumer: the tile's residual in, its output out
constexpr uint32_t BIAS_OFF = EPI_OFF + 2 * 4 * EPI_BOX;
constexpr uint32_t BAR_OFF = BIAS_OFF + 2 * BN * 2;
// full and empty per stage; per consumer, its residual's and its turn
constexpr int N_BARS = 2 * STAGES + 4;
// + 1024: the swizzled tiles start on a 1024-byte boundary
constexpr size_t SMEM_BYTES = BAR_OFF + N_BARS * 8 + 1024;
static_assert(SMEM_BYTES <= 232448, "shared memory");
constexpr int BAR_EPILOGUE = 1;  // + the consumer's index

struct Epilogue {
  const __nv_bfloat16* bias;  // [N] or null
  bool residual;              // the residual's tensor map holds it
  float scale;
};

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// generic-proxy writes to shared memory -> visible to TMA
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// one box of shared memory -> a 2-D tensor map at (c0 inner, c1 outer)
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void store_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// this thread's stores have all finished reading shared memory
__device__ __forceinline__ void store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t ld_shared(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// the bf16 in the low / high half of a 32-bit word, as fp32 (exact)
__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

// The activation: gemm_bf16.cu's quick_gelu x sigmoid(1.702 x) with a
// one-instruction reciprocal (__fdividef: at CLIP-L's fc1 the exact
// division cost ~0.09 ms of 0.39, PERF.md) and its erf-GELU
template <int ACT>
__device__ __forceinline__ float activation(float v) {
  if constexpr (ACT == 1) return __fdividef(v, 1.f + __expf(-1.702f * v));
  else if constexpr (ACT == 2)
    return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  else return v;
}

// act((acc + bias) * scale) + residual of one column pair, packed to bf16
template <int ACT>
__device__ __forceinline__ uint32_t epilogue_pair(float v0, float v1,
                                                  uint32_t bias, float scale,
                                                  uint32_t res) {
  v0 = activation<ACT>((v0 + bf_lo(bias)) * scale) + bf_lo(res);
  v1 = activation<ACT>((v1 + bf_hi(bias)) * scale) + bf_hi(res);
  return pack_bf16(v0, v1);
}

// One 64-row half of a tile's epilogue: accumulator d[4i + e] is (r_lo,
// 8i + 2 t4 + e), d[4i + 2 + e] (r_lo + 8, the same column); column block
// i (of 16) lies in staging box i / 8 of the half, at chunk (i % 8) ^
// (row % 8) of its 128-byte row. The residual is read from, and the
// output written to, the same place. CH column blocks at a time: their
// bias and residual words are loaded together, then their activations
// run side by side (the shared-memory accesses stay in program order, so
// one block at a time would chain every load behind the last store).
template <int ACT>
__device__ __forceinline__ void epilogue_half(const float (&d)[64],
                                              uint32_t boxes, uint32_t bias,
                                              int r_lo, int g, int t4,
                                              float scale, bool has_res) {
  constexpr int CH = 4;
#pragma unroll
  for (int i0 = 0; i0 < 16; i0 += CH) {
    uint32_t addr[CH], b[CH], res[CH][2];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int i = i0 + c;
      addr[c] = boxes + (i / 8) * EPI_BOX + r_lo * 128 +
                (((i % 8) ^ g) << 4) + 4 * t4;
      b[c] = ld_shared(bias + 4 * (4 * i + t4));
      res[c][0] = has_res ? ld_shared(addr[c]) : 0u;
      res[c][1] = has_res ? ld_shared(addr[c] + 8 * 128) : 0u;
    }
    uint32_t out[CH][2];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int i = i0 + c;
      out[c][0] = epilogue_pair<ACT>(d[4 * i], d[4 * i + 1], b[c], scale,
                                     res[c][0]);
      out[c][1] = epilogue_pair<ACT>(d[4 * i + 2], d[4 * i + 3], b[c],
                                     scale, res[c][1]);
    }
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      st_shared(addr[c], out[c][0]);
      st_shared(addr[c] + 8 * 128, out[c][1]);
    }
  }
}

template <int ACT>
__global__ void __launch_bounds__(NT, 1)
    gemm_bf16_sm90_kernel(const __grid_constant__ CUtensorMap tm_a,
                          const __grid_constant__ CUtensorMap tm_b,
                          const __grid_constant__ CUtensorMap tm_c,
                          const __grid_constant__ CUtensorMap tm_r,
                          const Epilogue ep, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bars = base + BAR_OFF;
  auto a_s = [&](int s) { return base + s * STAGE; };
  auto b_s = [&](int s) { return base + s * STAGE + A_BYTES; };
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (STAGES + s); };

  // persistent grid: block b takes tiles b, b + gridDim.x, ... in the
  // grouped raster (GROUP_M row tiles per group, row tiles fastest); its
  // i-th tile goes to consumer i % 2
  const int n_m = (M + BM - 1) / BM, n_n = (N + BN - 1) / BN;
  const int n_tiles = n_m * n_n;
  const int per_group = GROUP_M * n_n;
  auto tile_origin = [&](int tile, int& m0, int& n0) {
    const int first_m = (tile / per_group) * GROUP_M;
    const int gsize = min(n_m - first_m, GROUP_M);
    m0 = (first_m + (tile % per_group) % gsize) * BM;
    n0 = ((tile % per_group) / gsize) * BN;
  };
  const int n_k = (K + BK - 1) / BK;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      // the four warps of the consumer that reads the stage
      mbar_init(empty(s), 4);
    }
    mbar_init(bars + 8u * 2 * STAGES, 1);
    mbar_init(bars + 8u * (2 * STAGES + 1), 1);
    mbar_init(bars + 8u * (2 * STAGES + 2), 4);
    mbar_init(bars + 8u * (2 * STAGES + 3), 4);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------- producer ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == 0) {
      int it = 0;  // k-tiles over all of this block's tiles
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        int m0, n0;
        tile_origin(tile, m0, n0);
        for (int kt = 0; kt < n_k; ++kt, ++it) {
          const int s = it % STAGES;
          // the first pass over the ring finds every stage free
          mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(full(s), STAGE);
          tma_load_2d(a_s(s), &tm_a, full(s), kt * BK, m0);
          tma_load_2d(b_s(s), &tm_b, full(s), n0, kt * BK);
          tma_load_2d(b_s(s) + B_BOX, &tm_b, full(s), n0 + BOX, kt * BK);
        }
      }
    }
  } else {
    // ---------------- consumers ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int cw = wg - 1;
    const int wtid = tid - 128 * wg;  // 0..127 inside the warpgroup
    const int warp = wtid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    // this thread's first accumulator row of each half; the consumer's
    // staging boxes ([half][column box]), bias and residual barrier
    const int r_lo = 16 * warp + g;
    const uint32_t epi = base + EPI_OFF + cw * 4 * EPI_BOX;
    const uint32_t bias_s = base + BIAS_OFF + cw * BN * 2;
    const uint32_t res_bar = bars + 8u * (2 * STAGES + cw);
    // The consumers run their products in turn, tile after tile: a
    // consumer's n-th tile waits for the other's last products to have
    // been issued (consumer 0's first waits for nothing). So every stage's
    // previous fill has been seen before its next is awaited, and a full
    // barrier's parity never names a phase two behind.
    const uint32_t my_turn = bars + 8u * (2 * STAGES + 2 + cw);
    const uint32_t next_turn = bars + 8u * (2 * STAGES + 2 + (cw ^ 1));

    float acc0[64], acc1[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
    int n_done = 0;  // tiles this consumer has finished
    for (int i = cw;; i += 2, ++n_done) {
      const int tile = blockIdx.x + i * gridDim.x;
      if (tile >= n_tiles) break;
      int m0, n0;
      tile_origin(tile, m0, n0);
      // under the products: the bias pair of columns n0 + 2 wtid, and the
      // residual into the staging boxes once the last tile's stores have
      // read them (TMA zero-fills past M and N)
      uint32_t bias = 0u;
      if (wtid < BN / 2 && ep.bias != nullptr && n0 + 2 * wtid < N)
        bias = __ldg(reinterpret_cast<const unsigned int*>(ep.bias + n0 +
                                                           2 * wtid));
      if (wtid == 0) {
        store_wait_read();
        if (ep.residual) {
          mbar_expect_tx(res_bar, 4 * EPI_BOX);
#pragma unroll
          for (int b = 0; b < 4; ++b)
            tma_load_2d(epi + b * EPI_BOX, &tm_r, res_bar,
                        n0 + BOX * (b % 2), m0 + BOX * (b / 2));
        }
      }

      const int it0 = i * n_k;
      mbar_wait(my_turn, (n_done & 1) ^ (cw == 0));
      for (int kt = 0; kt < n_k; ++kt) {
        const int it = it0 + kt, s = it % STAGES;
        mbar_wait(full(s), (it / STAGES) & 1);
        wg_fence();
        // the tile's first product overwrites the accumulator
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t db = desc_sw128(b_s(s) + kk * 16 * 128, B_BOX, 1024);
          const int add = (kt > 0) | (kk > 0);
          wgmma_ss_tb(acc0, desc_sw128(a_s(s) + kk * 32, 16, 1024), db, add);
          wgmma_ss_tb(acc1, desc_sw128(a_s(s) + 64 * 128 + kk * 32, 16, 1024),
                      db, add);
        }
        wg_commit();
        // the last stage awaited and its products issued: the other
        // consumer's turn, while these run
        if (kt == n_k - 1 && lane == 0) mbar_arrive(next_turn);
        // the previous k-tile's products have retired: its stage is free
        wg_wait<1>();
        if (kt > 0 && lane == 0) mbar_arrive(empty((it - 1) % STAGES));
      }
      wg_wait<0>();
      pin(acc0);
      pin(acc1);
      if (lane == 0) mbar_arrive(empty((it0 + n_k - 1) % STAGES));

      // epilogue, while the other consumer runs its tile's products
      if (wtid < BN / 2) st_shared(bias_s + 4 * wtid, bias);
      named_sync(BAR_EPILOGUE + cw, 128);
      if (ep.residual) mbar_wait(res_bar, n_done & 1);
      epilogue_half<ACT>(acc0, epi, bias_s, r_lo, g, t4, ep.scale,
                         ep.residual);
      epilogue_half<ACT>(acc1, epi + 2 * EPI_BOX, bias_s, r_lo, g, t4,
                         ep.scale, ep.residual);
      fence_async_smem();
      named_sync(BAR_EPILOGUE + cw, 128);
      if (wtid == 0) {
        // boxes wholly past M or N store nothing (TMA clips the rest)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (n0 + BOX * (b % 2) < N && m0 + BOX * (b / 2) < M)
            tma_store_2d(&tm_c, epi + b * EPI_BOX, n0 + BOX * (b % 2),
                         m0 + BOX * (b / 2));
        store_commit();
      }
    }
    // the last stores have left shared memory before the block exits
    if (wtid == 0) store_wait_read();
  }
}

int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 0;
  }
  return n;
}

template <int ACT>
int launch(const CUtensorMap& ta, const CUtensorMap& tb,
           const CUtensorMap& tc, const CUtensorMap& tr, const Epilogue& ep,
           int M, int N, int K, cudaStream_t st) {
  auto kern = gemm_bf16_sm90_kernel<ACT>;
  const cudaError_t r = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (r != cudaSuccess) return (int)r;
  const int sms = num_sms();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const long long tiles =
      (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const unsigned blocks = (unsigned)(tiles < sms ? tiles : sms);
  kern<<<blocks, NT, SMEM_BYTES, st>>>(ta, tb, tc, tr, ep, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// geom: 4 x GEOM_2D int64 (A, B, C, residual), each the byte offset of
// the map's base, dims (inner, outer), the outer byte stride and the box,
// as kernels.gemm_bf16_sm90_geometry computes them (the residual's read
// only when there is one)
extern "C" int vls_gemm_bf16_sm90(const void* a, const void* b,
                                  const void* bias, const void* residual,
                                  void* c, const long long* geom, int m,
                                  int n, int k, float scale, int act,
                                  void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const long long* ga = geom;
  const long long* gb = geom + GEOM_2D;
  const long long* gc = geom + 2 * GEOM_2D;
  const long long* gr = geom + 3 * GEOM_2D;
  if (k <= 0 || k % 8 || n % 8 || ga[1] != k || ga[2] != m || gb[1] != n ||
      gb[2] != k || gc[1] != n || gc[2] != m ||
      (residual != nullptr && (gr[1] != n || gr[2] != m)) || act < 0 ||
      act > 2)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb, tc, tr;
  constexpr CUtensorMapDataType BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  int e = encode_2d(&ta, a, ga, BK, BM, BF16);
  if (e == 0) e = encode_2d(&tb, b, gb, BOX, BK, BF16);
  if (e == 0) e = encode_2d(&tc, c, gc, BOX, BOX, BF16);
  // without a residual the map is never read: C's stands in
  if (e == 0)
    e = encode_2d(&tr, residual ? residual : c, residual ? gr : gc, BOX, BOX,
                  BF16);
  if (e != 0) return e;
  Epilogue ep;
  ep.bias = (const __nv_bfloat16*)bias;
  ep.residual = residual != nullptr;
  ep.scale = scale;
  const cudaStream_t st = (cudaStream_t)stream;
  if (act == 1) return launch<1>(ta, tb, tc, tr, ep, m, n, k, st);
  if (act == 2) return launch<2>(ta, tb, tc, tr, ep, m, n, k, st);
  return launch<0>(ta, tb, tc, tr, ep, m, n, k, st);
}
