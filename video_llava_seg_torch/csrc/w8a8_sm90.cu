// W8A8 product for Hopper (sm_90a): gemm_s8 on TMA loads into
// 128-byte-swizzled shared tiles with mbarrier completion, the int8
// products on wgmma with the [in, out] weights on the register side.
//
//   acc = xq[M, K] @ W[K, N]   (int8 x int8 -> exact int32; W = kernel_qa)
//   int32 mode: y = acc
//   dense mode: y = bf16((float(acc) * a_scale[r]) * w_scale[c])
//                   [+ bias] [* bf16(qscale) | act(.)] [+ residual]
//
// The contract and the arithmetic are w8a8.cu's gemm_s8_kernel, bit for
// bit, in both modes: each epilogue step is rounded to bf16, with
// __fmul_rn / __fadd_rn (no contraction) and the same expf / erff forms
// of the activations. This source must not be built with
// --use_fast_math.
//
// Replaces, with attention.cu and w8a8.cu's row kernels,
// video_llava_seg_tpu/ops/vit_block.py::_vit_kernel_i8 (K8): its
// `_dense_i8` (vit_block.py:206-213) with the q scale, the activation
// and the residuals fused into the epilogue. The int32 mode replaces
// XLA's int8 `jnp.dot(..., preferred_element_type=int32)` of nn.dense
// (video_llava_seg_tpu/ops/nn.py:77): ops/int4.int_matmul, the product
// of every `kernel_qa` dense outside the layer (the projector, the
// unembedding). Where TMA cannot address the operands (K or N not a
// multiple of 16) w8a8.cu keeps the call (kernels.gemm_s8_entry names
// the route).
//
// Bound on the card: 2 M K N int8 operations against the bytes of xq, W,
// y (and the residual). At the ViT shapes (18,464 rows = 32 frames x 577
// tokens) fc1 and fc2 are operation-bound (0.078 ms at CLIP-L, 0.122 ms
// at RADIO-H), q / k / v / out nearly balanced. The design is w4a8_sm90.cu's
// without the nibble planes:
//
// - 8-bit wgmma reads both operands K-major and has no transpose bit.
//   W is [K, N] with N contiguous (N-major), which TMA cannot transpose,
//   and the parameter tree keeps that layout. So each output tile is
//   computed transposed, Y^T = W^T X^T: W is the A operand of
//   `wgmma m64n128k32 .s32.s8.s8`, built in registers; X is the B
//   operand, read by the tensor cores straight from the swizzled box TMA
//   fills (xq [M, K] is K-major).
// - Persistent grid: one block of 3 warpgroups (384 threads) per SM walks
//   output tiles of BM = 128 rows by BN = 128 channels. Warpgroup 0 is
//   the producer: it gives up registers (setmaxnreg.dec) and one thread
//   starts, per stage, two TMA loads on the stage's full mbarrier: the
//   activation box xq[m0 : m0 + 128, kk : kk + 128] and the weight box
//   W[kk : kk + 128, n0 : n0 + 128], 16 KB each. Four stages of 32 KB,
//   filled across tiles: the next tile's first stages load while the
//   consumers run the epilogue. TMA zero-fills past M, K and N, so a
//   ragged tail adds zeros.
// - Warpgroups 1 and 2 are consumers of 64 output channels each
//   (setmaxnreg.inc). Per k32 step a thread reads 4 x 4 weight bytes
//   from shared memory (4 K rows x 4 adjacent channels, four 32-bit
//   loads), byte-transposes them and trades half with the lane 4 away:
//   the 4 A registers of `mma.sync m16n8k32`'s A fragment, which is
//   wgmma's register-A layout. One m64n128k32 wgmma per step into an
//   int32 accumulator of 64 channels x 128 rows (64 registers). The A
//   registers are double-buffered: step s + 1's are built while step s's
//   product runs (wgmma.wait_group 1), and a stage is released on its
//   empty mbarrier once every product that reads it has retired.
// - Channel order inside a tile: the A fragment gives a thread rows
//   lane / 4 and + 8 of its warp's 16; they map to channels 4 (g / 2) +
//   2 (g % 2) and + 1 (g = lane / 4), so a pair of lanes (g even, g odd)
//   covers 4 adjacent channels, one 32-bit shared load per K row.
// - Bank conflicts: the weight box is 128-byte swizzled (16-byte chunk c
//   of row r sits at c ^ (r % 8)), and each lane rotates the order of its
//   four row loads by (lane % 4) / 2 + 2 (g % 2), so the eight rows a
//   warp reads in one load fall on eight different chunks; one funnel
//   shift per transposed word rotates the bytes back into K order.
// - Epilogue: the int32 tile is staged, transposed, in a 66 KB buffer
//   beside the ring (two named barriers of the consumers); then each
//   thread takes 8 channels (one 16-byte chunk along N) of 8 rows: the
//   scales, the bias and the residual rows are loaded before the staging
//   so that their latency hides under it, the steps run on 8 values at a
//   time with two roundings to bf16 per conversion, and the result is
//   written as 16-byte stores (int32 mode: the sums as they are), rows
//   >= M and channels >= N masked. The activation is a template argument,
//   so each instance holds only its own.
// - Raster: blocks walk groups of 16 row tiles, row tiles fastest, so the
//   132 blocks in flight share ~16 activation tiles and ~8 weight tiles
//   (at RADIO-H fc2 X is 94 MB and W 6.6 MB against a 50 MB L2).
//
// Later work: the epilogue's arithmetic under the next tile's products
// (an epilogue warpgroup, or two consumers on alternate tiles), more than
// one step of products in flight during the A build, the per-row
// activation quantization fused into the producer.
//
// Contract (checked by the Python wrapper): M > 0; xq int8 [M, K] and W
// int8 [K, N] with K > 0 and K, N multiples of 16, contiguous, 16-byte
// aligned; dense mode: a_scale fp32 [M], w_scale fp32 [N], bias bf16 [N]
// or null, residual bf16 [M, N] or null, y bf16 [M, N]; int32 mode: y
// int32 [M, N].

#include "sm90.cuh"

namespace {

constexpr int BM = 128;  // activation rows per tile: the wgmma's N
constexpr int BN = 128;  // output channels per tile, 64 per consumer
constexpr int BK = 128;  // K per stage
constexpr int STAGES = 4;
constexpr int NT = 384;  // producer + two consumer warpgroups
constexpr int GROUP_M = 16;
constexpr int CONSUMER_WARPS = 8;
constexpr uint32_t W_BYTES = BK * BN;  // 16 KB weight box
constexpr uint32_t X_BYTES = BM * BK;  // 16 KB activation box
constexpr uint32_t STAGE_BYTES = W_BYTES + X_BYTES;
// the int32 tile staged for the epilogue, [BM rows][BN channels], each
// row padded by 16 bytes (conflict-free pair stores), beside the ring so
// that the producer fills the ring for the next tile meanwhile
constexpr int ROW_BYTES = BN * 4 + 16;
constexpr uint32_t STAGING_OFF = STAGES * STAGE_BYTES;
constexpr uint32_t BAR_OFF = STAGING_OFF + BM * ROW_BYTES;
constexpr int N_BARS = 2 * STAGES;  // full, empty per stage
// + 1024: the swizzled tiles start on a 1024-byte boundary
constexpr size_t SMEM_BYTES = BAR_OFF + N_BARS * 8 + 1024;
constexpr int BAR_EPILOGUE = 1;  // named barrier of the two consumers

struct Epilogue {
  const float* a_scale;          // [M] (dense mode)
  const float* w_scale;          // [N] (dense mode)
  const __nv_bfloat16* bias;     // [N] or null
  const __nv_bfloat16* residual; // [M, N] or null
  float qscale;                  // 0: none; else multiply by bf16(qscale)
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

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void pin_u64(uint64_t& v) {
  asm volatile("" : "+l"(v) :: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// the bf16 in the low / high half of a 32-bit word, as fp32 (exact)
__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

__device__ __forceinline__ float rbf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// round 8 values to bf16 and back, two a conversion
__device__ __forceinline__ void rbf8(float (&f)[8]) {
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[j], f[j + 1]);
    f[j] = __low2float(h);
    f[j + 1] = __high2float(h);
  }
}

// w8a8.cu's activation, term for term
__device__ __forceinline__ float activation(int act, float v) {
  if (act == 1) return v * (1.f / (1.f + expf(-1.702f * v)));
  if (act == 2) return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  return v;
}

// A thread's share of one tile's dense epilogue: the scales, the bias and
// the residual of 8 channels (one 16-byte bf16 chunk) of 8 rows
struct DenseChunk {
  static constexpr int CHUNKS = BN / 8, ITERS = BM * CHUNKS / 256;
  float ws[8], b[8], as[ITERS];
  int4 res[ITERS];
};

// w8a8.cu's dense epilogue on 8 adjacent channels of one row, the same
// steps in the same order, each rounded to bf16: (acc * as) * ws, +
// bias, * qs, act, + residual (rounded once at the end)
template <int ACT>
__device__ __forceinline__ int4 dense8(const int4& v0, const int4& v1,
                                       float as,
                                       const float (&ws)[8],
                                       const float (&b)[8], bool has_bias,
                                       float qs, bool has_res,
                                       const int4& res) {
  const int v[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
  float f[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    f[j] = __fmul_rn(__fmul_rn(__int2float_rn(v[j]), as), ws[j]);
  rbf8(f);
  if (has_bias) {
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = __fadd_rn(f[j], b[j]);
    rbf8(f);
  }
  if (qs != 0.f) {
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = __fmul_rn(f[j], qs);
    rbf8(f);
  }
  if (ACT) {
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = activation(ACT, f[j]);
    rbf8(f);
  }
  uint32_t o[4];
  if (has_res) {
    const uint32_t r[4] = {(uint32_t)res.x, (uint32_t)res.y, (uint32_t)res.z,
                           (uint32_t)res.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 h =
          __floats2bfloat162_rn(__fadd_rn(f[2 * j], bf_lo(r[j])),
                                __fadd_rn(f[2 * j + 1], bf_hi(r[j])));
      o[j] = *reinterpret_cast<const uint32_t*>(&h);
    }
  } else {
    // every value is exact in bf16 already: its upper half is the bf16
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o[j] = (__float_as_uint(f[2 * j]) >> 16) |
             (__float_as_uint(f[2 * j + 1]) & 0xFFFF0000u);
  }
  return make_int4((int)o[0], (int)o[1], (int)o[2], (int)o[3]);
}

// The 4 A registers of one k32 step from the swizzled weight tile at `w`
// (32 K rows from the step's first): this lane's 4 rows (offsets `off`,
// in rotated order), byte-transposed to 4 channels x 4 rows, rotated back
// into row order, half traded with lane ^ 4 (odd: the lane of g odd,
// which keeps channels 2 and 3 of the quad).
__device__ __forceinline__ void build_a(uint32_t (&a)[4], uint32_t w,
                                        const uint32_t (&off)[4],
                                        uint32_t rot, bool odd) {
  uint32_t r[4], c[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) r[i] = lds32(w + off[i]);
  transpose4x4(r, c);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] = __funnelshift_l(c[i], c[i], rot);
  const uint32_t s0 = odd ? c[0] : c[2], s1 = odd ? c[1] : c[3];
  const uint32_t q0 = __shfl_xor_sync(0xffffffffu, s0, 4);
  const uint32_t q1 = __shfl_xor_sync(0xffffffffu, s1, 4);
  // (channel, K bytes): a0 (ch 0, 4t..), a1 (ch 1, 4t..), a2 (ch 0,
  // 16 + 4t..), a3 (ch 1, 16 + 4t..) of this lane's two channels
  a[0] = odd ? q0 : c[0];
  a[1] = odd ? q1 : c[1];
  a[2] = odd ? c[2] : q0;
  a[3] = odd ? c[3] : q1;
}

// MODE: INT32 (the sums as they are) or the activation of the dense
// epilogue (bf16 out), a template argument so that each instance holds
// only its own activation's code
constexpr int INT32 = -1;

template <int MODE>
__global__ void __launch_bounds__(NT, 1)
    gemm_s8_sm90_kernel(const __grid_constant__ CUtensorMap tm_x,
                        const __grid_constant__ CUtensorMap tm_w,
                        const Epilogue ep, void* __restrict__ y, int M,
                        int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const staging = smem_raw + (base - raw) + STAGING_OFF;
  const uint32_t bars = base + BAR_OFF;
  auto w_s = [&](int s) { return base + s * STAGE_BYTES; };
  auto x_s = [&](int s) { return base + s * STAGE_BYTES + W_BYTES; };
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (STAGES + s); };

  // persistent grid: block b takes tiles b, b + gridDim.x, ... in the
  // grouped raster (GROUP_M row tiles per group, row tiles fastest)
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
      mbar_init(empty(s), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------- producer ----------------
    // runs up to STAGES k-tiles ahead, across tiles: the next tile's
    // loads are in flight while the consumers run the epilogue
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (tid == 0) {
      int it = 0;  // k-tiles over all of this block's tiles
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        int m0, n0;
        tile_origin(tile, m0, n0);
        for (int kt = 0; kt < n_k; ++kt, ++it) {
          const int s = it % STAGES;
          // the first pass over the ring finds every stage free
          mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(full(s), STAGE_BYTES);
          tma_load_2d(w_s(s), &tm_w, full(s), n0, kt * BK);
          tma_load_2d(x_s(s), &tm_x, full(s), kt * BK, m0);
        }
      }
    }
  } else {
    // ---------------- consumers ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int cw = wg - 1;
    const int ltid = tid - 128;  // 0..255 over both consumers
    const int warp = (tid - 128 * wg) / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const bool odd = g & 1;
    // this lane reads K rows 16 odd + 4 t4 + i (i = 0..3) of each k32
    // step, in the order i = (load + rot) % 4, at the 16-byte chunk of its
    // warp's 16 channels, word g / 2
    const int rot = (t4 >> 1) + 2 * odd;
    const int chunk = 4 * cw + warp;
    uint32_t off[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 16 * odd + 4 * t4 + ((i + rot) & 3);
      off[i] = r * 128 + ((chunk ^ (r & 7)) << 4) + 4 * (g >> 1);
    }
    const uint32_t rot_bits = 8 * rot;
    // the staged tile: this thread's two channels (acc rows g, g + 8 of
    // its warp's 16) and rows 8 i + 2 t4 + e
    const int pc = 64 * cw + 16 * warp + 4 * (g >> 1) + 2 * odd;

    int it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      int m0, n0;
      tile_origin(tile, m0, n0);
      uint32_t acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0u;
      uint32_t a[2][4];

      for (int kt = 0; kt < n_k; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(full(s), (it / STAGES) & 1);
#pragma unroll
        for (int step = 0; step < BK / 32; ++step) {
          uint32_t(&ab)[4] = a[step & 1];
          // the product of two steps ago (which read ab) has retired.
          // Unconditional: behind a test of the tile index (the first
          // tile has nothing to wait for) ptxas serializes every wgmma
          // (C7513)
          wg_wait<1>();
          pin(ab);
          // ... and at step 1 every product of the previous k-tile has
          if (step == 1 && kt > 0 && lane == 0)
            mbar_arrive(empty((it - 1) % STAGES));
          build_a(ab, w_s(s) + step * 32 * 128, off, rot_bits, odd);
          uint64_t dx = desc_sw128(x_s(s) + 32 * step, 16, 1024);
          // every input of the product is in its register before the fence
          pin(ab);
          pin_u64(dx);
          wg_fence();
          wgmma_rs_s8(acc, ab, dx);
          wg_commit();
        }
      }
      wg_wait<0>();
      pin(acc);
      pin(a[0]);
      pin(a[1]);
      // the tile's last stage is free for the producer's next tile
      if (lane == 0) mbar_arrive(empty((it - 1) % STAGES));

      // epilogue: stage the int32 tile (once both consumers are past the
      // previous tile's write-out), then turn 16-byte chunks along N into
      // output
      if constexpr (MODE == INT32) {
        named_sync(BAR_EPILOGUE, 256);
#pragma unroll
        for (int i = 0; i < BM / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            *reinterpret_cast<uint2*>(staging + (8 * i + 2 * t4 + e) *
                                      ROW_BYTES + pc * 4) =
                make_uint2(acc[4 * i + e], acc[4 * i + 2 + e]);
        named_sync(BAR_EPILOGUE, 256);
        constexpr int CHUNKS = BN / 4;  // 4 channels a chunk
        int32_t* const out = reinterpret_cast<int32_t*>(y);
        const int ch = ltid % CHUNKS, n = n0 + 4 * ch;
#pragma unroll 4
        for (int row = ltid / CHUNKS; row < BM; row += 256 / CHUNKS) {
          const int m = m0 + row;
          if (m < M && n < N)
            *reinterpret_cast<int4*>(out + (size_t)m * N + n) =
                *reinterpret_cast<const int4*>(staging + row * ROW_BYTES +
                                               ch * 16);
        }
      } else {
        // this thread's 8 channels are fixed over the write-out: its
        // scales, bias and residual are loaded before the staging, so
        // their latency hides under it
        using C = DenseChunk;
        const int ch = ltid % C::CHUNKS, r0 = ltid / C::CHUNKS;
        const int n = n0 + 8 * ch;
        // N % 16 == 0: a chunk lies inside N or wholly past it
        const bool in_n = n < N;
        const bool has_bias = ep.bias != nullptr;
        const bool has_res = ep.residual != nullptr;
        C c;
#pragma unroll
        for (int j = 0; j < 8; ++j) c.ws[j] = c.b[j] = 0.f;
        if (in_n) {
          const float4* wp = reinterpret_cast<const float4*>(ep.w_scale + n);
          const float4 w0 = __ldg(wp), w1 = __ldg(wp + 1);
          c.ws[0] = w0.x; c.ws[1] = w0.y; c.ws[2] = w0.z; c.ws[3] = w0.w;
          c.ws[4] = w1.x; c.ws[5] = w1.y; c.ws[6] = w1.z; c.ws[7] = w1.w;
          if (has_bias) {
            const int4 bv = __ldg(reinterpret_cast<const int4*>(ep.bias + n));
            const uint32_t bw[4] = {(uint32_t)bv.x, (uint32_t)bv.y,
                                    (uint32_t)bv.z, (uint32_t)bv.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              c.b[2 * j] = bf_lo(bw[j]);
              c.b[2 * j + 1] = bf_hi(bw[j]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < C::ITERS; ++i) {
          const int m = m0 + r0 + 16 * i;
          c.as[i] = m < M ? __ldg(ep.a_scale + m) : 0.f;
          c.res[i] = make_int4(0, 0, 0, 0);
          if (has_res && m < M && in_n)
            c.res[i] = __ldg(reinterpret_cast<const int4*>(
                ep.residual + (size_t)m * N + n));
        }
        const float qs = ep.qscale != 0.f ? rbf(ep.qscale) : 0.f;
        named_sync(BAR_EPILOGUE, 256);
#pragma unroll
        for (int i = 0; i < BM / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            *reinterpret_cast<uint2*>(staging + (8 * i + 2 * t4 + e) *
                                      ROW_BYTES + pc * 4) =
                make_uint2(acc[4 * i + e], acc[4 * i + 2 + e]);
        named_sync(BAR_EPILOGUE, 256);
        __nv_bfloat16* const out = reinterpret_cast<__nv_bfloat16*>(y);
#pragma unroll
        for (int i = 0; i < C::ITERS; ++i) {
          const int row = r0 + 16 * i, m = m0 + row;
          if (m >= M || !in_n) continue;
          const int4* src = reinterpret_cast<const int4*>(
              staging + row * ROW_BYTES + ch * 32);
          *reinterpret_cast<int4*>(out + (size_t)m * N + n) =
              dense8<MODE>(src[0], src[1], c.as[i], c.ws, c.b, has_bias, qs,
                           has_res, c.res[i]);
        }
      }
    }
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

template <int MODE>
int launch(const CUtensorMap& tx, const CUtensorMap& tw, const Epilogue& ep,
           void* y, int M, int N, int K, cudaStream_t st) {
  auto kern = gemm_s8_sm90_kernel<MODE>;
  const cudaError_t r = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (r != cudaSuccess) return (int)r;
  const int sms = num_sms();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const long long tiles =
      (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const unsigned blocks = (unsigned)(tiles < sms ? tiles : sms);
  kern<<<blocks, NT, SMEM_BYTES, st>>>(tx, tw, ep, y, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// geom: 2 x GEOM_2D int64 (xq, W), each the byte offset of the map's
// base, dims (inner, outer), the outer byte stride and the box, as
// kernels.gemm_s8_sm90_geometry computes them
extern "C" int vls_gemm_s8_sm90(const void* a, const void* a_scale,
                                const void* b, const void* w_scale,
                                const void* bias, const void* residual,
                                void* y, const long long* geom, int M, int N,
                                int K, int dense, int act, float qscale,
                                void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const long long* gx = geom;
  const long long* gw = geom + GEOM_2D;
  if (K <= 0 || K % 16 || N % 16 || gx[0] != 0 || gx[1] != K ||
      gx[2] != M || gw[0] != 0 || gw[1] != N || gw[2] != K || act < 0 ||
      act > 2)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  constexpr CUtensorMapDataType I8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  int e = encode_2d(&tx, a, gx, BK, BM, I8);
  if (e == 0) e = encode_2d(&tw, b, gw, BN, BK, I8);
  if (e != 0) return e;
  Epilogue ep;
  ep.a_scale = (const float*)a_scale;
  ep.w_scale = (const float*)w_scale;
  ep.bias = (const __nv_bfloat16*)bias;
  ep.residual = (const __nv_bfloat16*)residual;
  ep.qscale = qscale;
  const cudaStream_t st = (cudaStream_t)stream;
  if (!dense) return launch<INT32>(tx, tw, ep, y, M, N, K, st);
  if (act == 1) return launch<1>(tx, tw, ep, y, M, N, K, st);
  if (act == 2) return launch<2>(tx, tw, ep, y, M, N, K, st);
  return launch<0>(tx, tw, ep, y, M, N, K, st);
}
