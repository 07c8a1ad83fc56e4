// W4A8 prefill product for Hopper (sm_90a): TMA loads into
// 128-byte-swizzled shared tiles with mbarrier completion, the int8
// products on wgmma with the packed weights on the register side.
//
//   y[r, n] = (float(sum_k xq[r, k] * W[k, n]) * a_scale[r]) * w_scale[n]
//
// W is packed two values per byte in the JAX package's "halves" layout:
// byte (i, n) of packed [in/2, out] holds W[i, n] in its low nibble and
// W[i + in/2, n] in its high nibble, so the low plane multiplies
// xq[:, :in/2] and the high plane xq[:, in/2:].
//
// Replaces video_llava_seg_tpu/ops/int4.py::_w4a8_kernel (K5) for more
// than 8 rows (the LLM prefill) where TMA can address the operands
// (in/2 and out multiples of 16); w4a8_gemv_sm90.cu takes the decode
// rows (<= 8), w4a8.cu every other shape (kernels.w4a8_entry names the
// route).
//
// Arithmetic, bit for bit that of w4a8.cu and of w4a8_matmul_plain:
// each nibble plane is formed as 16 x its signed value (exact in int8),
// the int32 sums are 16 x the true sums (below 2^31 for in <= 131072,
// checked by the wrapper) and an arithmetic shift by 4 recovers them; the
// epilogue is (float(acc) * a_scale) * w_scale, two round-to-nearest fp32
// multiplies in that order (__fmul_rn: no contraction), then one
// round-to-nearest cast to bf16 or fp32.
//
// Bound on the card: 2 * rows * in * out int8 operations. At the
// Llama-3-8B prefill (10,392 rows, the four fused denses of one layer)
// that is 4.5e12 operations, 2.29 ms at the int8 peak, against ~0.2 ms
// for the bytes: compute-bound. The design feeds the tensor cores with
// wgmma and keeps the loads off the consumers' path:
//
// - 8-bit wgmma reads both operands K-major, and has no transpose bit.
//   The packed weight is [in/2, out] with out contiguous (N-major), which
//   TMA cannot transpose. So each output tile is computed transposed,
//   Y^T = W^T X^T: the weights are the A operand, built in registers
//   (wgmma ... .s32.s8.s8 with A from registers: the form that landed);
//   the activations are the B operand, read by the tensor cores straight
//   from the swizzled tiles TMA fills (xq [rows, in] is K-major).
// - A block is 3 warpgroups (384 threads) and owns BM = 128 activation
//   rows by BN = 128 output channels. Warpgroup 0 is the producer: it
//   gives up registers (setmaxnreg.dec) and one thread starts, per
//   stage, three TMA loads on the stage's full mbarrier: the activation box
//   xq[m0 : m0+128, kk : kk+128], the box at the same place of a second
//   tensor map whose base is xq + in/2 (each plane's ragged K tail is
//   zero-filled on its own), and the packed box packed[kk : kk+128,
//   n0 : n0+128]. Four stages of 48 KB.
// - Warpgroups 1 and 2 are consumers of 64 output channels each
//   (setmaxnreg.inc). Per k32 step a thread reads 4 x 4 packed bytes from
//   shared memory, byte-transposes them, trades half with the lane 4
//   away and splits the two nibble planes: 4 A registers of the low plane
//   and 4 of the high plane. It starts two m64n128k32 wgmmas (low plane x
//   the first activation box, high plane x the second) into one int32
//   accumulator of 64 channels x 128 rows (64 registers). The A registers
//   are double-buffered: step s + 1's are built while step s's products
//   run (wgmma.wait_group 1), and a stage is released on its empty
//   mbarrier once every product that reads it has retired.
// - Channel order inside a tile: the A fragment gives a thread rows
//   lane / 4 and + 8 of its warp's 16; they map to channels 4 (g / 2) +
//   2 (g % 2) and + 1 (g = lane / 4), so a pair of lanes (g even, g odd)
//   covers 4 adjacent channels, one 32-bit shared load per packed row.
//   The epilogue undoes nothing: it writes those two adjacent channels.
// - Bank conflicts: the packed box is 128-byte swizzled (16-byte chunk
//   c of row r sits at c ^ (r % 8)), and each lane rotates the order of
//   its four row loads by (lane % 4) / 2 + 2 (g % 2), so the eight rows a
//   warp reads in one load fall on eight different chunks; one funnel
//   shift per transposed word rotates the bytes back into K order.
// - Epilogue: both scales in the order above; the transposed tile is
//   staged through shared memory (the ring is free once both consumers'
//   products are done: a named barrier), then written as 16-byte stores
//   along out, rows >= rows and channels >= out masked.
// - Raster: blocks walk groups of 16 row tiles, row tiles fastest, so the
//   132 blocks in flight share ~16 activation tiles and ~8 weight tiles
//   (at the gate-up shape X is 42 MB and the packed weight 58 MB, against
//   a 50 MB L2).
//
// Later work: overlap of the A-fragment build with the previous step's
// products beyond one step, a persistent grid (one tile's epilogue under
// the next one's loads), the per-row activation quantization fused into
// the producer.
//
// Contract (checked by the Python wrapper): rows > 0; xq int8 [rows, in]
// and packed int8 [in/2, out] with in/2 and out multiples of 16, rows of
// 16-byte-aligned bytes; a_scale fp32 [rows]; w_scale fp32 [out]; y bf16
// or fp32 [rows, out], contiguous.

#include "sm90.cuh"

namespace {

constexpr int BM = 128;  // activation rows per block: the wgmma's N
constexpr int BN = 128;  // output channels per block, 64 per consumer
constexpr int BK = 128;  // packed rows per stage (2 x 128 values of K)
constexpr int STAGES = 4;
constexpr int NT = 384;  // producer + two consumer warpgroups
constexpr int GROUP_M = 16;
constexpr int CONSUMER_WARPS = 8;
constexpr uint32_t W_BYTES = BK * BN;  // 16 KB packed box
constexpr uint32_t X_BYTES = BM * BK;  // 16 KB activation box
constexpr uint32_t STAGE_BYTES = W_BYTES + 2 * X_BYTES;
constexpr uint32_t BAR_OFF = STAGES * STAGE_BYTES;
constexpr int N_BARS = 2 * STAGES;  // full, empty per stage
// + 1024: the swizzled tiles start on a 1024-byte boundary
constexpr size_t SMEM_BYTES = BAR_OFF + N_BARS * 8 + 1024;
constexpr int BAR_EPILOGUE = 1;  // named barrier of the two consumers

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

__device__ __forceinline__ float epilogue(uint32_t acc16, float as,
                                          float ws) {
  return __fmul_rn(__fmul_rn(__int2float_rn((int)acc16 >> 4), as), ws);
}

template <typename T>
struct Out;
template <>
struct Out<float> {
  __device__ static void store2(uint8_t* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};
template <>
struct Out<__nv_bfloat16> {
  __device__ static void store2(uint8_t* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) =
        __halves2bfloat162(__float2bfloat16_rn(a), __float2bfloat16_rn(b));
  }
};

// The 8 A registers (low plane 0-3, high plane 4-7) of one k32 step from
// the swizzled packed tile at `w` (32 packed rows from the step's first):
// this lane's 4 rows (offsets `off`, in rotated order), byte-transposed to
// 4 channels x 4 rows, rotated back into row order, half traded with lane
// ^ 4 (odd: the lane of g odd, which keeps channels 2 and 3 of the quad).
__device__ __forceinline__ void build_a(uint32_t (&a)[8], uint32_t w,
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
  // (channel, K bytes): f0 (ch 0, 4t..), f1 (ch 1, 4t..), f2 (ch 0,
  // 16 + 4t..), f3 (ch 1, 16 + 4t..) of this lane's two channels
  const uint32_t f0 = odd ? q0 : c[0], f1 = odd ? q1 : c[1];
  const uint32_t f2 = odd ? c[2] : q0, f3 = odd ? c[3] : q1;
  a[0] = lo16(f0); a[1] = lo16(f1); a[2] = lo16(f2); a[3] = lo16(f3);
  a[4] = hi16(f0); a[5] = hi16(f1); a[6] = hi16(f2); a[7] = hi16(f3);
}

template <typename T>
__global__ void __launch_bounds__(NT, 1)
    w4a8_sm90_kernel(const __grid_constant__ CUtensorMap tm_xlo,
                     const __grid_constant__ CUtensorMap tm_xhi,
                     const __grid_constant__ CUtensorMap tm_w,
                     const float* __restrict__ a_scale,
                     const float* __restrict__ w_scale, T* __restrict__ y,
                     int rows, int half, int out) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - raw);
  const uint32_t bars = base + BAR_OFF;
  auto w_s = [&](int s) { return base + s * STAGE_BYTES; };
  auto xlo_s = [&](int s) { return base + s * STAGE_BYTES + W_BYTES; };
  auto xhi_s = [&](int s) { return xlo_s(s) + X_BYTES; };
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (STAGES + s); };

  // grouped raster: GROUP_M row tiles per group, row tiles fastest
  const int n_m = (rows + BM - 1) / BM, n_n = (out + BN - 1) / BN;
  const int per_group = GROUP_M * n_n;
  const int pid = blockIdx.x;
  const int first_m = (pid / per_group) * GROUP_M;
  const int gsize = min(n_m - first_m, GROUP_M);
  const int m0 = (first_m + (pid % per_group) % gsize) * BM;
  const int n0 = ((pid % per_group) / gsize) * BN;
  const int n_k = (half + BK - 1) / BK;

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
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (tid == 0) {
      for (int t = 0; t < n_k; ++t) {
        const int s = t % STAGES;
        const uint32_t ph = (t / STAGES) & 1;
        // the first pass over the ring finds every stage free
        mbar_wait(empty(s), ph ^ 1);
        mbar_expect_tx(full(s), STAGE_BYTES);
        tma_load_2d(w_s(s), &tm_w, full(s), n0, t * BK);
        tma_load_2d(xlo_s(s), &tm_xlo, full(s), t * BK, m0);
        tma_load_2d(xhi_s(s), &tm_xhi, full(s), t * BK, m0);
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
    // this lane reads packed rows 16 odd + 4 t4 + i (i = 0..3) of each
    // k32 step, in the order i = (load + rot) % 4, at the 16-byte chunk of
    // its warp's 16 channels, word g / 2
    const int rot = (t4 >> 1) + 2 * odd;
    const int chunk = 4 * cw + warp;
    uint32_t off[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 16 * odd + 4 * t4 + ((i + rot) & 3);
      off[i] = r * 128 + ((chunk ^ (r & 7)) << 4) + 4 * (g >> 1);
    }
    const uint32_t rot_bits = 8 * rot;

    uint32_t acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0u;
    uint32_t a[2][8];

    for (int t = 0; t < n_k; ++t) {
      const int s = t % STAGES;
      mbar_wait(full(s), (t / STAGES) & 1);
#pragma unroll
      for (int step = 0; step < BK / 32; ++step) {
        uint32_t(&ab)[8] = a[step & 1];
        // the products of two steps ago (which read ab) have retired.
        // Unconditional: behind a test of the tile index (the first tile
        // has nothing to wait for) ptxas serialized every wgmma (C7513)
        wg_wait<1>();
        pin(ab);
        // ... and at step 1 every product of the previous tile has
        if (step == 1 && t > 0 && lane == 0)
          mbar_arrive(empty((t - 1) % STAGES));
        build_a(ab, w_s(s) + step * 32 * 128, off, rot_bits, odd);
        uint64_t dlo = desc_sw128(xlo_s(s) + 32 * step, 16, 1024);
        uint64_t dhi = desc_sw128(xhi_s(s) + 32 * step, 16, 1024);
        // every input of the products is in its register before the fence
        pin(ab);
        pin_u64(dlo);
        pin_u64(dhi);
        wg_fence();
        wgmma_rs_s8(acc, ab, dlo);
        wgmma_rs_s8(acc, ab + 4, dhi);
        wg_commit();
      }
    }
    wg_wait<0>();
    pin(acc);
    pin(a[0]);
    pin(a[1]);

    // epilogue: both consumers' products are done, so the ring is free
    // for the transposed tile, [BM rows][BN channels] of T, each row
    // padded by 16 bytes (conflict-free pair stores)
    constexpr int ROW_BYTES = BN * (int)sizeof(T) + 16;
    named_sync(BAR_EPILOGUE, 256);
    const int pc = 64 * cw + 16 * warp + 4 * (g >> 1) + 2 * odd;
    const float ws0 = n0 + pc < out ? w_scale[n0 + pc] : 0.f;
    const float ws1 = n0 + pc + 1 < out ? w_scale[n0 + pc + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < BM / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = 8 * i + 2 * t4 + e;
        const float as = m0 + row < rows ? __ldg(a_scale + m0 + row) : 0.f;
        Out<T>::store2(base_ptr + row * ROW_BYTES + pc * (int)sizeof(T),
                       epilogue(acc[4 * i + e], as, ws0),
                       epilogue(acc[4 * i + 2 + e], as, ws1));
      }
    }
    named_sync(BAR_EPILOGUE, 256);
    constexpr int CHUNKS = BN * (int)sizeof(T) / 16;  // per tile row
    constexpr int PER_CHUNK = 16 / (int)sizeof(T);    // channels
    for (int idx = ltid; idx < BM * CHUNKS; idx += 256) {
      const int row = idx / CHUNKS, ch = idx % CHUNKS;
      const int m = m0 + row, n = n0 + ch * PER_CHUNK;
      if (m < rows && n < out)
        *reinterpret_cast<int4*>(y + (size_t)m * out + n) =
            *reinterpret_cast<const int4*>(base_ptr + row * ROW_BYTES +
                                           ch * 16);
    }
  }
}

}  // namespace

// geom: 3 x GEOM_2D int64 (xq's low plane, its high plane, packed), each
// the byte offset of the map's base, dims (inner, outer), the outer byte
// stride and the box, as kernels.w4a8_sm90_geometry computes them
extern "C" int vls_w4a8_sm90(const void* xq, const void* a_scale,
                             const void* packed, const void* w_scale,
                             void* y, const long long* geom, int rows,
                             int half, int out, int out_f32, void* stream) {
  if (rows <= 0 || out <= 0) return 0;
  const long long* glo = geom;
  const long long* ghi = geom + GEOM_2D;
  const long long* gw = geom + 2 * GEOM_2D;
  if (half <= 0 || half % 16 || out % 16 || glo[0] != 0 || ghi[0] != half ||
      glo[1] != half || ghi[1] != half || glo[2] != rows ||
      ghi[2] != rows || gw[0] != 0 || gw[1] != out || gw[2] != half)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tlo, thi, tw;
  constexpr CUtensorMapDataType I8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  int e = encode_2d(&tlo, xq, glo, BK, BM, I8);
  if (e == 0) e = encode_2d(&thi, xq, ghi, BK, BM, I8);
  if (e == 0) e = encode_2d(&tw, packed, gw, BN, BK, I8);
  if (e != 0) return e;
  const float* as = (const float*)a_scale;
  const float* ws = (const float*)w_scale;
  const long long blocks =
      (long long)((rows + BM - 1) / BM) * ((out + BN - 1) / BN);
  const cudaStream_t st = (cudaStream_t)stream;
  if (out_f32) {
    auto kern = w4a8_sm90_kernel<float>;
    const cudaError_t r = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (r != cudaSuccess) return (int)r;
    kern<<<(unsigned)blocks, NT, SMEM_BYTES, st>>>(tlo, thi, tw, as, ws,
                                                   (float*)y, rows, half,
                                                   out);
  } else {
    auto kern = w4a8_sm90_kernel<__nv_bfloat16>;
    const cudaError_t r = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (r != cudaSuccess) return (int)r;
    kern<<<(unsigned)blocks, NT, SMEM_BYTES, st>>>(
        tlo, thi, tw, as, ws, (__nv_bfloat16*)y, rows, half, out);
  }
  return (int)cudaGetLastError();
}
