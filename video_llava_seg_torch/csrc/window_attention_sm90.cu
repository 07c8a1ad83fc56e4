// Windowed multi-head attention for Hopper (sm_90a) at head dims 56, 72
// and 96, read straight from the fused-qkv map by TMA: a persistent grid,
// one thread of a producer warpgroup keeping q / k / v boxes in flight
// under mbarriers, two consumer warpgroups with both products on wgmma
// and the softmax in registers.
//
//   o[b, y, x, h] = sum_j softmax_j(scale q_i . k_j) v_j
//
// over the ws x ws window of qkv [B, Hp, Wp, 3C] (last axis [q | k | v],
// heads major inside each, head h = columns h*D .. h*D + D - 1) that
// holds query i. With ps = 2 the queries are the 2x2 max pools of q
// inside the window and the output is the pooled map. The same function
// as window_attention.cu and ops/window_attention.py::window_attention_plain:
// a softmax over the whole window, fp32 sums, bf16 out. Up to 208 keys it
// is exact in one pass (row max, exp, divide by the row sum, P rounded to
// bf16 before P V, as the plain version); at 256 keys (Hiera-L's ws 16)
// it runs online over two halves of 128 keys: the running row max and
// sum, O rescaled once between them, P unnormalized (<= 1) rounded to
// bf16, O divided by the row sum at the end. The output is [B, oh, ow, C] with
// oh <= Hp / ps, ow <= Wp / ps: rows and columns past the crop are not
// written (K4 crops the maps it padded for ws 14 / 7).
//
// Replaces video_llava_seg_tpu/ops/window_attention.py::_win_kernel (K7)
// at head dims 96 (every windowed block of SAM2.1-hiera-tiny / small), 56
// (hiera-base-plus) and 72 (hiera-large), as the per-op trunk's K7 and as
// the attention of K4's chain (ops/hiera_block.py), where it takes the
// place of the window partition copy, pool.cu on q, attention_sm90.cu and
// the unpartition / crop copies. window_attention.cu keeps the other head
// dims and every plan this file does not take (kernels.window_entry).
//
// Bound on the card: bytes. A window's products are 4 * nq * nk * D per
// head (at most 256 x 256), far under the tensor cores' rate; qkv is read
// once and the output written once. The design:
//
// - A work unit is (image, window row, strip, head), the head fastest. A
//   strip is sw = nw * ws pixels of one window row: nw adjacent windows
//   (nw > 1 where a window's queries would leave a 64-row tile mostly
//   empty: ws 4 packs 4 windows; the pooled ws 8 and ws 4 pack 2 and 8).
//   Its keys are ONE TMA box (cols, 1, sw, ws, 1) of a 5-D tensor map over
//   qkv (dims cols, 3 * heads, Wp, Hp, B: the head's columns innermost,
//   then q / k / v head): key y * sw + x lands in shared-memory row
//   y * sw + x, for k and for v. No partitioned copy exists anywhere.
// - A head's D columns are two boxes from two such maps: a leading box of
//   W0 = 64 columns (32 at D = 56) and a tail box of the T = D - W0
//   columns left, TB = 32, 16 or 32 wide (D 96, 72, 56), under the 128-,
//   64- or 32-byte swizzle of its width, so that every box holds whole
//   k16 steps. The tail map's innermost extent is T: its box's TB - T
//   columns past the head lie outside the map, and TMA writes zeros
//   there. Only the head's own columns ever land: the next head's q / k /
//   v (which may hold inf or NaN) never reach S, and the zero columns add
//   exactly nothing to q . k. P V runs at N = W0 + TB; the O columns past
//   T are zeros and are not stored. (96 = 64 + 32 has no zero columns.)
// - Queries come as boxes (cols, 1, sw, qh, 1) of at most 64 rows: qh =
//   ws for ws 4 / 7 / 8 (one box, one query tile), qh = 4 for ws 14 / 16
//   (four boxes of 56 / 64 rows at window rows 0, 4, 8, 12, each a query
//   tile of one unit; rows past the window are computed and not stored).
//   With the q pool, the consumer takes the 2x2 max of each staged box
//   into its own 64-row pooled tile in the same swizzled layout
//   (fence.proxy.async, then wgmma reads it): no pooled map is written.
// - Rings: up to MAX_KV slots of a unit's K and V (one K and one V full
//   barrier, one empty barrier each) and MAX_Q stages of query boxes, as
//   many as shared memory holds, half of each q ring for each consumer.
//   The producer thread walks the block's units in order. Where a unit
//   has one query tile, consumer cw takes every other unit from its own
//   half of the KV ring too. (Halves, not one shared ring: a consumer
//   taking alternate items of a shared ring can wait on a stage's next
//   phase before its current one has completed, and an mbarrier's parity
//   cannot tell the two apart.) Where a unit has several (ws 14 / 16
//   without the pool: 4), both consumers take every unit, tiles cw,
//   cw + 2, .., from a shared KV ring of two slots: the next unit's K and
//   V load under this unit's products (faster on an H100 than a slot a
//   consumer with all four tiles on one: PERF.md).
// - Registers: 384 threads give the kernel 168 a thread; the producer
//   warpgroup hands all but 40 to the consumers (setmaxnreg 232), where
//   the 208-key tile's S (104 a thread), P (52) and O (48) live. Without
//   the hand-over (or with one producer warp, 288 threads, which ptxas
//   also held to 168) the 208-key instances spilled. At 256 keys all of
//   S (128), P (64) and O (40) would not fit: the one-pass form spilled
//   (ptxas: 28 bytes, 296 with the q pool), so that tile takes two
//   halves of 128 keys, S 64 and P 32 registers at a time, with one
//   rescale of O. (The exact two-pass form would also fit, but computes
//   Q K^T twice.)
// - Keys are padded to NKP (64, 128, 208 or 256 rows: all of a window's
//   keys in one box, up to 208 in the accumulator at once). Rows past
//   the box are zeroed once at the start and never written by TMA; their
//   scores are masked to -inf so their P is exactly 0 against zero V
//   rows. Packed windows are kept apart by a block-diagonal mask (key
//   window (col & (sw - 1)) >> log2 ws against the query's): off-window
//   P is exactly 0.
// - S = Q K^T: (W0 + TB) / 16 k16 steps of wgmma m64n64k16 per 64 keys
//   (plus one m64n16k16 at 208; at 256 a half's two 64-key chunks at a
//   time), both operands K-major in shared memory.
//   P goes from the accumulator to bf16 A fragments in registers, O += P V
//   is wgmma m64n{W0}k16 over V's leading box and m64n{TB}k16 over its
//   tail box, V MN-major through the transpose bit. O goes to the map
//   from registers.
//
// Key tiles by head dim: 64 and 208 (128 and 208 with the pool) at 96 and
// 56, 64 and 256 (128 and 256) at 72, where Hiera-L's ws 16 has 256 keys.
// At 96 two 256-key slots and the pooled tiles do not fit in shared
// memory beside the q ring.
//
// Later work: O through shared memory and a TMA store; the pooled ws 14 /
// 16 (one q stage a consumer: its four boxes load one after the other);
// head dims 64 / 80 / 128.

#include "sm90.cuh"

namespace {

constexpr int BQ = 64;          // rows of a query tile (one wgmma M)
constexpr int NT = 384;         // producer warpgroup + two consumers
constexpr int MAX_KV = 6;
constexpr int MAX_Q = 6;
constexpr uint32_t BAR_BYTES = (3 * MAX_KV + 2 * MAX_Q) * 8;
constexpr int SMEM_MAX = 232448;           // 227 KB a block
// one 5-D map: byte offset of its first column, dims, byte strides of
// dims 1..4, box
constexpr int GEOM5 = 15;
// key tiles up to this hold all of S at once (an exact one-pass
// softmax); the 256-key tile takes two online halves
constexpr int MAX_EXACT = 208;

constexpr uint32_t align1k(uint32_t x) { return (x + 1023u) & ~1023u; }

// the two boxes of a head of D columns: W0 leading columns, then the T
// left in a box TB wide (TB - T zero columns from TMA's fill)
template <int D>
struct Head {
  static constexpr int W0 = D >= 64 ? 64 : 32;
  static constexpr int T = D - W0;
  static constexpr int TB = T <= 16 ? 16 : T <= 32 ? 32 : 64;
  static constexpr int KSTEPS = (W0 + TB) / 16;        // k16 steps of Q K^T
  static constexpr uint32_t Q_BOX1 = BQ * W0 * 2;      // a q stage's tail box
  static constexpr uint32_t Q_STAGE = BQ * (W0 + TB) * 2;
  static_assert(D % 8 == 0 && T > 0 && T <= TB && TB <= 64, "head dim");
  static_assert(Q_BOX1 % 1024 == 0 && Q_STAGE % 1024 == 0, "alignment");
};

// a KV slot: K's two boxes, then V's, NKP rows each, each box on a
// 1024-byte boundary
template <int D, int NKP>
struct Slot {
  using H = Head<D>;
  static constexpr uint32_t B0 = align1k(NKP * H::W0 * 2);
  static constexpr uint32_t B1 = align1k(NKP * H::TB * 2);
  static constexpr uint32_t K1 = B0;
  static constexpr uint32_t V0 = B0 + B1;
  static constexpr uint32_t V1 = V0 + B0;
  static constexpr uint32_t BYTES = 2 * (B0 + B1);
  static constexpr int NC = NKP / 64;     // m64n64 chunks of S
  static constexpr int REM = NKP % 64;    // a last m64n16 chunk (or 0)
  static_assert(NKP % 16 == 0 && (REM == 0 || REM == 16), "key tile");
};

struct Params {
  __nv_bfloat16* o;
  int c, heads, ws, sw, qh, nqb, oh, ow;
  int nk;              // keys of a strip: sw * ws
  int n_strips, n_wr, units;
  int n_kv, n_q;       // ring depths, each even: half a consumer
  int split;           // both consumers share each unit (several tiles)
  int packed, wsl;     // several windows a strip; log2 ws
  float sc;            // scale * log2(e)
};

__device__ __forceinline__ uint4 lds128(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(a));
  return v;
}

__device__ __forceinline__ void sts128(uint32_t a, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};"
               :: "r"(a), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ uint32_t max2(uint32_t a, uint32_t b) {
  __nv_bfloat162 x = *reinterpret_cast<__nv_bfloat162*>(&a);
  const __nv_bfloat162 y = *reinterpret_cast<__nv_bfloat162*>(&b);
  x = __hmax2(x, y);
  return *reinterpret_cast<uint32_t*>(&x);
}

__device__ __forceinline__ uint4 max8(uint4 a, uint4 b) {
  return make_uint4(max2(a.x, b.x), max2(a.y, b.y), max2(a.z, b.z),
                    max2(a.w, b.w));
}

// byte offset of 16-byte chunk ch of row r in a box of W-column rows
// (2W bytes) under the swizzle of that width, box on a 1024-byte
// boundary: the chunk index is XORed with the address bits 7.. above it
// (128-byte rows: r % 8; 64-byte: r / 2 % 4; 32-byte: r / 4 % 2)
template <int W>
__device__ __forceinline__ uint32_t swz(int r, int ch) {
  constexpr int RB = 2 * W;
  return r * RB + ((ch ^ ((r * RB >> 7) & (RB / 16 - 1))) << 4);
}

// K-major descriptor of k16 step kk (columns [16 kk, 16 kk + 16)) of the
// rows row0.. of an operand held as a leading box at a0 and a tail box
// at a1
template <int D>
__device__ __forceinline__ uint64_t kdesc(uint32_t a0, uint32_t a1, int row0,
                                          int kk) {
  using H = Head<D>;
  const int col = 16 * kk;
  if (col < H::W0)
    return desc_cols<H::W0>(a0 + row0 * 2 * H::W0 + col * 2, 16, 16 * H::W0);
  return desc_cols<H::TB>(a1 + row0 * 2 * H::TB + (col - H::W0) * 2, 16,
                          16 * H::TB);
}

// d (+)= A B, m64n16k16, both K-major in shared memory
__device__ __forceinline__ void wgmma_ss16(float (&d)[8], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %10, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}"
      : VLS_ACC8(d, 0)
      : "l"(da), "l"(db), "r"(1));
}

// scale one accumulator chunk of S (2N columns from col0, this thread's
// column pairs at col0 + 8i + {0, 1}) into log2 units, mask keys past nk
// (pad) and, in packed strips, keys of other windows than the row's
// (qw0 / qw1; a key's window is (col & swm) >> wsl), and fold in the row
// maxima
template <int N>
__device__ __forceinline__ void scale_mask(float (&a)[N], int col0, float sc,
                                           int nk, bool pad, bool packed,
                                           int swm, int wsl, int qw0, int qw1,
                                           float& mx0, float& mx1) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = col0 + 8 * i + e;
      float v0 = a[4 * i + e] * sc, v1 = a[4 * i + 2 + e] * sc;
      if (pad && col >= nk) v0 = v1 = -INFINITY;
      if (packed) {
        const int kw = (col & swm) >> wsl;
        if (kw != qw0) v0 = -INFINITY;
        if (kw != qw1) v1 = -INFINITY;
      }
      a[4 * i + e] = v0;
      a[4 * i + 2 + e] = v1;
      mx0 = fmaxf(mx0, v0);
      mx1 = fmaxf(mx1, v1);
    }
}

template <int N>
__device__ __forceinline__ void exp_sum(float (&a)[N], float mu0, float mu1,
                                        float& l0, float& l1) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      a[4 * i + e] = ex2(a[4 * i + e] - mu0);
      a[4 * i + 2 + e] = ex2(a[4 * i + 2 + e] - mu1);
      l0 += a[4 * i + e];
      l1 += a[4 * i + 2 + e];
    }
}

// the bf16 A fragments of k16 steps kk0.. from one accumulator chunk,
// each row divided by its sum
template <int N>
__device__ __forceinline__ void pack_p(uint32_t* pa, const float (&a)[N],
                                       float inv0, float inv1) {
#pragma unroll
  for (int m = 0; m < N / 8; ++m) {
    pa[4 * m] = pack_bf16(a[8 * m] * inv0, a[8 * m + 1] * inv0);
    pa[4 * m + 1] = pack_bf16(a[8 * m + 2] * inv1, a[8 * m + 3] * inv1);
    pa[4 * m + 2] = pack_bf16(a[8 * m + 4] * inv0, a[8 * m + 5] * inv0);
    pa[4 * m + 3] = pack_bf16(a[8 * m + 6] * inv1, a[8 * m + 7] * inv1);
  }
}

// multiply the rows r0 / r0 + 8 of an accumulator by f0 / f1
template <int N>
__device__ __forceinline__ void scale_rows(float (&o)[N], float f0,
                                           float f1) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    o[4 * i] *= f0;
    o[4 * i + 1] *= f0;
    o[4 * i + 2] *= f1;
    o[4 * i + 3] *= f1;
  }
}

// one output row: the W0 + T columns of O this thread holds (E = 0 for
// its row r0, 2 for r0 + 8) as bf16 pairs; the tail box's columns past T
// are not stored
template <int D, int E>
__device__ __forceinline__ void store_row(__nv_bfloat16* row,
                                          const float (&o0)[Head<D>::W0 / 2],
                                          const float (&o1)[Head<D>::TB / 2]) {
  using H = Head<D>;
#pragma unroll
  for (int i = 0; i < H::W0 / 8; ++i)
    *reinterpret_cast<__nv_bfloat162*>(row + 8 * i) =
        __floats2bfloat162_rn(o0[4 * i + E], o0[4 * i + E + 1]);
#pragma unroll
  for (int i = 0; i < H::T / 8; ++i)
    *reinterpret_cast<__nv_bfloat162*>(row + H::W0 + 8 * i) =
        __floats2bfloat162_rn(o1[4 * i + E], o1[4 * i + E + 1]);
}

// the four 5-D maps: tm.kv0 / tm.kv1, boxes (W0 | TB, 1, sw, ws, 1) for k
// and v; tm.q0 / tm.q1, boxes (W0 | TB, 1, sw, qh, 1) for q
struct Maps {
  CUtensorMap kv0, kv1, q0, q1;
};

template <int D, int NKP, bool POOL>
__global__ void __launch_bounds__(NT, 1)
    window_attention_sm90_kernel(const __grid_constant__ Maps tm,
                                 const Params p) {
  using H = Head<D>;
  using S = Slot<D, NKP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_off = base + p.n_kv * S::BYTES;
  const uint32_t pool_off = q_off + p.n_q * H::Q_STAGE;
  const uint32_t bars = pool_off + (POOL ? 2 * H::Q_STAGE : 0);
  auto slot = [&](int s) { return base + s * S::BYTES; };
  auto q_s = [&](int i) { return q_off + i * H::Q_STAGE; };
  auto k_full = [&](int s) { return bars + 8u * s; };
  auto v_full = [&](int s) { return bars + 8u * (MAX_KV + s); };
  auto kv_empty = [&](int s) { return bars + 8u * (2 * MAX_KV + s); };
  auto q_full = [&](int i) { return bars + 8u * (3 * MAX_KV + i); };
  auto q_empty = [&](int i) {
    return bars + 8u * (3 * MAX_KV + MAX_Q + i);
  };

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  // both consumers share each unit: only where a unit has several query
  // tiles (no pool); the pooled instances compile it away
  const bool split = !POOL && p.split;

  // zero every tile once: rows that no box reaches (pad keys, query rows
  // past a box, pooled rows past the windows) stay zero
  for (uint32_t a = base + 16u * tid; a < bars; a += 16u * NT)
    sts128(a, make_uint4(0u, 0u, 0u, 0u));
  if (tid == 0) {
    for (int s = 0; s < p.n_kv; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(kv_empty(s), split ? 8 : 4);
    }
    for (int i = 0; i < p.n_q; ++i) {
      mbar_init(q_full(i), 1);
      mbar_init(q_empty(i), 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the zeros land before any TMA write to the same tiles
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  // the bytes a box pair lands, the tail box's zero fill included
  const uint32_t kv_bytes = p.sw * p.ws * (H::W0 + H::TB) * 2;
  const uint32_t q_bytes = p.sw * p.qh * (H::W0 + H::TB) * 2;

  if (wg == 0) {
    // ---------------- producer ----------------
    // 40 registers here, 232 in the consumers (setmaxnreg): at 384
    // threads ptxas gives the kernel 168, and without the hand-over the
    // 208-key instances spill
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == 0) {
      int k = 0;
      for (int u = blockIdx.x; u < p.units; u += gridDim.x, ++k) {
        const int h = u % p.heads;
        int t = u / p.heads;
        const int x0 = (t % p.n_strips) * p.sw;
        t /= p.n_strips;
        const int y0 = (t % p.n_wr) * p.ws;
        const int b = t / p.n_wr;
        // the unit's slot (split: the shared ring; else its consumer's
        // half, in that consumer's own count kk)
        const int cw = k & 1, kk = k >> 1;
        const int kv_half = p.n_kv / 2, q_half = p.n_q / 2;
        const int s = split ? k % p.n_kv : cw * kv_half + kk % kv_half;
        const int kph = split ? (k / p.n_kv) & 1 : (kk / kv_half) & 1;
        mbar_wait(kv_empty(s), kph ^ 1);
        mbar_expect_tx(k_full(s), kv_bytes);
        tma_load_5d(slot(s), &tm.kv0, k_full(s), 0, p.heads + h, x0, y0, b);
        tma_load_5d(slot(s) + S::K1, &tm.kv1, k_full(s), 0, p.heads + h, x0,
                    y0, b);
        mbar_expect_tx(v_full(s), kv_bytes);
        tma_load_5d(slot(s) + S::V0, &tm.kv0, v_full(s), 0, 2 * p.heads + h,
                    x0, y0, b);
        tma_load_5d(slot(s) + S::V1, &tm.kv1, v_full(s), 0, 2 * p.heads + h,
                    x0, y0, b);
        for (int j = 0; j < p.nqb; ++j) {
          // box j into the half of the consumer that takes it (split: tile
          // j goes to consumer j % 2), at its count of boxes qi
          int c = cw, qi = kk * p.nqb + j;
          if (split) {
            c = j & 1;
            qi = k * ((p.nqb + 1 - c) / 2) + j / 2;
          }
          const int qs = c * q_half + qi % q_half;
          mbar_wait(q_empty(qs), ((qi / q_half) & 1) ^ 1);
          mbar_expect_tx(q_full(qs), q_bytes);
          tma_load_5d(q_s(qs), &tm.q0, q_full(qs), 0, h, x0, y0 + j * p.qh,
                      b);
          tma_load_5d(q_s(qs) + H::Q_BOX1, &tm.q1, q_full(qs), 0, h, x0,
                      y0 + j * p.qh, b);
        }
      }
    }
    return;
  }

  // ---------------- consumers ----------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int cw = wg - 1;
  const int ltid = tid - 128 * wg;
  const int warp = ltid / 32, lane = ltid % 32;
  // this thread's rows of the 64 (r0, r0 + 8) and the first of its column
  // pair in every 8-column block of an accumulator
  const int r0 = warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const uint32_t pooled = pool_off + cw * H::Q_STAGE;
  const bool pad = p.nk < NKP;
  const bool packed = p.packed;
  const int nk = p.nk, swm = p.sw - 1, wsl = p.wsl;
  const float sc = p.sc;
  const int pw = p.sw / 2;                  // pooled strip width
  const int ppb = (p.qh / 2) * pw;          // pooled rows of one q box
  // 16-byte chunks of a q row the pool reads: the leading box's, then the
  // tail box's T columns (its zero columns stay zero in the pooled tile)
  constexpr int C0 = H::W0 / 8, NCH = C0 + H::T / 8;
  auto wg_sync = [&] {
    asm volatile("bar.sync %0, 128;" :: "r"(1 + cw) : "memory");
  };

  const int kv_half = p.n_kv / 2, q_half = p.n_q / 2;
  int k = 0;
  for (int u = blockIdx.x; u < p.units; u += gridDim.x, ++k) {
    // every other unit, or with split every unit's tiles cw, cw + 2, ..
    if (!split && (k & 1) != cw) continue;
    const int kk = split ? k : k >> 1;  // this consumer's own unit count
    const int h = u % p.heads;
    int t = u / p.heads;
    const int st = t % p.n_strips;
    t /= p.n_strips;
    const int wr = t % p.n_wr;
    const int b = t / p.n_wr;
    const int s = split ? k % p.n_kv : cw * kv_half + kk % kv_half;
    const uint32_t ph = split ? (k / p.n_kv) & 1 : (kk / kv_half) & 1;
    const uint32_t k0 = slot(s), k1 = slot(s) + S::K1;
    const uint32_t v0 = slot(s) + S::V0, v1 = slot(s) + S::V1;
    const int n_tiles = POOL ? 1 : p.nqb;

    for (int tile = split ? cw : 0; tile < n_tiles;
         tile += split ? 2 : 1) {
      uint32_t a0, a1;  // the query tile's two boxes
      int qs = 0;
      if constexpr (POOL) {
        // the 2x2 max of each staged q box into the pooled tile: pooled
        // row j * ppb + py * pw + px of box j takes rows (2py + dy) * sw +
        // 2px + dx of the box
        wg_sync();  // every warp is done with the last unit's tile
        for (int j = 0; j < p.nqb; ++j) {
          const int qi = kk * p.nqb + j;
          qs = cw * q_half + qi % q_half;
          mbar_wait(q_full(qs), (qi / q_half) & 1);
          const uint32_t src = q_s(qs);
          for (int w = ltid; w < ppb * NCH; w += 128) {
            const int pr = w / NCH, ch = w % NCH;
            const int r = 2 * (pr / pw) * p.sw + 2 * (pr % pw);
            const int dst_r = j * ppb + pr;
            uint4 v;
            if (ch < C0) {
              v = max8(max8(lds128(src + swz<H::W0>(r, ch)),
                            lds128(src + swz<H::W0>(r + 1, ch))),
                       max8(lds128(src + swz<H::W0>(r + p.sw, ch)),
                            lds128(src + swz<H::W0>(r + p.sw + 1, ch))));
              sts128(pooled + swz<H::W0>(dst_r, ch), v);
            } else {
              const uint32_t s1 = src + H::Q_BOX1;
              const int c1 = ch - C0;
              v = max8(max8(lds128(s1 + swz<H::TB>(r, c1)),
                            lds128(s1 + swz<H::TB>(r + 1, c1))),
                       max8(lds128(s1 + swz<H::TB>(r + p.sw, c1)),
                            lds128(s1 + swz<H::TB>(r + p.sw + 1, c1))));
              sts128(pooled + H::Q_BOX1 + swz<H::TB>(dst_r, c1), v);
            }
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(q_empty(qs));
        }
        // the pooled tile's generic writes, then wgmma's async reads
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        wg_sync();
        a0 = pooled;
        a1 = pooled + H::Q_BOX1;
      } else {
        const int qi = split ? k * ((p.nqb + 1 - cw) / 2) + tile / 2
                               : kk * p.nqb + tile;
        qs = cw * q_half + qi % q_half;
        mbar_wait(q_full(qs), (qi / q_half) & 1);
        a0 = q_s(qs);
        a1 = q_s(qs) + H::Q_BOX1;
      }

      // the query windows of rows r0 and r0 + 8 (packed strips only)
      int qw0 = 0, qw1 = 0;
      if (packed) {
        if (POOL) {
          qw0 = (r0 % pw) >> (wsl - 1);
          qw1 = ((r0 + 8) % pw) >> (wsl - 1);
        } else {
          qw0 = (r0 & swm) >> wsl;
          qw1 = ((r0 + 8) & swm) >> wsl;
        }
      }
      float o0[H::W0 / 2], o1[H::TB / 2];
      if constexpr (NKP <= MAX_EXACT) {
        // S = Q K^T, all NKP keys
        float sa[S::NC][32];
        float sb[8];
        mbar_wait(k_full(s), ph);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < H::KSTEPS; ++kk) {
          const uint64_t da = kdesc<D>(a0, a1, 0, kk);
#pragma unroll
          for (int c = 0; c < S::NC; ++c) {
            if (kk == 0)
              wgmma_ss64_first(sa[c], da, kdesc<D>(k0, k1, 64 * c, kk));
            else wgmma_ss64(sa[c], da, kdesc<D>(k0, k1, 64 * c, kk));
          }
          if constexpr (S::REM != 0) {
            const uint64_t db = kdesc<D>(k0, k1, 64 * S::NC, kk);
            if (kk == 0) wgmma_ss_first(sb, da, db);
            else wgmma_ss16(sb, da, db);
          }
        }
        wg_commit();
        wg_wait<0>();
#pragma unroll
        for (int c = 0; c < S::NC; ++c) pin(sa[c]);
        if constexpr (S::REM != 0) pin(sb);
        if (!POOL && lane == 0) mbar_arrive(q_empty(qs));

        // the exact softmax of the whole row, in log2 units
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int c = 0; c < S::NC; ++c)
          scale_mask(sa[c], 64 * c + cq, sc, nk, pad, packed, swm, wsl, qw0,
                     qw1, mx0, mx1);
        if constexpr (S::REM != 0)
          scale_mask(sb, 64 * S::NC + cq, sc, nk, pad, packed, swm, wsl, qw0,
                     qw1, mx0, mx1);
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        // a row with no key (only past the windows) gets P = 0
        const float mu0 = mx0 == -INFINITY ? 0.f : mx0;
        const float mu1 = mx1 == -INFINITY ? 0.f : mx1;
        float l0 = 0.f, l1 = 0.f;
#pragma unroll
        for (int c = 0; c < S::NC; ++c) exp_sum(sa[c], mu0, mu1, l0, l1);
        if constexpr (S::REM != 0) exp_sum(sb, mu0, mu1, l0, l1);
        l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
        l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
        const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
        const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
        uint32_t pa[NKP / 4];
#pragma unroll
        for (int c = 0; c < S::NC; ++c) pack_p(pa + 16 * c, sa[c], inv0, inv1);
        if constexpr (S::REM != 0) pack_p(pa + 16 * S::NC, sb, inv0, inv1);

        // O = P V
#pragma unroll
        for (int i = 0; i < H::W0 / 2; ++i) o0[i] = 0.f;
#pragma unroll
        for (int i = 0; i < H::TB / 2; ++i) o1[i] = 0.f;
        mbar_wait(v_full(s), ph);
        pin(pa);
        pin(o0);
        pin(o1);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < NKP / 16; ++kk) {
          wgmma_rs(o0, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                   pa[4 * kk + 3],
                   desc_cols<H::W0>(v0 + kk * 16 * 2 * H::W0, S::B0,
                                    16 * H::W0));
          wgmma_rs(o1, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                   pa[4 * kk + 3],
                   desc_cols<H::TB>(v1 + kk * 16 * 2 * H::TB, S::B1,
                                    16 * H::TB));
        }
        wg_commit();
        wg_wait<0>();
        pin(o0);
        pin(o1);
        pin(pa);
      } else {
        // two halves of 128 keys, the softmax online: S of one half (64
        // registers a thread) at a time, O rescaled once; P unnormalized
        // (<= 1) in bf16, O divided by the row sums at the end
        constexpr int HC = S::NC / 2;         // m64n64 chunks a half
        float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
#pragma unroll
        for (int i = 0; i < H::W0 / 2; ++i) o0[i] = 0.f;
#pragma unroll
        for (int i = 0; i < H::TB / 2; ++i) o1[i] = 0.f;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float sa[HC][32];
          if (hf == 0) mbar_wait(k_full(s), ph);
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < H::KSTEPS; ++kk) {
            const uint64_t da = kdesc<D>(a0, a1, 0, kk);
#pragma unroll
            for (int c = 0; c < HC; ++c) {
              const uint64_t db = kdesc<D>(k0, k1, 64 * (HC * hf + c), kk);
              if (kk == 0) wgmma_ss64_first(sa[c], da, db);
              else wgmma_ss64(sa[c], da, db);
            }
          }
          wg_commit();
          wg_wait<0>();
#pragma unroll
          for (int c = 0; c < HC; ++c) pin(sa[c]);
          if (hf == 1 && !POOL && lane == 0) mbar_arrive(q_empty(qs));
          float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
          for (int c = 0; c < HC; ++c)
            scale_mask(sa[c], 64 * (HC * hf + c) + cq, sc, nk, pad, packed,
                       swm, wsl, qw0, qw1, mx0, mx1);
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
          mx0 = fmaxf(mx0, m0);
          mx1 = fmaxf(mx1, m1);
          // a row with no key yet keeps P = 0; the first half's scale
          // factor of the empty O and sums is 0
          const float mu0 = mx0 == -INFINITY ? 0.f : mx0;
          const float mu1 = mx1 == -INFINITY ? 0.f : mx1;
          const float al0 = ex2(m0 - mu0), al1 = ex2(m1 - mu1);
          m0 = mx0;
          m1 = mx1;
          l0 *= al0;
          l1 *= al1;
          scale_rows(o0, al0, al1);
          scale_rows(o1, al0, al1);
#pragma unroll
          for (int c = 0; c < HC; ++c) exp_sum(sa[c], mu0, mu1, l0, l1);
          uint32_t pa[NKP / 8];
#pragma unroll
          for (int c = 0; c < HC; ++c) pack_p(pa + 16 * c, sa[c], 1.f, 1.f);
          if (hf == 0) mbar_wait(v_full(s), ph);
          pin(pa);
          pin(o0);
          pin(o1);
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < NKP / 32; ++kk) {
            const int kr = NKP / 32 * hf + kk;  // k16 step of all the keys
            wgmma_rs(o0, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                     pa[4 * kk + 3],
                     desc_cols<H::W0>(v0 + kr * 16 * 2 * H::W0, S::B0,
                                      16 * H::W0));
            wgmma_rs(o1, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                     pa[4 * kk + 3],
                     desc_cols<H::TB>(v1 + kr * 16 * 2 * H::TB, S::B1,
                                      16 * H::TB));
          }
          wg_commit();
          wg_wait<0>();
          pin(o0);
          pin(o1);
          pin(pa);
        }
        l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
        l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
        const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
        const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
        scale_rows(o0, inv0, inv1);
        scale_rows(o1, inv0, inv1);
      }

      // rows r0 and r0 + 8 to the (pooled) map, inside the window and
      // the crop
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = r0 + 8 * half;
        int y, x;
        bool ok;
        if (POOL) {
          const int j = i / ppb, li = i % ppb;
          const int py = j * (p.qh / 2) + li / pw;
          ok = j < p.nqb && py < p.ws / 2;
          y = wr * (p.ws / 2) + py;
          x = st * pw + li % pw;
        } else {
          const int wy = tile * p.qh + i / p.sw;
          ok = i < p.sw * p.qh && wy < p.ws;
          y = wr * p.ws + wy;
          x = st * p.sw + i % p.sw;
        }
        if (ok && y < p.oh && x < p.ow) {
          __nv_bfloat16* row =
              p.o + (((long long)b * p.oh + y) * p.ow + x) * p.c + h * D + cq;
          if (half == 0) store_row<D, 0>(row, o0, o1);
          else store_row<D, 2>(row, o0, o1);
        }
      }
    }
    if (lane == 0) mbar_arrive(kv_empty(s));
  }
}

CUtensorMapSwizzle swizzle_of(int cols) {
  return cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
         : cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                      : CU_TENSOR_MAP_SWIZZLE_32B;
}

// Encode one 5-D bf16 map over qkv from its geometry g (GEOM5 int64:
// byte offset of the first column, dims (ext, 3 * heads, Wp, Hp, B), byte
// strides of dims 1..4, box) after checking the extent and box against
// what the instance was written for. A refused geometry returns the
// negated CUresult.
int encode_head_map(CUtensorMap* map, const void* qkv, const long long* g,
                    int ext, const int (&box)[5]) {
  if (g[0] < 0 || g[0] % 16 || g[1] != ext) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 5; ++i)
    if (g[10 + i] != box[i]) return (int)cudaErrorInvalidValue;
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[5] = {(cuuint64_t)g[1], (cuuint64_t)g[2],
                              (cuuint64_t)g[3], (cuuint64_t)g[4],
                              (cuuint64_t)g[5]};
  const cuuint64_t strides[4] = {(cuuint64_t)g[6], (cuuint64_t)g[7],
                                 (cuuint64_t)g[8], (cuuint64_t)g[9]};
  const cuuint32_t bx[5] = {(cuuint32_t)box[0], (cuuint32_t)box[1],
                            (cuuint32_t)box[2], (cuuint32_t)box[3],
                            (cuuint32_t)box[4]};
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode_bound([&] {
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5,
              (void*)((const char*)qkv + g[0]), dims, strides, bx, elem,
              CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(box[0]),
              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  });
  return r == CUDA_SUCCESS ? 0 : -(int)r;
}

// Encode the four maps (kv lead, kv tail, q lead, q tail) from geom, size
// the rings to the shared memory and launch instance <D, NKP, POOL>.
template <int D, int NKP, bool POOL>
int launch(const void* qkv, const long long* geom, Params p,
           cudaStream_t stream) {
  using H = Head<D>;
  using S = Slot<D, NKP>;
  Maps tm;
  CUtensorMap* maps[4] = {&tm.kv0, &tm.kv1, &tm.q0, &tm.q1};
  const int exts[4] = {H::W0, H::T, H::W0, H::T};
  const int boxes[4][5] = {{H::W0, 1, p.sw, p.ws, 1},
                           {H::TB, 1, p.sw, p.ws, 1},
                           {H::W0, 1, p.sw, p.qh, 1},
                           {H::TB, 1, p.sw, p.qh, 1}};
  for (int i = 0; i < 4; ++i) {
    const int e = encode_head_map(maps[i], qkv, geom + i * GEOM5, exts[i],
                                  boxes[i]);
    if (e != 0) return e;
  }
  // rings, each even (half a consumer): MAX_Q q stages where a unit
  // takes one box (as deep as the slots), 4 where it takes several; then
  // as many KV slots as fit, and fewer q stages where fewer than two
  // slots would
  const int q_stage = (int)H::Q_STAGE;
  const int fixed = 1024 + (int)BAR_BYTES + (POOL ? 2 * q_stage : 0);
  int n_q = p.nqb == 1 ? MAX_Q : 4, n_kv = 0;
  for (;; n_q -= 2) {
    n_kv = (SMEM_MAX - fixed - n_q * q_stage) / (int)S::BYTES / 2 * 2;
    if (n_kv >= 2 || n_q == 2) break;
  }
  if (n_kv > MAX_KV) n_kv = MAX_KV;
  if (n_kv < 2) return (int)cudaErrorInvalidValue;
  if (p.nqb == 1 && n_q > n_kv) n_q = n_kv;
  p.n_kv = n_kv;
  p.n_q = n_q;
  const int smem = fixed + n_q * q_stage + n_kv * (int)S::BYTES;
  auto kern = window_attention_sm90_kernel<D, NKP, POOL>;
  static bool smem_set = false;
  static int sm_count[64];
  if (!smem_set) {
    const cudaError_t a = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (a != cudaSuccess) return (int)a;
    smem_set = true;
  }
  int dev = 0;
  cudaError_t a = cudaGetDevice(&dev);
  if (a != cudaSuccess) return (int)a;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (sm_count[dev] == 0) {
    a = cudaDeviceGetAttribute(&sm_count[dev],
                               cudaDevAttrMultiProcessorCount, dev);
    if (a != cudaSuccess) return (int)a;
  }
  const int grid = p.units < sm_count[dev] ? p.units : sm_count[dev];
  kern<<<grid, NT, smem, stream>>>(tm, p);
  return (int)cudaGetLastError();
}

// the key tile of a strip of nk keys: 64 or 128 (the pool) where they
// fit, else the head dim's largest, MAXK
template <int D, int MAXK>
int dispatch(const void* qkv, const long long* geom, const Params& p,
             int ps, cudaStream_t st) {
  if (ps == 1) {
    if (p.nk <= 64) return launch<D, 64, false>(qkv, geom, p, st);
    if (p.nk <= MAXK) return launch<D, MAXK, false>(qkv, geom, p, st);
  } else {
    if (p.nk <= 128) return launch<D, 128, true>(qkv, geom, p, st);
    if (p.nk <= MAXK) return launch<D, MAXK, true>(qkv, geom, p, st);
  }
  return (int)cudaErrorInvalidValue;
}

bool pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

}  // namespace

// geom: 4 x 15 int64, the 5-D maps over qkv [B, Hp, Wp, 3C] (a head's
// columns from the box's first, then q / k / v head, Wp, Hp, B) of the
// leading and the tail box for k and v (boxes (W0 | TB, 1, sw, ws, 1))
// and for q ((W0 | TB, 1, sw, qh, 1)), as kernels.window_sm90_geometry
// computes them. The plan (sw, qh, nqb) is kernels.window_sm90_plan's:
// strips of sw = nw * ws pixels (nw > 1 only for power-of-two windows and
// strips), query boxes of qh window rows, nqb of them a unit (with ps = 2
// their pooled rows make one tile). o: [B, oh, ow, C]. Head dims 56, 72
// and 96, C / heads; strips of at most 256 keys at 72, 208 at the others.
extern "C" int vls_window_attention_sm90(const void* qkv, void* o,
                                         const long long* geom, int batch,
                                         int hp, int wp, int c, int heads,
                                         int ws, int ps, int sw, int qh,
                                         int nqb, int oh, int ow, float scale,
                                         void* stream) {
  if (batch <= 0 || oh <= 0 || ow <= 0) return 0;
  if (heads <= 0 || c % heads) return (int)cudaErrorInvalidValue;
  const int hd = c / heads;
  const long long* g = geom;
  if (g[2] != 3LL * heads || g[3] != wp || g[4] != hp || g[5] != batch ||
      g[6] != 2LL * hd)
    return (int)cudaErrorInvalidValue;
  if (ws <= 0 || hp % ws || wp % ws || (ps != 1 && ps != 2) || ws % ps ||
      sw <= 0 || sw % ws || sw > 256 || qh <= 0 || nqb <= 0 ||
      sw * qh > BQ || oh > hp / ps || ow > wp / ps)
    return (int)cudaErrorInvalidValue;
  const bool packed = sw > ws;
  if (packed && !(pow2(ws) && pow2(sw))) return (int)cudaErrorInvalidValue;
  if (ps == 2) {
    // the pooled rows of all boxes make one tile covering the window
    if (qh % 2 || nqb * (qh / 2) * (sw / 2) > BQ || nqb * qh < ws)
      return (int)cudaErrorInvalidValue;
  } else if (nqb * qh < ws || (packed && nqb != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.o = (__nv_bfloat16*)o;
  p.c = c; p.heads = heads; p.ws = ws; p.sw = sw; p.qh = qh; p.nqb = nqb;
  p.oh = oh; p.ow = ow;
  p.nk = sw * ws;
  p.n_strips = (wp + sw - 1) / sw;
  p.n_wr = hp / ws;
  const long long units = (long long)batch * p.n_wr * p.n_strips * heads;
  if (units > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.units = (int)units;
  p.n_kv = p.n_q = 0;
  p.split = ps == 1 && nqb > 1;
  p.packed = packed;
  p.wsl = 0;
  while ((1 << p.wsl) < ws) ++p.wsl;
  p.sc = scale * LOG2E;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 96: return dispatch<96, 208>(qkv, geom, p, ps, st);
    case 72: return dispatch<72, 256>(qkv, geom, p, ps, st);
    case 56: return dispatch<56, 208>(qkv, geom, p, ps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
