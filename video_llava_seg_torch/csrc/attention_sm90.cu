// Flash-attention forward for Hopper (sm_90a) at head dims 64, 80, 96,
// 128 and 256: TMA loads into swizzled shared tiles with mbarrier
// completion, both products on wgmma, the softmax state in registers.
//
//   o[b,h,i] = softmax_j(scale * q[b,h,i] . k[b,h//g,j] + bias[b,h,j]) v[b,h//g,j]
//
// The same function as the online form of attention.cu: bf16 in and out,
// fp32 softmax state; GQA (kv head = q head // group); causal masking
// with the diagonal at the sequence ends (key j visible to query i iff
// j <= i + Skv - Sq); keys at j >= kv_len masked; an optional fp32 bias
// read through a batch and a head stride (head dim 128 only): per key
// [B, Skv] with head stride 0 (the left-pad mask), or per head and key
// [B, Hq, Skv] (MPT's ALiBi as slope_h * j, the pad mask folded in); an
// optional sliding window (head dim 128 only; Mistral): key j visible to
// query i only if j > i + Skv - Sq - window; optionally the fp32
// logsumexp lse [B, Hq, Sq] (natural-log units) that the flash backward
// (attention_bwd_sm90.cu) reads.
// A row with no visible key writes O = 0 and lse = 0. Q, K and V are read
// through (batch, head, sequence) strides with a contiguous last dim, so
// fused-qkv column slices and transposed views need no copy; O is written
// through its strides into the [B, S, H, D] buffer the wrapper allocates.
//
// Replaces video_llava_seg_tpu/ops/attention.py::_flash_kernel (K2) and
// the attention inside ops/vit_block.py::_vit_kernel (K1),
// ::_vit_kernel_i8 (K8) and ops/hiera_block.py::_block_kernel (K4). Head
// dim 128: the Llama-3-8B, Mistral-7B and MPT-7B prefills and the train
// step's forward and recompute. Head dims 64 / 80: the CLIP-L / RADIO-H
// towers' attention link (577 keys); 96: every block of the
// SAM2.1-hiera-small trunk (16-196 keys a window, 4096 for a global
// block) and the per-op trunk's global blocks; 80 also Hiera-L's global blocks (head dim 72, zero-padded by
// their caller). Head dim 256: SAM2's memory attention (one head of 256;
// self-attention over a frame's 4096 tokens, cross-attention over the
// memory bank's up to 7 x 4096 + 64 keys), whatever the form, for no
// other kernel has that head dim. attention.cu keeps head dims 16 / 32,
// the bias below 128, fewer than kernels.FLASH_SM90_MIN_KEYS keys and
// the two-pass form (kernels.attention_entry).
//
// Bound on the card: at the 5.2k causal prefill the two products are
// 2 * 2 * Hq * D * (Sq * Skv / 2) operations, ~0.22 ms at the bf16 peak,
// against ~0.01 ms for the bytes of Q, K, V and O: compute-bound. The
// towers' links over 577 keys are bound by their bytes (0.045 / 0.056
// ms), the trunk's global block by its operations (0.21 ms), the memory
// attention's cross-attention over a full bank by its operations (4 x
// 4096 x 28,736 x 256 = 120.5 GFLOP, 0.122 ms at the bf16 peak). The
// design
// keeps the tensor cores fed and everything else off their path:
//
// - A block is 3 warpgroups (384 threads). Warpgroup 0 is the producer:
//   it gives up registers (setmaxnreg.dec) and one of its threads issues
//   every TMA load. Warpgroups 1 and 2 are consumers of 64 query rows
//   each (BQ = 128) and take the registers the producer gave up
//   (setmaxnreg.inc). One block per SM.
// - Work items are (128 query rows, head, batch row). At head dim 128 a
//   block takes one item (the causal prefill's longest first). Below it
//   the grid is persistent, one block an SM walking items: the K / V ring
//   and two Q buffers run on from item to item, so the next item's Q
//   and first tiles load while this one computes and stores. At 577 keys
//   an item is only 5 kv tiles, and a block per item left the prologue
//   (barrier init, Q load) and the epilogue exposed.
// - Shared memory: the Q tile(s) and a two-stage ring of K and V tiles
//   of 128 keys (64 at head dim 256: Q 64 KB and K / V 128 KB, one Q
//   buffer). A tile is cut into column boxes that each hold whole k16
//   steps under the swizzle of its width: 64 columns (one 128-byte
//   swizzle row; D 128 has two), then at D 80 / 96 a box of the 16 / 32
//   columns left under the 32- / 64-byte swizzle, each from its own
//   tensor map (one map has one box and one swizzle). On an H100 this
//   beat D / 16 boxes of 16 columns under the 32-byte swizzle from one
//   map once the grid was persistent. TMA zero-fills rows past the
//   sequence end.
// - mbarriers: a "full" barrier per tile takes the TMA transaction bytes,
//   an "empty" barrier per stage the consumers' release. K and V have
//   their own, so S = Q K^T starts while V is still in flight.
// - S = Q K^T is D / 16 steps of wgmma m64n128k16, both operands K-major
//   in shared memory, each step on the descriptor of the box that holds
//   its columns. O += P V has N = D: A = P from registers (the fp32 score
//   accumulator converts pairwise into the bf16 A fragment) and B = V
//   read MN-major through the transpose bit, one wgmma over the leading
//   boxes (the leading byte offset steps box to box) and one of N = 16 /
//   32 over the remainder box, each into its own part of O (at head dim
//   256 one m64n256k16 over the four boxes). D is never padded: the
//   tensor work is what D counts. S (64 registers a thread; 32 at 256),
//   P (32; 16) and O (D / 2) never leave registers.
// - Online softmax in registers: a row lives on a quad of lanes, so its
//   max takes two shuffles (its sum is reduced once, at the end); the O
//   rescale is a register multiply; only tiles that cross the causal
//   diagonal, kv_len or the window's lower bound are masked.
// - The window: an item's first kv tile is the one that holds the lowest
//   key its first query row sees, q0 + Skv - Sq - window + 1, so the
//   producer loads and the consumers walk only the tiles inside the
//   band: at Mistral's 4096 over a 5.2k prompt the work is sum_i
//   min(i + 1, 4096) keys, not sum_i (i + 1).
// - The schedule at head dims 80 / 96: tile t's S = Q K^T and tile t - 1's
//   P V are issued together and t's softmax runs while they are in
//   flight, and the two consumers take turns issuing (named barriers 1
//   and 2), so one's products run under the other's exponentials. At 64
//   and 128 a consumer issues S, waits, and issues P V after its softmax
//   (see PIPELINED for why).
//
// Masking and the per-key bias. Without a bias the scores are kept in
// log2 units (one multiply, then ex2). With a bias they stay in natural
// units, s = scale * q.k + bias, and are scaled by log2(e) only after the
// running max is subtracted: the mask value -0.7 * FLT_MAX of a left-pad
// key overflows to -inf if scaled first, and a query row that sees only
// such keys would get -inf - -inf = NaN. Kept finite, all of that row's
// scores are equal, it gets the mean of its visible V rows and its lse is
// the mask value, as attention.cu gives it. Keys masked by the causal
// diagonal, kv_len or the window are -inf and excluded. ALiBi's bias
// slope_h * j reaches ~0.84 x 5.2k = 4.4k at MPT's prompt, where fp32
// keeps the score to ~2.4e-4 absolute: far below the bf16 of P.
//
// Later work: at head dim 256 a split over the keys (one object's memory
// attention is 32 items of 128 query rows, a quarter of the SMs) and
// the overlapped schedule; the overlapped schedule at head dims 64 and
// 128 (ptxas serialized it at 64, and the second P spilled at 128),
// carrying it across items (an item at the towers' 577 keys is 5 kv tiles), a
// persistent grid at head dim 128, packing a GQA group into one block.
//
// The mbarrier, TMA and wgmma helpers and the tensor-map encoding live in
// sm90.cuh, shared with the backward (attention_bwd_sm90.cu).

#include "sm90.cuh"

namespace {

constexpr int BQ = 128;      // query rows per block, 64 per consumer
constexpr int STAGES = 2;
constexpr int NT = 384;      // producer + two consumer warpgroups
// barriers: per Q buffer (at most two, Tile::Q_BUFS) q full, q empty;
// per stage k full, v full, k empty, v empty
constexpr int N_BARS = 2 * 2 + 4 * STAGES;
constexpr int CONSUMER_WARPS = 8;

// The column boxes of a 128-row Q tile, or a BKV-row K or V tile, at
// head dim D: NB0 boxes
// of W0 = 64 columns (one 128-byte swizzle row), then where D is no
// multiple of 64 one box of the W1 = D - 64 NB0 columns left (16 or 32:
// one 32- or 64-byte swizzle row), each box its own 128 rows of shared
// memory under the swizzle of its width. Every box holds whole k16
// steps, and every box size is a multiple of 1024 bytes, so every box
// starts on its swizzle pattern.
constexpr int W0 = 64;

template <int D>
struct Tile {
  // keys a K / V tile: 128, and 64 at head dim 256, where a 128-key
  // tile's S (64 registers a thread) and P (32) beside O (128) would not
  // fit a consumer's 240; 64 keys take S 32 + P 16
  static constexpr int BKV = D == 256 ? 64 : 128;
  static constexpr int NB0 = D / W0;
  static constexpr int N0 = NB0 * W0;    // columns in the leading boxes
  static constexpr int W1 = D - N0;      // remainder box: 0, 16 or 32
  static constexpr uint32_t BOX0 = BKV * W0 * 2;   // a K / V box
  static constexpr uint32_t BOX1 = BKV * W1 * 2;
  static constexpr uint32_t R1 = NB0 * BOX0;  // the remainder box
  static constexpr uint32_t BYTES = BKV * D * 2;   // a K / V tile
  static constexpr uint32_t Q_BOX0 = BQ * W0 * 2;  // a Q box
  static constexpr uint32_t Q_BYTES = BQ * D * 2;  // a Q tile
  // below head dim 128 a block walks many items (a persistent grid) and
  // the next item's Q loads during this one; at 128 a block takes one
  // item (the LLM's causal prefill) with one Q buffer; at 256 the grid
  // is persistent with one Q buffer (two Q buffers and the ring would
  // need 256 KB)
  static constexpr bool PERSISTENT = D != 128;
  static constexpr int Q_BUFS = PERSISTENT && D != 256 ? 2 : 1;
  static constexpr uint32_t Q_OFF = 0;
  static constexpr uint32_t K_OFF = Q_OFF + Q_BUFS * Q_BYTES;
  static constexpr uint32_t V_OFF = K_OFF + STAGES * BYTES;
  static constexpr uint32_t BAR_OFF = V_OFF + STAGES * BYTES;
  // + 1024: the swizzled tiles start on a 1024-byte boundary
  static constexpr size_t SMEM = BAR_OFF + N_BARS * 8 + 1024;
  static_assert(D % 16 == 0, "head dim");
  static_assert(W1 == 0 || W1 == 16 || W1 == 32, "remainder box");
  static_assert(BYTES % 1024 == 0 && BOX0 % 1024 == 0 &&
                    Q_BOX0 % 1024 == 0, "box alignment");
  static_assert(SMEM <= 232448, "shared memory");
};

// K-major descriptor of k16 step kk (columns [16 kk, 16 kk + 16)) of rows
// row0.. of a tile of ROWS rows (BQ for Q, BKV for K) at `tile`: the box
// that holds the columns, the row's byte offset inside it (k steps
// inside a swizzle row advance the start address; the hardware swizzles
// the address it forms)
template <int D, int ROWS>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int row0,
                                                int kk) {
  using T = Tile<D>;
  constexpr uint32_t box0 = ROWS * W0 * 2;
  const int col = 16 * kk;
  if (col < T::N0)
    return desc_cols<W0>(tile + (col / W0) * box0 + row0 * 2 * W0 +
                             (col % W0) * 2,
                         16, 16 * W0);
  constexpr int W1 = T::W1 ? T::W1 : 16;
  return desc_cols<W1>(tile + T::NB0 * box0 + row0 * 2 * W1 +
                           (col - T::N0) * 2,
                       16, 16 * W1);
}

// One row's columns of an m64nN accumulator (N = 2 x its size), scaled
// by inv, as bf16 pairs at row[8i .. 8i + 1] for its 8-column blocks i:
// E = 0 for the thread's row r0, 2 for r0 + 8
template <int E, int N>
__device__ __forceinline__ void store_pairs(__nv_bfloat16* row,
                                            const float (&acc)[N],
                                            float inv) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i)
    *reinterpret_cast<__nv_bfloat162*>(row + 8 * i) =
        __floats2bfloat162_rn(acc[4 * i + E] * inv, acc[4 * i + E + 1] * inv);
}

struct Params {
  __nv_bfloat16* o;
  const float* bias;
  float* lse;
  long long o_sb, o_sh, o_ss;
  long long bias_sb, bias_sh;
  int batch, hq, hkv, sq, skv, kv_len;
  int window;  // 0: none
  float scale;
  int causal;
};

// One work item: a block of BQ query rows of one head and batch row,
// over kv tiles [t0, t0 + n_tiles). The last query block comes first:
// under a causal mask it walks the most kv tiles, so the longest items
// start earliest and the tail is short.
struct Item {
  int q0, h, b, hk, t0, n_tiles;
};

template <int BKV>
__device__ __forceinline__ Item item_of(int it, const Params& p) {
  const int nq = (p.sq + BQ - 1) / BQ;
  Item r;
  r.q0 = (nq - 1 - it % nq) * BQ;
  r.h = (it / nq) % p.hq;
  r.b = it / (nq * p.hq);
  r.hk = r.h / (p.hq / p.hkv);
  const int off = p.skv - p.sq;  // causal diagonal offset
  int kv_end = min(p.kv_len, p.skv);
  if (p.causal) kv_end = min(kv_end, r.q0 + BQ + off);
  // the tile of the lowest key the item's first row sees under the window
  r.t0 = p.window > 0 ? max(0, r.q0 + off - p.window + 1) / BKV : 0;
  r.n_tiles = kv_end > 0 ? max(0, (kv_end + BKV - 1) / BKV - r.t0) : 0;
  return r;
}

// tm_*: the maps of the leading boxes; tm_*1: of the remainder box (the
// same tensor, a box of W1 columns at column N0), unused where W1 = 0
template <int D, bool HAS_BIAS>
__global__ void __launch_bounds__(NT, 1)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_q1,
                   const __grid_constant__ CUtensorMap tm_k1,
                   const __grid_constant__ CUtensorMap tm_v1,
                   const Params p) {
  using T = Tile<D>;
  constexpr int BKV = T::BKV;
  // a thread's S (BKV / 2 fp32) and its P as bf16 pairs (BKV / 4)
  constexpr int SN = BKV / 2, PN = BKV / 4;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bars = base + T::BAR_OFF;
  auto q_s = [&](int i) { return base + T::Q_OFF + i * T::Q_BYTES; };
  auto k_s = [&](int s) { return base + T::K_OFF + s * T::BYTES; };
  auto v_s = [&](int s) { return base + T::V_OFF + s * T::BYTES; };
  auto q_full = [&](int i) { return bars + 8u * i; };
  auto q_empty = [&](int i) { return bars + 8u * (T::Q_BUFS + i); };
  constexpr int KV_BAR = 2 * T::Q_BUFS;
  auto k_full = [&](int s) { return bars + 8u * (KV_BAR + s); };
  auto v_full = [&](int s) { return bars + 8u * (KV_BAR + STAGES + s); };
  auto k_empty = [&](int s) {
    return bars + 8u * (KV_BAR + 2 * STAGES + s);
  };
  auto v_empty = [&](int s) {
    return bars + 8u * (KV_BAR + 3 * STAGES + s);
  };

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  // this block's items: it0, it0 + the grid's size, ... below it_end (one
  // item, which the compiler sees, where the grid is not persistent). The
  // stride is read where it is used: held across the producer's loop it
  // spilled at 24 registers.
  const int it0 = blockIdx.x;
  const int it_end =
      T::PERSISTENT ? (p.sq + BQ - 1) / BQ * p.hq * p.batch : it0 + 1;
  auto step = [] {
    uint32_t n = 1;
    if (T::PERSISTENT) asm volatile("mov.u32 %0, %%nctaid.x;" : "=r"(n));
    return (int)n;
  };
  const int off = p.skv - p.sq;  // causal diagonal offset
  const int kv_lim = min(p.kv_len, p.skv);

  if (tid == 0) {
    for (int i = 0; i < T::Q_BUFS; ++i) {
      mbar_init(q_full(i), 1);
      mbar_init(q_empty(i), CONSUMER_WARPS);
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), CONSUMER_WARPS);
      mbar_init(v_empty(s), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------- producer ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    // one tile: the leading boxes (box0 bytes each), then the remainder
    // box
    auto load_tile = [&](uint32_t dst, uint32_t box0, const CUtensorMap* m,
                         const CUtensorMap* m1, uint32_t bar, int row,
                         int head, int b) {
#pragma unroll
      for (int i = 0; i < T::NB0; ++i)
        tma_load(dst + i * box0, m, bar, i * W0, row, head, b);
      if constexpr (T::W1 != 0)
        tma_load(dst + T::NB0 * box0, m1, bar, T::N0, row, head, b);
    };
    if (tid == 0) {
      // g counts kv tiles and u items with tiles over all of this block's
      // items: the ring and the Q buffers run on from item to item, so
      // the next item's Q and first tiles load during this one
      int g = 0, u = 0;
      for (int it = it0; it < it_end; it += step()) {
        const Item w = item_of<BKV>(it, p);
        if (w.n_tiles == 0) continue;
        const int qb = u % T::Q_BUFS;
        mbar_wait(q_empty(qb), ((u / T::Q_BUFS) & 1) ^ 1);
        mbar_expect_tx(q_full(qb), T::Q_BYTES);
        load_tile(q_s(qb), T::Q_BOX0, &tm_q, &tm_q1, q_full(qb), w.q0, w.h,
                  w.b);
        ++u;
        for (int t = w.t0; t < w.t0 + w.n_tiles; ++t, ++g) {
          const int s = g % STAGES;
          const uint32_t ph = (g / STAGES) & 1;
          const int j0 = t * BKV;
          // the first pass over the ring finds every stage free
          mbar_wait(k_empty(s), ph ^ 1);
          mbar_expect_tx(k_full(s), T::BYTES);
          load_tile(k_s(s), T::BOX0, &tm_k, &tm_k1, k_full(s), j0, w.hk,
                    w.b);
          mbar_wait(v_empty(s), ph ^ 1);
          mbar_expect_tx(v_full(s), T::BYTES);
          load_tile(v_s(s), T::BOX0, &tm_v, &tm_v1, v_full(s), j0, w.hk,
                    w.b);
        }
      }
    }
  } else {
    // ---------------- consumers ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int cw = wg - 1;
    const int ltid = tid - 128 * wg;
    const int warp = ltid / 32, lane = ltid % 32;
    // this thread's rows of the warpgroup's 64 (r0 and r0 + 8) and the
    // first of its column pair in every 8-column block of the
    // accumulators: d[4i + e] is (r0, 8i + cq + e), d[4i + 2 + e] is
    // (r0 + 8, 8i + cq + e)
    const int r0 = warp * 16 + lane / 4;
    const int cq = 2 * (lane % 4);
    const float sc = HAS_BIAS ? p.scale : p.scale * LOG2E;
    const float f = HAS_BIAS ? LOG2E : 1.f;
    // At head dims 80 / 96 the products of one tile overlap the softmax of
    // the next (a second P holds the fragment in flight), and the
    // consumers take turns issuing products: consumer cw waits at named
    // barrier 1 + cw for the other's turn, and hands the turn over at
    // 2 - cw; consumer 1 hands consumer 0 the first turn. On an H100 that
    // took the trunk's global block from 0.46 to 0.42 ms; at 64 (one P V
    // accumulator) ptxas serialized the products (C7513) and the link ran
    // slower, and at 128 the second P spilled.
    constexpr bool PIPELINED = T::W1 != 0;
    auto pp_sync = [&] {
      asm volatile("bar.sync %0, 256;" :: "r"(1 + cw) : "memory");
    };
    auto pp_arrive = [&] {
      asm volatile("bar.arrive %0, 256;" :: "r"(2 - cw) : "memory");
    };
    if (PIPELINED && cw == 1) pp_arrive();
    int g = 0, u = 0;  // as the producer counts them
    for (int it = it0; it < it_end; it += step()) {
      const Item w = item_of<BKV>(it, p);
      const int n_tiles = w.n_tiles, h = w.h, b = w.b;
      const int jt0 = w.t0 * BKV;  // the first kv tile's first key
      const int qw0 = w.q0 + cw * 64;
      const int qi0 = qw0 + r0, qi1 = qi0 + 8;
      const float* bias =
          HAS_BIAS ? p.bias + b * p.bias_sb + h * p.bias_sh : nullptr;
      const int qb = u % T::Q_BUFS;
      // this item's Q buffer (the warpgroup's rows from cw * 64)
      const uint32_t q_buf = q_s(qb);

      // O in two accumulators: the leading boxes' N0 columns and the
      // remainder box's W1 (a one-element stand-in where W1 = 0)
      constexpr int NO0 = T::N0 / 2, NO1 = T::W1 ? T::W1 / 2 : 1;
      float o0[NO0], o1[NO1];
#pragma unroll
      for (int i = 0; i < NO0; ++i) o0[i] = 0.f;
#pragma unroll
      for (int i = 0; i < NO1; ++i) o1[i] = 0.f;
      // running max (log2 units, or natural with a bias) and this thread's
      // part of the row sum, for rows r0 and r0 + 8
      float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

      // S = Q K^T on stage s: D / 16 k-steps (m64nBKVk16), each on the
      // descriptor of the box that holds its columns
      auto issue_qk = [&](float (&sacc)[SN], int s) {
        wg_fence();
        wgmma_ss_first(sacc, kmajor_desc<D, BQ>(q_buf, cw * 64, 0),
                       kmajor_desc<D, BKV>(k_s(s), 0, 0));
#pragma unroll
        for (int kk = 1; kk < D / 16; ++kk)
          wgmma_ss(sacc, kmajor_desc<D, BQ>(q_buf, cw * 64, kk),
                   kmajor_desc<D, BKV>(k_s(s), 0, kk));
        wg_commit();
      };
      // O += P V on stage s: BKV / 16 k-steps of 16 keys; the A fragment
      // of keys [16kk, 16kk + 16) is pa[4kk .. 4kk + 3]. V is the MN-major
      // B operand: one wgmma of N = N0 over the leading boxes (the leading
      // offset steps box to box; N = 256 at head dim 256) and one of N =
      // W1 over the remainder box, each into its own accumulator
      auto issue_pv = [&](uint32_t (&pa)[PN], int s) {
        // P and O settle before the fence: an instruction that defines a
        // product's input registers inside its issue stage serializes
        // every wgmma (ptxas C7513)
        pin(pa);
        pin(o0);
        pin(o1);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) {
          wgmma_rs(o0, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                   pa[4 * kk + 3],
                   desc_cols<W0>(v_s(s) + kk * 16 * 2 * W0, T::BOX0, 16 * W0));
          if constexpr (T::W1 != 0)
            wgmma_rs(o1, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                     pa[4 * kk + 3],
                     desc_cols<T::W1>(v_s(s) + T::R1 + kk * 16 * 2 * T::W1,
                                      T::BOX1, 16 * T::W1));
        }
        wg_commit();
      };
      // O *= alpha, row by row
      auto rescale = [&](float alpha0, float alpha1) {
#pragma unroll
        for (int i = 0; i < NO0 / 4; ++i) {
          o0[4 * i] *= alpha0;
          o0[4 * i + 1] *= alpha0;
          o0[4 * i + 2] *= alpha1;
          o0[4 * i + 3] *= alpha1;
        }
        if constexpr (T::W1 != 0) {
#pragma unroll
          for (int i = 0; i < NO1 / 4; ++i) {
            o1[4 * i] *= alpha0;
            o1[4 * i + 1] *= alpha0;
            o1[4 * i + 2] *= alpha1;
            o1[4 * i + 3] *= alpha1;
          }
        }
      };
      // the online softmax of the scores of keys j0.. (bias bv where there
      // is one): scale, mask, the new running max, P into pa as the bf16 A
      // fragment, the row sums; alpha = exp(old max - new max), the factor
      // O takes before this tile's P V
      auto softmax = [&](float (&sacc)[SN], const float (&bv)[PN], int j0,
                         uint32_t (&pa)[PN], float& alpha0, float& alpha1) {
#pragma unroll
        for (int i = 0; i < BKV / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if constexpr (HAS_BIAS) {
              sacc[4 * i + e] = fmaf(sacc[4 * i + e], sc, bv[2 * i + e]);
              sacc[4 * i + 2 + e] =
                  fmaf(sacc[4 * i + 2 + e], sc, bv[2 * i + e]);
            } else {
              sacc[4 * i + e] *= sc;
              sacc[4 * i + 2 + e] *= sc;
            }
          }
        // only tiles that cross kv_len, this warpgroup's causal diagonal
        // or the window's lower bound of its last row
        if (j0 + BKV > kv_lim || (p.causal && j0 + BKV - 1 > qw0 + off) ||
            (p.window > 0 && j0 <= qw0 + 63 + off - p.window)) {
          // column c = 8i + e of this thread's pairs is key j0 + cq + c:
          // visible below kv_lim, under the causal mask up to the row's
          // diagonal, and under the window from the row's lower bound
          const int big = 1 << 30;
          const int lim = kv_lim - j0 - cq;
          const int d0 = min(lim - 1, p.causal ? qi0 + off - j0 - cq : big);
          const int d1 = min(lim - 1, p.causal ? qi1 + off - j0 - cq : big);
          const int w0 =
              p.window > 0 ? qi0 + off - p.window + 1 - j0 - cq : -big;
          const int w1 = w0 + 8;
#pragma unroll
          for (int i = 0; i < BKV / 8; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (8 * i + e > d0 || 8 * i + e < w0)
                sacc[4 * i + e] = -INFINITY;
              if (8 * i + e > d1 || 8 * i + e < w1)
                sacc[4 * i + 2 + e] = -INFINITY;
            }
        }

        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int i = 0; i < BKV / 8; ++i) {
          mx0 = fmaxf(mx0, fmaxf(sacc[4 * i], sacc[4 * i + 1]));
          mx1 = fmaxf(mx1, fmaxf(sacc[4 * i + 2], sacc[4 * i + 3]));
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        // a row with no visible key so far keeps p = 0 (exp of -inf - 0)
        const float mu0 = mx0 == -INFINITY ? 0.f : mx0;
        const float mu1 = mx1 == -INFINITY ? 0.f : mx1;
        alpha0 = ex2((m0 - mu0) * f);
        alpha1 = ex2((m1 - mu1) * f);
        m0 = mx0;
        m1 = mx1;
        float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
        for (int i = 0; i < BKV / 8; ++i) {
          const float p00 = ex2((sacc[4 * i] - mu0) * f);
          const float p01 = ex2((sacc[4 * i + 1] - mu0) * f);
          const float p10 = ex2((sacc[4 * i + 2] - mu1) * f);
          const float p11 = ex2((sacc[4 * i + 3] - mu1) * f);
          rs0 += p00 + p01;
          rs1 += p10 + p11;
          pa[2 * i] = pack_bf16(p00, p01);
          pa[2 * i + 1] = pack_bf16(p10, p11);
        }
        l0 = l0 * alpha0 + rs0;
        l1 = l1 * alpha1 + rs1;
      };

      if (n_tiles > 0) mbar_wait(q_full(qb), (u / T::Q_BUFS) & 1);
      if constexpr (!PIPELINED) {
        // one tile at a time: S, its softmax, then its P V
        for (int t = 0; t < n_tiles; ++t, ++g) {
          const int s = g % STAGES;
          const uint32_t ph = (g / STAGES) & 1;
          const int j0 = jt0 + t * BKV;
          float sacc[SN];
          mbar_wait(k_full(s), ph);
          issue_qk(sacc, s);
          float bv[PN];
          if constexpr (HAS_BIAS) {
            // this thread's 32 keys of the bias, fetched while S runs; one
            // base pointer per tile and immediate offsets, so no per-key
            // address stays live across the loop
            const float* bt = bias + j0 + cq;
            const int lim = p.skv - j0 - cq;
#pragma unroll
            for (int i = 0; i < BKV / 8; ++i)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                bv[2 * i + e] = 8 * i + e < lim ? __ldg(bt + 8 * i + e) : 0.f;
          }
          wg_wait<0>();
          pin(sacc);
          if (lane == 0) mbar_arrive(k_empty(s));
          uint32_t pa[PN];
          float alpha0, alpha1;
          softmax(sacc, bv, j0, pa, alpha0, alpha1);
          rescale(alpha0, alpha1);
          mbar_wait(v_full(s), ph);
          issue_pv(pa, s);
          wg_wait<0>();
          pin(o0);
          pin(o1);
          pin(pa);
          if (lane == 0) mbar_arrive(v_empty(s));
        }
      } else {
        // tile t's S = Q K^T and tile t - 1's P V are issued together, and
        // t's softmax runs while P V is in flight; the two consumers take
        // turns issuing (pp_sync / pp_arrive), so one's products run under
        // the other's softmax. Every fence and wait stands outside any
        // branch (ptxas serializes the products when one sits behind a
        // condition), so tile 0's S and the last P V are issued apart.
        if (n_tiles > 0) {
          uint32_t pa[PN];  // P of the tile whose P V is issued next
          const float bv[PN] = {};
          {
            const int s = g % STAGES;
            float sacc[SN], alpha0, alpha1;
            mbar_wait(k_full(s), (g / STAGES) & 1);
            pp_sync();
            issue_qk(sacc, s);
            pp_arrive();
            wg_wait<0>();
            pin(sacc);
            if (lane == 0) mbar_arrive(k_empty(s));
            softmax(sacc, bv, jt0, pa, alpha0, alpha1);
            ++g;
          }
          // tile t - 1 is at ring position g - 1: its stage and phase
          for (int t = 1; t < n_tiles; ++t, ++g) {
            const int s = g % STAGES, sp = (g - 1) % STAGES;
            float sacc[SN], alpha0, alpha1;
            mbar_wait(k_full(s), (g / STAGES) & 1);
            mbar_wait(v_full(sp), ((g - 1) / STAGES) & 1);
            pp_sync();
            issue_qk(sacc, s);
            issue_pv(pa, sp);
            pp_arrive();
            wg_wait<1>();
            pin(sacc);
            if (lane == 0) mbar_arrive(k_empty(s));
            uint32_t pn[PN];
            softmax(sacc, bv, jt0 + t * BKV, pn, alpha0, alpha1);
            wg_wait<0>();
            pin(o0);
            pin(o1);
            pin(pa);
            if (lane == 0) mbar_arrive(v_empty(sp));
            // O holds tiles ..t - 1 at the old max; tile t's P is at the new
            rescale(alpha0, alpha1);
#pragma unroll
            for (int i = 0; i < PN; ++i) pa[i] = pn[i];
          }
          const int sp = (g - 1) % STAGES;
          mbar_wait(v_full(sp), ((g - 1) / STAGES) & 1);
          pp_sync();
          issue_pv(pa, sp);
          pp_arrive();
          wg_wait<0>();
          pin(o0);
          pin(o1);
          pin(pa);
          if (lane == 0) mbar_arrive(v_empty(sp));
        }
      }
      if (n_tiles > 0) {
        // every product that read this item's Q has completed
        if (lane == 0) mbar_arrive(q_empty(qb));
        ++u;
      }

      // epilogue: the quad's row sums, O / l straight from registers
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
      const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
      __nv_bfloat16* og = p.o + b * p.o_sb + h * p.o_sh;
      if (qi0 < p.sq) {
        __nv_bfloat16* row = og + (long long)qi0 * p.o_ss + cq;
        store_pairs<0>(row, o0, inv0);
        if constexpr (T::W1 != 0) store_pairs<0>(row + T::N0, o1, inv0);
      }
      if (qi1 < p.sq) {
        __nv_bfloat16* row = og + (long long)qi1 * p.o_ss + cq;
        store_pairs<2>(row, o0, inv1);
        if constexpr (T::W1 != 0) store_pairs<2>(row + T::N0, o1, inv1);
      }
      if (p.lse && (lane & 3) == 0) {
        // natural-log units: the running max is in log2 units without a bias
        float* lrow = p.lse + ((long long)b * p.hq + h) * p.sq;
        if (qi0 < p.sq)
          lrow[qi0] = l0 > 0.f ? (HAS_BIAS ? m0 : m0 * LN2) + logf(l0) : 0.f;
        if (qi1 < p.sq)
          lrow[qi1] = l1 > 0.f ? (HAS_BIAS ? m1 : m1 * LN2) + logf(l1) : 0.f;
      }
    }
  }
}

CUtensorMapSwizzle swizzle_of(int cols) {
  return cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
         : cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                      : CU_TENSOR_MAP_SWIZZLE_32B;
}

// Encode the maps of instance <D, *> (the three leading-box maps from
// geom, the remainder maps from geom + 3 GEOM where D % 64) and launch it.
template <int D, bool HAS_BIAS>
int launch(const void* q, const void* k, const void* v, const long long* geom,
           const Params& p, cudaStream_t stream) {
  using T = Tile<D>;
  CUtensorMap tm[6];
  const void* ptr[3] = {q, k, v};
  // Q's boxes are BQ rows, K's and V's BKV
  const int rows[3] = {BQ, T::BKV, T::BKV};
  int e = 0;
  for (int i = 0; i < 3 && e == 0; ++i) {
    const int box0[4] = {W0, rows[i], 1, 1};
    e = encode_bf16_box(&tm[i], ptr[i], geom + i * GEOM, D, box0,
                        swizzle_of(W0));
  }
  if constexpr (T::W1 != 0) {
    for (int i = 0; i < 3 && e == 0; ++i) {
      const int box1[4] = {T::W1, rows[i], 1, 1};
      e = encode_bf16_box(&tm[3 + i], ptr[i], geom + (3 + i) * GEOM, D, box1,
                          swizzle_of(T::W1));
    }
  } else {
    for (int i = 0; i < 3; ++i) tm[3 + i] = tm[i];
  }
  if (e != 0) return e;
  auto kern = flash_fwd_sm90<D, HAS_BIAS>;
  // the shared-memory attribute is raised once per instance, the SM
  // count read once per device: K4's window calls last ~0.1 ms
  static bool smem_set = false;
  static int sm_count[64];
  if (!smem_set) {
    const cudaError_t a = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
    if (a != cudaSuccess) return (int)a;
    smem_set = true;
  }
  const long long items =
      (long long)((p.sq + BQ - 1) / BQ) * p.hq * p.batch;
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  long long grid = items;
  if (T::PERSISTENT) {
    // one block an SM
    int dev = 0;
    cudaError_t a = cudaGetDevice(&dev);
    if (a != cudaSuccess) return (int)a;
    if (dev >= 64) return (int)cudaErrorInvalidDevice;
    if (sm_count[dev] == 0) {
      a = cudaDeviceGetAttribute(&sm_count[dev],
                                 cudaDevAttrMultiProcessorCount, dev);
      if (a != cudaSuccess) return (int)a;
    }
    if (grid > sm_count[dev]) grid = sm_count[dev];
  }
  kern<<<(unsigned)grid, NT, T::SMEM, stream>>>(tm[0], tm[1], tm[2], tm[3],
                                                tm[4], tm[5], p);
  return (int)cudaGetLastError();
}

}  // namespace

// geom: 3 x 11 int64 (q, k, v), each dims[4], byte strides[3], box[4],
// the leading boxes' maps; where the head dim is no multiple of 64, 3 x
// 11 more for the remainder box's maps. The head dim (dims[0]) picks the
// instance; the encoding checks every box against it. bias_sb / bias_sh:
// the bias's batch and head strides in elements (bias_sh 0: one bias a
// key for every head). window: 0 for none; a window or a bias only at
// head dim 128.
extern "C" int vls_flash_fwd_sm90(
    const void* q, const void* k, const void* v, void* o, const void* bias,
    void* lse, const long long* geom, long long o_sb, long long o_sh,
    long long o_ss, long long bias_sb, long long bias_sh, int kv_len,
    int window, int causal, float scale, void* stream) {
  const long long* gq = geom;
  const long long* gk = geom + GEOM;
  const long long* gv = geom + 2 * GEOM;
  const int batch = (int)gq[3];
  if (batch <= 0 || gq[1] <= 0) return 0;
  for (int i = 0; i < 4; ++i)
    if (gk[i] != gv[i]) return (int)cudaErrorInvalidValue;
  if (gk[3] != batch || gk[2] <= 0 || gq[2] % gk[2])
    return (int)cudaErrorInvalidValue;
  Params p;
  p.o = (__nv_bfloat16*)o;
  p.bias = (const float*)bias;
  p.lse = (float*)lse;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.bias_sb = bias_sb;
  p.bias_sh = bias_sh;
  p.batch = batch;
  p.hq = (int)gq[2]; p.hkv = (int)gk[2];
  p.sq = (int)gq[1]; p.skv = (int)gk[1];
  p.kv_len = kv_len;
  p.window = window;
  p.scale = scale;
  p.causal = causal;
  const cudaStream_t st = (cudaStream_t)stream;
  const int d = (int)gq[0];
  if (window < 0 || (window > 0 && d != 128))
    return (int)cudaErrorInvalidValue;
  // the bias only at head dim 128 (the LLM's left-padded batch, ALiBi)
  if (bias) {
    if (d == 128) return launch<128, true>(q, k, v, geom, p, st);
    return (int)cudaErrorInvalidValue;
  }
  switch (d) {
    case 64: return launch<64, false>(q, k, v, geom, p, st);
    case 80: return launch<80, false>(q, k, v, geom, p, st);
    case 96: return launch<96, false>(q, k, v, geom, p, st);
    case 128: return launch<128, false>(q, k, v, geom, p, st);
    case 256: return launch<256, false>(q, k, v, geom, p, st);
  }
  return (int)cudaErrorInvalidValue;
}
