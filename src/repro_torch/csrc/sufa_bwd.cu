// SU-FA backward for Hopper (sm_90a): K3's gradient, for STAR in training.
//
// Replaces no TPU kernel: the Pallas SU-FA kernel
// (repro/kernels/sufa.py::sufa_attention) has no VJP, and the reference
// trains STAR by differentiating its XLA form (repro/core/sufa.py::
// sufa_gathered, or sufa_scan with use_scan) under jax.grad. The port's
// STAR prefill runs K3 (sufa.cu), so a trainer on the card needs K3's
// gradient. It is the gradient of the masked softmax over exactly the keys
// K3's forward saw: for query row r of q-tile qt, the keys of each valid
// selected tile idx[bh, qt, j] that the causal mask at offset S - T leaves
// (every key of the tile without it). The strict and the fast forward
// compute the same function (the frozen max cancels in o / l), so one
// backward serves both. The selection (idx, valid) carries no gradient, as
// in the reference (top-k indices and booleans have none).
//
// Given q [BH, T, D], k, v [BH, S, D], idx [BH, n_qt, keep] int64 and
// valid [BH, n_qt, keep] bool, the forward's output o and the output
// gradient dO [BH, T, D] (bf16), and the forward's fp32 log-sum-exp lse
// [BH, T] (natural base, +inf on a row that sees no key), it writes dQ,
// dK, dV in bf16 with fp32 sums. Tiles Bq = block_q and Bc = block_kv are
// any multiples of 16 up to 128 (T, S their multiples), mixed pairs
// included, as K3's forward takes them; D 64, 128 and 192 (Nemotron-4-
// 340B's head). With the element-level
// sphere mask (STARConfig(elementwise=True)) the backward takes the keep
// bits the forward wrote (sufa.cu's keep_out: [BH, n_qt, keep, Bq,
// ceil(Bc / 32)] words) and lets them decide every key in place of the
// causal test. Recomputing the DLZS estimates here would sum them in
// another product shape than the forward's, and a key at the sphere's edge
// could then be in the forward's softmax but out of its gradient; the bits
// also spare the passes the estimates' products and row maxima.
//
// No sum crosses a block: every dQ, dK and dV element is summed inside one
// block in a fixed order, so the gradient is the same bits on every run
// (the restart check needs it); tools/torch_k3_bwd_forms.py finds the two
// forms below equal bit for bit where both take the tiles (128 x 128).
// P is rounded to bf16 before P^T . dO and dS before dS^T . Q and dS . K
// (the products' operands); the softmax, D = rowsum(dO * O) and dS are
// fp32. Rows with no visible key have lse = +inf, so 2^(s - inf) = 0 and
// they give nothing. Each pass walks the selection itself: dK/dV by key
// tile, over the q-tiles that chose it in ascending (q-tile, slot) order
// (a slot that names it twice counts twice, as the forward visits it
// twice); dQ by q-tile, over its slots in their given order. A key tile
// that no q-tile chose gets dK = dV = 0, a q-tile with no valid slot
// dQ = 0, and a step whose rows see none of a tile's keys (causal, offset
// S - T) is skipped.
//
// Bound: bytes, at the training shape. The gradient needs 10 * D flops per
// visible selected (query, key) pair (five products: the recomputed S, dV,
// dP, dK, dQ); two passes do 14 * D (S and dP in both). At OLMo-1B's
// training shape (BH 128, T = S = 2048, D 128, tiles 128, keep 4 of 16) it
// must move about 537 MB (q, k, v, o, dO, dQ, dK, dV, 67 MB each), 0.160
// ms at the card's memory rate. The glue's selection on chip_smoke.py's
// phase 21a inputs keeps 2787 of 8192 slots, 44.2 M pairs: 57 GFLOP by
// 10 * D, 79 by 14 * D, 0.08 ms at the bf16 peak. So the bytes bound it,
// and per-tile costs matter more than the recompute: every head's tile 0
// (the sink) is chosen by all 16 q-tiles, 65% of the key tiles by none.
//
// Two forms, chosen by shape alone (kernels/sufa.py, launch.tile_form), as
// K3's forward:
//   * Bq = Bc = 128, the tiles training runs: wgmma + TMA, two
//     warp-specialised passes of 384 threads. A producer warpgroup gives
//     its registers to two consumer warpgroups (setmaxnreg 24 / 240), and
//     one of its warps walks the selection and issues every load.
//     (c) runs first: one block per (bh, 128-row q-tile), a head's q-tiles
//     side by side (causal: heaviest first), modelled on the forward's
//     wgmma form. Each consumer warp first sums D for its 16 rows from O
//     and dO (the same sum, in the same order, as the prep kernel (a) of
//     the other form) and writes D and lse in base 2 for (b); Q and dO are
//     TMA-loaded once, each valid selected K and V tile in place (row
//     idx * 128 of a 3-D map) into a 2-stage ring (4 at D = 64); two
//     consumer warpgroups of 64 rows run S = Q . K^T and dP = dO . V^T (SS
//     m64n128), P and dS in registers, dQ += dS . K (RS, K MN-major as V
//     is in the forward's P . V).
//     (b) then: persistent, one block per SM taking (bh, 128-key tile)
//     items from a counter (an atomicAdd hands out items, no sum; (c)
//     zeroes it), key tile by key tile (every head's tile 0 first: the
//     longest walks start first). The producer warp scans the head's
//     selection 32 slots a ballot; a chosen tile's K and V are TMA-loaded
//     into one of two buffers with its first step (so the next item's
//     load overlaps this one's products), then each visible 64-row Q and
//     dO step with its lse2 and D slices (bulk copies) into a 3-stage ring
//     (8 at D = 64), the step's first row and item published beside it.
//     An unchosen tile loads nothing: the producer warp writes its zeros.
//     Each consumer warpgroup owns 64 keys: S^T and dP^T (SS m64n64, K, V
//     and Q, dO K-major) as two wgmma groups, P^T in registers while dP^T's
//     product runs, dS^T in registers, then dV += P^T . dO and dK += dS^T
//     . Q in one group (RS m64nD: both accumulators are register A
//     operands as they stand; dO and Q read MN-major through the transpose
//     bit). With no dQ product there is no dS^T through shared memory and
//     no barrier between the two warpgroups. When a new item's first step
//     arrives, the consumers release the old K/V buffer and store its dK
//     (scaled once) and dV. The causal mask is applied only on a step that
//     crosses a warpgroup's diagonal.
//     Measured against one block per key tile, the persistent pass saves
//     the launch and the exposed K/V load of every tile, most of them
//     unchosen; a persistent (c) was slower (its next q-tile's Q and dO
//     cannot load before the current one's products end: shared memory
//     holds one Q/dO pair beside the ring), and so was (b) in head-major
//     item order (the last head's sink walk runs alone at the end).
//   * Other tiles (any multiples of 16 up to 128): mma.sync (mma_bf16.cuh),
//     three kernels: (a) prep, D = rowsum(dO * O) in fp32 and lse in base
//     2, one warp per row; (b) one block per (bh, chunk of a key tile), the
//     chunk the largest of 64, 32 and 16 keys that divides Bc (16 keys a
//     warp), that scans the selection itself (32 slots a ballot) and steps
//     over the chosen q-tiles' rows in steps of the largest of 64, 32 and 16
//     that divides Bq (at most 32 at D = 128); (c) one block per (bh, chunk
//     of a q-tile), the chunk chosen the same way from Bq, stepping over
//     each valid tile in steps of Bc's chunk. So every step lies inside one
//     q-tile and one key tile, whose own selection and keep bits it reads:
//     at Bq = 16 a 64-row slice would span four q-tiles, each with its own
//     slots. At 64 x 64, 64 x 128, 128 x 64 and 128 x 128 the chunks and
//     steps are those of the 64-key blocks and 64-row slices this form had
//     before it took other tiles. Tiles are staged in padded shared rows (D
//     + 8 halves) by plain 16-byte loads; the C fragments of S^T and dS^T
//     are the A operand of the next product as they stand, and B operands
//     that run along the rows of a tile are read as column pairs. With the
//     element mask each step stages its rows' keep words beside them.
//   With the element mask the wgmma form's (c) reads each thread's two rows
//   of a slot's keep words (two 16-byte loads) before its products, and
//   (b) publishes each step's slot with its first row: each thread reads
//   the bits of its two keys for the 16 queries it holds (16 words, one
//   register of mask), so no stage of shared memory grows (the ring has no
//   room: 231,936 of 232,448 bytes at D = 128).
//
// What was hard: the scatter of dK and dV. Several q-tiles choose one key
// tile, and a pass per q-tile would have to add into shared rows across
// blocks (atomics, whose order changes the bits from run to run). Giving
// each key tile to one block, which finds its choosers in a fixed order,
// keeps every sum inside one block. K4's backward (flash_bwd.cu) fuses dQ
// into its key-tile pass through ordered per-tile counters; here that
// would write a 128 x D fp32 partial per (chooser, key tile), as many
// bytes as the reloads it saves, with wait chains that follow a
// data-dependent selection, so dQ keeps its own pass and its recompute.
// Then the selection's skew: a few tiles chosen by every q-tile, most by
// none, which the persistent (b) and its order absorb.
//
// D = 192. (b)'s plan does not fit: a warpgroup's dK and dV of 64 keys
// over 192 columns (96 + 96 fp32 registers a thread) beside S^T and dP^T
// (32 + 32) pass setmaxnreg's 240. So (b) takes 64-key parts of the tiles
// (two items a tile, in turn) and its warpgroups split the work by product
// over the part's keys (sufa_grad_kv_wgmma192_kernel): warpgroup 0 S^T,
// P^T (to shared memory in fp32) and dV, warpgroup 1 dP^T, dS^T and dK,
// two K/V buffers of 48 KB, a 2-stage ring, P^T's 16 KB (210 KB). (c) runs
// each selected tile as two 64-key stages (m64n64 S and dP, dQ by RS
// m64n192; 2 stages, 193 KB), as K3's forward streams a 128-key tile at D
// = 192. The mma.sync form takes 16-row dK/dV steps at D = 192 (its dK and
// dV are 192 registers a thread). Every sum stays inside one block, so
// two calls give the same bits here too.
//
// Later work: ping-pong scheduling of the consumer warpgroups, a (b) that
// splits the sink's long walk, and an mma.sync form whose small tiles share
// a block (at tiles of 16 a block is one warp).

#include <cuda.h>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace star;

constexpr int kWarps = 4;        // most warps of an mma.sync block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxWords = 4;     // keep-bit words per row: 128 keys
constexpr float kLog2e = 1.4426950408889634f;

// The mma.sync form's chunk of a tile: the largest of 64, 32 and 16 that
// divides it. A dK/dV block owns a chunk of one key tile's keys, a dQ block
// a chunk of one q-tile's rows, 16 per warp.
__host__ __device__ constexpr int chunk_of(int tile) {
  return tile % 64 == 0 ? 64 : tile % 32 == 0 ? 32 : 16;
}

template <int D>
__host__ __device__ constexpr int bq_kv() {  // most query rows per dK/dV step
  return D == 192 ? 16 : D == 128 ? 32 : 64;
}

template <int D>
__host__ __device__ constexpr int ld() {
  return D + 8;
}

// K, V (kc rows); Q, dO, their lse2 and D, and their keep words (STEP rows)
template <int D, int STEP>
__host__ __device__ constexpr int smem_kv_bytes(int kc) {
  return (2 * kc + 2 * STEP) * ld<D>() * 2 + 2 * STEP * 4 +
         STEP * kMaxWords * 4;
}

// Q, dO and their keep words (qc rows); K, V (KS rows)
template <int D, int KS>
__host__ __device__ constexpr int smem_q_bytes(int qc) {
  return (2 * qc + 2 * KS) * ld<D>() * 2 + qc * kMaxWords * 4;
}

// Tile j of a q-tile's list, or -1 where it is invalid or out of range
// (as sufa.cu's forward skips it).
__device__ __forceinline__ int selected(const int64_t* ids,
                                        const uint8_t* ok, int j, int n_kt) {
  const int64_t kt = ids[j];
  return ok[j] && kt >= 0 && kt < n_kt ? static_cast<int>(kt) : -1;
}

// Key c of a tile in a row's keep words (sufa.cu's layout).
__device__ __forceinline__ bool kept(const uint32_t* row_words, int c) {
  return (row_words[c >> 5] >> (c & 31)) & 1u;
}

__device__ __forceinline__ float bf16_lo(uint32_t x) {
  return __uint_as_float(x << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t x) {
  return __uint_as_float(x & 0xFFFF0000u);
}

// A fragments of 16 rows starting at row0 of a padded shared tile, k16
// step kk (mma_bf16.cuh's A layout).
template <int LD>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const uint16_t* tile,
                                       int row0, int kk, int lane) {
  const uint16_t* p = tile + (row0 + (lane >> 2)) * LD + kk * 16 +
                      (lane & 3) * 2;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * LD);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * LD + 8);
}

// C fragments of n8 tiles 2j and 2j + 1 as one k16 A fragment, in bf16.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// acc[rows x N] = (16 rows of A at row0) . B^T, B the first N rows of a
// padded tile (both contiguous along D): the score products.
template <int D, int N>
__device__ __forceinline__ void rows_dot(float (&acc)[N / 8][4],
                                         const uint16_t* a_tile, int row0,
                                         const uint16_t* b_tile, int lane) {
  constexpr int LD = ld<D>();
#pragma unroll
  for (int n = 0; n < N / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] =
      acc[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    a_frag<LD>(a, a_tile, row0, kk, lane);
    const uint16_t* bp = b_tile + (lane >> 2) * LD + kk * 16 + (lane & 3) * 2;
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
      mma_16816(acc[n], a, ld32(bp + n * 8 * LD), ld32(bp + n * 8 * LD + 8));
  }
}

// acc[16 x D] += P (16 x K, C fragments) . B, B a padded [K, D] tile read
// along its rows (column pairs).
template <int D, int K>
__device__ __forceinline__ void p_dot(float (&acc)[D / 8][4],
                                      const float (&p)[K / 8][4],
                                      const uint16_t* b_tile, int lane) {
  constexpr int LD = ld<D>();
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t a[4];
    c_to_a(a, p[2 * kk], p[2 * kk + 1]);
    const uint16_t* bp = b_tile + (kk * 16 + (lane & 3) * 2) * LD + (lane >> 2);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      mma_16816(acc[n], a, ld_col_pair(bp + n * 8, LD),
                ld_col_pair(bp + 8 * LD + n * 8, LD));
  }
}

// (a) D = rowsum(dO * O) and lse2 = lse * log2(e), one warp per row.
template <int D>
__global__ void __launch_bounds__(256)
sufa_grad_prep_kernel(const uint16_t* __restrict__ o,
                      const uint16_t* __restrict__ dout,
                      const float* __restrict__ lse, float* __restrict__ dvec,
                      float* __restrict__ lse2, int64_t rows) {
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const uint16_t* op = o + row * D;
  const uint16_t* dp = dout + row * D;
  float acc = 0.f;
#pragma unroll
  for (int e = lane * 2; e < D; e += 64) {
    const uint32_t a = ld32(op + e), b = ld32(dp + e);
    acc += bf16_lo(a) * bf16_lo(b) + bf16_hi(a) * bf16_hi(b);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    dvec[row] = acc;
    lse2[row] = lse[row] * kLog2e;
  }
}

// (b) dK, dV for one (bh, chunk of a key tile): blockDim.x / 2 keys, 16 a
// warp, over the STEP-row query steps of the q-tiles that selected the
// tile. Every warp scans the selection 32 slots a ballot, so the walk is
// block-uniform. ELEM: the element mask, whose keep_bits (the forward's)
// replace the causal test.
template <int D, int STEP, bool ELEM>
__global__ void __launch_bounds__(kThreads)
sufa_grad_kv_kernel(const uint16_t* __restrict__ q,
                    const uint16_t* __restrict__ k,
                    const uint16_t* __restrict__ v,
                    const int64_t* __restrict__ idx,
                    const uint8_t* __restrict__ valid,
                    const uint16_t* __restrict__ dout,
                    const float* __restrict__ lse2,
                    const float* __restrict__ dvec,
                    const uint32_t* __restrict__ keep_bits,
                    uint16_t* __restrict__ dk, uint16_t* __restrict__ dv,
                    int T, int S, int keep, int block_q, int block_kv,
                    int causal, float scale, float scale_log2) {
  constexpr int LD = ld<D>();
  const int kc = blockDim.x / 2;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint16_t* sk = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* sv = sk + kc * LD;
  uint16_t* sq = sv + kc * LD;
  uint16_t* sdo = sq + STEP * LD;
  float* sl = reinterpret_cast<float*>(sdo + STEP * LD);
  float* sd = sl + STEP;
  uint32_t* sb = reinterpret_cast<uint32_t*>(sd + STEP);  // [STEP, words]

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kc;
  const int kt = k0 / block_kv;
  const int n_qt = T / block_q;
  const int n_kt = S / block_kv;
  const int n_sel = n_qt * keep;
  const int words = (block_kv + 31) / 32;
  const int q_offset = S - T;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t2 = (lane & 3) * 2;
  const int key0 = k0 + warp * 16 + (lane >> 2);  // rows of c0/c1; +8: c2/c3
  const int kr0 = key0 - kt * block_kv;           // the same, in the tile
  const int64_t* ids = idx + (int64_t)bh * n_sel;
  const uint8_t* oks = valid + (int64_t)bh * n_sel;

  load_rows<D>(sk, k + (int64_t)bh * S * D, k0, kc, S, false);
  load_rows<D>(sv, v + (int64_t)bh * S * D, k0, kc, S, false);

  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_k[n][c] = acc_v[n][c] = 0.f;

  const int64_t qbase = (int64_t)bh * T;
  // the q-tiles that chose this key tile, in ascending (q-tile, slot)
  // order (a slot that names it twice counts twice, as the forward visits
  // it twice)
  for (int base = 0; base < n_sel; base += 32) {
    const int e = base + lane;
    uint32_t hits = __ballot_sync(
        0xffffffffu, e < n_sel && selected(ids, oks, e, n_kt) == kt);
    while (hits) {  // block-uniform
      const int sel = base + __ffs(hits) - 1;
      hits &= hits - 1;
      const int qt = sel / keep;
      // ELEM: the slot's keep words, from its q-tile's first row
      const uint32_t* bits =
          ELEM ? keep_bits + ((int64_t)bh * n_sel + sel) * block_q * words
               : nullptr;
      for (int q0 = qt * block_q; q0 < (qt + 1) * block_q; q0 += STEP) {
        // causal: no row of the step sees a key of this block
        if (causal && q0 + STEP - 1 + q_offset < k0) continue;
        __syncthreads();  // the previous step is done with the Q / dO tiles
        load_rows<D>(sq, q + qbase * D, q0, STEP, T, false);
        load_rows<D>(sdo, dout + qbase * D, q0, STEP, T, false);
        for (int i = threadIdx.x; i < STEP; i += blockDim.x) {
          sl[i] = lse2[qbase + q0 + i];
          sd[i] = dvec[qbase + q0 + i];
        }
        if constexpr (ELEM) {
          const uint32_t* src = bits + (q0 - qt * block_q) * words;
          for (int i = threadIdx.x; i < STEP * words; i += blockDim.x)
            sb[i] = src[i];
        }
        __syncthreads();

        // P^T = 2^(scale_log2 * K . Q^T - lse2), masked
        float st[STEP / 8][4];
        rows_dot<D, STEP>(st, sk, warp * 16, sq, lane);
#pragma unroll
        for (int n = 0; n < STEP / 8; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int qi = n * 8 + t2 + (c & 1);
            const int up = (c & 2) ? 8 : 0;
            bool ok;
            if constexpr (ELEM)
              ok = kept(sb + qi * words, kr0 + up);
            else
              ok = !causal || key0 + up <= q0 + qi + q_offset;
            st[n][c] = ok ? fast_exp2(st[n][c] * scale_log2 - sl[qi]) : 0.f;
          }
        // dV += P^T . dO
        p_dot<D, STEP>(acc_v, st, sdo, lane);
        // dS^T = P^T * (V . dO^T - D)
        float dpt[STEP / 8][4];
        rows_dot<D, STEP>(dpt, sv, warp * 16, sdo, lane);
#pragma unroll
        for (int n = 0; n < STEP / 8; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            st[n][c] *= dpt[n][c] - sd[n * 8 + t2 + (c & 1)];
        // dK += dS^T . Q
        p_dot<D, STEP>(acc_k, st, sq, lane);
      }
    }
  }

  const int64_t kbase = (int64_t)bh * S;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + t2;
    *reinterpret_cast<uint32_t*>(dk + (kbase + key0) * D + col) =
        pack_bf16(acc_k[n][0] * scale, acc_k[n][1] * scale);
    *reinterpret_cast<uint32_t*>(dv + (kbase + key0) * D + col) =
        pack_bf16(acc_v[n][0], acc_v[n][1]);
    *reinterpret_cast<uint32_t*>(dk + (kbase + key0 + 8) * D + col) =
        pack_bf16(acc_k[n][2] * scale, acc_k[n][3] * scale);
    *reinterpret_cast<uint32_t*>(dv + (kbase + key0 + 8) * D + col) =
        pack_bf16(acc_v[n][2], acc_v[n][3]);
  }
}

// (c) dQ for one (bh, chunk of a q-tile): blockDim.x / 2 rows, 16 a warp,
// over its q-tile's valid slots in KS-key steps; ELEM as in (b).
template <int D, int KS, bool ELEM>
__global__ void __launch_bounds__(kThreads)
sufa_grad_q_kernel(const uint16_t* __restrict__ q,
                   const uint16_t* __restrict__ k,
                   const uint16_t* __restrict__ v,
                   const int64_t* __restrict__ idx,
                   const uint8_t* __restrict__ valid,
                   const uint16_t* __restrict__ dout,
                   const float* __restrict__ lse2,
                   const float* __restrict__ dvec,
                   const uint32_t* __restrict__ keep_bits,
                   uint16_t* __restrict__ dq, int T, int S, int keep,
                   int block_q, int block_kv, int causal, float scale,
                   float scale_log2) {
  constexpr int LD = ld<D>();
  const int qc = blockDim.x / 2;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint16_t* sq = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* sdo = sq + qc * LD;
  uint16_t* sk = sdo + qc * LD;
  uint16_t* sv = sk + KS * LD;
  uint32_t* sb = reinterpret_cast<uint32_t*>(sv + KS * LD);  // [qc, words]

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * qc;
  const int qt = q0 / block_q;
  const int n_qt = T / block_q;
  const int n_kt = S / block_kv;
  const int words = (block_kv + 31) / 32;
  const int q_offset = S - T;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t2 = (lane & 3) * 2;
  const int lr0 = warp * 16 + (lane >> 2);  // c0/c1's row in the chunk
  const int row0 = q0 + lr0;                // +8: c2/c3
  const int64_t qbase = (int64_t)bh * T;
  const int64_t* ids = idx + ((int64_t)bh * n_qt + qt) * keep;
  const uint8_t* oks = valid + ((int64_t)bh * n_qt + qt) * keep;

  load_rows<D>(sq, q + qbase * D, q0, qc, T, false);
  load_rows<D>(sdo, dout + qbase * D, q0, qc, T, false);
  float l2[2], dd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l2[h] = lse2[qbase + row0 + 8 * h];
    dd[h] = dvec[qbase + row0 + 8 * h];
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

  for (int j = 0; j < keep; ++j) {
    const int kt = selected(ids, oks, j, n_kt);
    if (kt < 0) continue;  // block-uniform
    // ELEM: slot j's keep words of the chunk's first row
    const uint32_t* bits =
        ELEM ? keep_bits + ((((int64_t)bh * n_qt + qt) * keep + j) * block_q +
                            q0 - qt * block_q) * words
             : nullptr;
    for (int kv0 = kt * block_kv; kv0 < (kt + 1) * block_kv; kv0 += KS) {
      // causal: every key of the step lies after the chunk's last row
      if (causal && kv0 > q_offset + q0 + qc - 1) continue;
      __syncthreads();  // the previous step is done with the K / V tiles
      load_rows<D>(sk, k + (int64_t)bh * S * D, kv0, KS, S, false);
      load_rows<D>(sv, v + (int64_t)bh * S * D, kv0, KS, S, false);
      if constexpr (ELEM)
        for (int i = threadIdx.x; i < qc * words; i += blockDim.x)
          sb[i] = bits[i];
      __syncthreads();

      float p[KS / 8][4];
      rows_dot<D, KS>(p, sq, warp * 16, sk, lane);
#pragma unroll
      for (int n = 0; n < KS / 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = kv0 + n * 8 + t2 + (c & 1);
          const int h = (c >> 1) & 1;
          bool ok;
          if constexpr (ELEM)
            ok = kept(sb + (lr0 + 8 * h) * words, key - kt * block_kv);
          else
            ok = !causal || key <= row0 + 8 * h + q_offset;
          p[n][c] = ok ? fast_exp2(p[n][c] * scale_log2 - l2[h]) : 0.f;
        }
      float dp[KS / 8][4];
      rows_dot<D, KS>(dp, sdo, warp * 16, sv, lane);
#pragma unroll
      for (int n = 0; n < KS / 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) p[n][c] *= dp[n][c] - dd[(c >> 1) & 1];
      // dQ += dS . K
      p_dot<D, KS>(acc, p, sk, lane);
    }
  }

#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + t2;
    *reinterpret_cast<uint32_t*>(dq + (qbase + row0) * D + col) =
        pack_bf16(acc[n][0] * scale, acc[n][1] * scale);
    *reinterpret_cast<uint32_t*>(dq + (qbase + row0 + 8) * D + col) =
        pack_bf16(acc[n][2] * scale, acc[n][3] * scale);
  }
}

// The arguments every mma.sync pass takes, for the launch helpers.
struct MmaArgs {
  const uint16_t *q, *k, *v, *dout;
  const int64_t* idx;
  const uint8_t* valid;
  const float *lse2, *dvec;
  const uint32_t* keep_bits;
  uint16_t *dq, *dk, *dv;
  int BH, T, S, keep, block_q, block_kv, causal;
  float scale, scale_log2;
};

template <int D, int STEP, bool ELEM>
cudaError_t launch_kv(const MmaArgs& a, cudaStream_t stream) {
  static bool configured = false;  // the >48 KB opt-in, once per instance
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        sufa_grad_kv_kernel<D, STEP, ELEM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_kv_bytes<D, STEP>(64));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int kc = chunk_of(a.block_kv);
  sufa_grad_kv_kernel<D, STEP, ELEM><<<dim3(a.BH, a.S / kc), kc / 16 * 32,
                                       smem_kv_bytes<D, STEP>(kc), stream>>>(
      a.q, a.k, a.v, a.idx, a.valid, a.dout, a.lse2, a.dvec, a.keep_bits,
      a.dk, a.dv, a.T, a.S, a.keep, a.block_q, a.block_kv, a.causal, a.scale,
      a.scale_log2);
  return cudaGetLastError();
}

template <int D, int KS, bool ELEM>
cudaError_t launch_q(const MmaArgs& a, cudaStream_t stream) {
  static bool configured = false;  // the >48 KB opt-in, once per instance
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        sufa_grad_q_kernel<D, KS, ELEM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q_bytes<D, KS>(64));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int qc = chunk_of(a.block_q);
  sufa_grad_q_kernel<D, KS, ELEM><<<dim3(a.BH, a.T / qc), qc / 16 * 32,
                                    smem_q_bytes<D, KS>(qc), stream>>>(
      a.q, a.k, a.v, a.idx, a.valid, a.dout, a.lse2, a.dvec, a.keep_bits,
      a.dq, a.T, a.S, a.keep, a.block_q, a.block_kv, a.causal, a.scale,
      a.scale_log2);
  return cudaGetLastError();
}

// (b) and (c) at their steps: (b)'s query step is the q-tile's chunk, at
// most bq_kv<D>() rows; (c)'s key step the key tile's chunk.
template <int D, bool ELEM>
cudaError_t launch_passes(const MmaArgs& a, cudaStream_t stream) {
  const int chunk = chunk_of(a.block_q);
  const int step = chunk < bq_kv<D>() ? chunk : bq_kv<D>();
  cudaError_t err = cudaSuccess;
  if (step == 16) {
    err = launch_kv<D, 16, ELEM>(a, stream);
  } else if constexpr (bq_kv<D>() >= 32) {  // no wider step is built at 192
    if (step == 32)
      err = launch_kv<D, 32, ELEM>(a, stream);
    else if constexpr (bq_kv<D>() == 64)
      err = launch_kv<D, 64, ELEM>(a, stream);
  }
  if (err != cudaSuccess) return err;
  switch (chunk_of(a.block_kv)) {
    case 16: return launch_q<D, 16, ELEM>(a, stream);
    case 32: return launch_q<D, 32, ELEM>(a, stream);
    default: return launch_q<D, 64, ELEM>(a, stream);
  }
}

// The three passes at any tiles; with keep_bits the element mask's.
template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const int64_t* idx, const uint8_t* valid,
                       const void* o, const void* lse, const void* dout,
                       void* dq, void* dk, void* dv, void* scratch,
                       const uint32_t* keep_bits, int BH, int T, int S,
                       int keep, int block_q, int block_kv, int causal,
                       float scale, cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(BH) * T;
  float* dvec = static_cast<float*>(scratch);
  float* lse2 = dvec + rows;
  const auto* dob = static_cast<const uint16_t*>(dout);
  const MmaArgs a{static_cast<const uint16_t*>(q),
                  static_cast<const uint16_t*>(k),
                  static_cast<const uint16_t*>(v), dob, idx, valid, lse2,
                  dvec, keep_bits, static_cast<uint16_t*>(dq),
                  static_cast<uint16_t*>(dk), static_cast<uint16_t*>(dv), BH,
                  T, S, keep, block_q, block_kv, causal, scale,
                  scale * kLog2e};

  sufa_grad_prep_kernel<D><<<static_cast<unsigned>((rows + 7) / 8), 256, 0,
                             stream>>>(static_cast<const uint16_t*>(o), dob,
                                       static_cast<const float*>(lse), dvec,
                                       lse2, rows);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return keep_bits != nullptr ? launch_passes<D, true>(a, stream)
                              : launch_passes<D, false>(a, stream);
}

// -- the wgmma form: 128 x 128 tiles ------------------------------------------

constexpr int kTile = 128;       // query rows and keys per tile
constexpr int kStep = 64;        // query rows per dK/dV step
constexpr int kConsumers = 2;    // warpgroups of 64 keys (b) or rows (c)
constexpr int kWgThreads = (kConsumers + 1) * 128;  // + a producer warpgroup
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// At D = 192 both passes stream K and V in 64-key parts (kv_rows<192>()):
// (b) takes (bh, 64-key part) items, its two warpgroups split by product
// (sufa_grad_kv_wgmma192_kernel), and (c) runs each selected tile as two
// 64-key stages.
template <int D>
__host__ __device__ constexpr int kv_rows() {
  return D == 192 ? 64 : kTile;
}

// (b)'s ring of 64-row Q/dO steps and (c)'s ring of K/V stages: as deep as
// shared memory allows beside (b)'s two K/V buffers (and at D = 192 its
// P^T) and (c)'s Q and dO
template <int D>
__host__ __device__ constexpr int kv_pass_stages() {
  return D == 64 ? 8 : D == 128 ? 3 : 2;
}

template <int D>
__host__ __device__ constexpr int q_pass_stages() {
  return D == 64 ? 4 : 2;
}

template <int D>
__host__ __device__ constexpr int smem_kv_wgmma_bytes() {
  // two K, V buffers; per stage Q, dO and their lse2 / D slices; at D =
  // 192 the P^T exchange; alignment
  return 4 * tile_bytes<D>(kv_rows<D>()) +
         kv_pass_stages<D>() * (2 * tile_bytes<D>(kStep) + 2 * kStep * 4) +
         (D == 192 ? 64 * kStep * 4 : 0) + 1024;
}

template <int D>
__host__ __device__ constexpr int smem_q_wgmma_bytes() {
  // Q, dO; per stage K, V; alignment
  return 2 * tile_bytes<D>(kTile) +
         2 * q_pass_stages<D>() * tile_bytes<D>(kv_rows<D>()) + 1024;
}

// (b) dK, dV of 128-key tiles, each over the 64-row steps of the q-tiles
// that chose it. A persistent block takes (bh, key tile) items from a
// counter, key tile by key tile (every head's tile 0, then tile 1, ...):
// under causal STAR the low tiles are the most chosen (the sink by every
// q-tile), so the longest walks start first. ELEM: the element mask, from
// the forward's keep bits (each step's slot published with it; each
// thread reads its two keys' bits of the step's 16 queries it holds).
template <int D, bool ELEM>
__global__ void __launch_bounds__(kWgThreads, 1)
sufa_grad_kv_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap,   // [BH, T, D], boxes of 64
    const __grid_constant__ CUtensorMap domap,  // [BH, T, D], boxes of 64
    const __grid_constant__ CUtensorMap kmap,   // [BH, S, D], boxes of 128
    const __grid_constant__ CUtensorMap vmap,   // [BH, S, D], boxes of 128
    const int64_t* __restrict__ idx, const uint8_t* __restrict__ valid,
    const float* __restrict__ lse2,  // [BH, T]
    const float* __restrict__ dvec,  // [BH, T]
    const uint32_t* __restrict__ keep_bits,  // ELEM: [BH, n_qt, keep, 128, 4]
    int* __restrict__ next_item,     // the next item; (c) zeroed it
    uint16_t* __restrict__ dk, uint16_t* __restrict__ dv, int BH, int T,
    int S, int keep, int causal, float scale, float scale_log2) {
  constexpr int kStages = kv_pass_stages<D>();
  constexpr int kKV = tile_bytes<D>(kTile);
  constexpr int kQ = tile_bytes<D>(kStep);
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t kv_full[2];
  __shared__ __align__(8) uint64_t kv_empty[2];
  __shared__ __align__(8) uint64_t q_full[kStages];
  __shared__ __align__(8) uint64_t q_empty[kStages];
  __shared__ int step_q0[kStages];    // a stage's first row
  __shared__ int step_item[kStages];  // its item; -1: the walk's end
  __shared__ int step_sel[kStages];   // its slot, q-tile * keep + j

  // swizzled boxes need 1024-byte aligned shared addresses
  uint8_t* const skv =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // K/V buffer b: K at skv + 2b·kKV, V after
  uint8_t* const sring = skv + 4 * kKV;  // stage s: Q at + 2s·kQ, dO after
  float* const sstat = reinterpret_cast<float*>(sring + kStages * 2 * kQ);
  // stage s: lse2 at sstat + 2s·kStep, D after

  const int n_qt = T / kTile;
  const int n_kt = S / kTile;
  const int n_items = BH * n_kt;
  const int q_offset = S - T;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(&kv_full[b], 1);
      mbar_init(&kv_empty[b], kConsumers * 128);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&q_full[s], 1);
      mbar_init(&q_empty[s], kConsumers * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kConsumers * 4) {  // the producer warpgroup
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kConsumers * 4) {  // warp 8 walks, its lane 0 loads by TMA
      const int lane = threadIdx.x & 31;
      int n = 0;       // stages pushed
      int loaded = 0;  // items whose K and V were loaded
      for (;;) {
        int w = 0;
        if (lane == 0) w = atomicAdd(next_item, 1);
        w = __shfl_sync(0xffffffffu, w, 0);
        if (w >= n_items) break;
        const int bh = w % BH;
        const int kt = w / BH;
        const int k0 = kt * kTile;
        const int64_t* ids = idx + (int64_t)bh * n_qt * keep;
        const uint8_t* oks = valid + (int64_t)bh * n_qt * keep;
        const float* l2 = lse2 + (int64_t)bh * T;
        const float* dd = dvec + (int64_t)bh * T;
        // the q-tiles that chose this key tile, ascending (q-tile, slot),
        // 32 slots a ballot: a slot that names it twice counts twice, as
        // the forward visits it twice; a step whose rows see none of its
        // keys is skipped. K and V load with the first step
        bool first = true;
        for (int base = 0; base < n_qt * keep; base += 32) {
          const int e = base + lane;
          uint32_t hits = __ballot_sync(
              0xffffffffu,
              e < n_qt * keep && selected(ids, oks, e, n_kt) == kt);
          while (hits) {  // warp-uniform
            const int sel = base + __ffs(hits) - 1;
            const int qt = sel / keep;
            hits &= hits - 1;
            for (int q0 = qt * kTile; q0 < (qt + 1) * kTile; q0 += kStep) {
              if (causal && q0 + kStep - 1 + q_offset < k0) continue;
              if (lane == 0) {
                if (first) {  // buffer loaded & 1, free once released
                  const int b = loaded & 1;
                  if (loaded >= 2)
                    mbar_wait(&kv_empty[b], ((loaded >> 1) - 1) & 1);
                  uint8_t* ks = skv + 2 * b * kKV;
                  mbar_expect_tx(&kv_full[b], 2 * kKV);
                  for (int c = 0; c < D / 64; ++c) {
                    tma_load_3d(ks + c * box_bytes(kTile), &kmap,
                                &kv_full[b], c * 64, k0, bh);
                    tma_load_3d(ks + kKV + c * box_bytes(kTile), &vmap,
                                &kv_full[b], c * 64, k0, bh);
                  }
                }
                const int s = n % kStages;
                if (n >= kStages)
                  mbar_wait(&q_empty[s], (n / kStages - 1) & 1);
                step_q0[s] = q0;  // published by the arrival below
                step_item[s] = w;
                step_sel[s] = sel;
                uint8_t* qs = sring + 2 * s * kQ;
                float* st = sstat + 2 * s * kStep;
                mbar_expect_tx(&q_full[s], 2 * kQ + 2 * kStep * 4);
                for (int c = 0; c < D / 64; ++c) {
                  tma_load_3d(qs + c * box_bytes(kStep), &qmap, &q_full[s],
                              c * 64, q0, bh);
                  tma_load_3d(qs + kQ + c * box_bytes(kStep), &domap,
                              &q_full[s], c * 64, q0, bh);
                }
                bulk_load(st, l2 + q0, kStep * 4, &q_full[s]);
                bulk_load(st + kStep, dd + q0, kStep * 4, &q_full[s]);
              }
              loaded += first;
              first = false;
              ++n;
            }
          }
        }
        if (first) {  // no q-tile chose the tile: dK = dV = 0
          uint4* zk = reinterpret_cast<uint4*>(dk + ((int64_t)bh * S + k0) * D);
          uint4* zv = reinterpret_cast<uint4*>(dv + ((int64_t)bh * S + k0) * D);
          for (int i = lane; i < kTile * D / 8; i += 32)
            zk[i] = zv[i] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
      if (lane == 0) {  // the walk's end: one plain arrival
        const int s = n % kStages;
        if (n >= kStages) mbar_wait(&q_empty[s], (n / kStages - 1) & 1);
        step_item[s] = -1;
        mbar_arrive(&q_full[s]);
      }
    }
  } else {
    // a consumer warpgroup: 64 keys of each item; this thread's keys are
    // key, key + 8 of its tile
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = warp >> 2;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t2 = (lane & 3) * 2;
    const int krow = wg * 64 + (warp & 3) * 16 + g;  // its row in the tile

    float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
    int cur = -1;  // the item in hand
    int jc = -1;   // its place among the loaded items: buffer jc & 1
    int k0 = 0;
    for (int n = 0;; ++n) {
      const int s = n % kStages;
      mbar_wait(&q_full[s], (n / kStages) & 1);
      const int q0 = step_q0[s];
      const int w = step_item[s];
      // a new item's first step, or the walk's end (item -1, also in a
      // block that got no chosen tile): the item in hand is done, so
      // release its K and V buffer and store its dK and dV
      if (w != cur || w < 0) {
        if (cur >= 0) {
          mbar_arrive(&kv_empty[jc & 1]);
          const int bh = cur % BH;
          uint16_t* pk = dk + ((int64_t)bh * S + k0 + krow) * D + t2;
          uint16_t* pv = dv + ((int64_t)bh * S + k0 + krow) * D + t2;
#pragma unroll
          for (int c = 0; c < D / 8; ++c) {
            *reinterpret_cast<uint32_t*>(pk + 8 * c) =
                pack_bf16(acc_k[4 * c] * scale, acc_k[4 * c + 1] * scale);
            *reinterpret_cast<uint32_t*>(pv + 8 * c) =
                pack_bf16(acc_v[4 * c], acc_v[4 * c + 1]);
            *reinterpret_cast<uint32_t*>(pk + 8 * D + 8 * c) =
                pack_bf16(acc_k[4 * c + 2] * scale, acc_k[4 * c + 3] * scale);
            *reinterpret_cast<uint32_t*>(pv + 8 * D + 8 * c) =
                pack_bf16(acc_v[4 * c + 2], acc_v[4 * c + 3]);
          }
#pragma unroll
          for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
        }
        if (w < 0) break;
        cur = w;
        ++jc;
        k0 = w / BH * kTile;
        mbar_wait(&kv_full[jc & 1], (jc >> 1) & 1);
      }
      // ELEM: bit i set where score i (key krow + 8 ((i >> 1) & 1), query
      // q0 + 8 (i >> 2) + t2 + (i & 1)) survives the forward's masks; read
      // before the products are issued, so the loads overlap them
      uint32_t keep_mask = 0u;
      if constexpr (ELEM) {
        const uint32_t* b =
            keep_bits +
            (((int64_t)(w % BH) * n_qt * keep + step_sel[s]) * kTile +
             (q0 & (kTile - 1)) + t2) * 4 + (krow >> 5);
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const uint32_t word = b[(8 * a + c) * 4] >> (krow & 31);
            keep_mask |= ((word & 1u) << (4 * a + c)) |
                         (((word >> 8) & 1u) << (4 * a + 2 + c));
          }
      }
      const uint8_t* qs = sring + 2 * s * kQ;
      const uint8_t* dos = qs + kQ;
      const float* sl = sstat + 2 * s * kStep;
      const float* sd = sl + kStep;
      const uint8_t* ks = skv + 2 * (jc & 1) * kKV + wg * 64 * 128;
      const uint64_t d_k = kdesc(ks), d_v = kdesc(ks + kKV);
      const uint64_t d_q = kdesc(qs), d_do = kdesc(dos);

      // S^T = K . Q^T and dP^T = V . dO^T over D, two wgmma groups
      float st[kStep / 2], dpt[kStep / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_m64n64_t<0, 0>(st, kmajor(d_k, box_bytes(kTile), kk),
                                kmajor(d_q, box_bytes(kStep), kk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_m64n64_t<0, 0>(dpt, kmajor(d_v, box_bytes(kTile), kk),
                                kmajor(d_do, box_bytes(kStep), kk), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(st);

      // P^T = 2^(scale_log2 * S^T - lse2[query]) while dP^T's product
      // runs; element i of the accumulator is key row k0 + krow (+8 if
      // i & 2), query column q0 + 8(i / 4) + t2 + (i & 1)
      const int key = k0 + krow;
      const bool edge = causal && k0 + wg * 64 + 63 > q0 + q_offset;
#pragma unroll
      for (int i = 0; i < kStep / 2; ++i) {
        const int qc = (i >> 2) * 8 + t2 + (i & 1);
        float p = fast_exp2(st[i] * scale_log2 - sl[qc]);
        if constexpr (ELEM) {
          if (!((keep_mask >> i) & 1u)) p = 0.f;
        } else if (edge && key + ((i & 2) ? 8 : 0) > q0 + qc + q_offset) {
          p = 0.f;
        }
        st[i] = p;
      }
      uint32_t pa[kStep / 16][4];
#pragma unroll
      for (int kk = 0; kk < kStep / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);

      // dS^T = P^T * (dP^T - D[query]), in registers as well
      wgmma_wait<0>();
      fence_regs(dpt);
      uint32_t dsa[kStep / 16][4];
#pragma unroll
      for (int kk = 0; kk < kStep / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 8 * kk + 2 * r;
          const int qc = (i >> 2) * 8 + t2;
          dsa[kk][r] = pack_bf16(st[i] * (dpt[i] - sd[qc]),
                                 st[i + 1] * (dpt[i + 1] - sd[qc + 1]));
        }

      // dV += P^T . dO and dK += dS^T . Q: the accumulators of S^T and
      // dS^T are register A operands as they stand; dO and Q MN-major
      const uint64_t d_dot = mndesc(dos, box_bytes(kStep));
      const uint64_t d_qt = mndesc(qs, box_bytes(kStep));
      fence_regs(acc_v);
      fence_regs(acc_k);
      fence_regs(pa);
      fence_regs(dsa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kStep / 16; ++kk)
        rs_step<D>(acc_v, pa[kk], mnmajor(d_dot, kk));
#pragma unroll
      for (int kk = 0; kk < kStep / 16; ++kk)
        rs_step<D>(acc_k, dsa[kk], mnmajor(d_qt, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_v);
      fence_regs(acc_k);
      mbar_arrive(&q_empty[s]);
    }
  }
}

// (b) at D = 192: dK, dV of 64-key parts of the 128-key tiles, each over
// the 64-row steps of the q-tiles that chose its tile. The walk, the order
// of items (key tile by key tile, each tile's two parts in turn) and the
// ring are (b)'s above; a part's K and V load with its first step. dK and
// dV of 64 keys over 192 columns (96 + 96 registers) beside S^T and dP^T
// would pass setmaxnreg's 240, so the two consumer warpgroups split the
// work by product over the same 64 keys: warpgroup 0 S^T = K . Q^T, P^T
// (masked), P^T in fp32 to shared memory, dV += P^T . dO; warpgroup 1
// dP^T = V . dO^T, dS^T = P^T * (dP^T - D) from the shared P^T, dK += dS^T
// . Q (RS m64n192 both). Each warpgroup runs one wgmma sequence on
// operands chosen by warpgroup, so no product sits in a divergent branch.
template <bool ELEM>
__global__ void __launch_bounds__(kWgThreads, 1)
sufa_grad_kv_wgmma192_kernel(
    const __grid_constant__ CUtensorMap qmap,   // [BH, T, D], boxes of 64
    const __grid_constant__ CUtensorMap domap,  // [BH, T, D], boxes of 64
    const __grid_constant__ CUtensorMap kmap,   // [BH, S, D], boxes of 64
    const __grid_constant__ CUtensorMap vmap,   // [BH, S, D], boxes of 64
    const int64_t* __restrict__ idx, const uint8_t* __restrict__ valid,
    const float* __restrict__ lse2,  // [BH, T]
    const float* __restrict__ dvec,  // [BH, T]
    const uint32_t* __restrict__ keep_bits,  // ELEM: [BH, n_qt, keep, 128, 4]
    int* __restrict__ next_item,     // the next item; (c) zeroed it
    uint16_t* __restrict__ dk, uint16_t* __restrict__ dv, int BH, int T,
    int S, int keep, int causal, float scale, float scale_log2) {
  constexpr int D = 192;
  constexpr int kB = kv_rows<D>();  // keys per item
  constexpr int kStages = kv_pass_stages<D>();
  constexpr int kKV = tile_bytes<D>(kB);
  constexpr int kQ = tile_bytes<D>(kStep);
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t kv_full[2];
  __shared__ __align__(8) uint64_t kv_empty[2];
  __shared__ __align__(8) uint64_t q_full[kStages];
  __shared__ __align__(8) uint64_t q_empty[kStages];
  __shared__ __align__(8) uint64_t p_full;   // P^T published
  __shared__ __align__(8) uint64_t p_empty;  // P^T read
  __shared__ int step_q0[kStages];    // a stage's first row
  __shared__ int step_item[kStages];  // its item; -1: the walk's end
  __shared__ int step_sel[kStages];   // its slot, q-tile * keep + j

  uint8_t* const skv =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // K/V buffer b: K at skv + 2b·kKV, V after
  uint8_t* const sring = skv + 4 * kKV;  // stage s: Q at + 2s·kQ, dO after
  float* const sstat = reinterpret_cast<float*>(sring + kStages * 2 * kQ);
  // stage s: lse2 at sstat + 2s·kStep, D after
  float4* const sp4 = reinterpret_cast<float4*>(sstat + kStages * 2 * kStep);

  const int n_qt = T / kTile;
  const int n_kt = S / kTile;
  const int n_items = BH * n_kt * (kTile / kB);
  const int q_offset = S - T;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(&kv_full[b], 1);
      mbar_init(&kv_empty[b], kConsumers * 128);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&q_full[s], 1);
      mbar_init(&q_empty[s], kConsumers * 128);
    }
    mbar_init(&p_full, 128);
    mbar_init(&p_empty, 128);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kConsumers * 4) {  // the producer warpgroup
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kConsumers * 4) {  // warp 8 walks, its lane 0 loads by TMA
      const int lane = threadIdx.x & 31;
      int n = 0;       // stages pushed
      int loaded = 0;  // items whose K and V were loaded
      for (;;) {
        int w = 0;
        if (lane == 0) w = atomicAdd(next_item, 1);
        w = __shfl_sync(0xffffffffu, w, 0);
        if (w >= n_items) break;
        const int bh = w % BH;
        const int kt = w / BH / (kTile / kB);
        const int k0 = w / BH * kB;  // the part's first key
        const int64_t* ids = idx + (int64_t)bh * n_qt * keep;
        const uint8_t* oks = valid + (int64_t)bh * n_qt * keep;
        const float* l2 = lse2 + (int64_t)bh * T;
        const float* dd = dvec + (int64_t)bh * T;
        // the q-tiles that chose the part's tile, ascending (q-tile, slot),
        // 32 slots a ballot; a step whose rows see none of the part's keys
        // is skipped. K and V load with the first step
        bool first = true;
        for (int base = 0; base < n_qt * keep; base += 32) {
          const int e = base + lane;
          uint32_t hits = __ballot_sync(
              0xffffffffu,
              e < n_qt * keep && selected(ids, oks, e, n_kt) == kt);
          while (hits) {  // warp-uniform
            const int sel = base + __ffs(hits) - 1;
            const int qt = sel / keep;
            hits &= hits - 1;
            for (int q0 = qt * kTile; q0 < (qt + 1) * kTile; q0 += kStep) {
              if (causal && q0 + kStep - 1 + q_offset < k0) continue;
              if (lane == 0) {
                if (first) {  // buffer loaded & 1, free once released
                  const int b = loaded & 1;
                  if (loaded >= 2)
                    mbar_wait(&kv_empty[b], ((loaded >> 1) - 1) & 1);
                  uint8_t* ks = skv + 2 * b * kKV;
                  mbar_expect_tx(&kv_full[b], 2 * kKV);
                  for (int c = 0; c < D / 64; ++c) {
                    tma_load_3d(ks + c * box_bytes(kB), &kmap, &kv_full[b],
                                c * 64, k0, bh);
                    tma_load_3d(ks + kKV + c * box_bytes(kB), &vmap,
                                &kv_full[b], c * 64, k0, bh);
                  }
                }
                const int s = n % kStages;
                if (n >= kStages)
                  mbar_wait(&q_empty[s], (n / kStages - 1) & 1);
                step_q0[s] = q0;  // published by the arrival below
                step_item[s] = w;
                step_sel[s] = sel;
                uint8_t* qs = sring + 2 * s * kQ;
                float* st = sstat + 2 * s * kStep;
                mbar_expect_tx(&q_full[s], 2 * kQ + 2 * kStep * 4);
                for (int c = 0; c < D / 64; ++c) {
                  tma_load_3d(qs + c * box_bytes(kStep), &qmap, &q_full[s],
                              c * 64, q0, bh);
                  tma_load_3d(qs + kQ + c * box_bytes(kStep), &domap,
                              &q_full[s], c * 64, q0, bh);
                }
                bulk_load(st, l2 + q0, kStep * 4, &q_full[s]);
                bulk_load(st + kStep, dd + q0, kStep * 4, &q_full[s]);
              }
              loaded += first;
              first = false;
              ++n;
            }
          }
        }
        if (first) {  // no q-tile chose the tile, or no row sees the part
          uint4* zk = reinterpret_cast<uint4*>(dk + ((int64_t)bh * S + k0) * D);
          uint4* zv = reinterpret_cast<uint4*>(dv + ((int64_t)bh * S + k0) * D);
          for (int i = lane; i < kB * D / 8; i += 32)
            zk[i] = zv[i] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
      if (lane == 0) {  // the walk's end: one plain arrival
        const int s = n % kStages;
        if (n >= kStages) mbar_wait(&q_empty[s], (n / kStages - 1) & 1);
        step_item[s] = -1;
        mbar_arrive(&q_full[s]);
      }
    }
  } else {
    // a consumer warpgroup over the item's 64 keys; this thread's keys
    // are key, key + 8 of the part
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = warp >> 2;
    const int lane = threadIdx.x & 31;
    const int tid = threadIdx.x & 127;
    const int g = lane >> 2;
    const int t2 = (lane & 3) * 2;
    const int krow = (warp & 3) * 16 + g;  // its row in the part
    const int b_off = wg == 0 ? kQ : 0;    // the second product's B: dO, Q

    float acc[D / 2];  // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    int cur = -1;  // the item in hand
    int jc = -1;   // its place among the loaded items: buffer jc & 1
    int k0 = 0;
    for (int n = 0;; ++n) {
      const int s = n % kStages;
      mbar_wait(&q_full[s], (n / kStages) & 1);
      const int q0 = step_q0[s];
      const int w = step_item[s];
      // a new item's first step, or the walk's end: the item in hand is
      // done, so release its K and V buffer and store its dV or dK
      if (w != cur || w < 0) {
        if (cur >= 0) {
          mbar_arrive(&kv_empty[jc & 1]);
          const int bh = cur % BH;
          uint16_t* out = (wg == 0 ? dv : dk) +
                          ((int64_t)bh * S + k0 + krow) * D + t2;
          const float f = wg == 0 ? 1.f : scale;
#pragma unroll
          for (int c = 0; c < D / 8; ++c) {
            *reinterpret_cast<uint32_t*>(out + 8 * c) =
                pack_bf16(acc[4 * c] * f, acc[4 * c + 1] * f);
            *reinterpret_cast<uint32_t*>(out + 8 * D + 8 * c) =
                pack_bf16(acc[4 * c + 2] * f, acc[4 * c + 3] * f);
          }
#pragma unroll
          for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
        }
        if (w < 0) break;
        cur = w;
        ++jc;
        k0 = w / BH * kB;
        mbar_wait(&kv_full[jc & 1], (jc >> 1) & 1);
      }
      const uint8_t* qs = sring + 2 * s * kQ;
      const float* sl = sstat + 2 * s * kStep;
      const float* sd = sl + kStep;
      const uint8_t* ks = skv + 2 * (jc & 1) * kKV;
      const uint64_t d_a = kdesc(ks + (wg == 0 ? 0 : kKV));  // K or V
      const uint64_t d_b = kdesc(qs + kQ - b_off);

      // S^T = K . Q^T (warpgroup 0) or dP^T = V . dO^T (warpgroup 1)
      float x[kStep / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_m64n64_t<0, 0>(x, kmajor(d_a, box_bytes(kB), kk),
                                kmajor(d_b, box_bytes(kStep), kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(x);

      // element i of the accumulator is key k0 + krow (+8 if i & 2),
      // query q0 + 8(i / 4) + t2 + (i & 1)
      if (wg == 0) {
        // ELEM: bit i set where score i survives the forward's masks (the
        // part's keys sit kTile-key-tile rows k0 % 128 + krow, +8)
        uint32_t keep_mask = 0u;
        if constexpr (ELEM) {
          const int kr = (k0 & (kTile - 1)) + krow;
          const uint32_t* b =
              keep_bits +
              (((int64_t)(w % BH) * n_qt * keep + step_sel[s]) * kTile +
               (q0 & (kTile - 1)) + t2) * 4 + (kr >> 5);
#pragma unroll
          for (int a = 0; a < 8; ++a)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const uint32_t word = b[(8 * a + c) * 4] >> (kr & 31);
              keep_mask |= ((word & 1u) << (4 * a + c)) |
                           (((word >> 8) & 1u) << (4 * a + 2 + c));
            }
        }
        // P^T = 2^(scale_log2 * S^T - lse2[query]), masked
        const int key = k0 + krow;
        const bool edge = causal && k0 + kB - 1 > q0 + q_offset;
#pragma unroll
        for (int i = 0; i < kStep / 2; ++i) {
          const int qc = (i >> 2) * 8 + t2 + (i & 1);
          float p = fast_exp2(x[i] * scale_log2 - sl[qc]);
          if constexpr (ELEM) {
            if (!((keep_mask >> i) & 1u)) p = 0.f;
          } else if (edge && key + ((i & 2) ? 8 : 0) > q0 + qc + q_offset) {
            p = 0.f;
          }
          x[i] = p;
        }
        if (n >= 1) mbar_wait(&p_empty, (n - 1) & 1);
#pragma unroll
        for (int c = 0; c < kStep / 8; ++c)
          sp4[c * 128 + tid] = make_float4(x[4 * c], x[4 * c + 1],
                                           x[4 * c + 2], x[4 * c + 3]);
        mbar_arrive(&p_full);
      } else {
        // dS^T = P^T * (dP^T - D[query]), P^T from warpgroup 0
        mbar_wait(&p_full, n & 1);
#pragma unroll
        for (int c = 0; c < kStep / 8; ++c) {
          const float4 p = sp4[c * 128 + tid];
          const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * c + e;
            x[i] = pv[e] * (x[i] - sd[(i >> 2) * 8 + t2 + (i & 1)]);
          }
        }
        mbar_arrive(&p_empty);
      }
      // the second product's A: P^T or dS^T in bf16, as the accumulator
      // stands
      uint32_t ra[kStep / 16][4];
#pragma unroll
      for (int kk = 0; kk < kStep / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          ra[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);

      // dV += P^T . dO (warpgroup 0) or dK += dS^T . Q (warpgroup 1), B
      // MN-major
      const uint64_t d_bt = mndesc(qs + b_off, box_bytes(kStep));
      fence_regs(acc);
      fence_regs(ra);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kStep / 16; ++kk)
        rs_step<D>(acc, ra[kk], mnmajor(d_bt, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&q_empty[s]);
    }
  }
}

// (c)'s tile in slot j of a q-tile's list: -1 where the slot is invalid or
// out of range, or (causal) every key of the tile lies after the q-tile's
// last row. The producer and the consumers skip the same slots.
__device__ __forceinline__ int dq_tile(const int64_t* ids, const uint8_t* ok,
                                       int j, int n_kt, int last_pos,
                                       int causal) {
  const int kt = selected(ids, ok, j, n_kt);
  return kt >= 0 && causal && kt * kTile > last_pos ? -1 : kt;
}

// S (or dP) = A . B^T over D for one KS-key stage, A and B K-major
template <int KS>
__device__ __forceinline__ void ss_kmajor(float (&d)[KS / 2], uint64_t da,
                                          uint64_t db, int accumulate) {
  if constexpr (KS == 128)
    wgmma_ss_m64n128(d, da, db, accumulate);
  else
    wgmma_ss_m64n64_t<0, 0>(d, da, db, accumulate);
}

// (c) dQ of one (bh, 128-row q-tile), over its valid slots in their order;
// first D and lse2 of its rows, which the dK/dV pass (run after it) reads.
// ELEM: the element mask, from the forward's keep bits (each thread's two
// rows of the slot, four words each, in place of the causal test). Each
// tile's keys arrive as 128 / KS stages (two 64-key parts at D = 192).
template <int D, bool ELEM>
__global__ void __launch_bounds__(kWgThreads, 1)
sufa_grad_q_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap,   // [BH, T, D], boxes of 128
    const __grid_constant__ CUtensorMap domap,  // [BH, T, D], boxes of 128
    const __grid_constant__ CUtensorMap kmap,   // [BH, S, D], boxes of KS
    const __grid_constant__ CUtensorMap vmap,   // [BH, S, D], boxes of KS
    const int64_t* __restrict__ idx, const uint8_t* __restrict__ valid,
    const uint16_t* __restrict__ o, const uint16_t* __restrict__ dout,
    const float* __restrict__ lse,  // [BH, T], natural base
    const uint32_t* __restrict__ keep_bits,  // ELEM: [BH, n_qt, keep, 128, 4]
    float* __restrict__ lse2, float* __restrict__ dvec,
    int* __restrict__ next_item,  // the dK/dV pass's counter, to 0
    uint16_t* __restrict__ dq, int T, int S, int keep, int causal,
    float scale, float scale_log2) {
  constexpr int KS = kv_rows<D>();    // keys per stage
  constexpr int kParts = kTile / KS;  // stages per tile
  constexpr int kStages = q_pass_stages<D>();
  constexpr int kTileB = tile_bytes<D>(kTile);
  constexpr int kStageB = tile_bytes<D>(KS);
  constexpr int kBox = box_bytes(kTile);
  constexpr int kKBox = box_bytes(KS);
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t qd_full;
  __shared__ __align__(8) uint64_t kv_full[kStages];
  __shared__ __align__(8) uint64_t kv_empty[kStages];

  uint8_t* const sq =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* const sdo = sq + kTileB;
  uint8_t* const sring = sdo + kTileB;  // stage s: K at sring + 2s·kStageB

  const int n_qt = gridDim.x;
  const int qt = causal ? n_qt - 1 - blockIdx.x : blockIdx.x;  // heaviest
  const int bh = blockIdx.y;
  const int q0 = qt * kTile;
  const int n_kt = S / kTile;
  const int q_offset = S - T;
  const int last_pos = q0 + kTile - 1 + q_offset;
  const int64_t* ids = idx + ((int64_t)bh * n_qt + qt) * keep;
  const uint8_t* ok = valid + ((int64_t)bh * n_qt + qt) * keep;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    mbar_init(&qd_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&kv_empty[s], kConsumers * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kConsumers * 4) {  // the producer warpgroup
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(&qd_full, 2 * kTileB);
      for (int c = 0; c < D / 64; ++c) {
        tma_load_3d(sq + c * kBox, &qmap, &qd_full, c * 64, q0, bh);
        tma_load_3d(sdo + c * kBox, &domap, &qd_full, c * 64, q0, bh);
      }
      int n = 0;
      for (int j = 0; j < keep; ++j) {
        const int kt = dq_tile(ids, ok, j, n_kt, last_pos, causal);
        if (kt < 0) continue;
        for (int h = 0; h < kParts; ++h, ++n) {
          const int s = n % kStages;
          if (n >= kStages) mbar_wait(&kv_empty[s], (n / kStages - 1) & 1);
          uint8_t* ks = sring + 2 * s * kStageB;
          mbar_expect_tx(&kv_full[s], 2 * kStageB);
          for (int c = 0; c < D / 64; ++c) {
            tma_load_3d(ks + c * kKBox, &kmap, &kv_full[s], c * 64,
                        kt * kTile + h * KS, bh);
            tma_load_3d(ks + kStageB + c * kKBox, &vmap, &kv_full[s],
                        c * 64, kt * kTile + h * KS, bh);
          }
        }
      }
    }
  } else {
    // a consumer warpgroup: 64 rows; this thread's rows are row, row + 8
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = warp >> 2;
    const int lane = threadIdx.x & 31;
    const int t2 = (lane & 3) * 2;
    const int wg_row0 = q0 + wg * 64;
    const int row = wg_row0 + (warp & 3) * 16 + (lane >> 2);
    const uint8_t* sq_wg = sq + wg * 64 * 128;  // its rows in every box
    const uint8_t* sdo_wg = sdo + wg * 64 * 128;
    const int64_t rbase = (int64_t)bh * T + row;
    if (threadIdx.x == 0 && blockIdx.x == 0 && bh == 0) *next_item = 0;
    // D = rowsum(dO * O) of the warp's 16 rows, one by one, each summed as
    // the prep kernel (a) sums it; each thread keeps its rows' and writes
    // them for the dK/dV pass with lse in base 2
    float dd[2], l2[2];
    const int64_t wrow0 = rbase - (lane >> 2);
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const uint16_t* op = o + (wrow0 + r) * D;
      const uint16_t* dp = dout + (wrow0 + r) * D;
      float sum = 0.f;
#pragma unroll
      for (int e = lane * 2; e < D; e += 64) {
        const uint32_t a = ld32(op + e), b = ld32(dp + e);
        sum += bf16_lo(a) * bf16_lo(b) + bf16_hi(a) * bf16_hi(b);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if ((r & 7) == (lane >> 2)) dd[r >> 3] = sum;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l2[h] = lse[rbase + 8 * h] * kLog2e;
      if ((lane & 3) == 0) {
        dvec[rbase + 8 * h] = dd[h];
        lse2[rbase + 8 * h] = l2[h];
      }
    }

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    mbar_wait(&qd_full, 0);

    int n = 0;
    for (int j = 0; j < keep; ++j) {
      const int kt = dq_tile(ids, ok, j, n_kt, last_pos, causal);
      if (kt < 0) continue;  // block-uniform
      // ELEM: slot j's keep words of rows row and row + 8
      uint4 kw[2];
      if constexpr (ELEM) {
        const uint32_t* b =
            keep_bits + ((((int64_t)bh * n_qt + qt) * keep + j) * kTile +
                         row - q0) * 4;
        kw[0] = *reinterpret_cast<const uint4*>(b);
        kw[1] = *reinterpret_cast<const uint4*>(b + 32);
      }
      for (int part = 0; part < kParts; ++part, ++n) {
        const int s = n % kStages;
        mbar_wait(&kv_full[s], (n / kStages) & 1);
        const uint8_t* ks = sring + 2 * s * kStageB;
        const uint8_t* vs = ks + kStageB;
        const int kv0 = kt * kTile + part * KS;

        // S = Q . K^T and dP = dO . V^T over D, two wgmma groups
        float sc[KS / 2], dp[KS / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int off = (kk & 3) * 32;
          ss_kmajor<KS>(sc, sw128_desc(sq_wg + (kk >> 2) * kBox + off, 16,
                                       1024),
                        sw128_desc(ks + (kk >> 2) * kKBox + off, 16, 1024),
                        kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int off = (kk & 3) * 32;
          ss_kmajor<KS>(dp, sw128_desc(sdo_wg + (kk >> 2) * kBox + off, 16,
                                       1024),
                        sw128_desc(vs + (kk >> 2) * kKBox + off, 16, 1024),
                        kk > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(sc);

        // P = 2^(scale_log2 * S - lse2[row]) while dP's product runs;
        // element i is row row (+8 if i & 2), key kv0 + 8(i / 4) + t2 +
        // (i & 1)
        const bool diag = causal && kv0 + KS - 1 > q_offset + wg_row0;
#pragma unroll
        for (int i = 0; i < KS / 2; ++i) {
          const int h = (i >> 1) & 1;
          float p = fast_exp2(sc[i] * scale_log2 - l2[h]);
          if constexpr (ELEM) {
            // key part·KS + 8 (i / 4) + t2 + (i & 1) of the tile: word
            // part·KS / 32 + i / 16 of row half h
            const int wi = part * (KS / 32) + (i >> 4);
            const uint32_t word = wi == 0   ? kw[h].x
                                  : wi == 1 ? kw[h].y
                                  : wi == 2 ? kw[h].z
                                            : kw[h].w;
            if (!((word >> (((i >> 2) & 3) * 8 + t2 + (i & 1))) & 1u))
              p = 0.f;
          } else if (diag && kv0 + (i >> 2) * 8 + t2 + (i & 1) >
                                 row + 8 * h + q_offset) {
            p = 0.f;
          }
          sc[i] = p;
        }
        wgmma_wait<0>();
        fence_regs(dp);
        // dS = P * (dP - D[row]) in bf16, the register A operand of dS . K
        uint32_t dsa[KS / 16][4];
#pragma unroll
        for (int kk = 0; kk < KS / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = 8 * kk + 2 * r;
            const float d = dd[(i >> 1) & 1];
            dsa[kk][r] = pack_bf16(sc[i] * (dp[i] - d),
                                   sc[i + 1] * (dp[i + 1] - d));
          }

        // dQ += dS . K, K MN-major: k16 step kk starts 16 keys (2048
        // bytes) in, the 64-column boxes kKBox apart
        fence_regs(acc);
        fence_regs(dsa);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KS / 16; ++kk)
          rs_step<D>(acc, dsa[kk], sw128_desc(ks + kk * 2048, kKBox, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive(&kv_empty[s]);
      }
    }

    uint16_t* out = dq + rbase * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      *reinterpret_cast<uint32_t*>(out + 8 * c + t2) =
          pack_bf16(acc[4 * c] * scale, acc[4 * c + 1] * scale);
      *reinterpret_cast<uint32_t*>(out + 8 * D + 8 * c + t2) =
          pack_bf16(acc[4 * c + 2] * scale, acc[4 * c + 3] * scale);
    }
  }
}

template <int D, bool ELEM>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const int64_t* idx, const uint8_t* valid,
                         const void* o, const void* lse, const void* dout,
                         void* dq, void* dk, void* dv, void* scratch,
                         const uint32_t* keep_bits, int BH, int T, int S,
                         int keep, int causal, float scale,
                         cudaStream_t stream) {
  constexpr bool kWide = D == 192;  // (b) is sufa_grad_kv_wgmma192_kernel
  static bool configured = false;  // the >48 KB opt-in, once per instance
  if (!configured) {
    cudaError_t err;
    if constexpr (kWide)
      err = cudaFuncSetAttribute(sufa_grad_kv_wgmma192_kernel<ELEM>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem_kv_wgmma_bytes<D>());
    else
      err = cudaFuncSetAttribute(sufa_grad_kv_wgmma_kernel<D, ELEM>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem_kv_wgmma_bytes<D>());
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(sufa_grad_q_wgmma_kernel<D, ELEM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_q_wgmma_bytes<D>());
    if (err != cudaSuccess) return err;
    configured = true;
  }
  static int sms = 0;  // the card's SMs: the persistent pass's grid
  if (!sms) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const int64_t rows = static_cast<int64_t>(BH) * T;
  float* dvec = static_cast<float*>(scratch);
  float* lse2 = dvec + rows;
  int* next_item = reinterpret_cast<int*>(lse2 + rows);
  const int n_items = BH * (S / kv_rows<D>());
  CUtensorMap qstep, dostep, qtile, dotile, kmap, vmap;
  if (!encode_rows_map(&qstep, q, BH, T, D, kStep) ||
      !encode_rows_map(&dostep, dout, BH, T, D, kStep) ||
      !encode_rows_map(&qtile, q, BH, T, D, kTile) ||
      !encode_rows_map(&dotile, dout, BH, T, D, kTile) ||
      !encode_rows_map(&kmap, k, BH, S, D, kv_rows<D>()) ||
      !encode_rows_map(&vmap, v, BH, S, D, kv_rows<D>()))
    return cudaErrorInvalidValue;
  const float scale_log2 = scale * kLog2e;

  sufa_grad_q_wgmma_kernel<D, ELEM><<<dim3(T / kTile, BH), kWgThreads,
                                      smem_q_wgmma_bytes<D>(), stream>>>(
      qtile, dotile, kmap, vmap, idx, valid,
      static_cast<const uint16_t*>(o), static_cast<const uint16_t*>(dout),
      static_cast<const float*>(lse), keep_bits, lse2, dvec, next_item,
      static_cast<uint16_t*>(dq), T, S, keep, causal, scale, scale_log2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int grid = n_items < sms ? n_items : sms;
  if constexpr (kWide)
    sufa_grad_kv_wgmma192_kernel<ELEM><<<grid, kWgThreads,
                                         smem_kv_wgmma_bytes<D>(), stream>>>(
        qstep, dostep, kmap, vmap, idx, valid, lse2, dvec, keep_bits,
        next_item, static_cast<uint16_t*>(dk), static_cast<uint16_t*>(dv),
        BH, T, S, keep, causal, scale, scale_log2);
  else
    sufa_grad_kv_wgmma_kernel<D, ELEM><<<grid, kWgThreads,
                                         smem_kv_wgmma_bytes<D>(), stream>>>(
        qstep, dostep, kmap, vmap, idx, valid, lse2, dvec, keep_bits,
        next_item, static_cast<uint16_t*>(dk), static_cast<uint16_t*>(dv),
        BH, T, S, keep, causal, scale, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// The mma.sync form, for any tiles block_q and block_kv that are multiples
// of 16 up to 128 (T, S their multiples). scratch: 2 * BH * T floats (D,
// then lse in base 2). keep_bits: null, or the forward's keep bits of the
// element mask ([BH, T / block_q, keep, block_q, ceil(block_kv / 32)]
// words, sufa.cu's keep_out), which then decide every key.
extern "C" int sufa_bwd_bf16(const void* q, const void* k, const void* v,
                             const void* idx, const void* valid,
                             const void* o, const void* lse, const void* dout,
                             void* dq, void* dk, void* dv, void* scratch,
                             const void* keep_bits, int BH, int T, int S,
                             int keep, int block_q, int block_kv, int D,
                             int causal, float scale, void* stream) {
  if (BH <= 0 || T <= 0 || S <= 0 || keep <= 0 || block_q <= 0 ||
      block_q > 128 || block_q % 16 || block_kv <= 0 || block_kv > 128 ||
      block_kv % 16 || T % block_q || S % block_kv)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* ip = static_cast<const int64_t*>(idx);
  const auto* vp = static_cast<const uint8_t*>(valid);
  const auto* bp = static_cast<const uint32_t*>(keep_bits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return static_cast<int>(launch_mma<64>(q, k, v, ip, vp, o, lse, dout, dq,
                                           dk, dv, scratch, bp, BH, T, S,
                                           keep, block_q, block_kv, causal,
                                           scale, s));
  if (D == 128)
    return static_cast<int>(launch_mma<128>(q, k, v, ip, vp, o, lse, dout, dq,
                                            dk, dv, scratch, bp, BH, T, S,
                                            keep, block_q, block_kv, causal,
                                            scale, s));
  if (D == 192)
    return static_cast<int>(launch_mma<192>(q, k, v, ip, vp, o, lse, dout, dq,
                                            dk, dv, scratch, bp, BH, T, S,
                                            keep, block_q, block_kv, causal,
                                            scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The wgmma form: tiles of 128 x 128 (T, S their multiples); the same
// operands and result as sufa_bwd_bf16, and one int more of scratch after
// its 2 * BH * T floats (the dK/dV pass's work counter).
extern "C" int sufa_bwd_wgmma_bf16(const void* q, const void* k,
                                   const void* v, const void* idx,
                                   const void* valid, const void* o,
                                   const void* lse, const void* dout,
                                   void* dq, void* dk, void* dv,
                                   void* scratch, const void* keep_bits,
                                   int BH, int T, int S, int keep, int D,
                                   int causal, float scale, void* stream) {
  if (BH <= 0 || T <= 0 || S <= 0 || keep <= 0 || T % kTile || S % kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* ip = static_cast<const int64_t*>(idx);
  const auto* vp = static_cast<const uint8_t*>(valid);
  const auto* bp = static_cast<const uint32_t*>(keep_bits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SUFA_BWD_WGMMA(DD, EE)                                               \
  if (D == DD && (bp != nullptr) == EE)                                      \
    return static_cast<int>(launch_wgmma<DD, EE>(q, k, v, ip, vp, o, lse,    \
                                                 dout, dq, dk, dv, scratch,  \
                                                 bp, BH, T, S, keep, causal, \
                                                 scale, s));
  SUFA_BWD_WGMMA(64, false)
  SUFA_BWD_WGMMA(128, false)
  SUFA_BWD_WGMMA(192, false)
  SUFA_BWD_WGMMA(64, true)
  SUFA_BWD_WGMMA(128, true)
  SUFA_BWD_WGMMA(192, true)
#undef SUFA_BWD_WGMMA
  return static_cast<int>(cudaErrorInvalidValue);
}
