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
// dK, dV in bf16 with fp32 sums. Tiles Bq = block_q and Bc = block_kv of
// 64 or 128 (T, S their multiples), D 64 and 128. The element-level sphere
// mask (STARConfig(elementwise=True)) is not covered: the wrapper refuses
// it (kernels/sufa.py).
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
//   * Other tiles (64 x 64, 64 x 128, 128 x 64): mma.sync (mma_bf16.cuh),
//     three kernels of 4 warps a block: (a) prep, D = rowsum(dO * O) in
//     fp32 and lse in base 2, one warp per row; (b) one block per (bh, 64
//     keys of a key tile) that scans the selection itself and steps over
//     32-row (D = 128) or 64-row (D = 64) query slices; (c) one block per
//     (bh, 64-row query slice) stepping over each valid tile in 64-key
//     steps. Tiles are staged in padded shared rows (D + 8 halves) by plain
//     16-byte loads; the C fragments of S^T and dS^T are the A operand of
//     the next product as they stand, and B operands that run along the
//     rows of a tile are read as column pairs.
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
// Later work: ping-pong scheduling of the consumer warpgroups, a (b) that
// splits the sink's long walk, and the element mask.

#include <cuda.h>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace star;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBK = 64;          // keys per dK/dV block, and per dQ step
constexpr int kBQdq = 64;        // query rows per dQ block
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
__host__ __device__ constexpr int bq_kv() {  // query rows per dK/dV step
  return D == 128 ? 32 : 64;
}

template <int D>
__host__ __device__ constexpr int ld() {
  return D + 8;
}

template <int D>
__host__ __device__ constexpr int smem_kv_bytes() {  // K, V, Q, dO, lse, D
  return (2 * kBK + 2 * bq_kv<D>()) * ld<D>() * 2 + 2 * bq_kv<D>() * 4;
}

template <int D>
__host__ __device__ constexpr int smem_q_bytes() {  // Q, dO, K, V
  return (2 * kBQdq + 2 * kBK) * ld<D>() * 2;
}

// Tile j of a q-tile's list, or -1 where it is invalid or out of range
// (as sufa.cu's forward skips it).
__device__ __forceinline__ int selected(const int64_t* ids,
                                        const uint8_t* ok, int j, int n_kt) {
  const int64_t kt = ids[j];
  return ok[j] && kt >= 0 && kt < n_kt ? static_cast<int>(kt) : -1;
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

// (b) dK, dV for one (bh, 64 keys of a key tile), over the q-tiles that
// selected the tile.
template <int D>
__global__ void __launch_bounds__(kThreads)
sufa_grad_kv_kernel(const uint16_t* __restrict__ q,
                    const uint16_t* __restrict__ k,
                    const uint16_t* __restrict__ v,
                    const int64_t* __restrict__ idx,
                    const uint8_t* __restrict__ valid,
                    const uint16_t* __restrict__ dout,
                    const float* __restrict__ lse2,
                    const float* __restrict__ dvec, uint16_t* __restrict__ dk,
                    uint16_t* __restrict__ dv, int T, int S, int keep,
                    int block_q, int block_kv, int causal, float scale,
                    float scale_log2) {
  constexpr int LD = ld<D>();
  constexpr int BQ = bq_kv<D>();
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint16_t* sk = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* sv = sk + kBK * LD;
  uint16_t* sq = sv + kBK * LD;
  uint16_t* sdo = sq + BQ * LD;
  float* sl = reinterpret_cast<float*>(sdo + BQ * LD);
  float* sd = sl + BQ;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBK;
  const int kt = k0 / block_kv;
  const int n_qt = T / block_q;
  const int n_kt = S / block_kv;
  const int q_offset = S - T;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t2 = (lane & 3) * 2;
  const int key0 = k0 + warp * 16 + (lane >> 2);  // rows of c0/c1; +8: c2/c3
  const int64_t* ids = idx + (int64_t)bh * n_qt * keep;
  const uint8_t* oks = valid + (int64_t)bh * n_qt * keep;

  load_rows<D>(sk, k + (int64_t)bh * S * D, k0, kBK, S, false);
  load_rows<D>(sv, v + (int64_t)bh * S * D, k0, kBK, S, false);

  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_k[n][c] = acc_v[n][c] = 0.f;

  const int64_t qbase = (int64_t)bh * T;
  // the q-tiles that chose this key tile, in ascending order (a slot that
  // names it twice counts twice, as the forward visits it twice)
  for (int qt = 0; qt < n_qt; ++qt) {
    for (int j = 0; j < keep; ++j) {
      if (selected(ids + qt * keep, oks + qt * keep, j, n_kt) != kt)
        continue;  // block-uniform
      for (int q0 = qt * block_q; q0 < (qt + 1) * block_q; q0 += BQ) {
        // causal: no row of the slice sees a key of this block
        if (causal && q0 + BQ - 1 + q_offset < k0) continue;
        __syncthreads();  // the previous step is done with the Q / dO tiles
        load_rows<D>(sq, q + qbase * D, q0, BQ, T, false);
        load_rows<D>(sdo, dout + qbase * D, q0, BQ, T, false);
        for (int i = threadIdx.x; i < BQ; i += blockDim.x) {
          sl[i] = lse2[qbase + q0 + i];
          sd[i] = dvec[qbase + q0 + i];
        }
        __syncthreads();

        // P^T = 2^(scale_log2 * K . Q^T - lse2), masked
        float st[BQ / 8][4];
        rows_dot<D, BQ>(st, sk, warp * 16, sq, lane);
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int qi = n * 8 + t2 + (c & 1);
            const int key = key0 + ((c & 2) ? 8 : 0);
            const bool ok = !causal || key <= q0 + qi + q_offset;
            st[n][c] = ok ? fast_exp2(st[n][c] * scale_log2 - sl[qi]) : 0.f;
          }
        // dV += P^T . dO
        p_dot<D, BQ>(acc_v, st, sdo, lane);
        // dS^T = P^T * (V . dO^T - D)
        float dpt[BQ / 8][4];
        rows_dot<D, BQ>(dpt, sv, warp * 16, sdo, lane);
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            st[n][c] *= dpt[n][c] - sd[n * 8 + t2 + (c & 1)];
        // dK += dS^T . Q
        p_dot<D, BQ>(acc_k, st, sq, lane);
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

// (c) dQ for one (bh, 64-row query slice), over its q-tile's valid slots.
template <int D>
__global__ void __launch_bounds__(kThreads)
sufa_grad_q_kernel(const uint16_t* __restrict__ q,
                   const uint16_t* __restrict__ k,
                   const uint16_t* __restrict__ v,
                   const int64_t* __restrict__ idx,
                   const uint8_t* __restrict__ valid,
                   const uint16_t* __restrict__ dout,
                   const float* __restrict__ lse2,
                   const float* __restrict__ dvec, uint16_t* __restrict__ dq,
                   int T, int S, int keep, int block_q, int block_kv,
                   int causal, float scale, float scale_log2) {
  constexpr int LD = ld<D>();
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint16_t* sq = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* sdo = sq + kBQdq * LD;
  uint16_t* sk = sdo + kBQdq * LD;
  uint16_t* sv = sk + kBK * LD;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBQdq;
  const int qt = q0 / block_q;
  const int n_qt = T / block_q;
  const int n_kt = S / block_kv;
  const int q_offset = S - T;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t2 = (lane & 3) * 2;
  const int row0 = q0 + warp * 16 + (lane >> 2);  // c0/c1; +8: c2/c3
  const int64_t qbase = (int64_t)bh * T;
  const int64_t* ids = idx + ((int64_t)bh * n_qt + qt) * keep;
  const uint8_t* oks = valid + ((int64_t)bh * n_qt + qt) * keep;

  load_rows<D>(sq, q + qbase * D, q0, kBQdq, T, false);
  load_rows<D>(sdo, dout + qbase * D, q0, kBQdq, T, false);
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
    for (int kv0 = kt * block_kv; kv0 < (kt + 1) * block_kv; kv0 += kBK) {
      // causal: every key of the step lies after the slice's last row
      if (causal && kv0 > q_offset + q0 + kBQdq - 1) continue;
      __syncthreads();  // the previous step is done with the K / V tiles
      load_rows<D>(sk, k + (int64_t)bh * S * D, kv0, kBK, S, false);
      load_rows<D>(sv, v + (int64_t)bh * S * D, kv0, kBK, S, false);
      __syncthreads();

      float p[kBK / 8][4];
      rows_dot<D, kBK>(p, sq, warp * 16, sk, lane);
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = kv0 + n * 8 + t2 + (c & 1);
          const int h = (c >> 1) & 1;
          const bool ok = !causal || key <= row0 + 8 * h + q_offset;
          p[n][c] = ok ? fast_exp2(p[n][c] * scale_log2 - l2[h]) : 0.f;
        }
      float dp[kBK / 8][4];
      rows_dot<D, kBK>(dp, sdo, warp * 16, sv, lane);
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) p[n][c] *= dp[n][c] - dd[(c >> 1) & 1];
      // dQ += dS . K
      p_dot<D, kBK>(acc, p, sk, lane);
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

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                   const int64_t* idx, const uint8_t* valid, const void* o,
                   const void* lse, const void* dout, void* dq, void* dk,
                   void* dv, void* scratch, int BH, int T, int S, int keep,
                   int block_q, int block_kv, int causal, float scale,
                   cudaStream_t stream) {
  static bool configured = false;  // the >48 KB opt-in, once per instance
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        sufa_grad_kv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_kv_bytes<D>());
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(sufa_grad_q_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_q_bytes<D>());
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int64_t rows = static_cast<int64_t>(BH) * T;
  float* dvec = static_cast<float*>(scratch);
  float* lse2 = dvec + rows;
  const auto* qb = static_cast<const uint16_t*>(q);
  const auto* kb = static_cast<const uint16_t*>(k);
  const auto* vb = static_cast<const uint16_t*>(v);
  const auto* dob = static_cast<const uint16_t*>(dout);
  const float scale_log2 = scale * kLog2e;

  sufa_grad_prep_kernel<D><<<static_cast<unsigned>((rows + 7) / 8), 256, 0,
                             stream>>>(static_cast<const uint16_t*>(o), dob,
                                       static_cast<const float*>(lse), dvec,
                                       lse2, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sufa_grad_kv_kernel<D><<<dim3(BH, S / kBK), kThreads, smem_kv_bytes<D>(),
                           stream>>>(
      qb, kb, vb, idx, valid, dob, lse2, dvec, static_cast<uint16_t*>(dk),
      static_cast<uint16_t*>(dv), T, S, keep, block_q, block_kv, causal,
      scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sufa_grad_q_kernel<D><<<dim3(BH, T / kBQdq), kThreads, smem_q_bytes<D>(),
                          stream>>>(
      qb, kb, vb, idx, valid, dob, lse2, dvec, static_cast<uint16_t*>(dq), T,
      S, keep, block_q, block_kv, causal, scale, scale_log2);
  return cudaGetLastError();
}

// -- the wgmma form: 128 x 128 tiles ------------------------------------------

constexpr int kTile = 128;       // query rows and keys per tile
constexpr int kStep = 64;        // query rows per dK/dV step
constexpr int kConsumers = 2;    // warpgroups of 64 keys (b) or rows (c)
constexpr int kWgThreads = (kConsumers + 1) * 128;  // + a producer warpgroup
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// (b)'s ring of 64-row Q/dO steps and (c)'s ring of K/V tiles: as deep as
// shared memory allows beside (b)'s two K/V buffers and (c)'s Q and dO
template <int D>
__host__ __device__ constexpr int kv_pass_stages() {
  return D == 128 ? 3 : 8;
}

template <int D>
__host__ __device__ constexpr int q_pass_stages() {
  return D == 128 ? 2 : 4;
}

template <int D>
__host__ __device__ constexpr int smem_kv_wgmma_bytes() {
  // two K, V buffers; per stage Q, dO and their lse2 / D slices; alignment
  return 4 * tile_bytes<D>(kTile) +
         kv_pass_stages<D>() * (2 * tile_bytes<D>(kStep) + 2 * kStep * 4) +
         1024;
}

template <int D>
__host__ __device__ constexpr int smem_q_wgmma_bytes() {
  // Q, dO; per stage K, V; alignment
  return (2 + 2 * q_pass_stages<D>()) * tile_bytes<D>(kTile) + 1024;
}

// (b) dK, dV of 128-key tiles, each over the 64-row steps of the q-tiles
// that chose it. A persistent block takes (bh, key tile) items from a
// counter, key tile by key tile (every head's tile 0, then tile 1, ...):
// under causal STAR the low tiles are the most chosen (the sink by every
// q-tile), so the longest walks start first.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
sufa_grad_kv_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap,   // [BH, T, D], boxes of 64
    const __grid_constant__ CUtensorMap domap,  // [BH, T, D], boxes of 64
    const __grid_constant__ CUtensorMap kmap,   // [BH, S, D], boxes of 128
    const __grid_constant__ CUtensorMap vmap,   // [BH, S, D], boxes of 128
    const int64_t* __restrict__ idx, const uint8_t* __restrict__ valid,
    const float* __restrict__ lse2,  // [BH, T]
    const float* __restrict__ dvec,  // [BH, T]
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
            const int qt = (base + __ffs(hits) - 1) / keep;
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
        if (edge && key + ((i & 2) ? 8 : 0) > q0 + qc + q_offset) p = 0.f;
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

// (c)'s tile in slot j of a q-tile's list: -1 where the slot is invalid or
// out of range, or (causal) every key of the tile lies after the q-tile's
// last row. The producer and the consumers skip the same slots.
__device__ __forceinline__ int dq_tile(const int64_t* ids, const uint8_t* ok,
                                       int j, int n_kt, int last_pos,
                                       int causal) {
  const int kt = selected(ids, ok, j, n_kt);
  return kt >= 0 && causal && kt * kTile > last_pos ? -1 : kt;
}

// (c) dQ of one (bh, 128-row q-tile), over its valid slots in their order;
// first D and lse2 of its rows, which the dK/dV pass (run after it) reads.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
sufa_grad_q_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap,   // [BH, T, D], boxes of 128
    const __grid_constant__ CUtensorMap domap,  // [BH, T, D], boxes of 128
    const __grid_constant__ CUtensorMap kmap,   // [BH, S, D], boxes of 128
    const __grid_constant__ CUtensorMap vmap,   // [BH, S, D], boxes of 128
    const int64_t* __restrict__ idx, const uint8_t* __restrict__ valid,
    const uint16_t* __restrict__ o, const uint16_t* __restrict__ dout,
    const float* __restrict__ lse,  // [BH, T], natural base
    float* __restrict__ lse2, float* __restrict__ dvec,
    int* __restrict__ next_item,  // the dK/dV pass's counter, to 0
    uint16_t* __restrict__ dq, int T, int S, int keep, int causal,
    float scale, float scale_log2) {
  constexpr int kStages = q_pass_stages<D>();
  constexpr int kTileB = tile_bytes<D>(kTile);
  constexpr int kBox = box_bytes(kTile);
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t qd_full;
  __shared__ __align__(8) uint64_t kv_full[kStages];
  __shared__ __align__(8) uint64_t kv_empty[kStages];

  uint8_t* const sq =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* const sdo = sq + kTileB;
  uint8_t* const sring = sdo + kTileB;  // stage s: K at sring + 2s·kTileB

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
        const int s = n % kStages;
        if (n >= kStages) mbar_wait(&kv_empty[s], (n / kStages - 1) & 1);
        uint8_t* ks = sring + 2 * s * kTileB;
        mbar_expect_tx(&kv_full[s], 2 * kTileB);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_3d(ks + c * kBox, &kmap, &kv_full[s], c * 64, kt * kTile,
                      bh);
          tma_load_3d(ks + kTileB + c * kBox, &vmap, &kv_full[s], c * 64,
                      kt * kTile, bh);
        }
        ++n;
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
      const int s = n % kStages;
      mbar_wait(&kv_full[s], (n / kStages) & 1);
      ++n;
      const uint8_t* ks = sring + 2 * s * kTileB;
      const uint8_t* vs = ks + kTileB;
      const int kv0 = kt * kTile;

      // S = Q . K^T and dP = dO . V^T over D, two wgmma groups
      float sc[kTile / 2], dp[kTile / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk >> 2) * kBox + (kk & 3) * 32;
        wgmma_ss_m64n128(sc, sw128_desc(sq_wg + off, 16, 1024),
                         sw128_desc(ks + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk >> 2) * kBox + (kk & 3) * 32;
        wgmma_ss_m64n128(dp, sw128_desc(sdo_wg + off, 16, 1024),
                         sw128_desc(vs + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);

      // P = 2^(scale_log2 * S - lse2[row]) while dP's product runs;
      // element i is row row (+8 if i & 2), key kv0 + 8(i / 4) + t2 + (i & 1)
      const bool diag = causal && kv0 + kTile - 1 > q_offset + wg_row0;
#pragma unroll
      for (int i = 0; i < kTile / 2; ++i) {
        const int h = (i >> 1) & 1;
        float p = fast_exp2(sc[i] * scale_log2 - l2[h]);
        if (diag && kv0 + (i >> 2) * 8 + t2 + (i & 1) > row + 8 * h + q_offset)
          p = 0.f;
        sc[i] = p;
      }
      wgmma_wait<0>();
      fence_regs(dp);
      // dS = P * (dP - D[row]) in bf16, the register A operand of dS . K
      uint32_t dsa[kTile / 16][4];
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 8 * kk + 2 * r;
          const float d = dd[(i >> 1) & 1];
          dsa[kk][r] = pack_bf16(sc[i] * (dp[i] - d),
                                 sc[i + 1] * (dp[i + 1] - d));
        }

      // dQ += dS . K, K MN-major: k16 step kk starts 16 keys (2048 bytes) in
      fence_regs(acc);
      fence_regs(dsa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk)
        rs_step<D>(acc, dsa[kk], sw128_desc(ks + kk * 2048, kBox, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&kv_empty[s]);
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

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const int64_t* idx, const uint8_t* valid,
                         const void* o, const void* lse, const void* dout,
                         void* dq, void* dk, void* dv, void* scratch, int BH,
                         int T, int S, int keep, int causal, float scale,
                         cudaStream_t stream) {
  static bool configured = false;  // the >48 KB opt-in, once per instance
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        sufa_grad_kv_wgmma_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv_wgmma_bytes<D>());
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(sufa_grad_q_wgmma_kernel<D>,
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
  const int n_items = BH * (S / kTile);
  CUtensorMap qstep, dostep, qtile, dotile, kmap, vmap;
  if (!encode_rows_map(&qstep, q, BH, T, D, kStep) ||
      !encode_rows_map(&dostep, dout, BH, T, D, kStep) ||
      !encode_rows_map(&qtile, q, BH, T, D, kTile) ||
      !encode_rows_map(&dotile, dout, BH, T, D, kTile) ||
      !encode_rows_map(&kmap, k, BH, S, D, kTile) ||
      !encode_rows_map(&vmap, v, BH, S, D, kTile))
    return cudaErrorInvalidValue;
  const float scale_log2 = scale * kLog2e;

  sufa_grad_q_wgmma_kernel<D><<<dim3(T / kTile, BH), kWgThreads,
                                smem_q_wgmma_bytes<D>(), stream>>>(
      qtile, dotile, kmap, vmap, idx, valid,
      static_cast<const uint16_t*>(o), static_cast<const uint16_t*>(dout),
      static_cast<const float*>(lse), lse2, dvec, next_item,
      static_cast<uint16_t*>(dq), T, S, keep, causal, scale, scale_log2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sufa_grad_kv_wgmma_kernel<D><<<n_items < sms ? n_items : sms, kWgThreads,
                                 smem_kv_wgmma_bytes<D>(), stream>>>(
      qstep, dostep, kmap, vmap, idx, valid, lse2, dvec, next_item,
      static_cast<uint16_t*>(dk), static_cast<uint16_t*>(dv), BH, T, S, keep,
      causal, scale, scale_log2);
  return cudaGetLastError();
}

bool good_tile(int b) { return b == 64 || b == 128; }

}  // namespace

// scratch: 2 * BH * T floats (D, then lse in base 2). Tiles of 64 or 128.
extern "C" int sufa_bwd_bf16(const void* q, const void* k, const void* v,
                             const void* idx, const void* valid,
                             const void* o, const void* lse, const void* dout,
                             void* dq, void* dk, void* dv, void* scratch,
                             int BH, int T, int S, int keep, int block_q,
                             int block_kv, int D, int causal, float scale,
                             void* stream) {
  if (BH <= 0 || T <= 0 || S <= 0 || keep <= 0 || !good_tile(block_q) ||
      !good_tile(block_kv) || T % block_q || S % block_kv)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* ip = static_cast<const int64_t*>(idx);
  const auto* vp = static_cast<const uint8_t*>(valid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return static_cast<int>(launch_mma<64>(q, k, v, ip, vp, o, lse, dout, dq, dk,
                                       dv, scratch, BH, T, S, keep, block_q,
                                       block_kv, causal, scale, s));
  if (D == 128)
    return static_cast<int>(launch_mma<128>(q, k, v, ip, vp, o, lse, dout, dq,
                                        dk, dv, scratch, BH, T, S, keep,
                                        block_q, block_kv, causal, scale, s));
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
                                   void* scratch, int BH, int T, int S,
                                   int keep, int D, int causal, float scale,
                                   void* stream) {
  if (BH <= 0 || T <= 0 || S <= 0 || keep <= 0 || T % kTile || S % kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* ip = static_cast<const int64_t*>(idx);
  const auto* vp = static_cast<const uint8_t*>(valid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return static_cast<int>(launch_wgmma<64>(q, k, v, ip, vp, o, lse, dout,
                                             dq, dk, dv, scratch, BH, T, S,
                                             keep, causal, scale, s));
  if (D == 128)
    return static_cast<int>(launch_wgmma<128>(q, k, v, ip, vp, o, lse, dout,
                                              dq, dk, dv, scratch, BH, T, S,
                                              keep, causal, scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
