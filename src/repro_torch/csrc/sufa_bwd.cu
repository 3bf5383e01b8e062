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
// Three kernels, launched in order on the caller's stream, no atomics, so
// the gradient is the same bits on every run (the restart check needs it):
//   (a) prep: D_i = rowsum(dO_i * O_i) in fp32, and lse in base 2, one warp
//       per row;
//   (b) dK/dV: one block per (bh, 64-key quarter or half of a key tile),
//       4 warps of 16 keys. It loads its K and V rows once and walks the
//       q-tiles that selected its key tile, in ascending order: it scans
//       the bh's selection itself (n_qt x keep ids, uniform loads), so no
//       inverse list is built. In each such q-tile it steps over 32-row
//       (D = 128) or 64-row (D = 64) query slices, skipping a slice that
//       lies wholly before its keys under the causal mask: S^T = K . Q^T,
//       P^T = 2^(scale * log2(e) * S^T - lse2), dV += P^T . dO, dP^T =
//       V . dO^T, dS^T = P^T * (dP^T - D), dK += dS^T . Q; dK is scaled
//       once at the end. A key tile that no q-tile chose writes zeros;
//   (c) dQ: one block per (bh, 64-row query slice), 4 warps of 16 rows,
//       walking its q-tile's keep slots in their given order, each valid
//       tile in 64-key steps (a step wholly after the slice's last row,
//       causal, skipped): S, P, dP = dO . V^T, dS and dQ += dS . K, scaled
//       at the end. A q-tile with no valid slot writes zeros.
// P is rounded to bf16 before P^T . dO and dS before dS^T . Q and dS . K
// (the mma operands); the softmax, D and dS are fp32.
//
// Bound: bytes, at the training shape. The gradient needs 10 * D flops per
// visible selected (query, key) pair (five products: the recomputed S, dV,
// dP, dK, dQ); this design does 14 * D (S and dP in both (b) and (c)). At
// OLMo-1B's training shape (BH 128, T = S = 2048, D 128, tiles 128, keep 4
// of 16) it must move about 537 MB (q, k, v, o, dO, dQ, dK, dV, 67 MB
// each), 0.160 ms at the card's memory rate. With every slot valid a head
// keeps 1 + 2 + 3 + 13 * 4 = 58 (q-tile, key tile) pairs of 128^2, about
// 0.95 M (query, key) pairs, 156 GFLOP over the 128 heads, 0.157 ms at the
// bf16 peak: the two about even. The glue's selection on chip_smoke.py's
// phase 21a inputs keeps 2787 of 8192 slots, 44.2 M pairs (57 GFLOP), so
// there the bytes bound it.
//
// Design: K4's first backward on mma.sync (mma_bf16.cuh), walking a
// selection instead of a range. Every product is an m16n8k16: the C
// fragments of S^T and dS^T are the A operand of the next product as they
// stand (two n8 tiles make one k16 step), so P and dS never leave
// registers. Tiles are staged in padded shared rows (D + 8 halves) by
// plain 16-byte loads; B operands that run along the rows of a tile (dO
// and Q in (b), K in (c)) are read as column pairs.
//
// What was hard: the scatter of dK and dV. Several q-tiles choose one key
// tile, and a pass per q-tile would have to add into shared rows across
// blocks (atomics, whose order changes the bits from run to run). Giving
// each key tile its own block, which finds its choosers by scanning the
// selection in a fixed order, keeps every sum inside one block. Rows with
// no visible key have lse = +inf, so 2^(s - inf) = 0 and they give nothing.
//
// Later work: wgmma + TMA (the forward's shape), dQ fused into the key-tile
// pass as K4's backward sums it (ordered per-tile counters), the element
// mask.

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
cudaError_t launch(const void* q, const void* k, const void* v,
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
    return static_cast<int>(launch<64>(q, k, v, ip, vp, o, lse, dout, dq, dk,
                                       dv, scratch, BH, T, S, keep, block_q,
                                       block_kv, causal, scale, s));
  if (D == 128)
    return static_cast<int>(launch<128>(q, k, v, ip, vp, o, lse, dout, dq,
                                        dk, dv, scratch, BH, T, S, keep,
                                        block_q, block_kv, causal, scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
