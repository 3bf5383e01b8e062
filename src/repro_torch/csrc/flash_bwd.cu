// FlashAttention backward for Hopper (sm_90a): K4's gradient, for training.
//
// The TPU kernel (repro/kernels/flash.py::flash_attention) has no VJP: the
// reference trains through XLA's dense chunked softmax. The port's dense
// full-sequence attention runs K4 (flash.cu), so a trainer on the card
// needs K4's gradient. Given q, k, v [BH, T|S, D], the forward's output o
// and the output gradient dO [BH, T, D] (bf16), and the forward's fp32
// log-sum-exp lse [BH, T] (natural base; +inf on a row that sees no key),
// it returns dQ, dK, dV in bf16 with fp32 sums, for exactly the function
// K4 computes: causal at offset q_offset = S - T or not, any T and S (keys
// past S and rows past T masked), D 64 and 128.
//
// Three kernels, launched in order on the caller's stream, no atomics, so
// the gradient is the same bits on every run:
//   (a) prep: D_i = rowsum(dO_i * O_i) in fp32, and lse in base 2 (the
//       recompute's base), one warp per row;
//   (b) dK/dV: one block per (bh, 64-key tile), 4 warps of 16 keys each,
//       looping over the 32-row (D = 128) or 64-row (D = 64) query tiles
//       that see the tile. Per tile it recomputes S^T = K . Q^T, then
//       P^T = 2^(scale * log2(e) * S^T - lse2) (the forward's base-2
//       folding), dV += P^T . dO, dP^T = V . dO^T, dS^T = P^T * (dP^T - D)
//       and dK += dS^T . Q; dK is scaled once at the end;
//   (c) dQ: one block per (bh, 64-row query tile), 4 warps of 16 rows,
//       looping over its visible 64-key tiles: S, P, dP = dO . V^T, dS and
//       dQ += dS . K, scaled at the end.
// P is rounded to bf16 before P^T . dO and dS before dS^T . Q and dS . K
// (the mma operands); the softmax, D and dS are fp32.
//
// Bound: operations. The gradient needs 10 * D flops per visible (query,
// key) pair (five products: the recomputed S, dV, dP, dK, dQ); this
// design does 14 * D (S and dP are computed in both (b) and (c)). At the
// OLMo-1B training shape (BH 128, T = S = 2048, D 128, causal) that is
// 344 GFLOP of need against 134 MB of q, k, v, o, dO, dQ, dK, dV, far
// above the bf16 ridge.
//
// Design: the FA-2 backward on mma.sync (mma_bf16.cuh). Every product is
// an m16n8k16: the C fragments of S^T and dS^T are the A operand of the
// next product as they stand (two n8 tiles make one k16 step), so P and
// dS never leave registers. Tiles are staged in padded shared rows (D + 8
// halves) by plain 16-byte loads; B operands that run along the rows of a
// tile (dO and Q in (b), K in (c)) are read as column pairs. A causal key
// tile starts its loop at the first query tile that sees it, and a causal
// query tile stops at its last visible key tile.
//
// What was hard: the causal offset S - T and the rows with no visible key
// (the forward zeroes them): their lse is +inf, so 2^(s - inf) = 0 and
// they give nothing, and keys past S and rows past T are masked explicitly
// (their zero-filled rows would otherwise carry P = 2^(-lse)). The
// forward's base-2 softmax is matched by folding scale * log2(e) into the
// scores and recomputing P against lse * log2(e).
//
// Later work: wgmma + TMA (the forward's shape), one pass with dQ summed
// across key tiles (needs atomics or a reduction pass; atomics would lose
// the determinism the resume check relies on), and ldmatrix.trans for
// the column-pair operands.

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
bwd_prep_kernel(const uint16_t* __restrict__ o,
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

// (b) dK, dV for one (bh, 64-key tile).
template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                const uint16_t* __restrict__ v,
                const uint16_t* __restrict__ dout,
                const float* __restrict__ lse2,
                const float* __restrict__ dvec, uint16_t* __restrict__ dk,
                uint16_t* __restrict__ dv, int T, int S, int q_offset,
                int causal, float scale, float scale_log2) {
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
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t2 = (lane & 3) * 2;
  const int key0 = k0 + warp * 16 + (lane >> 2);  // rows of c0/c1; +8: c2/c3

  load_rows<D>(sk, k + (int64_t)bh * S * D, k0, kBK, S, false);
  load_rows<D>(sv, v + (int64_t)bh * S * D, k0, kBK, S, false);

  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_k[n][c] = acc_v[n][c] = 0.f;

  // the first query row that sees key k0
  const int q_first = causal ? max(0, k0 - q_offset) : 0;
  const int64_t qbase = (int64_t)bh * T;
  for (int q0 = (q_first / BQ) * BQ; q0 < T; q0 += BQ) {
    __syncthreads();  // the previous step is done with the Q / dO tiles
    load_rows<D>(sq, q + qbase * D, q0, BQ, T, false);
    load_rows<D>(sdo, dout + qbase * D, q0, BQ, T, false);
    for (int i = threadIdx.x; i < BQ; i += blockDim.x) {
      const bool in = q0 + i < T;
      sl[i] = in ? lse2[qbase + q0 + i] : __int_as_float(0x7f800000);
      sd[i] = in ? dvec[qbase + q0 + i] : 0.f;
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
        const bool ok = key < S && q0 + qi < T &&
                        (!causal || key <= q0 + qi + q_offset);
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

  const int64_t kbase = (int64_t)bh * S;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + t2;
    if (key0 < S) {
      *reinterpret_cast<uint32_t*>(dk + (kbase + key0) * D + col) =
          pack_bf16(acc_k[n][0] * scale, acc_k[n][1] * scale);
      *reinterpret_cast<uint32_t*>(dv + (kbase + key0) * D + col) =
          pack_bf16(acc_v[n][0], acc_v[n][1]);
    }
    if (key0 + 8 < S) {
      *reinterpret_cast<uint32_t*>(dk + (kbase + key0 + 8) * D + col) =
          pack_bf16(acc_k[n][2] * scale, acc_k[n][3] * scale);
      *reinterpret_cast<uint32_t*>(dv + (kbase + key0 + 8) * D + col) =
          pack_bf16(acc_v[n][2], acc_v[n][3]);
    }
  }
}

// (c) dQ for one (bh, 64-row query tile).
template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
              const uint16_t* __restrict__ v,
              const uint16_t* __restrict__ dout,
              const float* __restrict__ lse2, const float* __restrict__ dvec,
              uint16_t* __restrict__ dq, int T, int S, int q_offset,
              int causal, float scale, float scale_log2) {
  constexpr int LD = ld<D>();
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint16_t* sq = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* sdo = sq + kBQdq * LD;
  uint16_t* sk = sdo + kBQdq * LD;
  uint16_t* sv = sk + kBK * LD;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQdq;  // heaviest first
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t2 = (lane & 3) * 2;
  const int row0 = q0 + warp * 16 + (lane >> 2);  // c0/c1; +8: c2/c3
  const int64_t qbase = (int64_t)bh * T;

  load_rows<D>(sq, q + qbase * D, q0, kBQdq, T, false);
  load_rows<D>(sdo, dout + qbase * D, q0, kBQdq, T, false);
  const float inf = __int_as_float(0x7f800000);
  float l2[2], dd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    l2[h] = r < T ? lse2[qbase + r] : inf;
    dd[h] = r < T ? dvec[qbase + r] : 0.f;
  }

  int n_tiles = (S + kBK - 1) / kBK;
  if (causal) {
    const int last = q_offset + min(q0 + kBQdq, T) - 1;
    n_tiles = last < 0 ? 0 : min(n_tiles, last / kBK + 1);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * kBK;
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
        const int r = row0 + 8 * h;
        const bool ok = key < S && r < T && (!causal || key <= r + q_offset);
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

#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + t2;
    if (row0 < T)
      *reinterpret_cast<uint32_t*>(dq + (qbase + row0) * D + col) =
          pack_bf16(acc[n][0] * scale, acc[n][1] * scale);
    if (row0 + 8 < T)
      *reinterpret_cast<uint32_t*>(dq + (qbase + row0 + 8) * D + col) =
          pack_bf16(acc[n][2] * scale, acc[n][3] * scale);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* lse, const void* dout, void* dq, void* dk,
                   void* dv, void* scratch, int BH, int T, int S,
                   int q_offset, int causal, float scale,
                   cudaStream_t stream) {
  static bool configured = false;  // the >48 KB opt-in, once per instance
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_kv_bytes<D>());
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(bwd_dq_kernel<D>,
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

  bwd_prep_kernel<D><<<static_cast<unsigned>((rows + 7) / 8), 256, 0,
                       stream>>>(static_cast<const uint16_t*>(o), dob,
                                 static_cast<const float*>(lse), dvec, lse2,
                                 rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dkdv_kernel<D><<<dim3(BH, (S + kBK - 1) / kBK), kThreads,
                       smem_kv_bytes<D>(), stream>>>(
      qb, kb, vb, dob, lse2, dvec, static_cast<uint16_t*>(dk),
      static_cast<uint16_t*>(dv), T, S, q_offset, causal, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dq_kernel<D><<<dim3(BH, (T + kBQdq - 1) / kBQdq), kThreads,
                     smem_q_bytes<D>(), stream>>>(
      qb, kb, vb, dob, lse2, dvec, static_cast<uint16_t*>(dq), T, S,
      q_offset, causal, scale, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// scratch: 2 * BH * T floats (D, then lse in base 2).
extern "C" int flash_bwd_bf16(const void* q, const void* k, const void* v,
                              const void* o, const void* lse,
                              const void* dout, void* dq, void* dk, void* dv,
                              void* scratch, int BH, int T, int S, int D,
                              int q_offset, int causal, float scale,
                              void* stream) {
  if (BH <= 0 || T <= 0 || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return static_cast<int>(launch<64>(q, k, v, o, lse, dout, dq, dk, dv,
                                       scratch, BH, T, S, q_offset, causal,
                                       scale, s));
  if (D == 128)
    return static_cast<int>(launch<128>(q, k, v, o, lse, dout, dq, dk, dv,
                                        scratch, BH, T, S, q_offset, causal,
                                        scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
