// FlashAttention forward for Hopper (sm_90a): the dense prefill.
//
// Replaces repro/kernels/flash.py::flash_attention (body _flash_kernel):
// softmax(scale * Q . K^T) . V over q [BH, T, D] and k/v [BH, S, D],
// causal or not, with the causal mask at offset q_offset = S - T, FA-2's
// per-tile max refresh and rescale, and fp32 statistics; P is rounded to
// bf16 before P . V and the output o / max(l, 1e-30) is written in bf16.
// Unlike the TPU kernel, T and S need not be multiples of the tile: rows
// past T are not written and keys past S are masked, so every T the model
// hands it (prompt + generated tokens) is served. Rows that see no key
// (T > S, causal) are zero.
//
// Bound: operations. Each call must read Q, K and V and write O once
// (4 * BH * T * D bytes at T = S) and do 4 * D flops per visible
// (query, key) pair: at the OLMo-1B served shape (BH 16, T = S = 2048,
// D 128, causal) that is 33.6 MB against 17.2 GFLOP, far above the bf16
// ridge. Only wgmma reaches Hopper's tensor-core rate, so both products
// run on it, fed by TMA so that no thread spends time on the copies.
//
// Design (the FA-3 shape, without its ping-pong scheduling):
//   * One block per (bh, 128-row query tile): two consumer warpgroups of
//     64 rows each and one producer warp (288 threads, so the consumers
//     may use up to 224 registers without setmaxnreg).
//   * The producer's lane 0 loads the Q tile once and then K and V tiles
//     of 128 keys (64 at D = 192) into a 2-stage ring in dynamic shared
//     memory (160 KB at D = 128, 145 KB at D = 192) with TMA, handing
//     each tile over on full mbarriers (K and V apart, so Q . K^T starts
//     before V lands) and reusing a stage once
//     all 256 consumer threads arrived on its empty mbarrier. Tiles of
//     128 keys (not 64) halve the hand-offs and the per-tile softmax
//     overhead; 64 + 64 + 32 registers of S, O and P still fit.
//   * S = Q . K^T: wgmma m64n128k16, both operands K-major in shared
//     memory. O += P . V: wgmma m64nDk16 with P, converted to bf16 from
//     S's accumulator (the same quad layout as mma.sync's C and A), as the
//     register A operand and V as an MN-major B read through the transpose
//     bit.
//   * Softmax online in fp32 on the accumulator fragments, in base 2:
//     scale * log2(e) is folded into one multiply and exp is ex2.approx.
//     Against exp(scale * s - m) this adds one fp32 rounding of the
//     product scale * log2(e) (relative 6e-8 of the exponent) and ex2's
//     2^-22 relative error, both far below the bf16 output's 2^-8.
//   * Causal: key tiles wholly above the diagonal are not loaded; only
//     tiles that cross the diagonal or the key edge S are masked. Query
//     tiles launch heaviest first (blockIdx.y counts down), so the
//     longest blocks start in the first wave and the tail is short.
//   * Ragged edges: 3-D tensor maps over [BH, rows, D] give zero fill past
//     a head's last row, so a tile never reads the next head; keys >= S
//     are masked as well, and rows >= T are not stored (guarded register
//     stores).
//   * The kernel allocates nothing and launches on the caller's stream;
//     the C entry point encodes the tensor maps (cuTensorMapEncodeTiled,
//     from libcuda: -lcuda) and returns cudaGetLastError().
//
// What was hard: with CU_TENSOR_MAP_SWIZZLE_128B a box is at most 64 bf16
// wide, so at D = 128 every tile arrives as two 64-column boxes; the
// wgmma descriptors (hopper.cuh) step through them (K-major: +32 bytes
// per k16 step inside a box, next box for k >= 64; MN-major V: LBO = the
// box size between the two 64-wide halves of d, SBO = 1024 bytes between
// 8-key groups).
//
// D = 192 (Nemotron-4-340B's head): a 128-row tile is three boxes, 48 KB,
// so the Q tile and a 2-stage ring of 128-key K and V tiles would need
// 241 KB, above the 227 KB a block may have. At D = 192 the K/V stages
// hold 64 keys (kv_rows<192>() = 64; 145 KB in all, FA-3 also narrows its
// key tile at this head dim): S = Q . K^T runs as m64n64 products, and
// O += P . V as m64n192 ones (96 fp32 accumulators a thread beside S's 32
// and P's 16 registers). The softmax is exact under any key tiling, so
// only the order of the fp32 sums changes. The P . V product is picked by
// hopper.cuh's rs_step<D>, which does not compile for a D it has no
// product for.
//
// Later work: ping-pong the two consumer warpgroups and overlap the
// softmax with the next Q . K^T (FA-3); split-S for short T, where BH x
// ceil(T / 128) blocks leave SMs idle.

#include <cuda.h>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace star;

constexpr int kBQ = 128;         // query rows per block
constexpr int kStages = 2;       // K/V ring depth
constexpr int kConsumers = 2;    // warpgroups of 64 query rows
constexpr int kThreads = kConsumers * 128 + 32;  // + one producer warp

// keys per K/V tile: 128, or 64 at D = 192, where 128-key stages do not
// fit the 227 KB of shared memory a block may have
template <int D>
__host__ __device__ constexpr int kv_rows() {
  static_assert(D == 64 || D == 128 || D == 192, "flash: head dim not built");
  return D > 128 ? 64 : 128;
}

template <int D>
__host__ __device__ constexpr int smem_bytes() {  // Q, K/V ring, alignment
  return tile_bytes<D>(kBQ) + 2 * kStages * tile_bytes<D>(kv_rows<D>()) +
         1024;
}

// S (+)= Q . K^T for one k16 step over a tile of N keys (128 or 64)
template <int N>
__device__ __forceinline__ void ss_step(float (&d)[N / 2], uint64_t da,
                                        uint64_t db, int accumulate) {
  if constexpr (N == 128)
    wgmma_ss_m64n128(d, da, db, accumulate);
  else
    wgmma_ss_m64n64_t<0, 0>(d, da, db, accumulate);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel(const __grid_constant__ CUtensorMap qmap,   // [BH, T, D]
             const __grid_constant__ CUtensorMap kmap,   // [BH, S, D]
             const __grid_constant__ CUtensorMap vmap,   // [BH, S, D]
             uint16_t* __restrict__ out,                 // [BH, T, D]
             float* __restrict__ lse,                    // [BH, T] or null
             int T, int S, int q_offset, int causal, float scale_log2) {
  constexpr int kBC = kv_rows<D>();          // keys per K/V tile
  constexpr int kQTile = tile_bytes<D>(kBQ);
  constexpr int kTile = tile_bytes<D>(kBC);  // one K or V tile
  constexpr int kQBox = box_bytes(kBQ);      // 64 columns of the Q tile
  constexpr int kBox = box_bytes(kBC);       // 64 columns of a K/V tile
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full;
  __shared__ __align__(8) uint64_t k_full[kStages];
  __shared__ __align__(8) uint64_t v_full[kStages];
  __shared__ __align__(8) uint64_t kv_empty[kStages];

  // swizzled boxes need 1024-byte aligned shared addresses
  uint8_t* const sq =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* const skv = sq + kQTile;  // stage s: K at skv + 2s·kTile, V after

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest first
  int n_tiles = (S + kBC - 1) / kBC;
  if (causal) {
    const int last = q_offset + min(q0 + kBQ, T) - 1;
    n_tiles = last < 0 ? 0 : min(n_tiles, last / kBC + 1);
  }
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&kv_empty[s], kConsumers * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumers * 4) {  // the producer warp: lane 0 loads by TMA
    if ((threadIdx.x & 31) == 0) {
      mbar_expect_tx(&q_full, kQTile);
      for (int c = 0; c < D / 64; ++c)
        tma_load_3d(sq + c * kQBox, &qmap, &q_full, c * 64, q0, bh);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&kv_empty[s], (j / kStages - 1) & 1);
        uint8_t* ks = skv + 2 * s * kTile;
        mbar_expect_tx(&k_full[s], kTile);
        for (int c = 0; c < D / 64; ++c)
          tma_load_3d(ks + c * kBox, &kmap, &k_full[s], c * 64, j * kBC, bh);
        mbar_expect_tx(&v_full[s], kTile);
        for (int c = 0; c < D / 64; ++c)
          tma_load_3d(ks + kTile + c * kBox, &vmap, &v_full[s], c * 64,
                      j * kBC, bh);
      }
    }
    return;
  }

  // a consumer warpgroup: 64 query rows; this thread's rows are row, row + 8
  const int wg = warp >> 2;
  const int lane = threadIdx.x & 31;
  const int t2 = (lane & 3) * 2;
  const int wg_row0 = q0 + wg * 64;
  const int row = wg_row0 + (warp & 3) * 16 + (lane >> 2);
  const uint8_t* sq_wg = sq + wg * 64 * 128;  // its rows in every Q box

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  mbar_wait(&q_full, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    const uint8_t* ks = skv + 2 * s * kTile;
    const uint8_t* vs = ks + kTile;

    // S = Q . K^T over D in k16 steps; step kk sits in box kk / 4
    float sc[kBC / 2];
    mbar_wait(&k_full[s], parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int in_box = (kk & 3) * 32;
      ss_step<kBC>(sc,
                   sw128_desc(sq_wg + (kk >> 2) * kQBox + in_box, 16, 1024),
                   sw128_desc(ks + (kk >> 2) * kBox + in_box, 16, 1024),
                   kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

#pragma unroll
    for (int i = 0; i < kBC / 2; ++i) sc[i] *= scale_log2;
    const int kv0 = j * kBC;
    // warpgroup-uniform: does this tile cross S or the diagonal of its rows?
    if (kv0 + kBC > S || (causal && kv0 + kBC - 1 > q_offset + wg_row0)) {
#pragma unroll
      for (int i = 0; i < kBC / 2; ++i) {
        const int col = kv0 + (i >> 2) * 8 + t2 + (i & 1);
        const int qpos = q_offset + row + ((i & 2) ? 8 : 0);
        if (col >= S || (causal && col > qpos)) sc[i] = kNegInf;
      }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < kBC / 2; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float alpha[2], base[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], quad_max(mx[h]));
      // m = NEG_INF: alpha = 0 (o and l are 0 then anyway)
      alpha[h] = fast_exp2(m[h] - m_new);
      m[h] = m_new;
      // a row with no visible key yet: every score is NEG_INF, p = 0
      base[h] = m_new <= kNegInf / 2 ? 0.f : m_new;
    }
    float row_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kBC / 2; ++i) {
      const int h = (i >> 1) & 1;
      sc[i] = fast_exp2(sc[i] - base[h]);
      row_sum[h] += sc[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + row_sum[h];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

    // P in bf16 as wgmma's register A operand, k16 step kk = keys 16kk..
    uint32_t pa[kBC / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBC / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
    }

    // O += P . V; V's k16 step kk starts 16 rows (2048 bytes) in
    mbar_wait(&v_full[s], parity);
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBC / 16; ++kk)
      rs_step<D>(o, pa[kk], sw128_desc(vs + kk * 2048, kBox, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(&kv_empty[s]);
  }

  const float s0 = quad_sum(l[0]);
  const float s1 = quad_sum(l[1]);
  const float l0 = fmaxf(s0, 1e-30f);
  const float l1 = fmaxf(s1, 1e-30f);
  if (lse != nullptr && (lane & 3) == 0) {  // m and the sums: quad-wide
    constexpr float kLn2 = 0.6931471805599453f;
    const float inf = __int_as_float(0x7f800000);
    const int64_t at = (int64_t)bh * T + row;
    if (row < T) lse[at] = s0 > 0.f ? (m[0] + log2f(s0)) * kLn2 : inf;
    if (row + 8 < T) lse[at + 8] = s1 > 0.f ? (m[1] + log2f(s1)) * kLn2 : inf;
  }
  uint16_t* ob = out + ((int64_t)bh * T + row) * D + t2;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (row < T)
      *reinterpret_cast<uint32_t*>(ob + n * 8) =
          pack_bf16(o[4 * n] / l0, o[4 * n + 1] / l0);
    if (row + 8 < T)
      *reinterpret_cast<uint32_t*>(ob + 8 * D + n * 8) =
          pack_bf16(o[4 * n + 2] / l1, o[4 * n + 3] / l1);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int BH, int T, int S, int q_offset, int causal,
                   float scale, cudaStream_t stream) {
  static bool configured = false;  // the >48 KB opt-in, once per instance
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes<D>());
    if (err != cudaSuccess) return err;
    configured = true;
  }
  CUtensorMap qmap, kmap, vmap;
  if (!encode_rows_map(&qmap, q, BH, T, D, kBQ) ||
      !encode_rows_map(&kmap, k, BH, S, D, kv_rows<D>()) ||
      !encode_rows_map(&vmap, v, BH, S, D, kv_rows<D>()))
    return cudaErrorInvalidValue;
  const dim3 grid(BH, (T + kBQ - 1) / kBQ);
  flash_kernel<D><<<grid, kThreads, smem_bytes<D>(), stream>>>(
      qmap, kmap, vmap, static_cast<uint16_t*>(out), lse, T, S, q_offset,
      causal,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

// lse: null, or [BH, T] fp32 for the row log-sum-exps.
extern "C" int flash_bf16(const void* q, const void* k, const void* v,
                          void* out, void* lse, int BH, int T, int S, int D,
                          int q_offset, int causal, float scale,
                          void* stream) {
  if (BH <= 0 || T <= 0 || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return static_cast<int>(
        launch<64>(q, k, v, out, static_cast<float*>(lse), BH, T, S,
                   q_offset, causal, scale, s));
  if (D == 128)
    return static_cast<int>(
        launch<128>(q, k, v, out, static_cast<float*>(lse), BH, T, S,
                    q_offset, causal, scale, s));
  if (D == 192)
    return static_cast<int>(
        launch<192>(q, k, v, out, static_cast<float*>(lse), BH, T, S,
                    q_offset, causal, scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
