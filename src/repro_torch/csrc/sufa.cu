// SU-FA (sorted-updating block-sparse flash attention) for Hopper (sm_90a):
// stage 3 of the STAR prefill.
//
// Replaces repro/kernels/sufa.py::sufa_attention (body _sufa_kernel). Each
// query tile attends to the `keep` key/value tiles that SADS selected for
// it, in the given (descending predicted-max) order. The TPU kernel takes
// those tiles gathered beforehand with an int8 mask, because its static
// BlockSpecs cannot follow tile ids; this kernel takes the ids and reads
// the selected tiles of K and V in place:
//   idx [BH, n_qt, keep] int64 tile ids, valid [BH, n_qt, keep] bool.
// Key idx * Bc + c is visible to query row r of q-tile qt iff the tile is
// valid and, when causal, idx * Bc + c <= (S - T) + qt * Bq + r: the mask
// the glue's gather built (repro/kernels/ops.py). A tile with valid = false
// changes nothing in either mode, so it is neither loaded nor computed; an
// id outside [0, S / Bc) is skipped the same way.
//
// STRICT = true is FA-2's online rescale (exact in any order); STRICT =
// false freezes each row's running max at the first tile in which that row
// sees a key and drops the rescale, the paper's descend-updating fast path,
// as _sufa_kernel does. Statistics are fp32; the output o / l is written
// in bf16 (rows that see no key are zero).
//
// Bound: bytes at the served shape. Each call must read Q, the distinct
// selected K and V tiles and the ids once and write the output: at OLMo-1B
// (BH 16, T = S = 2048, tiles 128, keep 4) at most 4 x 8.4 MB, against
// 4 * D flops per visible (query, key) pair (about 4.3 GFLOP), below the
// bf16 ridge. Reading in place drops the gathered copies (2 x 33.5 MB) and
// the mask (16.8 MB) that the gathered contract had to write and read.
//
// Two forms, chosen by shape alone (kernels/sufa.py):
//   * Bq = Bc = 128 (the served tiles): warp-specialised, modelled on
//     flash.cu. One block per (bh, q-tile): a producer warp whose lane 0
//     reads the tile ids, TMA-loads the Q tile once and each valid K and
//     V tile at row idx * 128 of a 3-D tensor map over [BH, S, D] into a
//     2-stage mbarrier ring; two consumer warpgroups of 64 rows run
//     S = Q . K^T (wgmma, both operands in shared memory) and O += P . V
//     (wgmma, P from registers, V MN-major), the softmax in base 2 with
//     scale * log2(e) folded into one multiply. The consumers walk the
//     same ids to know each stage's tile for the causal mask, which they
//     apply only where a tile crosses their rows' diagonal. Causal
//     q-tiles launch heaviest first.
//   * Other tiles (any multiple of 16 up to 128; the pool probe's 16):
//     mma.sync, one block per (bh, q-tile) of block_q / 16 warps that own
//     16 rows each; a valid tile's K rows are staged in shared memory,
//     S = Q . K^T runs over the whole tile (the frozen max needs the whole
//     first tile's maximum), then its V rows take the same buffer for
//     P . V with P rounded to bf16.
//
// The element-level sphere mask (STARConfig(elementwise=True); the
// reference applies it in repro/core/star_attention.py::star_attention)
// drops every key whose DLZS estimate A = bf16(bf16(q . pow2(k)) * scale)
// lies below bf16(row max - radius), the row max taken over the visible
// keys of the valid tiles, on top of the causal mask; the estimates are
// rounded as the plain form (dlzs.dlzs_scores in the model dtype) rounds
// them. Each estimate is an fp32 sum of exact bf16 x power-of-two
// products, so it matches the plain form up to the order of that sum.
// Both forms carry it (ELEM):
//   * wgmma (128 x 128 tiles): a first sweep over the same tile ids has
//     the producer TMA-load only the K tiles; the consumers copy each
//     landed K stage into a pow2(K) stage (sign and exponent bits, an
//     elementwise mask, so the 128-byte swizzle stays valid), fence the
//     writes against wgmma's async proxy and meet at a named barrier;
//     E = Q . pow2(K)^T runs on wgmma and each row keeps its largest
//     visible estimate in registers. The ids repeat in the second sweep,
//     so its K loads are L2 hits. There each K stage is copied to pow2
//     the same way and E runs before S = Q . K^T, so the estimates become
//     a 64-bit keep mask per thread (causal mask folded in) before S's
//     accumulators go live: register pressure stays that of the
//     tile-level form (166 registers, no spill; a variant that tested the
//     sphere on the fp32 sums against a per-row bound found by bisection,
//     with no per-key rounding, spilled 892 bytes at D = 128 and ran 30%
//     slower). The copy goes to its own 2-stage ring (a consumer may
//     still read stage n's pow2(K) while another writes stage n + 1's),
//     224 KB of shared memory in all at D = 128.
//   * mma.sync (other tiles): the first sweep stages pow2(K) with the
//     copy; the second stages pow2(K) once more after each tile's S.
// D is 64 or 128. The kernels allocate nothing and launch on the caller's
// stream; the C entry points return cudaGetLastError() (the wgmma form
// encodes its tensor maps with libcuda's cuTensorMapEncodeTiled: -lcuda).

#include <cuda.h>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace star;

// -- the wgmma form: 128 x 128 tiles ------------------------------------------

constexpr int kBQ = 128;         // query rows per block
constexpr int kBC = 128;         // keys per K/V tile
constexpr int kStages = 2;       // K/V ring depth
constexpr int kConsumers = 2;    // warpgroups of 64 query rows
constexpr int kConsumerThreads = kConsumers * 128;
constexpr int kThreads = kConsumerThreads + 32;  // + one producer warp
constexpr int kBoxBytes = 128 * 128;  // one 128-row x 64-col bf16 box
constexpr int kPow2Barrier = 1;  // named barrier of the consumer threads

template <int D>
__host__ __device__ constexpr int tile_bytes() {
  return (D / 64) * kBoxBytes;
}

// Q, the K/V ring, with ELEM the pow2(K) ring, and alignment
template <int D, bool ELEM>
__host__ __device__ constexpr int smem_bytes() {
  return tile_bytes<D>() * (1 + (ELEM ? 3 : 2) * kStages) + 1024;
}

// Tile j of a q-tile's list, or -1 where it is invalid or out of range.
__device__ __forceinline__ int selected(const int64_t* ids,
                                        const uint8_t* ok, int j, int n_kt) {
  const int64_t kt = ids[j];
  return ok[j] && kt >= 0 && kt < n_kt ? static_cast<int>(kt) : -1;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// The plain form's DLZS estimate of one score from its fp32 sum q . pow2(k):
// rounded to bf16, scaled, rounded again (bf16 tensor times a float).
__device__ __forceinline__ float dlzs_estimate(float dot, float scale) {
  return round_bf16(round_bf16(dot) * scale);
}

// ELEM: copy a landed K stage into its pow2(K) stage (sign and exponent
// bits of every bf16; byte offsets, and so the swizzle, unchanged), fence
// the writes against wgmma's async-proxy reads, and meet the other
// consumer threads, whose copies E reads too.
template <int D>
__device__ __forceinline__ void stage_pow2(const uint8_t* ks, uint8_t* ps) {
  const uint4* src = reinterpret_cast<const uint4*>(ks);
  uint4* dst = reinterpret_cast<uint4*>(ps);
#pragma unroll
  for (int i = 0; i < tile_bytes<D>() / 16 / kConsumerThreads; ++i) {
    const int c = threadIdx.x + i * kConsumerThreads;
    uint4 x = src[c];
    x.x &= 0xFF80FF80u;
    x.y &= 0xFF80FF80u;
    x.z &= 0xFF80FF80u;
    x.w &= 0xFF80FF80u;
    dst[c] = x;
  }
  fence_proxy_async();
  named_barrier_sync(kPow2Barrier, kConsumerThreads);
}

// acc = (the warpgroup's 64 rows of the Q tile) . (a K-major 128-key
// tile)^T over D in k16 steps; step kk sits in box kk / 4.
template <int D>
__device__ __forceinline__ void qk_wgmma(float (&acc)[kBC / 2],
                                         const uint8_t* sq_wg,
                                         const uint8_t* ks) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk >> 2) * kBoxBytes + (kk & 3) * 32;
    wgmma_ss_m64n128(acc, sw128_desc(sq_wg + off, 16, 1024),
                     sw128_desc(ks + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

template <int D, bool STRICT, bool ELEM>
__global__ void __launch_bounds__(kThreads, 1)
sufa_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,  // [BH, T, D]
                  const __grid_constant__ CUtensorMap kmap,  // [BH, S, D]
                  const __grid_constant__ CUtensorMap vmap,  // [BH, S, D]
                  const int64_t* __restrict__ idx,   // [BH, n_qt, keep]
                  const uint8_t* __restrict__ valid,  // [BH, n_qt, keep]
                  uint16_t* __restrict__ out,         // [BH, T, D]
                  int S, int keep, int q_offset, int causal,
                  float scale_log2, float scale, float radius) {
  constexpr int kTile = tile_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full;
  __shared__ __align__(8) uint64_t k_full[kStages];
  __shared__ __align__(8) uint64_t v_full[kStages];
  __shared__ __align__(8) uint64_t kv_empty[kStages];

  // swizzled boxes need 1024-byte aligned shared addresses
  uint8_t* const sq =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* const skv = sq + kTile;  // stage s: K at skv + 2s·kTile, V after
  uint8_t* const sp2 = skv + 2 * kStages * kTile;  // ELEM: pow2(K) stage s

  const int bh = blockIdx.x;
  const int n_qt = gridDim.y;
  const int qt = causal ? n_qt - 1 - blockIdx.y : blockIdx.y;  // heaviest
  const int q0 = qt * kBQ;
  const int T = n_qt * kBQ;
  const int n_kt = S / kBC;
  const int64_t* ids = idx + ((int64_t)bh * n_qt + qt) * keep;
  const uint8_t* ok = valid + ((int64_t)bh * n_qt + qt) * keep;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&kv_empty[s], kConsumerThreads);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumers * 4) {  // the producer warp: lane 0 loads by TMA
    if ((threadIdx.x & 31) == 0) {
      mbar_expect_tx(&q_full, kTile);
      for (int c = 0; c < D / 64; ++c)
        tma_load_3d(sq + c * kBoxBytes, &qmap, &q_full, c * 64, q0, bh);
      int n = 0;  // tiles loaded so far, over both sweeps
      // ELEM's first sweep loads K tiles only (v_full's phases count the
      // second sweep's tiles alone)
      for (int sweep = ELEM ? 0 : 1; sweep < 2; ++sweep) {
        for (int j = 0; j < keep; ++j) {
          const int kt = selected(ids, ok, j, n_kt);
          if (kt < 0) continue;
          const int s = n % kStages;
          if (n >= kStages) mbar_wait(&kv_empty[s], (n / kStages - 1) & 1);
          uint8_t* ks = skv + 2 * s * kTile;
          mbar_expect_tx(&k_full[s], kTile);
          for (int c = 0; c < D / 64; ++c)
            tma_load_3d(ks + c * kBoxBytes, &kmap, &k_full[s], c * 64,
                        kt * kBC, bh);
          if (sweep == 1) {
            mbar_expect_tx(&v_full[s], kTile);
            for (int c = 0; c < D / 64; ++c)
              tma_load_3d(ks + kTile + c * kBoxBytes, &vmap, &v_full[s],
                          c * 64, kt * kBC, bh);
          }
          ++n;
        }
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

  int n = 0;  // tiles consumed so far: the ring position
  // ELEM: each row's sphere edge, bf16(max of its visible estimates -
  // radius), from a first sweep over the valid tiles
  float edge[2] = {kNegInf, kNegInf};
  if constexpr (ELEM) {
    float top[2] = {kNegInf, kNegInf};
    for (int j = 0; j < keep; ++j) {
      const int kt = selected(ids, ok, j, n_kt);
      if (kt < 0) continue;
      const int s = n % kStages;
      mbar_wait(&k_full[s], (n / kStages) & 1);
      ++n;
      stage_pow2<D>(skv + 2 * s * kTile, sp2 + s * kTile);
      mbar_arrive(&kv_empty[s]);  // the K stage is copied: reload it
      float e[kBC / 2];
      qk_wgmma<D>(e, sq_wg, sp2 + s * kTile);
      const int kv0 = kt * kBC;
      const bool diag = causal && kv0 + kBC - 1 > q_offset + wg_row0;
#pragma unroll
      for (int i = 0; i < kBC / 2; ++i) {
        const int col = kv0 + (i >> 2) * 8 + t2 + (i & 1);
        const int qpos = q_offset + row + ((i & 2) ? 8 : 0);
        if (!(diag && col > qpos))
          top[(i >> 1) & 1] =
              fmaxf(top[(i >> 1) & 1], dlzs_estimate(e[i], scale));
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      edge[h] = round_bf16(quad_max(top[h]) - radius);
  }

  const int n1 = n;  // the first sweep's tiles
  for (int j = 0; j < keep; ++j) {
    const int kt = selected(ids, ok, j, n_kt);
    if (kt < 0) continue;
    const int s = n % kStages;
    const uint32_t parity = (n / kStages) & 1;
    // v_full[s] completes once per second-sweep tile of stage s
    const uint32_t v_parity = ((n - n1) / kStages) & 1;
    ++n;
    const uint8_t* ks = skv + 2 * s * kTile;
    const uint8_t* vs = ks + kTile;
    const int kv0 = kt * kBC;
    // warpgroup-uniform: does this tile cross the diagonal of its rows?
    const bool diag = causal && kv0 + kBC - 1 > q_offset + wg_row0;

    float sc[kBC / 2];
    mbar_wait(&k_full[s], parity);
    if constexpr (ELEM) {
      // the keys that survive the causal and the element mask, bit i for
      // sc[i]: the estimates are done before S's accumulators go live
      uint32_t keep_bits[2] = {0u, 0u};
      {
        stage_pow2<D>(ks, sp2 + s * kTile);
        float e[kBC / 2];
        qk_wgmma<D>(e, sq_wg, sp2 + s * kTile);
#pragma unroll
        for (int i = 0; i < kBC / 2; ++i) {
          const int col = kv0 + (i >> 2) * 8 + t2 + (i & 1);
          const int qpos = q_offset + row + ((i & 2) ? 8 : 0);
          if (!(diag && col > qpos) &&
              dlzs_estimate(e[i], scale) >= edge[(i >> 1) & 1])
            keep_bits[i >> 5] |= 1u << (i & 31);
        }
      }
      qk_wgmma<D>(sc, sq_wg, ks);
#pragma unroll
      for (int i = 0; i < kBC / 2; ++i)
        sc[i] = (keep_bits[i >> 5] >> (i & 31)) & 1u ? sc[i] * scale_log2
                                                      : kNegInf;
    } else {
      // S = Q . K^T
      qk_wgmma<D>(sc, sq_wg, ks);
#pragma unroll
      for (int i = 0; i < kBC / 2; ++i) sc[i] *= scale_log2;
      if (diag) {
#pragma unroll
        for (int i = 0; i < kBC / 2; ++i) {
          const int col = kv0 + (i >> 2) * 8 + t2 + (i & 1);
          const int qpos = q_offset + row + ((i & 2) ? 8 : 0);
          if (col > qpos) sc[i] = kNegInf;
        }
      }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < kBC / 2; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float alpha[2], base[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float tile_max = quad_max(mx[h]);
      if (STRICT) {
        const float m_new = fmaxf(m[h], tile_max);
        // m = NEG_INF: alpha = 0 (o and l are 0 then anyway)
        alpha[h] = fast_exp2(m[h] - m_new);
        m[h] = m_new;
      } else {
        // descend updating: the max set by the row's first visible tile
        // is final, and nothing is rescaled. alpha is 1, or 0 while the
        // row has seen no key (o and l are 0 then): multiplying by it
        // changes no value, but keeps this form's code the strict one's
        // shape, whose wgmma products ptxas does not serialise (with
        // alpha = 1 it spilled and serialised them, warning C7512)
        alpha[h] = m[h] <= kNegInf / 2 ? 0.f : 1.f;
        if (m[h] <= kNegInf / 2) m[h] = tile_max;
      }
      // a row with no visible key yet: every score is NEG_INF, p = 0
      base[h] = m[h] <= kNegInf / 2 ? 0.f : m[h];
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
    mbar_wait(&v_full[s], v_parity);
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBC / 16; ++kk) {
      const uint64_t db = sw128_desc(vs + kk * 2048, kBoxBytes, 1024);
      if constexpr (D == 128)
        wgmma_rs_m64n128(o, pa[kk], db);
      else
        wgmma_rs_m64n64(o, pa[kk], db);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(&kv_empty[s]);
  }

  const float l0 = fmaxf(quad_sum(l[0]), 1e-30f);
  const float l1 = fmaxf(quad_sum(l[1]), 1e-30f);
  uint16_t* ob = out + ((int64_t)bh * T + row) * D + t2;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    *reinterpret_cast<uint32_t*>(ob + c * 8) =
        pack_bf16(o[4 * c] / l0, o[4 * c + 1] / l0);
    *reinterpret_cast<uint32_t*>(ob + 8 * D + c * 8) =
        pack_bf16(o[4 * c + 2] / l1, o[4 * c + 3] / l1);
  }
}

template <int D, bool STRICT, bool ELEM>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const int64_t* idx, const uint8_t* valid, void* out,
                         int BH, int T, int S, int keep, int causal,
                         float scale, float radius, cudaStream_t stream) {
  static bool configured = false;  // the >48 KB opt-in, once per instance
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        sufa_wgmma_kernel<D, STRICT, ELEM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<D, ELEM>());
    if (err != cudaSuccess) return err;
    configured = true;
  }
  CUtensorMap qmap, kmap, vmap;
  if (!encode_rows_map(&qmap, q, BH, T, D, kBQ) ||
      !encode_rows_map(&kmap, k, BH, S, D, kBC) ||
      !encode_rows_map(&vmap, v, BH, S, D, kBC))
    return cudaErrorInvalidValue;
  const dim3 grid(BH, T / kBQ);
  sufa_wgmma_kernel<D, STRICT, ELEM>
      <<<grid, kThreads, smem_bytes<D, ELEM>(), stream>>>(
          qmap, kmap, vmap, idx, valid, static_cast<uint16_t*>(out), S,
          keep, S - T, causal, scale * 1.4426950408889634f, scale, radius);
  return cudaGetLastError();
}

// -- the mma.sync form: any tile that is a multiple of 16 up to 128 -----------

constexpr int kMaxTile = 128;

template <int D, int BC, bool STRICT, bool ELEM>
__global__ void __launch_bounds__(256)
sufa_mma_kernel(const uint16_t* __restrict__ q,      // [BH, T, D]
                const uint16_t* __restrict__ k,      // [BH, S, D]
                const uint16_t* __restrict__ v,      // [BH, S, D]
                const int64_t* __restrict__ idx,     // [BH, n_qt, keep]
                const uint8_t* __restrict__ valid,   // [BH, n_qt, keep]
                uint16_t* __restrict__ out,          // [BH, T, D]
                int S, int keep, int block_q, int causal, float scale,
                float radius) {
  constexpr int LD = D + 8;
  constexpr int NT = BC / 8;  // 8-key score tiles
  __shared__ __align__(16) uint16_t tile[kMaxTile * LD];
  const int qt = blockIdx.x;
  const int bh = blockIdx.y;
  const int n_qt = gridDim.x;
  const int T = n_qt * block_q;
  const int n_kt = S / BC;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;
  const int row = warp * 16 + g;  // this thread's rows: row and row + 8
  // query position of row: the queries are the last T of the S positions
  const int qpos = S - T + qt * block_q + row;
  const int64_t* ids = idx + ((int64_t)bh * n_qt + qt) * keep;
  const uint8_t* ok = valid + ((int64_t)bh * n_qt + qt) * keep;
  const uint16_t* kb = k + (int64_t)bh * S * D;
  const uint16_t* vb = v + (int64_t)bh * S * D;

  load_rows<D>(tile, q + (int64_t)bh * T * D, qt * block_q, block_q, T, false);
  __syncthreads();
  uint32_t a[D / 16][4];
  load_a_frags<D, LD>(a, tile, warp * 16, lane);

  // ELEM: each row's sphere edge, bf16(max of its visible estimates -
  // radius), from a first sweep over the valid tiles with pow2(K) staged
  float edge[2] = {kNegInf, kNegInf};
  if constexpr (ELEM) {
    float top[2] = {kNegInf, kNegInf};
    for (int j = 0; j < keep; ++j) {
      const int kt = selected(ids, ok, j, n_kt);
      if (kt < 0) continue;  // block-uniform
      const int kv0 = kt * BC;
      __syncthreads();  // every warp is done with the previous tile
      load_rows<D>(tile, kb, kv0, BC, S, true);
      __syncthreads();
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float e[4];
        qk_tile<D, LD>(e, a, tile, nt * 8, lane);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qp = qpos + (i >= 2 ? 8 : 0);
          const int col = kv0 + nt * 8 + t2 + (i & 1);
          if (!(causal && col > qp))
            top[i >> 1] = fmaxf(top[i >> 1], dlzs_estimate(e[i], scale));
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      edge[h] = round_bf16(quad_max(top[h]) - radius);
  }

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int j = 0; j < keep; ++j) {
    const int kt = selected(ids, ok, j, n_kt);
    if (kt < 0) continue;  // block-uniform
    const int kv0 = kt * BC;
    __syncthreads();  // every warp is done with the previous V tile
    load_rows<D>(tile, kb, kv0, BC, S, false);
    __syncthreads();
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) qk_tile<D, LD>(s[nt], a, tile, nt * 8, lane);
    if constexpr (ELEM) {  // pow2(K) of the same tile, for the estimates
      __syncthreads();
      load_rows<D>(tile, kb, kv0, BC, S, true);
      __syncthreads();
    }

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float e[4];
      if constexpr (ELEM) qk_tile<D, LD>(e, a, tile, nt * 8, lane);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qp = qpos + (i >= 2 ? 8 : 0);
        const int col = kv0 + nt * 8 + t2 + (i & 1);
        bool drop = causal && col > qp;
        if constexpr (ELEM)
          drop = drop || dlzs_estimate(e[i], scale) < edge[i >> 1];
        const float x = drop ? kNegInf : s[nt][i] * scale;
        s[nt][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float tile_max = quad_max(mx[h]);
      if (STRICT) {
        const float m_new = fmaxf(m[h], tile_max);
        alpha[h] = m[h] <= kNegInf / 2 ? 0.f : __expf(m[h] - m_new);
        m[h] = m_new;
      } else {
        // descend updating: the max set by the first visible tile is final
        if (m[h] <= kNegInf / 2) m[h] = tile_max;
        alpha[h] = 1.f;
      }
    }
    float row_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = s[nt][i];
        const float p = x <= kNegInf / 2 ? 0.f : __expf(x - m[i >> 1]);
        s[nt][i] = p;
        row_sum[i >> 1] += p;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + row_sum[h];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    __syncthreads();  // every warp is done with the K tile
    load_rows<D>(tile, vb, kv0, BC, S, false);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const uint16_t* vp = tile + (kk * 16 + t2) * LD + g;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        mma_16816(o[n], pa, ld_col_pair(vp + n * 8, LD),
                  ld_col_pair(vp + 8 * LD + n * 8, LD));
    }
  }

  const float l0 = fmaxf(quad_sum(l[0]), 1e-30f);
  const float l1 = fmaxf(quad_sum(l[1]), 1e-30f);
  uint16_t* ob = out + ((int64_t)bh * T + qt * block_q + row) * D + t2;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<uint32_t*>(ob + n * 8) =
        pack_bf16(o[n][0] / l0, o[n][1] / l0);
    *reinterpret_cast<uint32_t*>(ob + 8 * D + n * 8) =
        pack_bf16(o[n][2] / l1, o[n][3] / l1);
  }
}

template <int D, int BC>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const int64_t* idx, const uint8_t* valid, void* out,
                       int BH, int T, int S, int keep, int block_q,
                       int causal, bool strict, bool elementwise, float scale,
                       float radius, cudaStream_t stream) {
  const dim3 grid(T / block_q, BH);
  const dim3 block(block_q / 16 * 32);
  const uint16_t* qp = static_cast<const uint16_t*>(q);
  const uint16_t* kp = static_cast<const uint16_t*>(k);
  const uint16_t* vp = static_cast<const uint16_t*>(v);
  uint16_t* op = static_cast<uint16_t*>(out);
#define SUFA_MMA(SS, EE)                                                     \
  if (strict == SS && elementwise == EE)                                    \
    sufa_mma_kernel<D, BC, SS, EE><<<grid, block, 0, stream>>>(              \
        qp, kp, vp, idx, valid, op, S, keep, block_q, causal, scale, radius);
  SUFA_MMA(true, false)
  SUFA_MMA(false, false)
  SUFA_MMA(true, true)
  SUFA_MMA(false, true)
#undef SUFA_MMA
  return cudaGetLastError();
}

bool bad_shape(int BH, int T, int S, int keep, int block_q, int block_kv) {
  return BH <= 0 || T <= 0 || S <= 0 || keep <= 0 || block_q <= 0 ||
         block_q > kMaxTile || block_q % 16 || block_kv <= 0 ||
         block_kv > kMaxTile || block_kv % 16 || T % block_q ||
         S % block_kv;
}

}  // namespace

// elementwise != 0 runs the element-level sphere mask at radius (ELEM).
extern "C" int sufa_wgmma_bf16(const void* q, const void* k, const void* v,
                               const void* idx, const void* valid, void* out,
                               int BH, int T, int S, int keep, int D,
                               int causal, int strict, int elementwise,
                               float scale, float radius, void* stream) {
  if (bad_shape(BH, T, S, keep, kBQ, kBC))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t* ip = static_cast<const int64_t*>(idx);
  const uint8_t* vp = static_cast<const uint8_t*>(valid);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SUFA_WGMMA(DD, SS, EE)                                              \
  if (D == DD && (strict != 0) == SS && (elementwise != 0) == EE)           \
    return static_cast<int>(launch_wgmma<DD, SS, EE>(                       \
        q, k, v, ip, vp, out, BH, T, S, keep, causal, scale, radius, st));
  SUFA_WGMMA(64, true, false)
  SUFA_WGMMA(64, false, false)
  SUFA_WGMMA(128, true, false)
  SUFA_WGMMA(128, false, false)
  SUFA_WGMMA(64, true, true)
  SUFA_WGMMA(64, false, true)
  SUFA_WGMMA(128, true, true)
  SUFA_WGMMA(128, false, true)
#undef SUFA_WGMMA
  return static_cast<int>(cudaErrorInvalidValue);
}

#define SUFA_CASE(DD, BB)                                                    \
  if (D == DD && block_kv == BB)                                             \
    return static_cast<int>(launch_mma<DD, BB>(                              \
        q, k, v, ip, vp, out, BH, T, S, keep, block_q, causal, strict != 0,  \
        elementwise != 0, scale, radius, st));
#define SUFA_TILES(DD)                                                      \
  SUFA_CASE(DD, 16) SUFA_CASE(DD, 32) SUFA_CASE(DD, 48) SUFA_CASE(DD, 64)   \
  SUFA_CASE(DD, 80) SUFA_CASE(DD, 96) SUFA_CASE(DD, 112) SUFA_CASE(DD, 128)

// elementwise != 0 runs the element-level sphere mask at radius (ELEM).
extern "C" int sufa_mma_bf16(const void* q, const void* k, const void* v,
                             const void* idx, const void* valid, void* out,
                             int BH, int T, int S, int keep, int block_q,
                             int block_kv, int D, int causal, int strict,
                             int elementwise, float scale, float radius,
                             void* stream) {
  if (bad_shape(BH, T, S, keep, block_q, block_kv))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t* ip = static_cast<const int64_t*>(idx);
  const uint8_t* vp = static_cast<const uint8_t*>(valid);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  SUFA_TILES(64)
  SUFA_TILES(128)
  return static_cast<int>(cudaErrorInvalidValue);
}
