// DLZS block maxima for Hopper (sm_90a): stage 1 + 2a of the STAR prefill.
//
// Replaces repro/kernels/dlzs.py::dlzs_block_scores (body _dlzs_kernel,
// quantizer _pow2_bitwise). For every (query tile, key tile) it returns
// the largest predicted score max(scale * Q . pow2(K)^T) of the tile, with
// the causal mask at offset q_offset = S - T; pow2 keeps only the sign and
// exponent bits of each K element. Only the [BH, n_qt, n_kt] fp32 maxima
// leave the kernel: the [T, S] estimate A-hat is formed tile by tile in
// registers and never reaches device memory (the paper's "A-hat stays on
// chip"). Tiles wholly above the diagonal are skipped and written as
// NEG_INF, as the reference's masked maximum reads.
//
// Bound: operations at long T. Each call must read Q and K once
// (2 * BH * (T + S) * D bytes) and do 2 * D flops per visible (query, key)
// pair: at the OLMo-1B served shape (BH 16, T = S = 2048, D 128, causal)
// that is 8.4 MB against 8.6 GFLOP, above the bf16 ridge point. Only
// wgmma reaches Hopper's tensor-core rate, so the served tiles run on it,
// fed by TMA.
//
// pow2(K) is exact in bf16 (sign and exponent only, bits & 0xFF80), so a
// bf16 product with fp32 accumulators reproduces the reference's fp32
// product up to the order of the sum.
//
// Two forms, chosen by shape alone (kernels/dlzs.py):
//   * 128 x 128 tiles (the served ones): warp-specialised, modelled on
//     flash.cu. One block per (bh, q-tile): a producer warp whose lane 0
//     TMA-loads the Q tile once and the visible K tiles into a 2-stage
//     mbarrier ring; two consumer warpgroups of 64 rows each. On each
//     landed K tile the 256 consumer threads apply pow2 in shared memory
//     (the mask is elementwise, so the swizzle does not matter), fence the
//     generic-proxy writes against wgmma's async-proxy reads and meet at a
//     named barrier; then S = Q . pow2(K)^T runs on wgmma (both operands
//     in shared memory, fp32 accumulators). The epilogue is a masked max:
//     causal positions only on a tile that crosses the warpgroup's
//     diagonal, then over the thread's registers, a warp shuffle, and the
//     8 consumer warps in shared memory, read at the next tile's barrier.
//     Two blocks fit an SM (97 KB of shared memory at D = 128), so one
//     block's epilogue overlaps the other's products. Causal q-tiles
//     launch heaviest first.
//   * Other tiles (any multiple of 16 up to 128; the pool probe's 16):
//     mma.sync, one block per (bh, q-tile) of block_q / 16 warps, each
//     owning 16 query rows whose A fragments stay in registers; one key
//     tile at a time is copied to shared memory with the mantissa masked
//     on the copy; each warp reduces its 16 x block_kv scores through
//     shuffles and the warps meet in shared memory.
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
constexpr int kBC = 128;         // keys per K tile
constexpr int kStages = 2;       // K ring depth
constexpr int kConsumers = 2;    // warpgroups of 64 query rows
constexpr int kConsumerThreads = kConsumers * 128;
constexpr int kThreads = kConsumerThreads + 32;  // + one producer warp
constexpr int kBoxBytes = 128 * 128;  // one 128-row x 64-col bf16 box
constexpr int kPow2Barrier = 1;  // named barrier of the consumer threads

template <int D>
__host__ __device__ constexpr int tile_bytes() {
  return (D / 64) * kBoxBytes;
}

template <int D>
__host__ __device__ constexpr int smem_bytes() {  // Q, K ring, alignment
  return tile_bytes<D>() * (1 + kStages) + 1024;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
dlzs_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,  // [BH, T, D]
                  const __grid_constant__ CUtensorMap kmap,  // [BH, S, D]
                  float* __restrict__ out,   // [BH, n_qt, n_kt]
                  int S, int q_offset, int causal, float scale) {
  constexpr int kTile = tile_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full;
  __shared__ __align__(8) uint64_t k_full[kStages];
  __shared__ __align__(8) uint64_t k_empty[kStages];
  __shared__ float warp_max[2][kConsumers * 4];  // by tile parity, warp

  // swizzled boxes need 1024-byte aligned shared addresses
  uint8_t* const sq =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* const sk = sq + kTile;  // stage s at sk + s·kTile

  const int bh = blockIdx.x;
  const int n_qt = gridDim.y;
  const int qt = causal ? n_qt - 1 - blockIdx.y : blockIdx.y;  // heaviest
  const int q0 = qt * kBQ;
  const int n_kt = S / kBC;
  // key tiles holding a visible key: start <= the tile's last query position
  int n_vis = n_kt;
  if (causal) {
    const int last = q_offset + q0 + kBQ - 1;
    n_vis = last < 0 ? 0 : min(n_kt, last / kBC + 1);
  }
  float* out_row = out + ((int64_t)bh * n_qt + qt) * n_kt;
  for (int j = n_vis + threadIdx.x; j < n_kt; j += blockDim.x)
    out_row[j] = kNegInf;
  if (n_vis == 0) return;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&k_empty[s], kConsumerThreads);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumers * 4) {  // the producer warp: lane 0 loads by TMA
    if ((threadIdx.x & 31) == 0) {
      mbar_expect_tx(&q_full, kTile);
      for (int c = 0; c < D / 64; ++c)
        tma_load_3d(sq + c * kBoxBytes, &qmap, &q_full, c * 64, q0, bh);
      for (int j = 0; j < n_vis; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&k_empty[s], (j / kStages - 1) & 1);
        mbar_expect_tx(&k_full[s], kTile);
        for (int c = 0; c < D / 64; ++c)
          tma_load_3d(sk + s * kTile + c * kBoxBytes, &kmap, &k_full[s],
                      c * 64, j * kBC, bh);
      }
    }
    return;
  }

  // a consumer warpgroup: 64 query rows; this thread's rows are row, row + 8
  const int wg = warp >> 2;
  const int lane = threadIdx.x & 31;
  const int t2 = (lane & 3) * 2;
  const int wg_row0 = q0 + wg * 64;
  const int qpos = q_offset + wg_row0 + (warp & 3) * 16 + (lane >> 2);
  const uint8_t* sq_wg = sq + wg * 64 * 128;  // its rows in every Q box
  mbar_wait(&q_full, 0);

  for (int j = 0; j < n_vis; ++j) {
    const int s = j % kStages;
    uint8_t* ks = sk + s * kTile;
    mbar_wait(&k_full[s], (j / kStages) & 1);
    // pow2 in place: sign and exponent bits of every bf16 of the tile
    uint4* kv = reinterpret_cast<uint4*>(ks);
    for (int c = threadIdx.x; c < kTile / 16; c += kConsumerThreads) {
      uint4 x = kv[c];
      x.x &= 0xFF80FF80u;
      x.y &= 0xFF80FF80u;
      x.z &= 0xFF80FF80u;
      x.w &= 0xFF80FF80u;
      kv[c] = x;
    }
    fence_proxy_async();
    named_barrier_sync(kPow2Barrier, kConsumerThreads);
    // every warp wrote tile j - 1's maximum before this barrier
    if (threadIdx.x == 0 && j > 0) {
      float mx = warp_max[(j - 1) & 1][0];
      for (int w = 1; w < kConsumers * 4; ++w)
        mx = fmaxf(mx, warp_max[(j - 1) & 1][w]);
      out_row[j - 1] = mx;
    }

    // S = Q . pow2(K)^T over D in k16 steps; step kk sits in box kk / 4
    float sc[kBC / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk >> 2) * kBoxBytes + (kk & 3) * 32;
      wgmma_ss_m64n128(sc, sw128_desc(sq_wg + off, 16, 1024),
                       sw128_desc(ks + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    mbar_arrive(&k_empty[s]);

    const int kv0 = j * kBC;
    float mx = kNegInf;
    // warpgroup-uniform: does this tile cross the diagonal of its rows?
    if (causal && kv0 + kBC - 1 > q_offset + wg_row0) {
#pragma unroll
      for (int i = 0; i < kBC / 2; ++i) {
        const int col = kv0 + (i >> 2) * 8 + t2 + (i & 1);
        if (col <= qpos + ((i & 2) ? 8 : 0)) mx = fmaxf(mx, sc[i] * scale);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kBC / 2; ++i) mx = fmaxf(mx, sc[i] * scale);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) warp_max[j & 1][warp] = mx;
  }
  named_barrier_sync(kPow2Barrier, kConsumerThreads);
  if (threadIdx.x == 0) {
    float mx = warp_max[(n_vis - 1) & 1][0];
    for (int w = 1; w < kConsumers * 4; ++w)
      mx = fmaxf(mx, warp_max[(n_vis - 1) & 1][w]);
    out_row[n_vis - 1] = mx;
  }
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, void* out, int BH,
                         int T, int S, int causal, float scale,
                         cudaStream_t stream) {
  static bool configured = false;  // the >48 KB opt-in, once per instance
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        dlzs_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes<D>());
    if (err != cudaSuccess) return err;
    configured = true;
  }
  CUtensorMap qmap, kmap;
  if (!encode_rows_map(&qmap, q, BH, T, D, kBQ) ||
      !encode_rows_map(&kmap, k, BH, S, D, kBC))
    return cudaErrorInvalidValue;
  const dim3 grid(BH, T / kBQ);
  dlzs_wgmma_kernel<D><<<grid, kThreads, smem_bytes<D>(), stream>>>(
      qmap, kmap, static_cast<float*>(out), S, S - T, causal, scale);
  return cudaGetLastError();
}

// -- the mma.sync form: any tile that is a multiple of 16 up to 128 -----------

constexpr int kMaxTile = 128;

template <int D>
__global__ void __launch_bounds__(256)
dlzs_mma_kernel(const uint16_t* __restrict__ q,   // [BH, T, D]
                const uint16_t* __restrict__ k,   // [BH, S, D]
                float* __restrict__ out,          // [BH, n_qt, n_kt]
                int T, int S, int block_q, int block_kv, int q_offset,
                int causal, float scale) {
  constexpr int LD = D + 8;
  __shared__ __align__(16) uint16_t tile[kMaxTile * LD];
  __shared__ float warp_max[kMaxTile / 16];
  const int qt = blockIdx.x;
  const int bh = blockIdx.y;
  const int n_kt = S / block_kv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int q0 = qt * block_q;
  float* out_row = out + ((int64_t)bh * gridDim.x + qt) * n_kt;

  // key tiles holding a visible key: start <= the tile's last query position
  int n_vis = n_kt;
  if (causal) {
    const int last = q_offset + q0 + block_q - 1;
    n_vis = last < 0 ? 0 : min(n_kt, last / block_kv + 1);
  }
  for (int j = n_vis + threadIdx.x; j < n_kt; j += blockDim.x)
    out_row[j] = kNegInf;

  load_rows<D>(tile, q + (int64_t)bh * T * D, q0, block_q, T, false);
  __syncthreads();
  uint32_t a[D / 16][4];
  load_a_frags<D, LD>(a, tile, warp * 16, lane);
  // query position of this thread's rows g and g + 8
  const int qpos = q_offset + q0 + warp * 16 + (lane >> 2);
  const uint16_t* kb = k + (int64_t)bh * S * D;

  for (int j = 0; j < n_vis; ++j) {
    const int kv0 = j * block_kv;
    __syncthreads();  // every warp is done with the previous tile
    load_rows<D>(tile, kb, kv0, block_kv, S, true);
    __syncthreads();
    float mx = kNegInf;
    for (int n0 = 0; n0 < block_kv; n0 += 8) {
      float acc[4];
      qk_tile<D, LD>(acc, a, tile, n0, lane);
      const int col = kv0 + n0 + (lane & 3) * 2;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qp = qpos + (i >= 2 ? 8 : 0);
        if (!causal || col + (i & 1) <= qp) mx = fmaxf(mx, acc[i] * scale);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) warp_max[warp] = mx;
    __syncthreads();
    if (threadIdx.x == 0) {
      float m = warp_max[0];
      for (int w = 1; w < n_warps; ++w) m = fmaxf(m, warp_max[w]);
      out_row[j] = m;
    }
  }
}

}  // namespace

extern "C" int dlzs_wgmma_bf16(const void* q, const void* k, void* out,
                               int BH, int T, int S, int D, int causal,
                               float scale, void* stream) {
  if (BH <= 0 || T <= 0 || S <= 0 || T % kBQ || S % kBC)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return static_cast<int>(
        launch_wgmma<64>(q, k, out, BH, T, S, causal, scale, st));
  if (D == 128)
    return static_cast<int>(
        launch_wgmma<128>(q, k, out, BH, T, S, causal, scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int dlzs_mma_bf16(const void* q, const void* k, void* out, int BH,
                             int T, int S, int D, int block_q, int block_kv,
                             int causal, float scale, void* stream) {
  if (BH <= 0 || block_q <= 0 || block_q > kMaxTile || block_q % 16 ||
      block_kv <= 0 || block_kv > kMaxTile || block_kv % 16 ||
      T % block_q || S % block_kv)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(T / block_q, BH);
  const dim3 block(block_q / 16 * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint16_t* qp = static_cast<const uint16_t*>(q);
  const uint16_t* kp = static_cast<const uint16_t*>(k);
  float* op = static_cast<float*>(out);
  if (D == 64)
    dlzs_mma_kernel<64><<<grid, block, 0, s>>>(qp, kp, op, T, S, block_q,
                                               block_kv, S - T, causal, scale);
  else if (D == 128)
    dlzs_mma_kernel<128><<<grid, block, 0, s>>>(qp, kp, op, T, S, block_q,
                                                block_kv, S - T, causal,
                                                scale);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
