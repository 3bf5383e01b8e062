// DLZS block maxima for Hopper (sm_90a): stage 1 + 2a of the STAR prefill.
//
// Replaces repro/kernels/dlzs.py::dlzs_block_scores (body _dlzs_kernel,
// quantizer _pow2_bitwise). For every (query tile, key tile) it returns
// the largest predicted score max(scale * Q . pow2(K)^T) of the tile, with
// the causal mask at offset q_offset = S - T; pow2 keeps only the sign and
// exponent bits of each K element. Only the [BH, n_qt, n_kt] fp32 maxima
// leave the kernel: the [T, S] estimate A-hat is formed tile by tile in
// registers and never reaches device memory (the paper's "A-hat stays on
// chip").
//
// Bound: operations at long T. Each call must read Q and K once
// (2 * BH * (T + S) * D bytes) and do 2 * D flops per visible (query, key)
// pair: at the OLMo-1B served shape (BH 16, T = S = 2048, D 128, causal)
// that is 8.4 MB against 8.6 GFLOP, above the bf16 ridge point.
//
// Design:
//   * One block per (bh, query tile); block_q / 16 warps, each owning 16
//     query rows whose A fragments stay in registers for the whole call.
//   * The block loops over the key tiles the causal mask leaves visible;
//     tiles wholly above the diagonal are skipped and written as NEG_INF,
//     as the reference's masked maximum reads.
//   * pow2(K) is exact in bf16 (sign and exponent only), so bf16 mma.sync
//     with fp32 accumulators reproduces the reference's fp32 product up to
//     the order of the sum. The mantissa is masked while the tile is
//     copied to shared memory.
//   * Each warp reduces its 16 x block_kv scores to one maximum through
//     shuffles; the block's warps meet in shared memory and one thread
//     writes the tile's value.
//   * Tiles are any multiple of 16 up to 128; D is 64 or 128. The kernel
//     allocates nothing and launches on the caller's stream; the C entry
//     point returns cudaGetLastError() after the launch.
//
// Later work: wgmma/TMA, keeping several key tiles in flight.

#include "mma_bf16.cuh"

namespace {

using namespace star;

constexpr int kMaxTile = 128;

template <int D>
__global__ void __launch_bounds__(256)
dlzs_block_kernel(const uint16_t* __restrict__ q,   // [BH, T, D]
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

extern "C" int dlzs_block_bf16(const void* q, const void* k, void* out, int BH,
                               int T, int S, int D, int block_q, int block_kv,
                               int q_offset, int causal, float scale,
                               void* stream) {
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
    dlzs_block_kernel<64><<<grid, block, 0, s>>>(qp, kp, op, T, S, block_q,
                                                 block_kv, q_offset, causal,
                                                 scale);
  else if (D == 128)
    dlzs_block_kernel<128><<<grid, block, 0, s>>>(qp, kp, op, T, S, block_q,
                                                  block_kv, q_offset, causal,
                                                  scale);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
