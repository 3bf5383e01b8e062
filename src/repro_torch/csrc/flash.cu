// FlashAttention-2 forward for Hopper (sm_90a): the dense prefill.
//
// Replaces repro/kernels/flash.py::flash_attention (body _flash_kernel):
// softmax(scale * Q . K^T) . V over q [BH, T, D] and k/v [BH, S, D],
// causal or not, with the causal mask at offset q_offset = S - T, FA-2's
// per-tile max refresh and rescale, and fp32 statistics. The output
// o / max(l, 1e-30) is written in bf16. Unlike the TPU kernel, T and S
// need not be multiples of the tile: rows past T are not written and keys
// past S are masked (they are zero-filled in shared memory), so every T
// the model hands it (prompt + generated tokens) is served.
//
// Bound: operations. Each call must read Q, K and V and write O once
// (4 * BH * T * D bytes at T = S) and do 4 * D flops per visible
// (query, key) pair: at the OLMo-1B served shape (BH 16, T = S = 2048,
// D 128, causal) that is 33.6 MB against 17.2 GFLOP, above the bf16 ridge.
//
// Design:
//   * One block of 4 warps per (bh, 64-row query tile); each warp owns 16
//     query rows, keeps their A fragments and (m, l, o) in registers.
//   * The block loops over 64-key tiles up to the last one the causal
//     mask leaves visible (tiles wholly above the diagonal are skipped;
//     they add nothing to the sums). K and V tiles are staged in shared
//     memory; S = Q . K^T and O += P . V run on bf16 mma.sync with fp32
//     accumulators, P rounded to bf16.
//   * The tile sizes are the kernel's own: the function does not depend on
//     them (the block_q / block_kv of the TPU signature only set the
//     order of its sums). D is 64 or 128. The kernel allocates nothing and
//     launches on the caller's stream; the C entry point returns
//     cudaGetLastError().
//
// Later work: wgmma/TMA with a producer warp, split-S for short T.

#include "mma_bf16.cuh"

namespace {

using namespace star;

constexpr int kBQ = 64;
constexpr int kBC = 64;

template <int D>
__global__ void __launch_bounds__(kBQ / 16 * 32)
flash_kernel(const uint16_t* __restrict__ q,   // [BH, T, D]
             const uint16_t* __restrict__ k,   // [BH, S, D]
             const uint16_t* __restrict__ v,   // [BH, S, D]
             uint16_t* __restrict__ out,       // [BH, T, D]
             int T, int S, int q_offset, int causal, float scale) {
  constexpr int LD = D + 8;
  constexpr int NT = kBC / 8;
  __shared__ __align__(16) uint16_t sk[kBC * LD];
  __shared__ __align__(16) uint16_t sv[kBC * LD];
  const int qt = blockIdx.x;
  const int bh = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;
  const int q0 = qt * kBQ;
  const int row = q0 + warp * 16 + g;  // this thread's rows: row, row + 8

  // the query tile passes through sk on its way to registers
  load_rows<D>(sk, q + (int64_t)bh * T * D, q0, kBQ, T, false);
  __syncthreads();
  uint32_t a[D / 16][4];
  load_a_frags<D, LD>(a, sk, warp * 16, lane);

  int n_tiles = (S + kBC - 1) / kBC;
  if (causal) {
    const int last = q_offset + min(q0 + kBQ, T) - 1;
    n_tiles = last < 0 ? 0 : min(n_tiles, last / kBC + 1);
  }
  const uint16_t* kb = k + (int64_t)bh * S * D;
  const uint16_t* vb = v + (int64_t)bh * S * D;
  const int qpos = q_offset + row;

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * kBC;
    __syncthreads();  // every warp is done with the previous tiles
    load_rows<D>(sk, kb, kv0, kBC, S, false);
    load_rows<D>(sv, vb, kv0, kBC, S, false);
    __syncthreads();
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) qk_tile<D, LD>(s[nt], a, sk, nt * 8, lane);

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = kv0 + nt * 8 + t2 + (i & 1);
        const int qp = qpos + (i >= 2 ? 8 : 0);
        const bool ok = col < S && (!causal || col <= qp);
        const float x = ok ? s[nt][i] * scale : kNegInf;
        s[nt][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], quad_max(mx[h]));
      alpha[h] = m[h] <= kNegInf / 2 ? 0.f : __expf(m[h] - m_new);
      m[h] = m_new;
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
#pragma unroll
    for (int kk = 0; kk < kBC / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const uint16_t* vp = sv + (kk * 16 + t2) * LD + g;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        mma_16816(o[n], pa, ld_col_pair(vp + n * 8, LD),
                  ld_col_pair(vp + 8 * LD + n * 8, LD));
    }
  }

  const float l0 = fmaxf(quad_sum(l[0]), 1e-30f);
  const float l1 = fmaxf(quad_sum(l[1]), 1e-30f);
  uint16_t* ob = out + ((int64_t)bh * T + row) * D + t2;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (row < T)
      *reinterpret_cast<uint32_t*>(ob + n * 8) =
          pack_bf16(o[n][0] / l0, o[n][1] / l0);
    if (row + 8 < T)
      *reinterpret_cast<uint32_t*>(ob + 8 * D + n * 8) =
          pack_bf16(o[n][2] / l1, o[n][3] / l1);
  }
}

}  // namespace

extern "C" int flash_bf16(const void* q, const void* k, const void* v,
                          void* out, int BH, int T, int S, int D,
                          int q_offset, int causal, float scale,
                          void* stream) {
  if (BH <= 0 || T <= 0 || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((T + kBQ - 1) / kBQ, BH);
  const dim3 block(kBQ / 16 * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint16_t* qp = static_cast<const uint16_t*>(q);
  const uint16_t* kp = static_cast<const uint16_t*>(k);
  const uint16_t* vp = static_cast<const uint16_t*>(v);
  uint16_t* op = static_cast<uint16_t*>(out);
  if (D == 64)
    flash_kernel<64><<<grid, block, 0, s>>>(qp, kp, vp, op, T, S, q_offset,
                                            causal, scale);
  else if (D == 128)
    flash_kernel<128><<<grid, block, 0, s>>>(qp, kp, vp, op, T, S, q_offset,
                                             causal, scale);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
