// SU-FA (sorted-updating block-sparse flash attention) for Hopper (sm_90a):
// stage 3 of the STAR prefill.
//
// Replaces repro/kernels/sufa.py::sufa_attention (body _sufa_kernel). Each
// query tile attends to `keep` key/value tiles that SADS selected and the
// caller gathered beforehand, in descending predicted-max order, under an
// int8 (or bool) mask that carries tile validity, the sphere and the
// in-tile causal mask. STRICT = true is FA-2's online rescale (exact in
// any order); STRICT = false freezes the running max at the first tile
// that has a visible key and drops the rescale, the paper's
// descend-updating fast path. Statistics are fp32; the output o / l is
// written in bf16.
//
// Bound: bytes at the served shape. Each call must read Q, the gathered
// K and V tiles and the mask once: at OLMo-1B (BH 16, T 2048, tiles 128,
// keep 4) that is 8.4 + 2 x 33.5 + 16.8 MB, against 4 * D flops per
// unmasked (query, key) pair (about 4.3 GFLOP), below the bf16 ridge.
// The gathered copies and the mask are the cost of this contract: the
// TPU kernel needs them for static BlockSpecs. Reading K/V tiles in place
// from the selected tile ids is a later redesign.
//
// Design:
//   * One block per (bh, query tile); block_q / 16 warps, each owning 16
//     query rows (A fragments in registers) and their (m, l, o) state in
//     registers for the whole call.
//   * The block loops over the keep tiles: the K tile is staged in shared
//     memory, S = Q . K^T runs on bf16 mma.sync with fp32 accumulators
//     over the whole tile (the frozen max of the fast path needs the whole
//     first tile's maximum), then the V tile takes the same buffer and
//     P . V accumulates in fp32 with P rounded to bf16.
//   * BC (the key tile) is a template argument, any multiple of 16 up to
//     128; D is 64 or 128. The kernel allocates nothing and launches on the
//     caller's stream; the C entry point returns cudaGetLastError().

#include "mma_bf16.cuh"

namespace {

using namespace star;

constexpr int kMaxTile = 128;

template <int D, int BC, bool STRICT>
__global__ void __launch_bounds__(256)
sufa_kernel(const uint16_t* __restrict__ q,     // [BH, T, D]
            const uint16_t* __restrict__ kg,    // [BH, n_qt, keep, BC, D]
            const uint16_t* __restrict__ vg,    // [BH, n_qt, keep, BC, D]
            const uint8_t* __restrict__ mask,   // [BH, n_qt, keep, Bq, BC]
            uint16_t* __restrict__ out,         // [BH, T, D]
            int keep, int block_q, float scale) {
  constexpr int LD = D + 8;
  constexpr int NT = BC / 8;  // 8-key score tiles
  __shared__ __align__(16) uint16_t tile[kMaxTile * LD];
  const int qt = blockIdx.x;
  const int bh = blockIdx.y;
  const int n_qt = gridDim.x;
  const int T = n_qt * block_q;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;
  const int row = warp * 16 + g;  // this thread's rows: row and row + 8
  const int64_t first_tile = ((int64_t)bh * n_qt + qt) * keep;

  load_rows<D>(tile, q + (int64_t)bh * T * D, qt * block_q, block_q, T, false);
  __syncthreads();
  uint32_t a[D / 16][4];
  load_a_frags<D, LD>(a, tile, warp * 16, lane);

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int j = 0; j < keep; ++j) {
    const int64_t tid = first_tile + j;
    __syncthreads();  // every warp is done with the previous V tile
    load_rows<D>(tile, kg + tid * BC * D, 0, BC, BC, false);
    __syncthreads();
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) qk_tile<D, LD>(s[nt], a, tile, nt * 8, lane);

    const uint8_t* mk = mask + tid * block_q * BC;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = row + (i >= 2 ? 8 : 0);
        const int c = nt * 8 + t2 + (i & 1);
        const float x = mk[r * BC + c] ? s[nt][i] * scale : kNegInf;
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
    load_rows<D>(tile, vg + tid * BC * D, 0, BC, BC, false);
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
cudaError_t launch(const void* q, const void* kg, const void* vg,
                   const void* mask, void* out, int BH, int n_qt, int keep,
                   int block_q, bool strict, float scale,
                   cudaStream_t stream) {
  const dim3 grid(n_qt, BH);
  const dim3 block(block_q / 16 * 32);
  const uint16_t* qp = static_cast<const uint16_t*>(q);
  const uint16_t* kp = static_cast<const uint16_t*>(kg);
  const uint16_t* vp = static_cast<const uint16_t*>(vg);
  const uint8_t* mp = static_cast<const uint8_t*>(mask);
  uint16_t* op = static_cast<uint16_t*>(out);
  if (strict)
    sufa_kernel<D, BC, true><<<grid, block, 0, stream>>>(
        qp, kp, vp, mp, op, keep, block_q, scale);
  else
    sufa_kernel<D, BC, false><<<grid, block, 0, stream>>>(
        qp, kp, vp, mp, op, keep, block_q, scale);
  return cudaGetLastError();
}

}  // namespace

#define SUFA_CASE(DD, BB)                                                    \
  if (D == DD && block_kv == BB)                                             \
    return static_cast<int>(launch<DD, BB>(q, kg, vg, mask, out, BH, n_qt,   \
                                           keep, block_q, strict != 0,       \
                                           scale,                            \
                                           static_cast<cudaStream_t>(stream)));
#define SUFA_TILES(DD)                                                      \
  SUFA_CASE(DD, 16) SUFA_CASE(DD, 32) SUFA_CASE(DD, 48) SUFA_CASE(DD, 64)   \
  SUFA_CASE(DD, 80) SUFA_CASE(DD, 96) SUFA_CASE(DD, 112) SUFA_CASE(DD, 128)

extern "C" int sufa_bf16(const void* q, const void* kg, const void* vg,
                         const void* mask, void* out, int BH, int n_qt,
                         int keep, int block_q, int block_kv, int D,
                         int strict, float scale, void* stream) {
  if (BH <= 0 || n_qt <= 0 || keep <= 0 || block_q <= 0 ||
      block_q > kMaxTile || block_q % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  SUFA_TILES(64)
  SUFA_TILES(128)
  return static_cast<int>(cudaErrorInvalidValue);
}
