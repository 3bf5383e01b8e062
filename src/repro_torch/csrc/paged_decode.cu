// Paged decode attention for Hopper (sm_90a).
//
// Replaces repro/kernels/paged.py::paged_decode_attention (body
// _paged_kernel): one decode query per sequence — R query heads grouped
// per KV head — attends to the rows of up to W pool pages named by a
// block table. Rows are masked where the slot is padding (logical < 0) or
// the row lies at or beyond kv_len. Softmax runs online (m, l, o) in fp32;
// the output o / l is written in bf16.
//
// Bound: memory. Each call must read the K and V rows of every gathered
// page once: B*W*page*nkv*d*2 (K and V) * 2 bytes. At the OLMo-1B main
// path (B=4, W=64, page=16, nkv=16, d=128) that is ~33.5 MB per layer,
// ~10 us at 3.35 TB/s; the arithmetic (4 FLOP per K/V element pair) is
// far below the bf16 ridge point.
//
// Design:
//   * Layout. The pool stays in its native [P, page, nkv, d] layout; the
//     kernel addresses one KV head's rows through the strides it is given,
//     so no slab is ever transposed or copied (the JAX wrapper moveaxis'es
//     both whole slabs on every call).
//   * Grid. One block per (sequence b, KV head g). The block loads its own
//     block-table row. Its 8 warps stride over the W*page candidate rows,
//     UNROLL rows at a time so each warp keeps 2*UNROLL row loads in
//     flight; each lane holds d/32 contiguous elements of a row, so a
//     warp reads a whole row as one coalesced transaction. Each warp keeps
//     its own online-softmax state for the R query heads; the 8 partial
//     states merge through shared memory at the end (the exact flash
//     merge, as across the TPU kernel's grid steps).
//   * The kernel allocates nothing and launches on the caller's stream;
//     the C entry point returns cudaGetLastError() after the launch.
//
// Later work: wgmma/TMA tiles, and split-W parallelism (at B*nkv = 64
// blocks the card's 132 SMs are not all busy).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 8;
constexpr int kUnroll = 4;

template <int E>
__device__ __forceinline__ void load_row(const __nv_bfloat16* __restrict__ p,
                                         float (&dst)[E]) {
#pragma unroll
  for (int e = 0; e < E; e += 2) {
    const __nv_bfloat162 two =
        *reinterpret_cast<const __nv_bfloat162*>(p + e);
    const float2 f = __bfloat1622float2(two);
    dst[e] = f.x;
    dst[e + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D, int R>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,     // [B, G, R, D]
                    const __nv_bfloat16* __restrict__ k,     // [P, page, G, D]
                    const __nv_bfloat16* __restrict__ v,     // (strided)
                    const int32_t* __restrict__ phys,        // [B, W]
                    const int32_t* __restrict__ logical,     // [B, W]
                    const int32_t* __restrict__ kv_len,      // [B]
                    __nv_bfloat16* __restrict__ out,         // [B, G, R, D]
                    int G, int W, int page, int P,
                    int64_t k_sp, int64_t k_sr, int64_t k_sg,
                    int64_t v_sp, int64_t v_sr, int64_t v_sg,
                    float scale) {
  constexpr int E = D / 32;  // elements of a row held by one lane
  const int b = blockIdx.x / G;
  const int g = blockIdx.x - b * G;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float qr[R][E];
  const __nv_bfloat16* qb = q + ((int64_t)(b * G + g) * R) * D + lane * E;
#pragma unroll
  for (int r = 0; r < R; ++r) load_row<E>(qb + r * D, qr[r]);

  float m[R], l[R], o[R][E];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) o[r][e] = 0.f;
  }

  const int len = kv_len[b];
  const int rows = W * page;
  const int32_t* phys_b = phys + (int64_t)b * W;
  const int32_t* logical_b = logical + (int64_t)b * W;

  for (int base = warp * kUnroll; base < rows; base += kWarps * kUnroll) {
    float kf[kUnroll][E], vf[kUnroll][E];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int idx = base + u;
      ok[u] = false;
      if (idx < rows) {
        const int w = idx / page;
        const int row = idx - w * page;
        const int lg = logical_b[w];
        ok[u] = lg >= 0 && (int64_t)lg * page + row < len;
        if (ok[u]) {
          // padded slots are masked above; clamp keeps any id in the pool
          const int ph = min(max(phys_b[w], 0), P - 1);
          load_row<E>(k + ph * k_sp + row * k_sr + g * k_sg + lane * E, kf[u]);
          load_row<E>(v + ph * v_sp + row * v_sr + g * v_sg + lane * E, vf[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;  // warp-uniform: depends on the row only
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) part = fmaf(qr[r][e], kf[u][e], part);
        const float s = warp_sum(part) * scale;
        const float m_new = fmaxf(m[r], s);
        const float alpha = __expf(m[r] - m_new);
        const float p = __expf(s - m_new);
        l[r] = l[r] * alpha + p;
#pragma unroll
        for (int e = 0; e < E; ++e) o[r][e] = fmaf(p, vf[u][e], o[r][e] * alpha);
        m[r] = m_new;
      }
    }
  }

  // merge the warps' partial states: exact flash merge in fp32
  __shared__ float sm_m[kWarps][R];
  __shared__ float sm_l[kWarps][R];
  __shared__ float sm_o[kWarps][R][D];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (lane == 0) {
      sm_m[warp][r] = m[r];
      sm_l[warp][r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sm_o[warp][r][lane * E + e] = o[r][e];
  }
  __syncthreads();

  __nv_bfloat16* ob = out + ((int64_t)(b * G + g) * R) * D;
  for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
    const int r = i / D;
    const int e = i - r * D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][r]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      // a warp that saw no valid row holds l = 0, o = 0: weight 0
      const float c = sm_l[w][r] > 0.f ? __expf(sm_m[w][r] - mx) : 0.f;
      den = fmaf(sm_l[w][r], c, den);
      num = fmaf(sm_o[w][r][e], c, num);
    }
    ob[i] = __float2bfloat16(num / fmaxf(den, 1e-30f));
  }
}

template <int D, int R>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* phys, const void* logical, const void* kv_len,
                   void* out, int B, int G, int W, int page, int P,
                   int64_t k_sp, int64_t k_sr, int64_t k_sg, int64_t v_sp,
                   int64_t v_sr, int64_t v_sg, float scale,
                   cudaStream_t stream) {
  paged_decode_kernel<D, R><<<B * G, kWarps * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int32_t*>(phys),
      static_cast<const int32_t*>(logical), static_cast<const int32_t*>(kv_len),
      static_cast<__nv_bfloat16*>(out), G, W, page, P, k_sp, k_sr, k_sg, v_sp,
      v_sr, v_sg, scale);
  return cudaGetLastError();
}

}  // namespace

// (D, R) pairs with R*D <= 1024 keep the merge buffer in static shared
// memory (<= 32 KB); the Python wrapper checks the pair before calling.
#define PAGED_CASE(DD, RR)                                                    \
  if (D == DD && R == RR)                                                     \
    return static_cast<int>(launch<DD, RR>(q, k, v, phys, logical, kv_len, \
                                           out, B, G, W, page, P, k_sp, k_sr, \
                                           k_sg, v_sp, v_sr, v_sg, scale,     \
                                           static_cast<cudaStream_t>(stream)));

extern "C" int paged_decode_bf16(const void* q, const void* k, const void* v,
                                 const void* phys, const void* logical,
                                 const void* kv_len, void* out, int B, int G,
                                 int R, int D, int W, int page, int P,
                                 int64_t k_sp, int64_t k_sr, int64_t k_sg,
                                 int64_t v_sp, int64_t v_sr, int64_t v_sg,
                                 float scale, void* stream) {
  PAGED_CASE(64, 1) PAGED_CASE(64, 2) PAGED_CASE(64, 4) PAGED_CASE(64, 8)
  PAGED_CASE(64, 16)
  PAGED_CASE(128, 1) PAGED_CASE(128, 2) PAGED_CASE(128, 4) PAGED_CASE(128, 8)
  PAGED_CASE(256, 1) PAGED_CASE(256, 2) PAGED_CASE(256, 4)
  return static_cast<int>(cudaErrorInvalidValue);
}
