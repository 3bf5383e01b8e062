// FlashAttention backward for Hopper (sm_90a): K4's gradient, for training.
//
// Replaces no TPU kernel. The TPU kernel (repro/kernels/flash.py::
// flash_attention) has no VJP: the reference trains through XLA's dense
// chunked softmax. The port's dense full-sequence attention runs K4
// (flash.cu), so a trainer on the card needs K4's gradient. Given q, k, v
// [BH, T|S, D], the forward's output o and the output gradient dO [BH, T, D]
// (bf16), and the forward's fp32 log-sum-exp lse [BH, T] (natural base;
// +inf on a row that sees no key), it returns dQ, dK, dV in bf16 with fp32
// sums, for exactly the function K4 computes: causal at offset q_offset =
// S - T or not, any T and S (keys past S and rows past T masked), D 64 and
// 128.
//
// Bound: operations. The gradient needs 10 * D flops per visible (query,
// key) pair, five products: the recomputed S, dV, dP, dK, dQ. At the
// OLMo-1B training shape (BH 128, T = S = 2048, D 128, causal) that is 344
// GFLOP against 134 MB of q, k, v, o, dO, dQ, dK, dV, far above the bf16
// ridge. Only wgmma reaches Hopper's tensor-core rate, so every product
// runs on it, fed by TMA, and each is computed once: dQ is summed across
// key tiles instead of recomputing S and dP in a pass of its own (which
// costs 14 * D).
//
// Two kernels, launched in order on the caller's stream:
//   (a) prep: D_i = rowsum(dO_i * O_i) in fp32 and lse in base 2 (the
//       recompute's base), into rows padded to a multiple of 64 (pad rows:
//       D = 0, lse2 = +inf, so P = 0 there); it zeroes dQ's rows that see
//       no key and the per-query-tile order counters;
//   (b) one block per (bh, 128-key tile): two consumer warpgroups of 64
//       keys each and a producer warpgroup (384 threads). The producer's
//       lane 0 loads the block's K and V once by TMA, then 64-row Q and dO
//       tiles with their lse2 and D slices (bulk copies) into a 2-stage
//       ring on full/empty mbarriers. Per query tile each warpgroup runs:
//         S^T = K . Q^T        SS m64n64, both operands K-major;
//         dP^T = V . dO^T      SS m64n64, issued right behind S^T;
//         P^T = 2^(scale * log2(e) * S^T - lse2), masked, in registers;
//         dV += P^T . dO       RS m64nD: P^T's accumulator, in bf16, is the
//                              A operand as it stands; dO is read MN-major
//                              through the transpose bit;
//         dS^T = P^T * (dP^T - D)   (while dV's product runs), stored in
//                              bf16 to shared memory as a swizzled box;
//         dK += dS^T . Q       SS m64nD, its rows of dS^T K-major, Q
//                              MN-major;
//         dQ_tile += dS . K    SS m64n64 over the block's 128 keys (both
//                              warpgroups' dS^T rows, so the two meet at a
//                              named barrier), warpgroup w taking D columns
//                              64w.. (at D = 64 both compute the one
//                              partial and warpgroup 0 keeps it).
//       dK is scaled once at the end.
//
// dQ, deterministically. Key tiles are summed into each 64-row query tile
// in a fixed order, descending key tile, so two calls give the same bits
// (the restart check of training needs that; free-running atomics would
// not). A block's partial goes to a shared-memory buffer (two, in the
// accumulators' fragment order: conflict-free stores) and a second
// producer lane waits on the tile's counter until the tiles before it in
// the order are in, then stores (the first) or fp32-adds (cp.reduce.
// async.bulk) the 32 KB partial into global scratch and raises the counter
// once the write is complete (release/acquire, GPU scope). Block 0, last
// in every query tile's order, reads that sum back, adds its own partial
// and writes dQ in bf16 itself: no conversion pass. Blocks launch in the
// order they add (key tiles descending within each bh, bh by bh), so a
// block only ever waits for blocks launched before it: no deadlock,
// whatever the grid's size. A causal key tile reaches each query tile two
// steps after the key tile above it, so most waits are short; block 0,
// the heaviest and the end of every chain, fetches the sum while its own
// products run.
//
// Registers: a consumer thread holds two D-wide fp32 sums (dK, dV: 64 + 64
// at D = 128) plus S^T and dP^T (32 + 32) and P^T in bf16. That passes the
// 168 a thread of a 384-thread block may have, so the producer warpgroup
// drops to 24 registers and the consumers rise to 240 (setmaxnreg; the two
// roles' branches never meet). wgmma descriptors are rebuilt each step
// from an opaque base (eight hoisted 64-bit descriptors per operand would
// pin registers), and no wgmma sits in a divergent branch: ptxas would
// serialize them.
//
// Causal: a key tile's loop starts at the first 64-row query tile that
// sees it; only tiles that cross the diagonal or the key edge S are
// masked.
//
// What was hard: the causal offset S - T and the rows with no visible key
// (the forward zeroes them): their lse is +inf, so 2^(s - inf) = 0 and
// they give nothing, and prep zeroes their dQ (no block may visit their
// tile); keys past S are masked explicitly (their zero-filled rows would
// otherwise carry P = 2^(-lse)), rows past T carry the padded lse2 = +inf
// and zero-filled Q and dO, and are not stored. The forward's base-2
// softmax is matched by folding scale * log2(e) into the scores and
// recomputing P against lse * log2(e). Q and dO, K and dS^T are each one
// swizzled tile read two ways: K-major for one product (+32 bytes per k16
// step inside a 64-column box) and MN-major for another (+16 rows = 2048
// bytes per k16 step, LBO = one box between the two 64-column halves of D
// = 128). In the block the accumulators' rows are keys, so each thread
// reads lse2 and D for its columns (queries) from the ring's slices.
//
// Later work: ping-pong of the two consumer warpgroups (the dQ product's
// barrier keeps them in step, so both run their softmax at once), a
// deeper ring (shared memory is full at D = 128), D computed in the block
// instead of the prep pass.

#include <cuda.h>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace star;

constexpr int kBK = 128;        // keys per block
constexpr int kBQ = 64;         // query rows per step (and lse/D padding)
constexpr int kStages = 2;      // Q/dO ring depth
constexpr int kConsumers = 2;   // warpgroups of 64 keys
constexpr int kThreads = (kConsumers + 1) * 128;  // + a producer warpgroup
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kDsBar = 1;       // named barrier: all of dS^T stored
constexpr float kLog2e = 1.4426950408889634f;

// a dQ partial: 64 query rows x D fp32
template <int D>
__host__ __device__ constexpr int dq_bytes() {
  return kBQ * D * 4;
}

template <int D>
__host__ __device__ constexpr int smem_bytes() {
  // K, V, the Q/dO ring, 2 dS^T boxes, 2 dQ partials, lse2/D slices
  return 2 * tile_bytes<D>(kBK) + kStages * 2 * tile_bytes<D>(kBQ) +
         2 * box_bytes(kBK) + 2 * dq_bytes<D>() + kStages * 2 * kBQ * 4 +
         1024;
}

__host__ __device__ constexpr int padded_rows(int T) {
  return (T + kBQ - 1) / kBQ * kBQ;
}

__device__ __forceinline__ float bf16_lo(uint32_t x) {
  return __uint_as_float(x << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t x) {
  return __uint_as_float(x & 0xFFFF0000u);
}

// d += A . B over D output columns: A K-major, B MN-major in shared memory
template <int D>
__device__ __forceinline__ void ss_step(float (&d)[D / 2], uint64_t da,
                                        uint64_t db) {
  if constexpr (D == 128)
    wgmma_ss_m64n128_t<0, 1>(d, da, db, 1);
  else
    wgmma_ss_m64n64_t<0, 1>(d, da, db, 1);
}

// Query tile q0's last key tile: the key tiles 0..kt_last see it and add
// their dQ partials in descending order.
__device__ __forceinline__ int last_key_tile(int q0, int n_kt, int q_offset,
                                             int causal) {
  return causal ? min(n_kt - 1, (q0 + kBQ - 1 + q_offset) / kBK) : n_kt - 1;
}

// (a) D = rowsum(dO * O) and lse2 = lse * log2(e), D / 8 lanes (16 bytes of
// O and dO each) per padded row; rows past T get D = 0 and lse2 = +inf.
// Rows that see no key get dQ = 0, and the first row of each 64-row tile
// zeroes the tile's order counter.
template <int D>
__global__ void __launch_bounds__(256)
bwd_prep_kernel(const uint16_t* __restrict__ o,
                const uint16_t* __restrict__ dout,
                const float* __restrict__ lse, float* __restrict__ dvec,
                float* __restrict__ lse2, int* __restrict__ order,
                uint16_t* __restrict__ dq, int64_t rows, int T, int Tp,
                int q_offset, int causal) {
  constexpr int kLanes = D / 8;
  const int64_t prow = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x) / kLanes;
  const int part = threadIdx.x % kLanes;
  const int64_t bh = prow / Tp;
  const int i = static_cast<int>(prow - bh * Tp);
  const bool real = prow < rows && i < T;
  const int64_t row = bh * T + i;
  float acc = 0.f;
  if (real) {
    const uint4 a = *reinterpret_cast<const uint4*>(o + row * D + part * 8);
    const uint4 b =
        *reinterpret_cast<const uint4*>(dout + row * D + part * 8);
    const uint32_t av[4] = {a.x, a.y, a.z, a.w};
    const uint32_t bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int c = 0; c < 4; ++c)
      acc += bf16_lo(av[c]) * bf16_lo(bv[c]) + bf16_hi(av[c]) * bf16_hi(bv[c]);
    if (causal && i + q_offset < 0)  // sees no key
      *reinterpret_cast<uint4*>(dq + row * D + part * 8) =
          make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)  // every lane takes part
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (part == 0 && prow < rows) {
    if (i % kBQ == 0) order[prow / kBQ] = 0;
    dvec[prow] = real ? acc : 0.f;
    lse2[prow] = real ? lse[row] * kLog2e : __int_as_float(0x7f800000);
  }
}

// (b) dK, dV and the dQ partials of one (bh, 128-key tile).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
bwd_kv_kernel(const __grid_constant__ CUtensorMap qmap,   // [BH, T, D], 64
              const __grid_constant__ CUtensorMap domap,  // [BH, T, D], 64
              const __grid_constant__ CUtensorMap kmap,   // [BH, S, D], 128
              const __grid_constant__ CUtensorMap vmap,   // [BH, S, D], 128
              const float* __restrict__ lse2,             // [BH, Tp]
              const float* __restrict__ dvec,             // [BH, Tp]
              float* __restrict__ dq_acc,  // [BH, Tp / 64, 64 x D] partials
              int* __restrict__ order,     // [BH, Tp / 64] tiles added
              uint16_t* __restrict__ dq, uint16_t* __restrict__ dk,
              uint16_t* __restrict__ dv, int T, int S, int q_offset,
              int causal, float scale, float scale_log2) {
  constexpr int kKV = tile_bytes<D>(kBK);
  constexpr int kQ = tile_bytes<D>(kBQ);
  constexpr int kDS = box_bytes(kBK);  // dS^T: 128 keys x 64 queries
  constexpr int kDQ = dq_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t kv_full;
  __shared__ __align__(8) uint64_t q_full[kStages];
  __shared__ __align__(8) uint64_t q_empty[kStages];
  __shared__ __align__(8) uint64_t dq_full[2];
  __shared__ __align__(8) uint64_t dq_empty[2];

  // swizzled boxes need 1024-byte aligned shared addresses
  uint8_t* const sk =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* const sv = sk + kKV;
  uint8_t* const sring = sv + kKV;  // stage s: Q at sring + 2s·kQ, dO after
  uint8_t* const sds = sring + kStages * 2 * kQ;  // dS^T, by step parity
  uint8_t* const sdq = sds + 2 * kDS;             // dQ partials, likewise
  float* const sstat = reinterpret_cast<float*>(sdq + 2 * kDQ);
  // stage s: lse2 at sstat + 2s·kBQ, D after

  const int n_kt = gridDim.x;
  const int kt = n_kt - 1 - blockIdx.x;  // launched in the order they add
  const int bh = blockIdx.y;
  const int k0 = kt * kBK;
  const int Tp = padded_rows(T);
  const int n_qt = Tp / kBQ;
  const int q_start = causal ? max(0, k0 - q_offset) / kBQ * kBQ : 0;
  const int n_steps = (T - q_start + kBQ - 1) / kBQ;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    mbar_init(&kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&q_full[s], 1);
      mbar_init(&q_empty[s], kConsumers * 128);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&dq_full[b], kConsumers * 128);
      mbar_init(&dq_empty[b], 1);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kConsumers * 4) {  // the producer warpgroup
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) {  // lane 0 of warp 8: TMA loads
      mbar_expect_tx(&kv_full, 2 * kKV);
      for (int c = 0; c < D / 64; ++c) {
        tma_load_3d(sk + c * box_bytes(kBK), &kmap, &kv_full, c * 64, k0, bh);
        tma_load_3d(sv + c * box_bytes(kBK), &vmap, &kv_full, c * 64, k0, bh);
      }
      const int64_t stat0 = (int64_t)bh * Tp;
      for (int j = 0; j < n_steps; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&q_empty[s], (j / kStages - 1) & 1);
        const int q0 = q_start + j * kBQ;
        uint8_t* qs = sring + 2 * s * kQ;
        float* st = sstat + 2 * s * kBQ;
        mbar_expect_tx(&q_full[s], 2 * kQ + 2 * kBQ * 4);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_3d(qs + c * box_bytes(kBQ), &qmap, &q_full[s], c * 64, q0,
                      bh);
          tma_load_3d(qs + kQ + c * box_bytes(kBQ), &domap, &q_full[s],
                      c * 64, q0, bh);
        }
        bulk_load(st, lse2 + stat0 + q0, kBQ * 4, &q_full[s]);
        bulk_load(st + kBQ, dvec + stat0 + q0, kBQ * 4, &q_full[s]);
      }
    } else if (threadIdx.x == kConsumers * 128 + 32 && kt > 0) {
      // lane 0 of warp 9: the partials out, in the order (block 0 adds
      // last and writes dQ itself)
      for (int j = 0; j < n_steps; ++j) {
        const int b = j & 1;
        const int q0 = q_start + j * kBQ;
        const int rank = last_key_tile(q0, n_kt, q_offset, causal) - kt;
        const int64_t tile = (int64_t)bh * n_qt + q0 / kBQ;
        int* cnt = order + tile;
        if (rank > 0) {  // the key tiles above this one are in
          while (ld_acquire(cnt) < rank) __nanosleep(32);
          fence_proxy_async_global();
        }
        mbar_wait(&dq_full[b], (j >> 1) & 1);
        float* dst = dq_acc + tile * (kBQ * D);
        if (rank == 0)
          bulk_store(dst, sdq + b * kDQ, kDQ);
        else
          bulk_reduce_add_f32(dst, sdq + b * kDQ, kDQ);
        bulk_commit();
        bulk_wait_read();
        mbar_arrive(&dq_empty[b]);
        bulk_wait();
        fence_proxy_async_global();
        __threadfence();
        red_release_add(cnt, 1);
      }
    }
  } else {
    // a consumer warpgroup: 64 keys; this thread's keys are key, key + 8
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = warp >> 2;
    const int lane = threadIdx.x & 31;
    const int tid = threadIdx.x & 127;
    const int g = lane >> 2;
    const int t2 = (lane & 3) * 2;
    const int kw0 = k0 + wg * 64;
    const int krow = wg * 64 + (warp & 3) * 16 + g;  // its row in the tile
    const int key = k0 + krow;
    const uint8_t* sk_wg = sk + wg * 64 * 128;  // its rows in every box
    const uint8_t* sv_wg = sv + wg * 64 * 128;
    // the dQ product's D columns (at D = 64 both warpgroups compute the one
    // partial, so no wgmma sits in a divergent branch; warpgroup 0 keeps it)
    const int dq_box = D == 128 ? wg : 0;
    const bool dq_keep = D == 128 || wg == 0;

    float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
    mbar_wait(&kv_full, 0);

    for (int j = 0; j < n_steps; ++j) {
      const int s = j % kStages;
      const int b = j & 1;
      const int q0 = q_start + j * kBQ;
      const uint8_t* qs = sring + 2 * s * kQ;
      const uint8_t* dos = qs + kQ;
      const float* sl = sstat + 2 * s * kBQ;
      const float* sd = sl + kBQ;
      uint8_t* ds = sds + b * kDS;
      mbar_wait(&q_full[s], (j / kStages) & 1);
      const uint64_t d_k = kdesc(sk_wg), d_v = kdesc(sv_wg);
      const uint64_t d_q = kdesc(qs), d_do = kdesc(dos);
      const uint64_t d_ds = kdesc(ds + wg * 64 * 128);
      const uint64_t d_qt = mndesc(qs, box_bytes(kBQ));
      const uint64_t d_dot = mndesc(dos, box_bytes(kBQ));

      {
        // S^T = K . Q^T and dP^T = V . dO^T over D, two wgmma groups
        float st[kBQ / 2], dpt[kBQ / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_m64n64_t<0, 0>(st, kmajor(d_k, box_bytes(kBK), kk),
                                  kmajor(d_q, box_bytes(kBQ), kk), kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_m64n64_t<0, 0>(dpt, kmajor(d_v, box_bytes(kBK), kk),
                                  kmajor(d_do, box_bytes(kBQ), kk), kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(st);

        // P^T = 2^(scale_log2 * S^T - lse2[query]); element i of the
        // accumulator is key row key (+8 if i & 2), query column
        // q0 + 8(i / 4) + t2 + (i & 1)
        const bool edge =
            kw0 + 64 > S || (causal && kw0 + 63 > q0 + q_offset);
#pragma unroll
        for (int i = 0; i < kBQ / 2; ++i) {
          const int qc = (i >> 2) * 8 + t2 + (i & 1);
          float p = fast_exp2(st[i] * scale_log2 - sl[qc]);
          if (edge) {
            const int kr = key + ((i & 2) ? 8 : 0);
            if (kr >= S || (causal && kr > q0 + qc + q_offset)) p = 0.f;
          }
          st[i] = p;
        }
        uint32_t pa[kBQ / 16][4];
#pragma unroll
        for (int kk = 0; kk < kBQ / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            pa[kk][r] = pack_bf16(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);

        // dV += P^T . dO
        fence_regs(acc_v);
        fence_regs(pa);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBQ / 16; ++kk)
          rs_step<D>(acc_v, pa[kk], mnmajor(d_dot, kk));
        wgmma_commit();

        // dS^T = P^T * (dP^T - D[query]) while dV's product runs
        wgmma_wait<1>();
        fence_regs(dpt);
#pragma unroll
        for (int i = 0; i < kBQ / 2; ++i)
          st[i] *= dpt[i] - sd[(i >> 2) * 8 + t2 + (i & 1)];
        wgmma_wait<0>();
        fence_regs(acc_v);
        // dS^T in bf16 into shared memory, swizzled as a TMA box: rows
        // krow, krow + 8 (both have row & 7 == g), queries 16kk + 8(r / 2)
        // + t2, +1: bank-conflict free
#pragma unroll
        for (int kk = 0; kk < kBQ / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int chunk = (2 * kk + (r >> 1)) ^ g;
            *reinterpret_cast<uint32_t*>(ds + (krow + (r & 1) * 8) * 128 +
                                         chunk * 16 + t2 * 2) =
                pack_bf16(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
          }
      }
      fence_proxy_async();
      named_barrier_sync(kDsBar, kConsumers * 128);  // all of dS^T stored

      // dK += dS^T . Q and the dQ partial = dS . K (dS^T and K MN-major)
      float dqp[32];
      const uint64_t d_dst = mndesc(ds, kDS);
      const uint64_t d_kt =
          mndesc(sk + dq_box * box_bytes(kBK), box_bytes(kBK));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk)
        ss_step<D>(acc_k, kmajor(d_ds, kDS, kk), mnmajor(d_qt, kk));
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_ss_m64n64_t<1, 1>(dqp, mnmajor(d_dst, kk), mnmajor(d_kt, kk),
                                kk > 0);
      wgmma_commit();
      // block 0 is last in the order: while the products run, wait for the
      // other key tiles' sum of this query tile and fetch it
      const int kt_last = last_key_tile(q0, n_kt, q_offset, causal);
      const int64_t tile = (int64_t)bh * n_qt + q0 / kBQ;
      float4 prev[8];
      if (kt == 0 && dq_keep && kt_last > 0) {
        while (ld_acquire(order + tile) < kt_last) __nanosleep(32);
        const float4* sum = reinterpret_cast<const float4*>(
                                dq_acc + tile * (kBQ * D)) +
                            wg * 8 * 128 + tid;
#pragma unroll
        for (int c = 0; c < 8; ++c) prev[c] = __ldcg(sum + c * 128);
      } else {
#pragma unroll
        for (int c = 0; c < 8; ++c) prev[c] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      wgmma_wait<0>();
      fence_regs(acc_k);
      fence_regs(dqp);
      mbar_arrive(&q_empty[s]);

      if (kt == 0) {
        // add its own partial and write dQ
        if (dq_keep) {
          const int row = q0 + (warp & 3) * 16 + g;
          uint16_t* out = dq + ((int64_t)bh * T + row) * D + 64 * dq_box + t2;
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            if (row < T)
              *reinterpret_cast<uint32_t*>(out + 8 * c) =
                  pack_bf16((prev[c].x + dqp[4 * c]) * scale,
                            (prev[c].y + dqp[4 * c + 1]) * scale);
            if (row + 8 < T)
              *reinterpret_cast<uint32_t*>(out + 8 * D + 8 * c) =
                  pack_bf16((prev[c].z + dqp[4 * c + 2]) * scale,
                            (prev[c].w + dqp[4 * c + 3]) * scale);
          }
        }
      } else {
        // hand the partial to the writer: float4 c of thread tid of
        // warpgroup w at (w·8 + c)·128 + tid, element i of dqp at row
        // 16(warp & 3) + g (+8 if i & 2), column 64w + 8(i / 4) + t2 + (i & 1)
        if (dq_keep) {
          if (j >= 2) mbar_wait(&dq_empty[b], ((j >> 1) - 1) & 1);
          float4* out = reinterpret_cast<float4*>(sdq + b * kDQ) +
                        wg * 8 * 128 + tid;
#pragma unroll
          for (int c = 0; c < 8; ++c)
            out[c * 128] = make_float4(dqp[4 * c], dqp[4 * c + 1],
                                       dqp[4 * c + 2], dqp[4 * c + 3]);
          fence_proxy_async();
        }
        mbar_arrive(&dq_full[b]);
      }
    }

    const int64_t kbase = (int64_t)bh * S;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = n * 8 + t2;
      if (key < S) {
        *reinterpret_cast<uint32_t*>(dk + (kbase + key) * D + col) =
            pack_bf16(acc_k[4 * n] * scale, acc_k[4 * n + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + (kbase + key) * D + col) =
            pack_bf16(acc_v[4 * n], acc_v[4 * n + 1]);
      }
      if (key + 8 < S) {
        *reinterpret_cast<uint32_t*>(dk + (kbase + key + 8) * D + col) =
            pack_bf16(acc_k[4 * n + 2] * scale, acc_k[4 * n + 3] * scale);
        *reinterpret_cast<uint32_t*>(dv + (kbase + key + 8) * D + col) =
            pack_bf16(acc_v[4 * n + 2], acc_v[4 * n + 3]);
      }
    }
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
    const cudaError_t err = cudaFuncSetAttribute(
        bwd_kv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes<D>());
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int Tp = padded_rows(T);
  const int64_t rows = static_cast<int64_t>(BH) * Tp;
  float* dq_acc = static_cast<float*>(scratch);
  float* dvec = dq_acc + rows * D;
  float* lse2 = dvec + rows;
  int* order = reinterpret_cast<int*>(lse2 + rows);
  CUtensorMap qmap, domap, kmap, vmap;
  if (!encode_rows_map(&qmap, q, BH, T, D, kBQ) ||
      !encode_rows_map(&domap, dout, BH, T, D, kBQ) ||
      !encode_rows_map(&kmap, k, BH, S, D, kBK) ||
      !encode_rows_map(&vmap, v, BH, S, D, kBK))
    return cudaErrorInvalidValue;

  bwd_prep_kernel<D><<<static_cast<unsigned>((rows * (D / 8) + 255) / 256),
                       256, 0, stream>>>(
      static_cast<const uint16_t*>(o), static_cast<const uint16_t*>(dout),
      static_cast<const float*>(lse), dvec, lse2, order,
      static_cast<uint16_t*>(dq), rows, T, Tp, q_offset, causal);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_kv_kernel<D><<<dim3((S + kBK - 1) / kBK, BH), kThreads,
                      smem_bytes<D>(), stream>>>(
      qmap, domap, kmap, vmap, lse2, dvec, dq_acc, order,
      static_cast<uint16_t*>(dq), static_cast<uint16_t*>(dk),
      static_cast<uint16_t*>(dv), T, S, q_offset, causal, scale,
      scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// scratch: BH * Tp * (D + 2) + BH * Tp / 64 four-byte words, Tp = T rounded
// up to a multiple of 64: the dQ partial sums (fp32), D, lse in base 2,
// then the per-query-tile order counters (int).
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
