// Paged decode attention for Hopper (sm_90a): split-W over the block table.
//
// Replaces repro/kernels/paged.py::paged_decode_attention (body
// _paged_kernel): one decode query per sequence — R query heads grouped
// per KV head — attends to the rows of up to W pool pages named by a
// block table. Rows are masked where the slot is padding (logical < 0) or
// the row lies at or beyond kv_len; a sequence with no valid row gives 0;
// physical ids are clamped into the pool. Statistics are fp32; the output
// is bf16. Scores and the normalised P are rounded to bf16 where the plain
// version (kvcache.paged_attention.paged_gather_decode, bf16 matmuls)
// rounds them, so the kernel computes what its plain version computes up
// to the order of fp32 sums.
//
// Bound: memory. Each call must read the K and V rows of every gathered
// page once: at the OLMo-1B main path (B=4, W=64, page=16, nkv=16, d=128,
// kv_len 1024/1000/777/500) that is 27 MB, 8.1 us at 3.35 TB/s; the
// arithmetic (4·R flops per K/V element pair) is far below the bf16 ridge.
// So the card has to be kept full of loads: the TPU kernel's grid walks a
// sequence's pages in order on one core, and the first port kept that
// shape (one block per (sequence, KV head): 64 blocks on 132 SMs, 2 KB in
// flight per warp, 245 GB/s).
//
// Design:
//   * Split-W. Each (sequence, KV head) is cut into n_split contiguous
//     ranges of block-table slots, [s·W / n, (s+1)·W / n), one block each:
//     a (B·G, n_split) grid. The host picks n_split from the shapes alone
//     (kernels/paged.py::split_plan: about 4 blocks per SM, ranges of at
//     most kMaxRows rows), never from kv_len's values, which would cost a
//     device sync per layer.
//   * Three kernels on the caller's stream, launched by one C entry point,
//     with a workspace the wrapper allocates (nothing is allocated here):
//       1. scores: each block reads its K rows, writes the scaled scores
//          and its range's (m, l);
//       2. P·V: each block merges the ranges' (m, l) into the sequence's
//          (M, L) in split order, turns its range's scores into
//          P = bf16(exp(s - M) / L) in shared memory, reads its V rows and
//          writes the partial o = sum of P · v;
//       3. sum: the partial o's of each (sequence, KV head), added in split
//          order, rounded to bf16.
//     No atomics: two calls give identical bits. Normalising P before
//     P·V, as the plain version does, is what the two passes over the
//     table buy: a one-pass flash merge cannot round P where the plain
//     version does. With fp32 P the served path once put a token two bf16
//     steps from both dense oracles of chip_smoke.py's phase 4, whose
//     verdict turns on such rounding (PERF.md, Findings;
//     tools/torch_decode_forms.py).
//   * Overlap. Passes 2 and 3 are launched as programmatic dependents:
//     pass 2's blocks start while pass 1 runs, stream their V rows in and
//     wait for pass 1's results (griddepcontrol) only before using them.
//   * Early exit. A block first finds how many of its rows it must visit
//     (up to the last valid row of its range); with none it writes
//     (m = NEG_INF, l = 0) and the later passes weigh it as 0.
//   * Loads. The pool stays in its native [P, page, G, d] layout, read
//     through strides (no copy). Rows move 16 rows (one page at page 16)
//     a stage as 16-byte cp.async copies into a 16 KB ring (4 stages at
//     d = 128), masked rows zero-filled without a read; several blocks
//     share an SM. A 32 KB ring, with a block's whole range in flight at
//     once, measured slower: each block's first stage then lands last.
//   * The int8 cold tier (kv_quant="int8"). A second form of the three
//     kernels (template flag Q; launches without the tier run the fp form,
//     whose code is unchanged) reads, for each slot its qmask marks, the
//     slot's rows from the int8 mirror slabs kq/vq ([P, page, G, d],
//     through their own strides) instead of the bf16 slabs: half the
//     bytes, through the same cp.async ring (an int8 row lands in the
//     first half of its row's place), and the consumer turns each code
//     into bf16(float(code) · scale[page]), one fp32 product rounded to
//     nearest, exactly as the plain gather
//     (kvcache.paged_attention._gather_hot) dequantizes, then runs the fp
//     form's arithmetic on it. So every value and every fp32 sum, in its
//     order, is the fp form's over slabs whose marked pages hold the
//     dequantized rows (kvcache.paged_attention.dequantized_slabs): the
//     two are equal bit for bit, and an all-False qmask gives the fp
//     form's bits. What it costs beyond the fp form is latency, not
//     bytes, so the design keeps device-memory reads and divisions off
//     each row's path: one pass at block start (in place of the fp form's
//     row count) stages the range's slots in shared memory (page, mark,
//     valid rows, and the page's scale, which arrives by cp.async with the
//     first stage); the producer branches on that table; pass 2 reads
//     each row's scale from an array it fills once (a division on each
//     stage's path instead cost 1 us); each pass branches once a row
//     (pass 1) or once a stage (pass 2, where pages hold whole stages),
//     not in its inner loop, so its loads batch as the fp form's; and a
//     code becomes a float by a byte permute into 2^23's bits and one
//     subtraction, exact, not by the conversion unit (16 a clock on an
//     SM). An earlier lane read a qmask byte behind a block-table read
//     from device memory for every 16-byte copy and copied each row's
//     scale with its own cp.async: 6 us over the fp form with no slot
//     marked (PERF.md). Widening each landed int8 stage to bf16 in place,
//     by the thread that copied it before the stage's barrier, measured
//     slower than converting in registers where each code is read.
//   * Arithmetic. A row's score comes from 8 threads (a 3-step shuffle);
//     the first of them writes it and keeps its rows' max, and the 16 row
//     owners merge their (m, l) at the end, so a stage needs one barrier.
//     In P·V each thread adds its pair of output columns over a subset of
//     the stage's rows for all R heads, so every K/V row loaded serves the
//     whole GQA group. At D = 192 (Nemotron-4-340B's head, R = 12) a row
//     has 96 pairs: 96 threads add every row of the stage and the other
//     32 only copy rows in.
//
//   * The unnormalised (m, l, o) form (template flag ST; its own entry
//     point, paged_decode_stats), for the spatial engine's cross-shard
//     merge. It is the state the TPU kernel itself keeps (_paged_kernel's
//     fp32 o, m, l) and computes what the plain
//     kvcache.paged_attention.paged_gather_decode_stats computes: scores
//     rounded to bf16 as in the other form, P = exp(s - M) kept in fp32
//     (neither divided nor rounded), V widened to fp32, and fp32 (m, l, o)
//     written by pass 3 in split order without a rounding (no atomics:
//     two calls give identical bits). Pass 1 computes what the other
//     form's pass 1 computes. All shards run in one launch sequence: the
//     shard axis folds into the batch axis. Rows b = s·Bq + j of the block
//     tables are shard s's sequence j: they read query row j and
//     kv_len[j], and their physical ids index shard s's pool, pages
//     [s·P, (s + 1)·P) of the [S·P, page, G, D] slab (Range<true>; the
//     other form instantiates Range<false>, without that arithmetic). A
//     shard with no valid row for a sequence takes the early exit and
//     writes (m = NEG_INF, l = 0, o = 0), the merge's neutral state: no
//     host branch decides which shards run. Both lanes (fp and int8) have
//     the form.
//
// Later work: the kernel takes about 4x its bound, in two passes that each
// wait on DRAM and then on a few hundred cycles of work per stage; the
// tick is bound by the host, so CUDA-graph capture of the decode step
// comes first (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;            // rows per stage
constexpr int kRingBytes = 16384;    // one pass streams K or V
constexpr int kMaxRows = 256;        // rows of one range (split_plan)
constexpr int kMergeChunk = 64;      // splits staged at a time by pass 2

template <int D>
__host__ __device__ constexpr int stages() {
  return kRingBytes / (kRows * D * 2) > 8 ? 8 : kRingBytes / (kRows * D * 2);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// src-size 0: no read, zeros land in dst
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Programmatic dependent launch (sm_90): let the next kernel on the stream
// start, and wait until the previous one has finished and its writes are
// visible.
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// The int8 mirror tier of one slab (K or V): codes [P, page, G, D] int8
// through their strides, f32 scales [P], and the step's qmask [B, W]
// (nonzero: the slot reads its int8 rows). Unused by the fp form.
struct Int8Tier {
  const int8_t* codes;
  const float* scale;
  const uint8_t* qmask;
  int64_t sp, sr, sg;
};

// bf16(float(code) · scale), the plain gather's dequantization, of the
// codes in bytes 0..N-1 of w, widened back to fp32: the values a convert,
// a product and a rounding per code give, with the two conversions (16 a
// clock on an SM) replaced by integer byte permutes and one packed
// rounding per pair. code + 128 in the low byte of 2^23's bits reads as
// 2^23 + code + 128, exactly.
template <int N>
__device__ __forceinline__ void dequant(uint32_t w, float scale,
                                        float* out) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    const float a =
        __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + i)) - 8388736.f;
    const float b =
        __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651 + i)) - 8388736.f;
    const float2 ab =
        __bfloat1622float2(__floats2bfloat162_rn(a * scale, b * scale));
    out[i] = ab.x;
    out[i + 1] = ab.y;
  }
}

// The workspace, fp32: m and l [B·G, n_split, R], o [B·G, n_split, R, D],
// scores [B·G, R, W·page]; the view of one block's (b·g, split).
struct Workspace {
  float* m;
  float* l;
  float* o;
  float* s;  // this b·g's scores: head r's at s + r·W·page
  __device__ Workspace(float* ws, int bg, int n_bg, int split, int n_split,
                       int R, int D, int rows_w) {
    const int64_t at = ((int64_t)bg * n_split + split) * R;
    const int64_t all = (int64_t)n_bg * n_split * R;
    m = ws + at;
    l = ws + all + at;
    o = ws + 2 * all + at * D;
    s = ws + all * (D + 2) + (int64_t)bg * R * rows_w;
  }
};

// The block's range of one sequence's block table. In the stats form
// (FOLD) row b of the tables is shard b / Bq's sequence b % Bq, and its
// pages are [shard·P, (shard + 1)·P) of the slab; the other form reads
// row b as sequence b of the one pool, and carries none of that
// arithmetic (its registers are those of the form before the fold).
template <bool FOLD>
struct Range {
  int w0, w1, len, page, n_pages, base;
  const int32_t* phys;
  const int32_t* logical;
  const uint8_t* qmask;  // null in the fp form
  __device__ Range(const int32_t* phys_all, const int32_t* logical_all,
                   const int32_t* kv_len, const uint8_t* qmask_all, int b,
                   int Bq, int W, int page_, int P) {
    w0 = (int)((int64_t)blockIdx.y * W / gridDim.y);
    w1 = (int)((int64_t)(blockIdx.y + 1) * W / gridDim.y);
    len = kv_len[FOLD ? b % Bq : b];
    page = page_;
    n_pages = P;
    base = FOLD ? (b / Bq) * P : 0;
    phys = phys_all + (int64_t)b * W;
    logical = logical_all + (int64_t)b * W;
    qmask = qmask_all ? qmask_all + (int64_t)b * W : nullptr;
  }

  // where row idx of the range lives (slot w0 + wi); false where it is
  // masked
  __device__ bool locate(int idx, int& ph, int& rp, int& wi) const {
    wi = idx / page;
    rp = idx - wi * page;
    const int lg = logical[w0 + wi];
    // padded slots are masked; the clamp keeps any id inside the shard's
    // pool
    ph = min(max(phys[w0 + wi], 0), n_pages - 1);
    if constexpr (FOLD) ph += base;
    return lg >= 0 && lg * page + rp < len;
  }
  // rows to visit, up to the last valid row (0: none); every thread
  // calls it, and it syncs the block
  __device__ int visit_rows(int* scratch) const {
    int mine = 0;
    for (int w = w0 + threadIdx.x; w < w1; w += kThreads) {
      const int lg = logical[w];
      if (lg >= 0 && (int64_t)lg * page < len)
        mine = max(mine, (w - w0) * page + min(page, len - lg * page));
    }
    mine = __reduce_max_sync(0xffffffffu, mine);
    if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = mine;
    __syncthreads();
    int rows = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) rows = max(rows, scratch[i]);
    return rows;
  }
};

// The int8 form's view of its range's slots, staged in shared memory once
// at block start, so that neither the producer nor the consumers read
// the qmask, the block table or a scale from device memory per row: each
// slot's page (clamped, shard base added), whether it reads the tier,
// its valid rows and its page's scale (-1: a bf16 slot).
template <int N>
struct SlotTable {
  int ph[N];
  int lim[N];
  float scale[N];
  uint8_t q8[N];
};

// The int8 form's block start, in place of Range::visit_rows: one pass
// over the range's slots fills the table and finds the rows to visit (up
// to the last valid row; 0: none). The scales of marked pages arrive by
// cp.async in the first stage's group, so no thread waits on one: the
// first stage's wait and barrier publish them. Every thread calls it, and
// it syncs the block.
template <bool FOLD>
__device__ int stage_slots(SlotTable<kMaxRows>& t, const Range<FOLD>& range,
                           const float* __restrict__ scale, int* scratch) {
  int mine = 0;
  for (int wi = threadIdx.x; wi < range.w1 - range.w0; wi += kThreads) {
    const int w = range.w0 + wi;
    const int lg = range.logical[w];
    const int64_t left = (int64_t)range.len - (int64_t)lg * range.page;
    const int lim =
        lg < 0 || left <= 0 ? 0 : (int)min((int64_t)range.page, left);
    int ph = min(max(range.phys[w], 0), range.n_pages - 1);
    if constexpr (FOLD) ph += range.base;
    const bool q8 = lim > 0 && range.qmask[w];
    t.ph[wi] = ph;
    t.lim[wi] = lim;
    t.q8[wi] = q8;
    if (q8)
      cp_async4(&t.scale[wi], scale + ph);
    else
      t.scale[wi] = -1.f;
    if (lim > 0) mine = max(mine, wi * range.page + lim);
  }
  mine = __reduce_max_sync(0xffffffffu, mine);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = mine;
  __syncthreads();
  int rows = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) rows = max(rows, scratch[i]);
  return rows;
}

// The int8 form's reading of row idx < rows of the range: its page scale
// if it is a valid row of a marked slot (its codes are in the stage),
// else -1 (its bf16 row, or zeros where it is masked).
__device__ __forceinline__ float row_scale(const SlotTable<kMaxRows>& t,
                                           int idx, int page) {
  const int wi = idx / page;
  return idx - wi * page < t.lim[wi] ? t.scale[wi] : -1.f;
}

// A row's int8 codes in the int8 form: the first D bytes of its place in
// the stage's bf16 tile.
__device__ __forceinline__ int8_t* codes_of(__nv_bfloat16* tile, int r,
                                            int D) {
  return reinterpret_cast<int8_t*>(tile + r * D);
}
__device__ __forceinline__ const int8_t* codes_of(const __nv_bfloat16* tile,
                                                  int r, int D) {
  return reinterpret_cast<const int8_t*>(tile + r * D);
}

// Issue the copies of stage st (rows [st·kRows, st·kRows + kRows) of the
// range) into ring slot st % NS: bf16 rows into tile, 16 bytes a copy,
// masked rows zero-filled without a read. In the int8 form, which reads
// its range's slots from the staged table, a valid row of a marked slot
// copies its D codes into the first D bytes of its place instead, 16
// codes a copy. Commits one group.
template <int D, bool Q, bool FOLD, typename Slots>
__device__ __forceinline__ void fetch_stage(
    int st, int n_st, int rows, const Range<FOLD>& range, int g,
    const __nv_bfloat16* __restrict__ src, int64_t sp, int64_t sr,
    int64_t sg, const Int8Tier& tier, const Slots& slots,
    __nv_bfloat16* tile) {
  constexpr int CH = D / 8;  // 16-byte bf16 chunks per row
  if (st < n_st) {
    for (int c = threadIdx.x; c < kRows * CH; c += kThreads) {
      const int r = c / CH;
      const int e = (c - r * CH) * 8;
      const int idx = st * kRows + r;
      int ph = 0, rp = 0, wi = 0;
      if constexpr (Q) {
        bool ok = false, q8 = false;
        if (idx < rows) {
          wi = idx / range.page;
          rp = idx - wi * range.page;
          ph = slots.ph[wi];
          ok = rp < slots.lim[wi];
          q8 = ok && slots.q8[wi];
        }
        if (!q8)
          cp_async16(&tile[r * D + e], src + ph * sp + rp * sr + g * sg + e,
                     ok);
        else if ((e & 15) == 0)
          cp_async16(codes_of(tile, r, D) + e,
                     tier.codes + ph * tier.sp + rp * tier.sr + g * tier.sg +
                         e,
                     true);
      } else {
        const bool ok = idx < rows && range.locate(idx, ph, rp, wi);
        cp_async16(&tile[r * D + e], src + ph * sp + rp * sr + g * sg + e,
                   ok);
      }
    }
  }
  cp_async_commit();  // empty groups keep the count uniform
}

// Pass 1: the range's scaled scores (bf16(q·k) · scale, NEG_INF where
// masked) into the workspace, and its (m, l); in the stats form (ST)
// over the shards folded into the batch.
template <int D, int R, bool Q, bool ST>
__global__ void __launch_bounds__(kThreads)
paged_scores_kernel(const __nv_bfloat16* __restrict__ q,   // [B, G, R, D]
                    const __nv_bfloat16* __restrict__ k,   // [P, page, G, D]
                    const int32_t* __restrict__ phys,      // [B, W]
                    const int32_t* __restrict__ logical,   // [B, W]
                    const int32_t* __restrict__ kv_len,    // [B]
                    float* __restrict__ ws, int Bq, int G, int W, int page,
                    int P, int64_t k_sp, int64_t k_sr, int64_t k_sg,
                    float scale, Int8Tier tier) {
  constexpr int NS = stages<D>();
  constexpr int CH = D / 8;              // 16-byte chunks per row
  constexpr int TPR = kThreads / kRows;  // threads per row
  static_assert(CH % TPR == 0, "tile shape");
  __shared__ __align__(16) __nv_bfloat16 sk[NS][kRows * D];
  __shared__ SlotTable<Q ? kMaxRows : 1> s_slots;
  __shared__ __align__(16) float sq[R][D];
  __shared__ float s_m[R][kRows], s_l[R][kRows];
  __shared__ int scratch[kWarps];
  griddep_launch_dependents();  // pass 2 may start its V loads now

  const int bg = blockIdx.x;
  const int b = bg / G;
  const int g = bg - b * G;
  const Range<ST> range(phys, logical, kv_len, tier.qmask, b, Bq, W, page,
                        P);
  const Workspace out(ws, bg, gridDim.x, blockIdx.y, gridDim.y, R, D,
                      W * page);
  const __nv_bfloat16* qb =
      q + (ST ? ((int64_t)(b % Bq) * G + g) * R * D : (int64_t)bg * R * D);
  for (int i = threadIdx.x; i < R * D; i += kThreads)
    sq[i / D][i % D] = __bfloat162float(qb[i]);
  int rows;
  if constexpr (Q)
    rows = stage_slots(s_slots, range, tier.scale, scratch);
  else
    rows = range.visit_rows(scratch);
  if (rows == 0) {  // (NEG_INF, 0): weight 0 in the later passes
    if (threadIdx.x < R) {
      out.m[threadIdx.x] = kNegInf;
      out.l[threadIdx.x] = 0.f;
    }
    return;
  }
  const int n_st = (rows + kRows - 1) / kRows;
  auto fetch = [&](int st) {
    fetch_stage<D, Q, ST>(st, n_st, rows, range, g, k, k_sp, k_sr, k_sg,
                          tier, s_slots, sk[st % NS]);
  };
#pragma unroll
  for (int st = 0; st < NS - 1; ++st) fetch(st);

  // the 8 threads of a row share its score; the first writes it and
  // keeps the max over its rows, one per stage
  const int srow = threadIdx.x / TPR;
  const int part = threadIdx.x % TPR;
  float m[R];
#pragma unroll
  for (int r = 0; r < R; ++r) m[r] = kNegInf;
  float* scores = out.s + range.w0 * page;
  for (int st = 0; st < n_st; ++st) {
    cp_async_wait<NS - 2>();
    __syncthreads();  // stage st landed; stage st - 1 is consumed
    fetch(st + NS - 1);
    const __nv_bfloat16* tile = sk[st % NS];
    const int idx = st * kRows + srow;
    int ph, rp, wi;
    const bool ok = idx < rows && range.locate(idx, ph, rp, wi);
    // >= 0: this row reads its int8 codes at this page scale (the table
    // holds -1 for a bf16 slot)
    const float qs = Q && ok ? s_slots.scale[Q ? wi : 0] : -1.f;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    // acc += q · k over chunk c (8 values); with qs >= 0 the row's codes
    auto add_chunk = [&](int c, float qs) {
      float kx[8];
      if (Q && qs >= 0.f) {
        const uint2 raw = *reinterpret_cast<const uint2*>(
            codes_of(tile, srow, D) + c * 8);
        dequant<4>(raw.x, qs, kx);
        dequant<4>(raw.y, qs, kx + 4);
      } else {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(&tile[srow * D + c * 8]);
        const __nv_bfloat162* two =
            reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 kf = __bfloat1622float2(two[e]);
          kx[2 * e] = kf.x;
          kx[2 * e + 1] = kf.y;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          acc[r] = fmaf(sq[r][c * 8 + 2 * e], kx[2 * e],
                        fmaf(sq[r][c * 8 + 2 * e + 1], kx[2 * e + 1],
                             acc[r]));
      }
    };
    // a row's 8 threads read 128 bytes a step; the branch stays outside
    // the steps so that their loads batch as the fp form's do
    if (Q && qs >= 0.f) {
#pragma unroll
      for (int u = 0; u < CH / TPR; ++u) add_chunk(part + u * TPR, qs);
    } else {
#pragma unroll
      for (int u = 0; u < CH / TPR; ++u) add_chunk(part + u * TPR, -1.f);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
      if (part == 0 && idx < rows) {
        const float s = ok ? round_bf16(acc[r]) * scale : kNegInf;
        scores[(int64_t)r * W * page + idx] = s;
        m[r] = fmaxf(m[r], s);
      }
    }
  }
  cp_async_wait<0>();
  // each row owner's l over the scores it wrote; then the 16 owners'
  // (m, l) merge in row order
  if (part == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float l = 0.f;
      for (int idx = srow; idx < rows; idx += kRows) {
        const float x = scores[(int64_t)r * W * page + idx];
        if (x > kNegInf / 2) l += expf(x - m[r]);
      }
      s_m[r][srow] = m[r];
      s_l[r][srow] = l;
    }
  }
  __syncthreads();
  if (threadIdx.x < R) {
    const int r = threadIdx.x;
    float mx = kNegInf;
    for (int i = 0; i < kRows; ++i)
      if (s_l[r][i] > 0.f) mx = fmaxf(mx, s_m[r][i]);
    float sum = 0.f;
    for (int i = 0; i < kRows; ++i)
      if (s_l[r][i] > 0.f) sum += s_l[r][i] * expf(s_m[r][i] - mx);
    out.m[r] = mx;
    out.l[r] = sum;
  }
}

// Pass 2: the range's share of o = sum of bf16(exp(s - M) / L) · v, with
// (M, L) the sequence's, merged from every range's (m, l) in split order;
// in the stats form (ST) P = exp(s - M) in fp32, neither divided nor
// rounded. Launched while pass 1 runs: it streams its V rows in first and
// waits for pass 1's results only before it needs them.
template <int D, int R, bool Q, bool ST>
__global__ void __launch_bounds__(kThreads)
paged_pv_kernel(const __nv_bfloat16* __restrict__ v,   // [P, page, G, D]
                const int32_t* __restrict__ phys,      // [B, W]
                const int32_t* __restrict__ logical,   // [B, W]
                const int32_t* __restrict__ kv_len,    // [B]
                float* __restrict__ ws, int Bq, int G, int W, int page,
                int P, int64_t v_sp, int64_t v_sr, int64_t v_sg,
                Int8Tier tier) {
  constexpr int NS = stages<D>();
  constexpr int EP = D / 2;              // bf16 pairs per row
  // row subsets: the threads past NH·EP (32 of 128 at D = 192, whose 96
  // pairs do not divide the block) add no products, only copy and merge
  constexpr int NH = kThreads / EP;
  constexpr int RT = kRows / NH;         // rows per thread and stage
  static_assert(NH >= 1 && kRows % NH == 0 &&
                    NH * R * D * 4 <= NS * kRows * D * 2,
                "tile shape");
  __shared__ __align__(16) __nv_bfloat16 sv[NS][kRows * D];
  __shared__ SlotTable<Q ? kMaxRows : 1> s_slots;
  __shared__ float s_qs[Q ? kMaxRows : 1];  // each row's row_scale
  __shared__ float s_p[R][kMaxRows];     // the range's P
  __shared__ float s_M[R], s_L[R];
  __shared__ float s_ml[2][kMergeChunk * R];  // staged (m, l) of splits
  __shared__ int scratch[kWarps];
  griddep_launch_dependents();  // pass 3 may launch now

  const int bg = blockIdx.x;
  const int b = bg / G;
  const int g = bg - b * G;
  const int n_split = gridDim.y;
  const Range<ST> range(phys, logical, kv_len, tier.qmask, b, Bq, W, page,
                        P);
  const Workspace out(ws, bg, gridDim.x, blockIdx.y, n_split, R, D,
                      W * page);
  int rows;
  if constexpr (Q)
    rows = stage_slots(s_slots, range, tier.scale, scratch);
  else
    rows = range.visit_rows(scratch);
  if (rows == 0) {  // l = 0 for this range: pass 3 skips it
    griddep_wait();  // pass 3 relies on pass 1 having finished too
    return;
  }

  const int n_st = (rows + kRows - 1) / kRows;
  auto fetch = [&](int st) {
    fetch_stage<D, Q, ST>(st, n_st, rows, range, g, v, v_sp, v_sr, v_sg,
                          tier, s_slots, sv[st % NS]);
  };
#pragma unroll
  for (int st = 0; st < NS - 1; ++st) fetch(st);

  griddep_wait();  // pass 1's scores and (m, l) are complete from here
  {
    // (M, L) of the sequence: head r's thread walks the splits in order,
    // twice (max, then the rescaled sum), from (m, l) that the whole
    // block stages kMergeChunk splits at a time (one thread reading
    // n_split values from device memory in turn waited on each load)
    const Workspace all(ws, bg, gridDim.x, 0, n_split, R, D, W * page);
    const int r = threadIdx.x;
    float mx = kNegInf, den = 0.f;
    for (int sweep = 0; sweep < 2; ++sweep) {
      for (int s0 = 0; s0 < n_split; s0 += kMergeChunk) {
        const int n = min(kMergeChunk, n_split - s0);
        __syncthreads();
        for (int i = threadIdx.x; i < n * R; i += kThreads) {
          s_ml[0][i] = all.m[s0 * R + i];
          s_ml[1][i] = all.l[s0 * R + i];
        }
        __syncthreads();
        if (r < R) {
          for (int s = 0; s < n; ++s) {
            const float ls = s_ml[1][s * R + r];
            if (ls <= 0.f) continue;
            if (sweep == 0)
              mx = fmaxf(mx, s_ml[0][s * R + r]);
            else
              den += ls * expf(s_ml[0][s * R + r] - mx);
          }
        }
      }
    }
    if (r < R) {
      s_M[r] = mx;
      s_L[r] = fmaxf(den, 1e-30f);
    }
  }
  // P = bf16(exp(s - M) / L) of every row of the range, once (0 where
  // masked and past the last row); exp(s - M) in the stats form
  const float* scores = out.s + range.w0 * page;
  const int padded = n_st * kRows;
  // the int8 form: the table's scales came with the first stage's group;
  // each row's, once here, spares every stage a division on its path
  if constexpr (Q) cp_async_wait<NS - 2>();
  __syncthreads();
  if constexpr (Q)
    for (int idx = threadIdx.x; idx < padded; idx += kThreads)
      s_qs[idx] = idx < rows ? row_scale(s_slots, idx, page) : -1.f;
  for (int i = threadIdx.x; i < R * padded; i += kThreads) {
    const int r = i / padded;
    const int idx = i - r * padded;
    const float x =
        idx < rows ? scores[(int64_t)r * W * page + idx] : kNegInf;
    if constexpr (ST)
      s_p[r][idx] = x > kNegInf / 2 ? expf(x - s_M[r]) : 0.f;
    else
      s_p[r][idx] =
          x > kNegInf / 2 ? round_bf16(expf(x - s_M[r]) / s_L[r]) : 0.f;
  }
  __syncthreads();
  float o[R][2];
#pragma unroll
  for (int r = 0; r < R; ++r) o[r][0] = o[r][1] = 0.f;
  const int pair = threadIdx.x % EP;
  const int sub = threadIdx.x / EP;
  const bool adds = sub < NH;  // this thread owns a pair of a row subset
  for (int st = 0; st < n_st; ++st) {
    cp_async_wait<NS - 2>();
    __syncthreads();
    fetch(st + NS - 1);
    if (!adds) continue;
    const __nv_bfloat16* tile = sv[st % NS];
    // o += p · v of one row; qs >= 0: the row holds codes at that scale
    auto add_row = [&](int row, float qs) {
      float2 vf;
      if (Q && qs >= 0.f) {
        float two[2];
        dequant<2>(*reinterpret_cast<const uint16_t*>(
                       codes_of(tile, row, D) + 2 * pair),
                   qs, two);
        vf = make_float2(two[0], two[1]);
      } else {
        vf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            &tile[row * D + 2 * pair]));
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float p = s_p[r][st * kRows + row];
        o[r][0] = fmaf(p, vf.x, o[r][0]);
        o[r][1] = fmaf(p, vf.y, o[r][1]);
      }
    };
    if (Q && page % kRows == 0) {
      // the stage is rows of one slot, read one way (its masked rows
      // were zero-filled: p = 0 times a finite value either way), so the
      // branch leaves the row loop and its loads batch as the fp form's
      const float qs = Q ? s_qs[Q ? st * kRows : 0] : -1.f;
      if (qs >= 0.f) {
#pragma unroll
        for (int j = 0; j < RT; ++j) add_row(sub + j * NH, qs);
      } else {
#pragma unroll
        for (int j = 0; j < RT; ++j) add_row(sub + j * NH, -1.f);
      }
    } else {
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        const int row = sub + j * NH;
        add_row(row, Q ? s_qs[Q ? st * kRows + row : 0] : -1.f);
      }
    }
  }

  // the NH row subsets' sums add, in order
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(&sv[0][0]);
  if (adds) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      red[(sub * R + r) * D + 2 * pair] = o[r][0];
      red[(sub * R + r) * D + 2 * pair + 1] = o[r][1];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    float acc = 0.f;
#pragma unroll
    for (int h = 0; h < NH; ++h) acc += red[h * R * D + i];
    out.o[i] = acc;
  }
}

// Pass 3: out[b, g] = the ranges' partial o's added in split order; a
// range with l = 0 (no valid row) adds nothing and its o is never read.
// The other form rounds it to bf16; the stats form (ST) writes it in fp32,
// and the first thread of each head also writes the sequence's (M, L),
// merged from the ranges' (m, l) in split order as pass 2 merges them
// (NEG_INF and 0 where no range holds a valid row).
// A (B·G, ceil(R·D / kThreads)) grid, one output per thread: with a wide
// GQA group (R·D of 1536-2048) and a short block table split many ways,
// one block per (b, g) walking R·D outputs x n_split ranges took most of
// the call. The split loop is unrolled for independent loads; the sum
// keeps its order, so the bits are those of one thread per output.
template <int D, int R, bool ST>
__global__ void __launch_bounds__(kThreads)
paged_sum_kernel(const float* __restrict__ ws, void* __restrict__ out,
                 float* __restrict__ m_out, float* __restrict__ l_out,
                 int n_split, int rows_w) {
  griddep_wait();
  const int bg = blockIdx.x;
  const int i = blockIdx.y * kThreads + threadIdx.x;
  if (i >= R * D) return;
  const Workspace all(const_cast<float*>(ws), bg, gridDim.x, 0, n_split, R,
                      D, rows_w);
  const int r = i / D;
  float acc = 0.f;
#pragma unroll 8
  for (int s = 0; s < n_split; ++s)
    if (all.l[s * R + r] > 0.f) acc += all.o[s * R * D + i];
  if constexpr (ST) {
    static_cast<float*>(out)[(int64_t)bg * R * D + i] = acc;
    if (i == r * D) {
      float mx = kNegInf, den = 0.f;
      for (int s = 0; s < n_split; ++s)
        if (all.l[s * R + r] > 0.f) mx = fmaxf(mx, all.m[s * R + r]);
      for (int s = 0; s < n_split; ++s) {
        const float ls = all.l[s * R + r];
        if (ls > 0.f) den += ls * expf(all.m[s * R + r] - mx);
      }
      m_out[(int64_t)bg * R + r] = mx;
      l_out[(int64_t)bg * R + r] = den;
    }
  } else {
    static_cast<__nv_bfloat16*>(out)[(int64_t)bg * R * D + i] =
        __float2bfloat16(acc);
  }
}

// Launch with programmatic dependent launch: the kernel may start before
// the previous one on the stream ends, and waits for it in griddep_wait.
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid,
                             cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <int D, int R, bool Q, bool ST>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* phys, const void* logical, const void* kv_len,
                   void* out, float* m_out, float* l_out, float* ws, int B,
                   int Bq, int G, int W, int page, int P, int64_t k_sp,
                   int64_t k_sr, int64_t k_sg, int64_t v_sp, int64_t v_sr,
                   int64_t v_sg, float scale, int n_split,
                   const Int8Tier& tier_k, const Int8Tier& tier_v,
                   cudaStream_t stream) {
  const dim3 grid(B * G, n_split);
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(v);
  const int32_t* ph = static_cast<const int32_t*>(phys);
  const int32_t* lg = static_cast<const int32_t*>(logical);
  const int32_t* kl = static_cast<const int32_t*>(kv_len);
  paged_scores_kernel<D, R, Q, ST><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k), ph, lg, kl, ws, Bq, G, W, page,
      P, k_sp, k_sr, k_sg, scale, tier_k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_dependent(paged_pv_kernel<D, R, Q, ST>, grid, stream, vp, ph,
                         lg, kl, ws, Bq, G, W, page, P, v_sp, v_sr, v_sg,
                         tier_v);
  if (err != cudaSuccess) return err;
  err = launch_dependent(paged_sum_kernel<D, R, ST>,
                         dim3(B * G, (R * D + kThreads - 1) / kThreads),
                         stream, static_cast<const float*>(ws), out, m_out,
                         l_out, n_split, W * page);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool bad_shape(int B, int Bq, int G, int W, int page, int P, int n_split) {
  return B <= 0 || Bq <= 0 || B % Bq != 0 || G <= 0 || W <= 0 || page <= 0 ||
         P <= 0 || n_split <= 0 || n_split > W ||
         (W + n_split - 1) / n_split * page > kMaxRows;
}

Int8Tier tier_of(const void* codes, const void* scale, const void* qmask,
                 int64_t sp, int64_t sr, int64_t sg) {
  return {static_cast<const int8_t*>(codes), static_cast<const float*>(scale),
          static_cast<const uint8_t*>(qmask), sp, sr, sg};
}

}  // namespace

// (D, R) pairs with R*D <= 1024 (Grok-1's group of 6 among them), and the
// GQA groups of ChatGLM3-6B (128, 16), StarCoder2-15B (128, 12) and
// Nemotron-4-340B (192, 12), whose P·V reduction still fits the ring
// (pass 2's static_assert); the Python
// wrapper checks the pair, the shapes and the strides before calling, and
// allocates ws: B·G·R·(n_split·(D + 2) + W·page) floats.
#define PAGED_CASES(Q, ST)                                                    \
  PAGED_CASE(64, 1, Q, ST) PAGED_CASE(64, 2, Q, ST) PAGED_CASE(64, 4, Q, ST)  \
  PAGED_CASE(64, 8, Q, ST) PAGED_CASE(64, 16, Q, ST)                          \
  PAGED_CASE(128, 1, Q, ST) PAGED_CASE(128, 2, Q, ST)                         \
  PAGED_CASE(128, 4, Q, ST) PAGED_CASE(128, 6, Q, ST)                         \
  PAGED_CASE(128, 8, Q, ST) PAGED_CASE(128, 12, Q, ST)                        \
  PAGED_CASE(128, 16, Q, ST)                                                  \
  PAGED_CASE(192, 12, Q, ST)                                                  \
  PAGED_CASE(256, 1, Q, ST) PAGED_CASE(256, 2, Q, ST)                         \
  PAGED_CASE(256, 4, Q, ST)
#define PAGED_CASE(DD, RR, Q, ST)                                             \
  if (D == DD && R == RR)                                                     \
    return static_cast<int>(launch<DD, RR, Q, ST>(                            \
        q, k, v, phys, logical, kv_len, out, m_out, l_out,                    \
        static_cast<float*>(ws), B, Bq, G, W, page, P, k_sp, k_sr, k_sg,      \
        v_sp, v_sr, v_sg, scale, n_split, tier_k, tier_v,                     \
        static_cast<cudaStream_t>(stream)));

// One entry point for both forms: with kq null the fp form runs (the tier
// arguments are ignored); otherwise the int8 form, which also reads the
// tier's codes (kq, vq, int8 [P, page, G, D] through their strides,
// 16-byte aligned), scales (k_scale, v_scale, f32 [P]) and the step's
// qmask (bool [B, W]).
extern "C" int paged_decode(
    const void* q, const void* k, const void* v, const void* phys,
    const void* logical, const void* kv_len, void* out, void* ws,
    const void* kq, const void* vq, const void* k_scale, const void* v_scale,
    const void* qmask, int B, int G, int R, int D, int W, int page, int P,
    int n_split, int64_t k_sp, int64_t k_sr, int64_t k_sg, int64_t v_sp,
    int64_t v_sr, int64_t v_sg, int64_t kq_sp, int64_t kq_sr, int64_t kq_sg,
    int64_t vq_sp, int64_t vq_sr, int64_t vq_sg, float scale, void* stream) {
  const int Bq = B;
  float* m_out = nullptr;
  float* l_out = nullptr;
  if (bad_shape(B, Bq, G, W, page, P, n_split))
    return static_cast<int>(cudaErrorInvalidValue);
  const Int8Tier tier_k = tier_of(kq, k_scale, qmask, kq_sp, kq_sr, kq_sg);
  const Int8Tier tier_v = tier_of(vq, v_scale, qmask, vq_sp, vq_sr, vq_sg);
  if (kq == nullptr) {
    PAGED_CASES(false, false)
  } else {
    PAGED_CASES(true, false)
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The unnormalised (m, l, o) form over S shards folded into the batch:
// B = S·Bq rows of phys/logical/qmask ([S, Bq, W], shard-local ids), q
// [Bq, G, R, D] and kv_len [Bq] shared by the shards, slabs [S·P, page, G,
// D] (and the int8 tier [S·P, ...], scales [S·P]) with P pages a shard.
// Writes fp32 m_out, l_out [B, G, R] and o_out [B, G, R, D].
extern "C" int paged_decode_stats(
    const void* q, const void* k, const void* v, const void* phys,
    const void* logical, const void* kv_len, void* m_ptr, void* l_ptr,
    void* o_ptr, void* ws, const void* kq, const void* vq,
    const void* k_scale, const void* v_scale, const void* qmask, int B,
    int Bq, int G, int R, int D, int W, int page, int P, int n_split,
    int64_t k_sp, int64_t k_sr, int64_t k_sg, int64_t v_sp, int64_t v_sr,
    int64_t v_sg, int64_t kq_sp, int64_t kq_sr, int64_t kq_sg, int64_t vq_sp,
    int64_t vq_sr, int64_t vq_sg, float scale, void* stream) {
  if (bad_shape(B, Bq, G, W, page, P, n_split))
    return static_cast<int>(cudaErrorInvalidValue);
  void* out = o_ptr;
  float* m_out = static_cast<float*>(m_ptr);
  float* l_out = static_cast<float*>(l_ptr);
  const Int8Tier tier_k = tier_of(kq, k_scale, qmask, kq_sp, kq_sr, kq_sg);
  const Int8Tier tier_v = tier_of(vq, v_scale, qmask, vq_sp, vq_sr, vq_sg);
  if (kq == nullptr) {
    PAGED_CASES(false, true)
  } else {
    PAGED_CASES(true, true)
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
