// Shared pieces of the port's tile kernels (dlzs_block.cu, sufa.cu,
// flash.cu): bf16 tensor-core products through mma.sync.m16n8k16 with fp32
// accumulators, and the global -> shared tile copy.
//
// Operands are kept as raw bf16 bits (uint16_t), so no bf16 arithmetic
// operator is needed. Fragment layouts of m16n8k16 (PTX ISA), with
// g = lane / 4 and t = lane % 4:
//   A (16x16, row-major): reg0 = (row g,   cols 2t, 2t+1)
//                         reg1 = (row g+8, cols 2t, 2t+1)
//                         reg2 = (row g,   cols 2t+8, 2t+9)
//                         reg3 = (row g+8, cols 2t+8, 2t+9)
//   B (16x8, col-major):  reg0 = (rows 2t, 2t+1,   col g)
//                         reg1 = (rows 2t+8, 2t+9, col g)
//   C (16x8, fp32):       c0, c1 = (row g,   cols 2t, 2t+1)
//                         c2, c3 = (row g+8, cols 2t, 2t+1)
// The lower 16 bits of a register hold the element of the lower index.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace star {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

// D += A * B for one 16x8 output tile.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 values from two rows of one column, packed lo | hi << 16.
__device__ __forceinline__ uint32_t ld_col_pair(const uint16_t* p, int ld) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[ld]) << 16);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Load the A fragments of a warp's 16 rows (starting at row0 of a shared
// tile with leading dimension LD) over the whole head dim D.
template <int D, int LD>
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[D / 16][4],
                                             const uint16_t* tile, int row0,
                                             int lane) {
  const uint16_t* p = tile + (row0 + (lane >> 2)) * LD + (lane & 3) * 2;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    a[kk][0] = ld32(p + kk * 16);
    a[kk][1] = ld32(p + 8 * LD + kk * 16);
    a[kk][2] = ld32(p + kk * 16 + 8);
    a[kk][3] = ld32(p + 8 * LD + kk * 16 + 8);
  }
}

// acc[16 x 8] = A(16 x D) * rows[n0 .. n0+8) of a shared tile, transposed:
// the score tile Q . K^T for 8 keys.
template <int D, int LD>
__device__ __forceinline__ void qk_tile(float (&acc)[4],
                                        const uint32_t (&a)[D / 16][4],
                                        const uint16_t* tile, int n0,
                                        int lane) {
  const uint16_t* p = tile + (n0 + (lane >> 2)) * LD + (lane & 3) * 2;
  acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    mma_16816(acc, a[kk], ld32(p + kk * 16), ld32(p + kk * 16 + 8));
}

// Copy rows [row0, row0 + ROWS) of a row-major [n_rows, D] bf16 matrix into
// a shared tile with leading dimension D + 8, 16 bytes per thread and step.
// Rows at or past n_rows are zero-filled (the ragged edge: a masked score
// times a zero row stays finite). With pow2, every element keeps only its
// sign and exponent bits (the DLZS quantizer: bf16 bits & 0xFF80 are the
// f32 bits & 0xFF800000, exactly).
template <int D>
__device__ __forceinline__ void load_rows(uint16_t* dst,
                                          const uint16_t* __restrict__ src,
                                          int row0, int rows, int n_rows,
                                          bool pow2) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < rows * kChunks; c += blockDim.x) {
    const int r = c / kChunks;
    const int e = (c - r * kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows)
      val = *reinterpret_cast<const uint4*>(src + (int64_t)(row0 + r) * D + e);
    if (pow2) {
      val.x &= 0xFF80FF80u;
      val.y &= 0xFF80FF80u;
      val.z &= 0xFF80FF80u;
      val.w &= 0xFF80FF80u;
    }
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + e) = val;
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace star
