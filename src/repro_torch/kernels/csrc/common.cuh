// Shared device helpers of the port's int8 kernels (quant_matmul.cu,
// lowrank_qmm.cu): the s8 tensor-core product, the packed-nibble decode,
// and the transposition of a weight tile into the product's operand
// layout.
//
// Operand layout in shared memory. The product runs on
// mma.sync.m16n8k32.row.col.s32.s8.s8.s32. Its A operand is row-major
// (M x K, K contiguous: the activation codes as they lie in memory); its B
// operand is "col", i.e. each output column's 32 K-values contiguous. The
// weights lie K x N with N contiguous (the reference's layout, kept so
// checkpoints move byte for byte), so a raw weight tile lands in shared
// memory as it lies (cp.async, packed bytes included) and `to_col_layout`
// rewrites it as BTw[k/4][n]: the word of K-values k..k+3 of column n,
// rows of nt + 8 words. 4x4 byte blocks are transposed in registers with
// byte permutes and stored one 16-byte word per thread; with that row
// stride the stores and the fragment reads of `mma_tile(s)` are free of
// bank conflicts (the 8 column groups x 4 k-groups of a warp land on 32
// distinct banks). A tiles keep rows padded by 16 bytes (a row stride of
// BK + 16), which does the same for the A fragment reads.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rt {

// Element i of an output Y of float32 (bf16 == 0) or bfloat16: the
// float32 value v, or v rounded once to the nearest even bfloat16 (the
// reference's `.astype(bfloat16)` of its float32 result).
__device__ __forceinline__ void store_y(void* y, size_t i, float v,
                                        int bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(y)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(y)[i] = v;
}

// Elements i and i + 1 (i even) of Y: one 8-byte (fp32) or 4-byte (bf16)
// store of a and b, each rounded as in `store_y`.
__device__ __forceinline__ void store_y2(void* y, size_t i, float a, float b,
                                         int bf16) {
  if (bf16)
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(y) + i) =
        __floats2bfloat162_rn(a, b);
  else
    *reinterpret_cast<float2*>(static_cast<float*>(y) + i) = make_float2(a, b);
}

// One m16n8k32 step: c += a (16x32 s8, row) * b (32x8 s8, col), s32 sums.
// Fragment ownership (PTX ISA, m16n8k32 .s8): lane = 4*g + t;
//   A regs: (row g, k 4t..4t+3), (row g+8, same), (row g, k 16+4t..),
//           (row g+8, k 16+4t..);
//   B regs: (col g, k 4t..4t+3), (col g, k 16+4t..);
//   C regs: (row g, col 2t), (row g, col 2t+1), (row g+8, col 2t),
//           (row g+8, col 2t+1).
__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4],
                                       const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 4x4 byte transpose: out[c] holds byte c of in[0..3] (in[j] -> byte j).
__device__ __forceinline__ int4 transpose4(const uint32_t (&r)[4]) {
  const uint32_t lo01 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t hi01 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t lo23 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t hi23 = __byte_perm(r[2], r[3], 0x7362);
  return make_int4(static_cast<int>(__byte_perm(lo01, lo23, 0x5410)),
                   static_cast<int>(__byte_perm(lo01, lo23, 0x7632)),
                   static_cast<int>(__byte_perm(hi01, hi23, 0x5410)),
                   static_cast<int>(__byte_perm(hi01, hi23, 0x7632)));
}

// Four packed codes (the low 16 bits of x, code i in bits 4i..4i+3, as
// core.quant.pack_int4 lays them) -> four sign-extended int8 bytes.
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
  const uint32_t v = (x & 0xFu) | ((x << 4) & 0xF00u) |
                     ((x << 8) & 0xF0000u) | ((x << 12) & 0xF000000u);
  return v | ((v & 0x08080808u) * 0x1Eu);  // bit 3 set: high nibble 0xF
}

// Raw weight tile (kt rows of rb bytes; nt columns, two per byte when
// packed) -> BTw[k/4][n] words holding k..k+3 of column n, row stride
// nt + 8 words. A thread takes 4 rows x 4 columns (8 when packed: one
// 32-bit word of each row).
template <int THREADS>
__device__ __forceinline__ void to_col_layout(uint32_t* BTw,
                                              const int8_t* raw, int rb,
                                              bool packed, int kt, int nt) {
  const int nws = nt + 8;
  if (packed) {
    const int ng = nt / 8;
    for (int i = threadIdx.x; i < (kt / 4) * ng; i += THREADS) {
      const int kq = i / ng, n = (i % ng) * 8;
      uint32_t lo[4], hi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(
            raw + (kq * 4 + j) * rb + n / 2);
        lo[j] = spread4(w);
        hi[j] = spread4(w >> 16);
      }
      *reinterpret_cast<int4*>(BTw + kq * nws + n) = transpose4(lo);
      *reinterpret_cast<int4*>(BTw + kq * nws + n + 4) = transpose4(hi);
    }
    return;
  }
  const int ng = nt / 4;
  for (int i = threadIdx.x; i < (kt / 4) * ng; i += THREADS) {
    const int kq = i / ng, n = (i % ng) * 4;
    uint32_t r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      r[j] = *reinterpret_cast<const uint32_t*>(raw + (kq * 4 + j) * rb + n);
    *reinterpret_cast<int4*>(BTw + kq * nws + n) = transpose4(r);
  }
}

// acc += A (16 rows from A, row stride lda bytes) x BTw columns n0..n0+7,
// over the K-values k0, k0 + 32 * kw, ... below kd of BTw from row kq0
// (kd % 32 == 0): kw warps may share one tile's depth.
__device__ __forceinline__ void mma_tile(int (&acc)[4], const int8_t* A,
                                         int lda, const uint32_t* BTw,
                                         int nws, int kq0, int n0, int kd,
                                         int k0 = 0, int kw = 1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int kk = k0; kk < kd; kk += 32 * kw) {
    int a[4], b[2];
    a[0] = *reinterpret_cast<const int*>(A + g * lda + kk + 4 * t);
    a[1] = *reinterpret_cast<const int*>(A + (g + 8) * lda + kk + 4 * t);
    a[2] = *reinterpret_cast<const int*>(A + g * lda + kk + 16 + 4 * t);
    a[3] = *reinterpret_cast<const int*>(A + (g + 8) * lda + kk + 16 + 4 * t);
    const uint32_t* col = BTw + (kq0 + kk / 4 + t) * nws + n0 + g;
    b[0] = static_cast<int>(col[0]);
    b[1] = static_cast<int>(col[4 * nws]);
    mma_s8(acc, a, b);
  }
}

// The same for a warp tile of MT 16-row tiles (rows i * 16 of A) by NT
// 8-column groups (columns n0 + j * 8 of BTw): each fragment is read once
// per 32-deep slice and used MT or NT times.
template <int MT, int NT>
__device__ __forceinline__ void mma_tiles(int (&acc)[MT][NT][4],
                                          const int8_t* A, int lda,
                                          const uint32_t* BTw, int nws,
                                          int n0, int kd, int k0 = 0,
                                          int kw = 1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int kk = k0; kk < kd; kk += 32 * kw) {
    int a[MT][4], b[NT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int8_t* r = A + (i * 16 + g) * lda + kk + 4 * t;
      a[i][0] = *reinterpret_cast<const int*>(r);
      a[i][1] = *reinterpret_cast<const int*>(r + 8 * lda);
      a[i][2] = *reinterpret_cast<const int*>(r + 16);
      a[i][3] = *reinterpret_cast<const int*>(r + 8 * lda + 16);
    }
    const uint32_t* col = BTw + (kk / 4 + t) * nws + n0 + g;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      b[j][0] = static_cast<int>(col[j * 8]);
      b[j][1] = static_cast<int>(col[4 * nws + j * 8]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], a[i], b[j]);
  }
}

}  // namespace rt
