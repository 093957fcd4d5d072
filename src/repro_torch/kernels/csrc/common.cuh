// Shared device helpers of the port's int8 kernels (quant_matmul.cu,
// lowrank_qmm.cu): the s8 tensor-core product, tile loads into shared
// memory, and the packed-nibble decode.
//
// Operand layout in shared memory. The product runs on
// mma.sync.m16n8k32.row.col.s32.s8.s8.s32. Its A operand is row-major
// (M x K, K contiguous: the activation codes as they lie in memory); its B
// operand is "col", i.e. each output column's 32 K-values contiguous. The
// weights lie K x N with N contiguous (the reference's layout, kept so
// checkpoints move byte for byte), so tiles of B are transposed on their
// way into shared memory: BT[n][k]. Rows of both tiles are padded by 16
// bytes, which makes the fragment reads below free of bank conflicts
// (row stride of 80 or R+16 bytes maps the 8 row groups of a warp onto
// distinct banks).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rt {

// One m16n8k32 step: c += a (16x32 s8, row) * b (32x8 s8, col), s32 sums.
__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4],
                                       const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Warp product of a 16-row A strip (smem, row stride lda bytes) with NT
// 8-column groups of BT (smem, row stride ldb bytes), over kdim (a
// multiple of 32) K-values: acc[j] holds the 16x8 tile of column group j.
// Fragment ownership (PTX ISA, m16n8k32 .s8): lane = 4*g + t;
//   A regs: (row g, k 4t..4t+3), (row g+8, same), (row g, k 16+4t..),
//           (row g+8, k 16+4t..);
//   B regs: (col g, k 4t..4t+3), (col g, k 16+4t..);
//   C regs: (row g, col 2t), (row g, col 2t+1), (row g+8, col 2t),
//           (row g+8, col 2t+1).
template <int NT>
__device__ __forceinline__ void warp_mma(int (&acc)[NT][4],
                                         const int8_t* A, int lda,
                                         const int8_t* BT, int ldb,
                                         int kdim) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int kk = 0; kk < kdim; kk += 32) {
    int a[4];
    a[0] = *reinterpret_cast<const int*>(A + g * lda + kk + 4 * t);
    a[1] = *reinterpret_cast<const int*>(A + (g + 8) * lda + kk + 4 * t);
    a[2] = *reinterpret_cast<const int*>(A + g * lda + kk + 16 + 4 * t);
    a[3] = *reinterpret_cast<const int*>(A + (g + 8) * lda + kk + 16 + 4 * t);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int8_t* col = BT + (j * 8 + g) * ldb + kk;
      int b[2];
      b[0] = *reinterpret_cast<const int*>(col + 4 * t);
      b[1] = *reinterpret_cast<const int*>(col + 16 + 4 * t);
      mma_s8(acc[j], a, b);
    }
  }
}

// Sign-extend nibble i (0..3) of a 16-bit packed word: byte b holds code
// 2b in bits 3..0 and code 2b+1 in bits 7..4 (core.quant.pack_int4), the
// same shifts as the reference's unpack_int4_block.
__device__ __forceinline__ uint32_t unpack4(uint32_t p16) {
  uint32_t out = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int code = static_cast<int>((p16 >> (4 * i)) << 28) >> 28;
    out |= (static_cast<uint32_t>(code) & 0xFFu) << (8 * i);
  }
  return out;
}

// Load a ROWS x COLS int8 tile of a row-major matrix (row stride ld bytes,
// ld % 16 == 0, base 16-byte aligned) into smem (row stride lds) with
// 16-byte loads. Rows >= nrows and 16-byte chunks at or past ncols are
// zero (ncols % 16 == 0). Every load is issued before the first store, so
// a tile costs one trip to device memory, not one per chunk.
template <int THREADS, int ROWS, int COLS>
__device__ __forceinline__ void load_rows(int8_t* dst, int lds,
                                          const int8_t* src, int ld,
                                          int row0, int nrows, int col0,
                                          int ncols) {
  constexpr int CHUNKS = COLS / 16, N = ROWS * CHUNKS;
  constexpr int ITEMS = (N + THREADS - 1) / THREADS;
  int4 v[ITEMS];
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int r = i / CHUNKS, c = (i % CHUNKS) * 16;
    v[it] = make_int4(0, 0, 0, 0);
    if (i < N && row0 + r < nrows && col0 + c < ncols)
      v[it] = *reinterpret_cast<const int4*>(src + (size_t)(row0 + r) * ld +
                                             col0 + c);
  }
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    if (i < N)
      *reinterpret_cast<int4*>(dst + (i / CHUNKS) * lds +
                               (i % CHUNKS) * 16) = v[it];
  }
}

// Load a KT x NT tile (K rows from k0, N columns from n0) of a K x N
// weight into BT[n][k] (row stride ldb bytes), transposing 4x4 byte
// blocks in registers. packed: the weight holds two nibble codes per byte
// along N (row stride N/2 bytes), decoded here. K rows past kdim and
// columns past ndim (ndim % 4 == 0) load as zero codes. As in load_rows,
// all of a thread's loads are in flight before it stores.
template <int THREADS, int KT, int NT>
__device__ __forceinline__ void load_weight_t(int8_t* BT, int ldb,
                                              const int8_t* w, int kdim,
                                              int ndim, bool packed, int k0,
                                              int n0) {
  constexpr int NG = NT / 4, N = (KT / 4) * NG;
  constexpr int ITEMS = (N + THREADS - 1) / THREADS;
  uint32_t r[ITEMS][4];
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int kq = (i / NG) * 4, n = n0 + (i % NG) * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + kq + j;
      r[it][j] = 0;
      if (i < N && k < kdim && n < ndim) {
        if (packed) {
          r[it][j] = unpack4(*reinterpret_cast<const uint16_t*>(
              w + (size_t)k * (ndim / 2) + n / 2));
        } else {
          r[it][j] = *reinterpret_cast<const uint32_t*>(
              w + (size_t)k * ndim + n);
        }
      }
    }
  }
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    if (i >= N) continue;
    const int kq = (i / NG) * 4, nq = (i % NG) * 4;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t col = ((r[it][0] >> (8 * c)) & 0xFFu) |
                           (((r[it][1] >> (8 * c)) & 0xFFu) << 8) |
                           (((r[it][2] >> (8 * c)) & 0xFFu) << 16) |
                           (((r[it][3] >> (8 * c)) & 0xFFu) << 24);
      *reinterpret_cast<uint32_t*>(BT + (nq + c) * ldb + kq) = col;
    }
  }
}

}  // namespace rt
