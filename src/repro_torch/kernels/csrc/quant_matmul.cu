// Dense WxAy matmul for Hopper (sm_90a): Y = (Xq @ Wq as f32) * sx * sw.
//
// Replaces the TPU kernel src/repro/kernels/quant_matmul.py::quant_matmul
// (body `_kernel`, helper `unpack_int4_block`), the paper's dense MatMul
// engine (§V-A). Inputs: int8 activation codes Xq (M, K) with per-row fp32
// scales sx, int8 weight codes Wq (K, N) -- or packed W4, two nibbles per
// byte along N, (K, N/2) -- with per-column fp32 scales sw. Output fp32.
//
// What bounds it on this card: on the serving path it runs the lm head at
// M = max_batch rows (K = 512, N = 32000), where it streams 16 MB of int8
// weights for 2 x 8 x 512 x 32000 ops: far below the H100's ~590 int8
// ops per byte, so it is bound by HBM bytes. Packed W4 halves those bytes;
// the nibbles are decoded in registers on the way into shared memory.
//
// Design (first version, right before fast): one CTA per 64 x 128 output
// tile, 8 warps, each warp a 16 x 64 strip of int8 mma.sync m16n8k32
// products with s32 sums in registers; K in steps of 128 through shared
// memory, single-buffered, every thread's loads of a step issued before
// its stores so a step waits on device memory once. The epilogue applies
// the scales in the reference's order, ((float)acc * sx) * sw, so the
// result is bit-equal to the plain version. Wgmma, TMA and a deeper
// pipeline come later.
#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 128, BK = 128, THREADS = 256, LDS = BK + 16;
constexpr int NT = BN / 2 / 8;  // 4 warps along M x 2 along N, 8-col groups

__global__ void __launch_bounds__(THREADS)
qmm_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
           const int8_t* __restrict__ wq, const float* __restrict__ sw,
           float* __restrict__ y, int M, int K, int N, int packed) {
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5, wm = warp & 3, wn = warp >> 2;
  int acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    rt::load_rows<THREADS, BM, BK>(As, LDS, xq, K, m0, M, k0, K);
    rt::load_weight_t<THREADS, BK, BN>(Bs, LDS, wq, K, N, packed != 0, k0,
                                       n0);
    __syncthreads();
    rt::warp_mma<NT>(acc, As + wm * 16 * LDS, LDS, Bs + wn * 64 * LDS, LDS,
                     BK);
    __syncthreads();
  }

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int m = m0 + wm * 16 + g;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = n0 + wn * 64 + j * 8 + 2 * t;
    if (n >= N) continue;  // N % 4 == 0, so n + 1 < N too
    const float sw0 = sw[n], sw1 = sw[n + 1];
    if (m < M) {
      const float s = sx[m];
      float2 o;
      o.x = static_cast<float>(acc[j][0]) * s * sw0;
      o.y = static_cast<float>(acc[j][1]) * s * sw1;
      *reinterpret_cast<float2*>(y + (size_t)m * N + n) = o;
    }
    if (m + 8 < M) {
      const float s = sx[m + 8];
      float2 o;
      o.x = static_cast<float>(acc[j][2]) * s * sw0;
      o.y = static_cast<float>(acc[j][3]) * s * sw1;
      *reinterpret_cast<float2*>(y + (size_t)(m + 8) * N + n) = o;
    }
  }
}

}  // namespace

// Shapes: K % 16 == 0, N % 4 == 0, pointers 16-byte aligned (the Python
// wrapper checks). Launches on `stream`; returns the launch's CUDA error.
extern "C" int qmm_launch(const int8_t* xq, const float* sx,
                          const int8_t* wq, const float* sw, float* y, int M,
                          int K, int N, int packed, void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  qmm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      xq, sx, wq, sw, y, M, K, N, packed);
  return static_cast<int>(cudaGetLastError());
}
