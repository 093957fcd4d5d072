// Fused ITERA cascade for Hopper (sm_90a): the paper's Cascade SVD MatMul
// Engine (§V-B).
//
// Replaces the TPU kernel src/repro/kernels/lowrank_qmm.py::lowrank_qmm
// (body `_kernel`). For a block of BM rows of X it runs
//   phase 1:  T = Xq @ W1q                       (s32, BM x R, on chip)
//   boundary: t = T * sx * s1 * s2ᵀ; st = absmax_row(t) * (1 / act_qmax);
//             Tq = clamp(rint(t / st), ±act_qmax) (int8, on chip)
//   phase 2:  Y = (Tq @ W2q) * st
// and T never goes to device memory: that is the cascade property.
// W1 may be packed W4 along R, W2 along N (two nibbles per byte).
//
// What bounds it on this card: on the serving path K, N in {512, 2048}
// and R = 256. Decode steps have M = max_batch rows, where the kernel
// streams the two factors (0.5 MB packed at most) for few operations:
// bound by bytes, and by launch latency below that. Wide prefill steps
// (M up to 2048) do ~4 int8 ops per weight byte per row and lean
// towards the tensor-core rate.
//
// Design: one CTA holds BM rows x the FULL R (the row absmax needs all of
// R), in shared memory: T as s32 (BM x R x 4 bytes, 64 KB at BM = 64, R =
// 256) and Tq as int8. BM shrinks (64, 32, 16) so that this fits the
// 227 KB a CTA may use. With an M-only grid a decode step (M ~ 8) would
// launch one CTA, so the grid's second axis splits the N columns of
// phase 2 across CTAs; each of them recomputes phase 1 for its rows. The
// recomputation is integer and deterministic, so every CTA finds the same
// Tq and st, and no (M, R) buffer exists anywhere. K and R go in steps of
// 256 through shared memory, each thread issuing all its loads of a step
// before its stores, so a decode step's serial phase 1 waits on device
// memory a few times, not once per 64 columns. Both products are int8
// mma.sync m16n8k32 with s32 sums (common.cuh). The boundary keeps the
// reference's arithmetic: scales multiplied left to right, a true IEEE
// division t / st, round half to even (rintf), so the output is bit-equal
// to the plain version.
#include "common.cuh"

namespace {

// BK: depth of a K step (phase 1) and of an R step (phase 2); R pads to a
// multiple of it. RT: the R columns one phase-1 pass accumulates.
constexpr int THREADS = 256, BK = 256, LDS = BK + 16, RT = 128, BN = 128;

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Dynamic shared memory of one CTA: T (s32), Tq (int8, row stride Rp+16),
// st, the activation tile and the (transposed) weight tile.
__host__ __device__ inline size_t smem_bytes(int bm, int r) {
  const int rp = round_up(r, BK);
  return (size_t)bm * rp * 4 + (size_t)bm * (rp + 16) + bm * 4 +
         (size_t)bm * LDS + (size_t)(RT > BN ? RT : BN) * LDS;
}

template <int BMT>
__global__ void __launch_bounds__(THREADS)
lrmm_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
            const int8_t* __restrict__ w1, const float* __restrict__ s1,
            const int8_t* __restrict__ w2, const float* __restrict__ s2,
            float* __restrict__ y, int M, int K, int R, int N, int w1_packed,
            int w2_packed, int qm) {
  constexpr int WM = BMT / 16, WN = 8 / WM;       // warp grid
  constexpr int NT1 = RT / WN / 8, NT2 = BN / WN / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rp = round_up(R, BK), ldt = rp + 16;
  int* T = reinterpret_cast<int*>(smem);
  int8_t* Tq = reinterpret_cast<int8_t*>(T + BMT * rp);
  float* st = reinterpret_cast<float*>(Tq + BMT * ldt);
  int8_t* As = reinterpret_cast<int8_t*>(st + BMT);
  int8_t* Bs = As + BMT * LDS;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % WM, wn = warp / WM;
  const int m0 = blockIdx.x * BMT;

  // ---- phase 1: T = Xq @ W1q, RT columns of R at a time ----------------
  for (int r0 = 0; r0 < rp; r0 += RT) {
    int acc[NT1][4];
#pragma unroll
    for (int j = 0; j < NT1; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
    for (int k0 = 0; k0 < K; k0 += BK) {
      rt::load_rows<THREADS, BMT, BK>(As, LDS, xq, K, m0, M, k0, K);
      rt::load_weight_t<THREADS, BK, RT>(Bs, LDS, w1, K, R, w1_packed != 0,
                                         k0, r0);
      __syncthreads();
      rt::warp_mma<NT1>(acc, As + wm * 16 * LDS, LDS,
                        Bs + wn * (RT / WN) * LDS, LDS, BK);
      __syncthreads();
    }
    const int row = wm * 16 + g;
#pragma unroll
    for (int j = 0; j < NT1; ++j) {
      const int c = r0 + wn * (RT / WN) + j * 8 + 2 * t;
      T[row * rp + c] = acc[j][0];
      T[row * rp + c + 1] = acc[j][1];
      T[(row + 8) * rp + c] = acc[j][2];
      T[(row + 8) * rp + c + 1] = acc[j][3];
    }
  }
  __syncthreads();

  // ---- boundary: fold the scales, requantize each row (one warp a row) -
  for (int row = warp; row < BMT; row += THREADS / 32) {
    const int m = m0 + row;
    const float sxm = m < M ? sx[m] : 1.0f;  // rows past M hold T == 0
    float amax = 0.0f;
    for (int c = lane; c < R; c += 32) {
      const float v = static_cast<float>(T[row * rp + c]) * sxm * s1[c] * s2[c];
      amax = fmaxf(amax, fabsf(v));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    // st = amax * f32(1 / qm): the reference divides by the constant qm
    // under jit, which XLA lowers to this product (core.quant's
    // symmetric_scale); t / st below is a true division
    const float lim = static_cast<float>(qm);
    const float s = amax > 0.0f ? amax * (1.0f / lim) : 1.0f;
    for (int c = lane; c < rp; c += 32) {
      float q = 0.0f;
      if (c < R) {
        const float v =
            static_cast<float>(T[row * rp + c]) * sxm * s1[c] * s2[c];
        q = fminf(fmaxf(rintf(v / s), -lim), lim);
      }
      Tq[row * ldt + c] = static_cast<int8_t>(q);
    }
    if (lane == 0) st[row] = s;
  }
  __syncthreads();

  // ---- phase 2: Y = (Tq @ W2q) * st over this CTA's column tiles --------
  for (int n0 = blockIdx.y * BN; n0 < N; n0 += gridDim.y * BN) {
    int acc[NT2][4];
#pragma unroll
    for (int j = 0; j < NT2; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
    for (int k0 = 0; k0 < rp; k0 += BK) {
      rt::load_weight_t<THREADS, BK, BN>(Bs, LDS, w2, R, N, w2_packed != 0,
                                         k0, n0);
      __syncthreads();
      rt::warp_mma<NT2>(acc, Tq + wm * 16 * ldt + k0, ldt,
                        Bs + wn * (BN / WN) * LDS, LDS, BK);
      __syncthreads();
    }
    const int row = wm * 16 + g, m = m0 + row;
#pragma unroll
    for (int j = 0; j < NT2; ++j) {
      const int n = n0 + wn * (BN / WN) + j * 8 + 2 * t;
      if (n >= N) continue;
      if (m < M) {
        float2 o;
        o.x = static_cast<float>(acc[j][0]) * st[row];
        o.y = static_cast<float>(acc[j][1]) * st[row];
        *reinterpret_cast<float2*>(y + (size_t)m * N + n) = o;
      }
      if (m + 8 < M) {
        float2 o;
        o.x = static_cast<float>(acc[j][2]) * st[row + 8];
        o.y = static_cast<float>(acc[j][3]) * st[row + 8];
        *reinterpret_cast<float2*>(y + (size_t)(m + 8) * N + n) = o;
      }
    }
  }
}

template <int BMT>
int launch(const int8_t* xq, const float* sx, const int8_t* w1,
           const float* s1, const int8_t* w2, const float* s2, float* y,
           int M, int K, int R, int N, int w1p, int w2p, int qm, int n_split,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(BMT, R);
  cudaError_t e = cudaFuncSetAttribute(
      lrmm_kernel<BMT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((M + BMT - 1) / BMT, n_split);
  lrmm_kernel<BMT><<<grid, THREADS, smem, stream>>>(
      xq, sx, w1, s1, w2, s2, y, M, K, R, N, w1p, w2p, qm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory one CTA of `bm` rows needs at rank R (the wrapper picks
// bm so that this fits the card's per-block limit).
extern "C" long long lrmm_smem_bytes(int bm, int R) {
  return static_cast<long long>(smem_bytes(bm, R));
}

// Shapes: K % 16 == 0, R % 4 == 0, N % 4 == 0, bm in {16, 32, 64},
// pointers 16-byte aligned (the Python wrapper checks). n_split CTAs
// share the N columns of each row block. Returns the launch's CUDA error.
extern "C" int lrmm_launch(const int8_t* xq, const float* sx,
                           const int8_t* w1, const float* s1,
                           const int8_t* w2, const float* s2, float* y, int M,
                           int K, int R, int N, int w1_packed, int w2_packed,
                           int act_qmax, int bm, int n_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bm) {
    case 64:
      return launch<64>(xq, sx, w1, s1, w2, s2, y, M, K, R, N, w1_packed,
                        w2_packed, act_qmax, n_split, s);
    case 32:
      return launch<32>(xq, sx, w1, s1, w2, s2, y, M, K, R, N, w1_packed,
                        w2_packed, act_qmax, n_split, s);
    case 16:
      return launch<16>(xq, sx, w1, s1, w2, s2, y, M, K, R, N, w1_packed,
                        w2_packed, act_qmax, n_split, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
