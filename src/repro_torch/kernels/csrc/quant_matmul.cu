// Dense WxAy matmul for Hopper (sm_90a): Y = (Xq @ Wq as f32) * sx * sw.
//
// Replaces the TPU kernel src/repro/kernels/quant_matmul.py::quant_matmul
// (body `_kernel`, helper `unpack_int4_block`), the paper's dense MatMul
// engine (§V-A). Inputs: int8 activation codes Xq (M, K) with per-row fp32
// scales sx, int8 weight codes Wq (K, N) -- or packed W4, two nibbles per
// byte along N, (K, N/2) -- with per-column fp32 scales sw. Output fp32,
// or bfloat16 (a bfloat16 model): the epilogue rounds its fp32 value once
// to nearest even as it stores it, the reference's `.astype(out_dtype)`.
//
// What bounds it on this card. The serving path runs it for the lm head of
// every plan (M = the step's rows, K 512, N 32000, W8) and, under a
// quant-only plan, for every linear. Least bytes (each input read once, Y
// written once) at 3.35 TB/s, at a decode step's 8 rows:
//   K 512 -> N 512, packed W4:    154 KB, 0.05 us
//   K 512 -> N 2048, packed W4:   602 KB, 0.18 us
//   K 2048 -> N 512, packed W4:   559 KB, 0.17 us
//   lm head K 512 -> N 32000, W8: 17.5 MB, 5.2 us
// and at a 2048-row prefill step, K 512 -> N 2048: 18.4 MB (16.8 MB of it
// the fp32 Y), 5.5 us, against 2.2 us of int8 operations at 1979 TOPS.
// Every shape is bound by bytes; at decode all but the lm head are so far
// below a microsecond that what bounds them in practice is latency: the
// launch, one trip to memory, the barriers, and how many SMs share the
// work. The lm head has to stream 16 MB at near the HBM rate.
//
// Design. The wrapper's `choose_tiles` picks a partition of BM x BN output
// tiles, each split along K over the C CTAs of a thread-block cluster:
// - BM 16 at M <= 16 (decode): one strip, no padding rows beyond the
//   mma's 16. BN narrows to 32 and C grows to 8 until the launch fills the
//   card: K 512 -> N 512 runs 16 column tiles x 8 CTAs, each a 64-deep K
//   slice. Each warp of a strip takes a slab of 32 columns and KW warps
//   share its depth. Wider M takes BM 64 or 128 with 4 x 2 warps. Every
//   tile fits two CTAs an SM.
// - Every tile streams through a ring of 3 shared-memory stages filled with
//   16-byte cp.async copies issued two steps ahead: raw Xq rows and raw
//   weight rows as they lie, packed bytes included. A strip takes each K
//   step up to 16 KB of weights deep (the lm head's 64 KB a CTA in 4),
//   since a step costs a barrier however small it is.
// - A strip builds its B fragments in registers straight from the raw rows
//   (`strip_b`): a lane reads 4 rows of 4 columns (2 packed bytes,
//   unpacked with `spread4`), transposes them with byte permutes, and so
//   holds one fragment of each of 4 mma tiles whose columns interleave by
//   4. Its rows are padded so that those reads are free of bank conflicts.
//   Wider tiles, whose fragments serve many rows, rewrite each stage once
//   with `to_col_layout` (common.cuh, shared with lowrank_qmm) into the
//   mma's "col" operand. Products are int8 mma.sync m16n8k32 with s32 sums
//   in registers.
// - Where warps or a cluster split K, the warps' s32 partial sums meet in
//   shared memory and each CTA pushes its sums into the CTA of its cluster
//   that owns those columns (DSMEM, one cluster barrier); the owner adds
//   them -- exact in any order -- and converts once. The tile's scales
//   arrive with the first step's copies.
// The epilogue is the reference's, ((float)acc * sx) * sw, left to right
// (built with --fmad=false), so Y is bit-equal to the plain version.
//
// Expert stacks: the grid's z axis is the expert of a stacked (E, ...)
// operand set, so one launch runs one projection of every expert of a
// mixture-of-experts layer (the reference's vmap of its pallas_call).
// Each expert's CTAs are the single-matrix launch's; E = 1 is that launch.
#include <cooperative_groups.h>

#include "async_copy.cuh"
#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256, WARPS = THREADS / 32, STAGES = 3;

// A strip's lane (g, t) reads, for k-quad t of a 32-deep slice, 4 raw
// weight rows of 4 columns (or 2 packed bytes), starting at the quad's row
// t (rotated). The strip's raw rows are padded to `ws` bytes, a multiple
// of 16: the least that puts the 4 quads a warp reads at once on disjoint
// banks.
__host__ __device__ constexpr bool strip_conflict_free(int ws, int packed) {
  const int width = packed ? 4 : 8;  // words the 8 lanes of a quad read
  for (int j = 0; j < 4; ++j)
    for (int t1 = 0; t1 < 4; ++t1)
      for (int t2 = t1 + 1; t2 < 4; ++t2) {
        const int a = (4 * t1 + ((j + t1) & 3)) * (ws / 4) % 32;
        const int b = (4 * t2 + ((j + t2) & 3)) * (ws / 4) % 32;
        const int d = (a - b + 32) % 32;
        if (d < width || 32 - d < width) return false;
      }
  return true;
}

__host__ __device__ constexpr int strip_ws(int rb, int packed) {
  int s = rb;
  while (!strip_conflict_free(s, packed)) s += 16;
  return s;
}

// The warp grid of a BM x BN tile. A 16-row strip gives each warp a slab
// of 32 columns (NT = 4 mma tiles) and lets KW warps share a slab's depth;
// its raw weight rows lie WS bytes apart (WSP packed). Wider tiles take
// WM = 4 warps along M, each MT 16-row tiles, and split the BN / 8 column
// groups (NT each) between the other 2 warps.
template <int BM, int BN>
struct Warps {
  static constexpr bool STRIP = BM == 16;
  static constexpr int WM = STRIP ? 1 : 4, MT = BM / 16 / WM;
  static constexpr int WNK = WARPS / WM;
  static constexpr int WN = STRIP ? BN / 32 : WNK;
  static constexpr int NT = STRIP ? 4 : BN / 8 / WN, KW = WNK / WN;
  static constexpr int WS = STRIP ? strip_ws(BN, 0) : BN;
  static constexpr int WSP = STRIP ? strip_ws(BN / 2, 1) : BN / 2;
};

// Byte offsets of one CTA's dynamic shared memory: the ring (as many
// stages as the CTA has steps, at most STAGES), the transposed weight tile
// (wider tiles only), the tile's scales, the warps' s32 partial sums when
// warps or a cluster split K, and the cluster's partials pushed here.
struct Layout {
  size_t stage, bt, sc, part, red, total;
};

template <int BM, int BN>
__host__ __device__ inline Layout layout(int bk, int packed, int c,
                                         int kslice) {
  using W = Warps<BM, BN>;
  Layout l;
  const int steps = (kslice + bk - 1) / bk;
  const int stages = steps < STAGES ? steps : STAGES;
  l.stage = (size_t)BM * (bk + 16) + (size_t)bk * (packed ? W::WSP : W::WS);
  l.bt = stages * l.stage;
  l.sc = l.bt + (W::STRIP ? 0 : (size_t)(bk / 4) * (BN + 8) * 4);
  l.part = l.sc + (size_t)(BM + BN) * 4;
  l.red = l.part + (c > 1 || W::KW > 1 ? (size_t)W::KW * BM * BN * 4 : 0);
  l.total = l.red + (c > 1 ? (size_t)BM * BN * 4 : 0);
  return l;
}

// PTX split cluster barrier: arrive without waiting, wait later.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// A strip's B fragments of one 32-deep slice, straight from the raw weight
// rows (row stride ws bytes; 32 columns from column `col`, two a byte when
// packed): lane (g, t) takes columns col + 4g .. col + 4g + 3, so column g
// of mma tile c is column col + 4g + c, and b[c] holds its K-values 4t..
// 4t+3 and 16+4t..16+4t+3. A quad's 4 rows are read rotated by t (see
// `strip_ws`), transposed by byte permutes, and rotated back.
__device__ __forceinline__ void strip_b(int (&b)[4][2], const int8_t* raw,
                                        int ws, int col, bool packed) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int8_t* row = raw + (16 * h + 4 * t + ((j + t) & 3)) * ws;
      r[j] = packed ? rt::spread4(*reinterpret_cast<const uint16_t*>(
                          row + col / 2 + 2 * g))
                    : *reinterpret_cast<const uint32_t*>(row + col + 4 * g);
    }
    const int4 q = rt::transpose4(r);
    const uint32_t v[4] = {static_cast<uint32_t>(q.x),
                           static_cast<uint32_t>(q.y),
                           static_cast<uint32_t>(q.z),
                           static_cast<uint32_t>(q.w)};
#pragma unroll
    for (int c = 0; c < 4; ++c)
      b[c][h] = static_cast<int>(__funnelshift_l(v[c], v[c], 8 * t));
  }
}

// One CTA: output rows m0.., columns n0.. of its tile, K rows
// [rank * kslice, (rank + 1) * kslice) of its cluster's K.
template <int BM, int BN>
__global__ void __launch_bounds__(THREADS, 2)
qmm_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
           const int8_t* __restrict__ wq, const float* __restrict__ sw,
           void* __restrict__ y, int M, int K, int N, int packed, int BK,
           int kslice, int out_bf16) {
  using W = Warps<BM, BN>;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  // peers write into this CTA's shared memory only once all have started
  if (C > 1) cluster_arrive();
  {  // expert blockIdx.z's slice of each stacked operand
    const size_t e = blockIdx.z;
    xq += e * M * K;
    sx += e * M;
    wq += e * K * (packed ? N / 2 : N);
    sw += e * N;
  }
  const size_t y0 = blockIdx.z * static_cast<size_t>(M) * N;  // Y elements

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / W::WNK, wn = warp % W::WNK % W::WN,
            kw = warp % W::WNK / W::WN;
  const int m0 = blockIdx.y * BM, n0 = (blockIdx.x / C) * BN;
  // the chooser gives every CTA a K slice that is not empty
  const int k_lo = rank * kslice, k_hi = min(K, k_lo + kslice);
  const int n_steps = (k_hi - k_lo + BK - 1) / BK;
  const int bnb = packed ? BN / 2 : BN, n0b = packed ? n0 / 2 : n0;
  const int rowb = packed ? N / 2 : N, ws = packed ? W::WSP : W::WS;
  const int lda = BK + 16;
  const Layout L = layout<BM, BN>(BK, packed, C, kslice);
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* ring = reinterpret_cast<int8_t*>(smem);
  uint32_t* BTw = reinterpret_cast<uint32_t*>(smem + L.bt);
  float* sxs = reinterpret_cast<float*>(smem + L.sc);
  float* sws = sxs + BM;
  int* part = reinterpret_cast<int*>(smem + L.part);
  int* red = reinterpret_cast<int*>(smem + L.red);

  // Issue the copies of step s into ring stage s % STAGES (one commit
  // group per call, empty past the last step, so group counts stay even).
  // Chunks past M, past the slice's K or past N are zeros.
  auto issue = [&](int s) {
    if (s < n_steps) {
      int8_t* stg = ring + (s % STAGES) * L.stage;
      const int k0 = k_lo + s * BK, ca = BK / 16, cw = bnb / 16;
      for (int i = tid; i < BM * ca; i += THREADS) {
        const int r = i / ca, c = (i % ca) * 16;
        const bool ok = m0 + r < M && k0 + c < k_hi;
        rt::cp_async16(stg + r * lda + c,
                       ok ? xq + (size_t)(m0 + r) * K + k0 + c : xq, ok);
      }
      int8_t* wt = stg + BM * lda;
      // cw divides THREADS: each thread keeps one 16-byte column chunk
      const int c = (tid % cw) * 16;
      for (int r = tid / cw; r < BK; r += THREADS / cw) {
        const bool ok = k0 + r < k_hi && n0b + c < rowb;
        rt::cp_async16(wt + r * ws + c,
                       ok ? wq + (size_t)(k0 + r) * rowb + n0b + c : wq, ok);
      }
    }
    rt::cp_async_commit();
  };

  int acc[W::MT][W::NT][4];
#pragma unroll
  for (int i = 0; i < W::MT; ++i)
#pragma unroll
    for (int j = 0; j < W::NT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  // the tile's scales ride with step 0's copies, so that the epilogue
  // reads them from shared memory, not from device memory at the end
  for (int i = tid; i < BM + BN; i += THREADS) {
    const int r = i < BM ? m0 + i : n0 + i - BM;
    const bool ok = r < (i < BM ? M : N);
    rt::cp_async4(sxs + i, ok ? (i < BM ? sx : sw) + r : sx, ok);
  }
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);

  for (int s = 0; s < n_steps; ++s) {
    rt::cp_async_wait<STAGES - 2>();
    __syncthreads();  // step s landed everywhere; step s-1 is consumed
    issue(s + STAGES - 1);
    const int8_t* stg = ring + (s % STAGES) * L.stage;
    const int8_t* wt = stg + BM * lda;
    const int kd = min(BK, (k_hi - k_lo - s * BK + 31) / 32 * 32);
    if constexpr (W::STRIP) {
      for (int kk = 32 * kw; kk < kd; kk += 32 * W::KW) {
        int a[4], b[4][2];
        const int8_t* ar = stg + g * lda + kk + 4 * t;
        a[0] = *reinterpret_cast<const int*>(ar);
        a[1] = *reinterpret_cast<const int*>(ar + 8 * lda);
        a[2] = *reinterpret_cast<const int*>(ar + 16);
        a[3] = *reinterpret_cast<const int*>(ar + 8 * lda + 16);
        strip_b(b, wt + kk * ws, ws, wn * 32, packed != 0);
#pragma unroll
        for (int c = 0; c < 4; ++c) rt::mma_s8(acc[0][c], a, b[c]);
      }
    } else {
      rt::to_col_layout<THREADS>(BTw, wt, bnb, packed != 0, BK, BN);
      __syncthreads();
      rt::mma_tiles<W::MT, W::NT>(acc, stg + wm * W::MT * 16 * lda, lda,
                                  BTw, BN + 8, wn * W::NT * 8, kd);
    }
  }

  if (!W::STRIP && C == 1) {
    // ---- epilogue straight from the fragments (wider tiles) ----------
#pragma unroll
    for (int i = 0; i < W::MT; ++i) {
#pragma unroll
      for (int j = 0; j < W::NT; ++j) {
        const int n = n0 + (wn * W::NT + j) * 8 + 2 * t;
        if (n >= N) continue;  // N % 32 == 0, so n + 1 < N too
        const float sw0 = sws[n - n0], sw1 = sws[n - n0 + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = (wm * W::MT + i) * 16 + g + 8 * h, m = m0 + row;
          if (m >= M) continue;
          const float s = sxs[row];
          float2 o;
          o.x = static_cast<float>(acc[i][j][2 * h]) * s * sw0;
          o.y = static_cast<float>(acc[i][j][2 * h + 1]) * s * sw1;
          rt::store_y2(y, y0 + (size_t)m * N + n, o.x, o.y, out_bf16);
        }
      }
    }
    return;
  }

  // ---- reductions: the warps' partial sums of the tile into `part`
  // (slot kw), added per element; with a cluster, each CTA then pushes its
  // sums into slot `rank` of the CTA owning the columns (a 1/C share of
  // the tile, DSMEM), which adds the C slots and writes Y. Integer sums
  // are exact in any order. ----------------------------------------------
  const int rows = min(BM, M - m0);
#pragma unroll
  for (int i = 0; i < W::MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = (wm * W::MT + i) * 16 + g + 8 * h;
      if (row >= rows) continue;
      int* p = part + (kw * BM + row) * BN;
      if constexpr (W::STRIP) {
        // lane (g, t) holds columns 8t..8t+7 of its slab: columns 2t + e
        // of tile c are slab columns 8t + 4e + c
#pragma unroll
        for (int e = 0; e < 2; ++e)
          *reinterpret_cast<int4*>(p + wn * 32 + 8 * t + 4 * e) =
              make_int4(acc[i][0][2 * h + e], acc[i][1][2 * h + e],
                        acc[i][2][2 * h + e], acc[i][3][2 * h + e]);
      } else {
#pragma unroll
        for (int j = 0; j < W::NT; ++j)
          *reinterpret_cast<int2*>(p + (wn * W::NT + j) * 8 + 2 * t) =
              make_int2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
  }
  __syncthreads();
  if (C == 1) {
    for (int i = tid; i < rows * BN; i += THREADS) {
      const int row = i / BN, cc = i % BN, n = n0 + cc;
      if (n >= N) continue;
      int sum = 0;
#pragma unroll
      for (int j = 0; j < W::KW; ++j) sum += part[(j * BM + row) * BN + cc];
      rt::store_y(y, y0 + (size_t)(m0 + row) * N + n,
              static_cast<float>(sum) * sxs[row] * sws[cc], out_bf16);
    }
    return;
  }
  const int share = BN / C;
  cluster_wait();
  for (int i = tid; i < rows * BN; i += THREADS) {
    const int row = i / BN, cc = i % BN;
    int sum = 0;
#pragma unroll
    for (int j = 0; j < W::KW; ++j) sum += part[(j * BM + row) * BN + cc];
    *cluster.map_shared_rank(red + (rank * BM + row) * share + cc % share,
                             cc / share) = sum;
  }
  cluster.sync();  // every partial of this CTA's columns has arrived
  for (int i = tid; i < rows * share; i += THREADS) {
    const int row = i / share, cc = i % share, n = n0 + rank * share + cc;
    if (n >= N) continue;
    int sum = 0;
    for (int j = 0; j < C; ++j) sum += red[(j * BM + row) * share + cc];
    rt::store_y(y, y0 + (size_t)(m0 + row) * N + n,
            static_cast<float>(sum) * sxs[row] * sws[rank * share + cc],
            out_bf16);
  }
  // after the last cluster barrier no CTA touches another's shared memory,
  // so each may leave on its own
}

template <int BM, int BN>
int launch(const int8_t* xq, const float* sx, const int8_t* wq,
           const float* sw, void* y, int E, int M, int K, int N, int packed,
           int bk, int C, int kslice, int out_bf16, cudaStream_t stream) {
  const Layout L = layout<BM, BN>(bk, packed, C, kslice);
  auto kern = qmm_kernel<BM, BN>;
  // raise the kernel's dynamic shared memory limit once, to the most any
  // launch has asked for
  static size_t allowed = 0;
  if (L.total > allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L.total));
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed = L.total;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * ((N + BN - 1) / BN), (M + BM - 1) / BM, E);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, xq, sx, wq, sw, y, M, K, N,
                                     packed, bk, kslice, out_bf16);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define QMM_TILES(X) \
  X(16, 32) X(16, 64) X(16, 128) X(64, 64) X(64, 128) X(128, 64) X(128, 128)

// Shared memory of one CTA of a (bm, bn) tile taking bk K rows a step of
// its kslice (-1: no such tile). The wrapper's chooser keeps it within
// two CTAs an SM.
extern "C" long long qmm_smem_bytes(int bm, int bn, int bk, int packed,
                                    int c, int kslice) {
#define QMM_SMEM(BM, BN)                                                    \
  if (bm == BM && bn == BN)                                                 \
    return static_cast<long long>(                                          \
        layout<BM, BN>(bk, packed, c, kslice).total);
  QMM_TILES(QMM_SMEM)
#undef QMM_SMEM
  return -1;
}

// Shapes: K % 16 == 0, N % 32 == 0 (weight rows of N bytes, N / 2 packed:
// whole 16-byte chunks); xq and wq 16-byte aligned. (bm, bn) one of
// QMM_TILES; bk % 32 == 0; kslice % 32 == 0 with c * kslice >= K >
// (c - 1) * kslice (no CTA's K slice is empty); c in {1, 2, 4, 8} with
// bn / c even. The grid is c * ceil(N / bn) CTAs along x by ceil(M / bm)
// along y by E experts along z, every operand a contiguous stack of E
// matrices (xq (E, M, K), sx (E, M), wq (E, K, N) or (E, K, N / 2), sw
// (E, N), y (E, M, N) of fp32, or of bfloat16 when out_bf16 != 0).
// Launches on `stream`; returns the launch's CUDA error.
extern "C" int qmm_launch(const int8_t* xq, const float* sx,
                          const int8_t* wq, const float* sw, void* y, int E,
                          int M, int K, int N, int packed, int bm, int bn,
                          int bk, int c, int kslice, int out_bf16,
                          void* stream) {
  if (K % 16 || N % 32 || bk % 32 || kslice % 32 || c * kslice < K ||
      (c - 1) * kslice >= K || E < 1 || E > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define QMM_CASE(BM, BN)                                                    \
  if (bm == BM && bn == BN)                                                 \
    return launch<BM, BN>(xq, sx, wq, sw, y, E, M, K, N, packed, bk, c,     \
                          kslice, out_bf16, s);
  QMM_TILES(QMM_CASE)
#undef QMM_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
