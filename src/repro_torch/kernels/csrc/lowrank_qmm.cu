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
// and R = 256. A decode step has M = max_batch rows (8) and streams the
// two factors (at most 0.3 MB packed) for few operations: bound by bytes
// at well under a microsecond, so in practice by latency -- how many
// dependent trips to memory and barriers one CTA makes, and how many SMs
// share them. Prefill steps (M up to 2048) do about 4 int8 operations per
// weight byte per row and lean towards the tensor-core rate.
//
// Design: a thread-block cluster of C CTAs (C <= 8, along the grid's x
// axis) shares one row block's phase 1. CTA `rank` computes T for its own
// RS columns of R (rank*RS ...), so no CTA streams all of W1 and none
// recomputes another's share. The CTAs exchange what they must through
// distributed shared memory (DSMEM), each pushing its values into its
// peers' shared memory before a cluster barrier, so every exchange costs
// one barrier and no CTA reads a peer's memory after the last one:
// - the row absmax: each CTA stores its partial row max into slot `rank`
//   of every peer; after the barrier every CTA takes the max of the C
//   slots (exact in any order), so all derive the same st and requantize
//   their own slice with the reference's per-element arithmetic (scales
//   multiplied left to right, a true division, rintf);
// - Tq: for phase 2 the cluster is a Cr x Cn grid (Cr * Cn = C), and CTA
//   (ir, in) multiplies the Cn slices of R group ir with those R rows of
//   W2 over its 1/Cn share of the cluster's N columns. With Cn > 1 each
//   CTA pushes its slice into its group's CTAs (16 bytes a store);
// - the partial sums: with Cr > 1 each CTA pushes its int32 partials of
//   a column to the group CTA that owns that column's 1/Cr share, which
//   adds them (exact in any order) and writes Y. Cr > 1 is what lets a
//   decode step with N = 512 fill the card: 16 clusters of 8 CTAs, each
//   CTA reducing 4 columns.
// T, Tq and the partial sums never leave the chip. A CTA takes at most 128
// registers a thread and about 100 KB of shared memory at R 256, so two
// fit an SM and all 16 clusters of a decode launch are resident at once.
//
// Expert stacks: a mixture-of-experts layer runs one projection of all E
// experts as ONE launch, as the reference's vmap adds a grid axis to its
// pallas_call. The grid's z axis is the expert: CTA (x, y, z) reads and
// writes expert z's slice of every operand (contiguous (E, ...) stacks of
// the 2-D shapes), and clusters stay along x, so each expert's launch is
// the single-matrix launch unchanged; E = 1 is exactly that launch.
//
// Loads: every tile (Xq and W1 for phase 1, W2 for phase 2) streams
// through one ring of STAGES shared-memory stages with 16-byte cp.async,
// issued STAGES-1 steps ahead, so the copies of the next steps (phase 2's
// W2 included, during the boundary) overlap the current step's product.
// A decode CTA takes its phase-1 slice 512 K-rows a step (K 2048 in 4),
// since each step costs barriers and a chain of dependent products more
// than bytes; two warps share each of its 4 tiles, each taking every
// other 32-deep slice, and their sums are added at the boundary.
// Packed W4 lands as raw bytes and is unpacked from shared memory. The
// weight tile is then transposed into the mma's "col" operand layout:
// 4x4 byte blocks are transposed in registers (byte permutes) and stored
// as one 16-byte word per thread into rows of stride NT + 8 words, which
// keeps both those stores and the fragment reads free of bank conflicts
// (the 8 column groups x 4 k-groups of a warp land on 32 distinct banks).
// Both products are int8 mma.sync m16n8k32 with s32 sums. The unpack,
// the transposition and the product are common.cuh's, shared with
// quant_matmul.cu.
//
// Every rank: the reference keeps R whole in VMEM and takes any rank that
// fits there. Here a cluster of 8 holds R up to 8 x 128 in the slices
// above (each a power of two, fixed at compile time), and up to
// 8 x RS_WIDE = 4096 in wide slices: any multiple of 32 up to RS_WIDE
// columns a CTA, the width read at run time, one CTA an SM, with as many
// K-rows a step (128, else 64) as leave room for T, the ring and the
// transposed tile. T stays on chip on both. Past 4096 R is split into G slices of GROUP_RS columns, and T
// LEAVES THE CHIP: a first launch (this kernel with clusters of one, one
// CTA per slice and row block) writes each slice's t = T * sx * s1 * s2
// (float32, the values the boundary would requantize) and the slice's
// row absmax to device memory; a second (`lrmm_tail_kernel`) takes the
// max of the G partials as the row's absmax, requantizes t a 64-row step
// at a time as it streams past, and runs phase 2 over the whole of R in
// each CTA's registers. Any split of R keeps the reference's bits: T and
// phase 2's sum are exact int32 sums, the absmax a max, and the
// per-element arithmetic is the same on every path.
#include <cooperative_groups.h>

#include "async_copy.cuh"
#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

// NC: the widest phase-2 column chunk a CTA accumulates at once.
// RS_WIDE: the widest wide slice; RS_DEEP: the widest that a decode CTA
// takes 128 K-rows a step; GROUP_RS: a grouped launch's slice; TK: R
// rows a step of the grouped path's second launch.
constexpr int THREADS = 256, WARPS = THREADS / 32, NC = 128, CLUSTER = 8,
              STAGES = 3, RS_WIDE = 512, RS_DEEP = 352, GROUP_RS = 128,
              TK = 64;

// Depth of a phase-1 K step and at most of a phase-2 R step. A decode CTA
// (BM 16) is bound by the latency of each step (barriers, the tile's
// transpose, a chain of dependent products), not by its bytes, so it
// takes its W1 slice 4096 codes deep at a time (512 at RS 32): K 2048 is
// 4 steps. Wider tiles keep 128, which leaves room for two CTAs an SM.
// Wide slices (RS > 128) take 64 where 128 leaves no room for T (wider
// tiles, or slices past RS_DEEP), and up to 128 R rows a phase-2 step
// (their W2 tile is no larger than the W1 tile).
__host__ __device__ constexpr int bk_of(int bm, int rs) {
  return rs > 128 ? (bm == 16 && rs <= RS_DEEP ? 128 : 64)
                  : bm == 16 ? (rs >= 128 ? 128 : 16384 / rs) : 128;
}
__host__ __device__ constexpr int bk2_of(int bm, int rs) {
  return rs > 128 ? 128 : bk_of(bm, rs);
}

// Byte offsets of one CTA's dynamic shared memory.
struct Layout {
  size_t stage, bt, t, red, tq_own, tq_grp, amax, st, total;
};

// c CTAs a cluster, cn of them along N in phase 2, nc columns a chunk.
__host__ __device__ inline Layout layout(int bm, int rs, int c, int cn,
                                         int nc) {
  Layout l;
  const int bk = bk_of(bm, rs), bk2max = bk2_of(bm, rs);
  const int bk2 = bk2max < rs * cn ? bk2max : rs * cn;
  const size_t p1 = (size_t)bm * (bk + 16) + (size_t)bk * rs;  // Xq + W1
  const size_t p2 = (size_t)bk2 * nc;                          // W2
  const size_t bt1 = (size_t)(bk / 4) * (rs + 8) * 4;
  const size_t bt2 = (size_t)(bk2 / 4) * (nc + 8) * 4;
  l.stage = p1 > p2 ? p1 : p2;
  l.bt = STAGES * l.stage;                        // transposed weight tile
  l.t = l.bt + (bt1 > bt2 ? bt1 : bt2);           // T (s32)
  l.red = l.t + (size_t)bm * rs * 4;              // partials pushed here
  l.tq_own = l.red + (c > cn ? (size_t)bm * nc * 4 : 0);  // own Tq slice
  l.tq_grp = l.tq_own + (size_t)bm * (rs + 16);   // its R group's Tq
  l.amax = l.tq_grp + (size_t)bm * (rs * cn + 16);
  l.st = l.amax + (size_t)CLUSTER * bm * 4;       // every rank's row max
  l.total = l.st + bm * 4;
  return l;
}

// Byte offsets of one `lrmm_tail_kernel` CTA's dynamic shared memory: a
// ring of t (float32, bm x TK) and W2 (TK x NC) tiles, Tq, the
// transposed tile, st.
struct TailLayout {
  size_t stage, aq, bt, st, total;
};

__host__ __device__ inline TailLayout tail_layout(int bm) {
  TailLayout l;
  l.stage = (size_t)bm * TK * 4 + (size_t)TK * NC;
  l.aq = STAGES * l.stage;
  l.bt = l.aq + (size_t)bm * (TK + 16);
  l.st = l.bt + (size_t)(TK / 4) * (NC + 8) * 4;
  l.total = l.st + bm * 4;
  return l;
}

// Shared memory of the larger of a launch's kernels.
__host__ __device__ inline size_t smem_total(int bm, int rs, int c, int cn,
                                             int ncl, int groups) {
  if (groups) {
    const size_t a = layout(bm, rs, 1, 1, 32).total,
                 b = tail_layout(bm).total;
    return a > b ? a : b;
  }
  const int sw = ncl / cn;
  return layout(bm, rs, c, cn, sw < NC ? sw : NC).total;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// PTX split cluster barrier: arrive without waiting, wait later.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// At most 128 registers a thread, so that two CTAs share an SM: one CTA
// per SM leaves room for only 15 clusters of 8 on an H100, and a decode
// launch has 16. The widest tiles (BM 64, RS 128; wide slices) need more.
// RSC is the rank slice, or 0 for a wide slice of `rs` columns (a
// multiple of 32 in (128, RS_WIDE]). With `tg` set (the grouped path's
// first launch, clusters of one) CTA x takes slice x of R and writes t
// and its row maxima to tg and pg instead of running phase 2.
template <int BM, int RSC>
__global__ void __launch_bounds__(THREADS,
                                  (BM == 64 && RSC == 128) || RSC == 0 ? 1
                                                                      : 2)
lrmm_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
            const int8_t* __restrict__ w1, const float* __restrict__ s1,
            const int8_t* __restrict__ w2, const float* __restrict__ s2,
            void* __restrict__ y, int M, int K, int R, int N, int w1_packed,
            int w2_packed, int qm, int rs, int Cn, int Ncl, int out_bf16,
            float* __restrict__ tg, float* __restrict__ pg) {
  // phase 1: T1 tiles of 16 x 8; with fewer tiles than warps, KW warps
  // share a tile, each taking every KW-th 32-deep slice of a step
  constexpr int RSCAP = RSC ? RSC : RS_WIDE;
  constexpr int T1C = (BM / 16) * (RSCAP / 8);
  constexpr int KW = T1C < WARPS ? WARPS / T1C : 1, TW = WARPS / KW;
  constexpr int MAXT1 = (T1C + TW - 1) / TW;
  constexpr int MAXT2 = (BM / 16) * (NC / 8) / WARPS;
  const int RS = RSC ? RSC : rs;
  const int BK = bk_of(BM, RS), BK2 = bk2_of(BM, RS), LDA = BK + 16;
  const int T1 = (BM / 16) * (RS / 8), LDO = RS + 16;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int Cr = C / Cn, ir = rank / Cn, in = rank % Cn;
  // peers write into this CTA's shared memory only once all have started
  cluster_arrive();
  {  // expert blockIdx.z's slice of each stacked operand
    const size_t e = blockIdx.z;
    xq += e * M * K;
    sx += e * M;
    w1 += e * K * (w1_packed ? R / 2 : R);
    s1 += e * R;
    w2 += e * R * (w2_packed ? N / 2 : N);
    s2 += e * R;
    if (tg) {
      tg += e * M * R;
      pg += e * gridDim.x * M;
    }
  }
  const size_t y0 = blockIdx.z * static_cast<size_t>(M) * N;  // Y elements

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM;
  // phase 1: this CTA's R columns
  const int r_own = (tg ? static_cast<int>(blockIdx.x) : rank) * RS;
  const int kd2 = RS * Cn;              // phase 2: depth, R rows r_grp...
  const int r_grp = ir * kd2;
  const int ldg = kd2 + 16;             // row stride of tq_grp
  const int sw = Ncl / Cn;              // this CTA's share of N columns
  const int n_cta = (blockIdx.x / C) * Ncl + in * sw;
  const int nc = sw < NC ? sw : NC;     // columns per phase-2 chunk
  const Layout L = layout(BM, RS, C, Cn, nc);
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* ring = reinterpret_cast<int8_t*>(smem);
  uint32_t* BTw = reinterpret_cast<uint32_t*>(smem + L.bt);
  int* T = reinterpret_cast<int*>(smem + L.t);
  int* red = reinterpret_cast<int*>(smem + L.red);
  int8_t* tq_own = reinterpret_cast<int8_t*>(smem + L.tq_own);
  int8_t* tq_grp = reinterpret_cast<int8_t*>(smem + L.tq_grp);
  float* amax_all = reinterpret_cast<float*>(smem + L.amax);
  float* st = reinterpret_cast<float*>(smem + L.st);
  // R rows per phase-2 step: the widest of BK2, 64, 32 that divides kd2
  const int bk2 = kd2 <= BK2 ? kd2 : kd2 % BK2 == 0 ? BK2
                                  : kd2 % 64 == 0   ? 64
                                                    : 32;
  const int n1 = (K + BK - 1) / BK, n2k = kd2 / bk2;
  const int n_steps = tg ? n1 : n1 + (sw / nc) * n2k;
  const int rsb = w1_packed ? RS / 2 : RS, ncb = w2_packed ? nc / 2 : nc;
  const int ldw1 = w1_packed ? R / 2 : R, ldw2 = w2_packed ? N / 2 : N;

  // Issue the copies of step s into ring stage s % STAGES (one commit
  // group per call, empty past the last step, so group counts stay even).
  auto issue = [&](int s) {
    if (s < n_steps) {
      int8_t* stg = ring + (s % STAGES) * L.stage;
      if (s < n1) {
        const int k0 = s * BK;
        for (int i = tid; i < BM * (BK / 16); i += THREADS) {
          const int r = i / (BK / 16), c = (i % (BK / 16)) * 16;
          const bool ok = m0 + r < M && k0 + c < K;
          rt::cp_async16(stg + r * LDA + c,
                         ok ? xq + (size_t)(m0 + r) * K + k0 + c : xq, ok);
        }
        int8_t* wt = stg + BM * LDA;
        const int cpr = rsb / 16;
        for (int i = tid; i < BK * cpr; i += THREADS) {
          const int r = i / cpr, c = (i % cpr) * 16;
          const int col = r_own + (w1_packed ? 2 * c : c);
          const bool ok = k0 + r < K && col < R;
          rt::cp_async16(wt + r * rsb + c,
                         ok ? w1 + (size_t)(k0 + r) * ldw1 +
                                  (w1_packed ? r_own / 2 : r_own) + c
                            : w1,
                         ok);
        }
      } else {
        const int j = s - n1, kk = (j % n2k) * bk2;
        const int n0 = n_cta + (j / n2k) * nc;
        const int cpr = ncb / 16;
        for (int i = tid; i < bk2 * cpr; i += THREADS) {
          const int r = i / cpr, c = (i % cpr) * 16;
          const int row = r_grp + kk + r;
          const int col = n0 + (w2_packed ? 2 * c : c);
          const bool ok = row < R && col < N;
          rt::cp_async16(stg + r * ncb + c,
                         ok ? w2 + (size_t)row * ldw2 +
                                  (w2_packed ? n0 / 2 : n0) + c
                            : w2,
                         ok);
        }
      }
    }
    rt::cp_async_commit();
  };

  int acc1[MAXT1][4], acc2[MAXT2][4];
#pragma unroll
  for (int j = 0; j < MAXT1; ++j)
    acc1[j][0] = acc1[j][1] = acc1[j][2] = acc1[j][3] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);

  for (int s = 0; s < n_steps; ++s) {
    rt::cp_async_wait<STAGES - 2>();
    __syncthreads();  // step s landed everywhere; step s-1 is consumed
    issue(s + STAGES - 1);
    const int8_t* stg = ring + (s % STAGES) * L.stage;

    if (s < n1) {
      // ---- phase 1: T[:, own slice] += Xq tile @ W1 tile -------------
      rt::to_col_layout<THREADS>(BTw, stg + BM * LDA, rsb, w1_packed != 0,
                                 BK, RS);
      __syncthreads();
      const int kd = min(BK, (K - s * BK + 31) / 32 * 32);
#pragma unroll
      for (int j = 0; j < MAXT1; ++j) {
        const int tile = warp % TW + j * TW;
        if (tile < T1)
          rt::mma_tile(acc1[j], stg + (tile / (RS / 8)) * 16 * LDA, LDA,
                       BTw, RS + 8, 0, (tile % (RS / 8)) * 8, kd,
                       32 * (warp / TW), KW);
      }
      if (s != n1 - 1) continue;

      // ---- boundary --------------------------------------------------
      // T = the KW warps' partial sums of each tile, added in turn
      for (int kg = 0; kg < KW; ++kg) {
        if (warp / TW == kg) {
#pragma unroll
          for (int j = 0; j < MAXT1; ++j) {
            const int tile = warp % TW + j * TW;
            if (tile >= T1) continue;
            int* o = T + ((tile / (RS / 8)) * 16 + g) * RS +
                     (tile % (RS / 8)) * 8 + 2 * t;
            const int at[4] = {0, 1, 8 * RS, 8 * RS + 1};
#pragma unroll
            for (int e = 0; e < 4; ++e)
              o[at[e]] = kg == 0 ? acc1[j][e] : o[at[e]] + acc1[j][e];
          }
        }
        __syncthreads();
      }
      if (tg) {  // grouped: t and the slice's row maxima leave the chip
        cluster_wait();
        for (int row = warp; row < BM; row += WARPS) {
          const int m = m0 + row;
          if (m >= M) continue;
          const float sxm = sx[m];
          float amax = 0.0f;
          for (int c = lane; c < RS; c += 32) {
            const int gc = r_own + c;
            if (gc < R) {
              const float v = static_cast<float>(T[row * RS + c]) * sxm *
                              s1[gc] * s2[gc];
              tg[(size_t)m * R + gc] = v;
              amax = fmaxf(amax, fabsf(v));
            }
          }
          amax = warp_max(amax);
          if (lane == 0) pg[(size_t)blockIdx.x * M + m] = amax;
        }
        return;
      }
      // t = T * sx * s1 * s2 (left to right, as the reference) over this
      // CTA's columns; rows past M hold T == 0. Each CTA's partial row max
      // goes into slot `rank` of every peer (DSMEM stores).
      cluster_wait();
      for (int row = warp; row < BM; row += WARPS) {
        const int m = m0 + row;
        const float sxm = m < M ? sx[m] : 1.0f;
        float amax = 0.0f;
        for (int c = lane; c < RS; c += 32) {
          const int gc = r_own + c;
          if (gc < R)
            amax = fmaxf(amax, fabsf(static_cast<float>(T[row * RS + c]) *
                                     sxm * s1[gc] * s2[gc]));
        }
        amax = warp_max(amax);
        if (lane < C)
          *cluster.map_shared_rank(amax_all + rank * BM + row, lane) = amax;
      }
      cluster.sync();  // every CTA holds the C partial maxima of each row
      const float lim = static_cast<float>(qm);
      // with Cn == 1 the group is this CTA's own slice: written in place
      int8_t* tq_dst = Cn == 1 ? tq_grp : tq_own;
      const int ld_dst = Cn == 1 ? ldg : LDO;
      for (int row = warp; row < BM; row += WARPS) {
        const int m = m0 + row;
        const float sxm = m < M ? sx[m] : 1.0f;
        const float amax = warp_max(lane < C ? amax_all[lane * BM + row]
                                             : 0.0f);
        // st = amax * f32(1 / qm): the reference divides by the constant
        // qm under jit, which XLA lowers to this product (core.quant's
        // symmetric_scale); t / st below is a true division
        const float sc = amax > 0.0f ? amax * (1.0f / lim) : 1.0f;
        for (int c = lane; c < RS; c += 32) {
          const int gc = r_own + c;
          float q = 0.0f;
          if (gc < R) {
            const float v = static_cast<float>(T[row * RS + c]) * sxm *
                            s1[gc] * s2[gc];
            q = fminf(fmaxf(rintf(v / sc), -lim), lim);
          }
          tq_dst[row * ld_dst + c] = static_cast<int8_t>(q);
        }
        if (lane == 0) st[row] = sc;
      }
      if (Cn > 1) {
        __syncthreads();  // this CTA's slice is complete
        // push it into its R group's CTAs (itself included), 16 bytes a
        // store, at the slice's place in the group
        const int CH = RS / 16;
        for (int i = tid; i < BM * Cn * CH; i += THREADS) {
          const int row = i / (Cn * CH), j = (i / CH) % Cn;
          const int c = (i % CH) * 16;
          *cluster.map_shared_rank(
              reinterpret_cast<int4*>(tq_grp + row * ldg + in * RS + c),
              ir * Cn + j) =
              *reinterpret_cast<const int4*>(tq_own + row * LDO + c);
        }
        cluster.sync();  // the group's Tq is complete in every CTA
      }
      // the first phase-2 step's barrier publishes tq_grp
      continue;
    }

    // ---- phase 2: partial Y over R group ir, this CTA's columns --------
    const int j2 = s - n1, ks = j2 % n2k, n0 = n_cta + (j2 / n2k) * nc;
    const int tiles = (BM / 16) * (nc / 8);
    if (ks == 0) {
#pragma unroll
      for (int j = 0; j < MAXT2; ++j)
        acc2[j][0] = acc2[j][1] = acc2[j][2] = acc2[j][3] = 0;
    }
    rt::to_col_layout<THREADS>(BTw, stg, ncb, w2_packed != 0, bk2, nc);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < MAXT2; ++j) {
      const int tile = warp + j * WARPS;
      if (tile < tiles)
        rt::mma_tile(acc2[j],
                     tq_grp + (tile / (nc / 8)) * 16 * ldg + ks * bk2, ldg,
                     BTw, nc + 8, 0, (tile % (nc / 8)) * 8, bk2);
    }
    if (ks != n2k - 1) continue;

    // ---- epilogue of a chunk: Y = sum over the Cr groups * st ---------
    if (Cr == 1) {
#pragma unroll
      for (int j = 0; j < MAXT2; ++j) {
        const int tile = warp + j * WARPS;
        if (tile >= tiles) continue;
        const int row = (tile / (nc / 8)) * 16 + g;
        const int n = n0 + (tile % (nc / 8)) * 8 + 2 * t;
        if (n >= N) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + row + 8 * h;
          if (m >= M) continue;
          float2 o;
          o.x = static_cast<float>(acc2[j][2 * h]) * st[row + 8 * h];
          o.y = static_cast<float>(acc2[j][2 * h + 1]) * st[row + 8 * h];
          rt::store_y2(y, y0 + (size_t)m * N + n, o.x, o.y, out_bf16);
        }
      }
      continue;
    }
    // each partial goes to the CTA of its group `in` that owns the
    // column's 1/Cr share, into slot ir of that CTA's `red` (DSMEM)
    const int share = nc / Cr;
    if (j2 / n2k > 0) cluster.sync();  // owners have read the last chunk
#pragma unroll
    for (int j = 0; j < MAXT2; ++j) {
      const int tile = warp + j * WARPS;
      if (tile >= tiles) continue;
      const int row = (tile / (nc / 8)) * 16 + g;
      const int c = (tile % (nc / 8)) * 8 + 2 * t;
      int* dst = cluster.map_shared_rank(red, (c / share) * Cn + in) +
                 (ir * BM + row) * share + c % share;
      *reinterpret_cast<int2*>(dst) = make_int2(acc2[j][0], acc2[j][1]);
      *reinterpret_cast<int2*>(dst + 8 * share) =
          make_int2(acc2[j][2], acc2[j][3]);
    }
    cluster.sync();  // every partial of this chunk has arrived
    const int rows = min(BM, M - m0);
    for (int i = tid; i < rows * share; i += THREADS) {
      const int row = i / share, cc = i % share, n = n0 + ir * share + cc;
      if (n >= N) continue;
      int sum = 0;
      for (int jr = 0; jr < Cr; ++jr) sum += red[(jr * BM + row) * share + cc];
      rt::store_y(y, y0 + (size_t)(m0 + row) * N + n,
              static_cast<float>(sum) * st[row], out_bf16);
    }
  }
  // after the last cluster barrier no CTA touches another's shared memory,
  // so each may leave on its own
}

// The grouped path's second launch: Y for BM rows x nc columns (nc in
// {32, 64, 128}) over the whole of R. st is the max of the G slices' row
// maxima times f32(1 / qm); each step requantizes TK columns of t with
// the boundary's arithmetic (a true division, rintf, the clamp) into Tq
// in shared memory and multiplies it with TK rows of W2, so the int32 sum
// over R never leaves the CTA's registers and Y = sum * st once.
template <int BM>
__global__ void __launch_bounds__(THREADS, 1)
lrmm_tail_kernel(const float* __restrict__ tg, const float* __restrict__ pg,
                 const int8_t* __restrict__ w2, void* __restrict__ y, int M,
                 int R, int N, int G, int w2_packed, int qm, int nc,
                 int out_bf16) {
  constexpr int MAXT = (BM / 16) * (NC / 8) / WARPS, LDQ = TK + 16;
  {
    const size_t e = blockIdx.z;
    tg += e * M * R;
    pg += e * G * M;
    w2 += e * R * (w2_packed ? N / 2 : N);
  }
  const size_t y0 = blockIdx.z * static_cast<size_t>(M) * N;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * nc;
  const TailLayout L = tail_layout(BM);
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* ring = reinterpret_cast<int8_t*>(smem);
  int8_t* aq = reinterpret_cast<int8_t*>(smem + L.aq);
  uint32_t* BTw = reinterpret_cast<uint32_t*>(smem + L.bt);
  float* st = reinterpret_cast<float*>(smem + L.st);
  const int ncb = w2_packed ? nc / 2 : nc, ldw2 = w2_packed ? N / 2 : N;
  const int n_steps = (R + TK - 1) / TK;
  const float lim = static_cast<float>(qm);

  auto issue = [&](int s) {
    if (s < n_steps) {
      unsigned char* stg = smem + (s % STAGES) * L.stage;
      const int k0 = s * TK;
      for (int i = tid; i < BM * (TK / 4); i += THREADS) {
        const int r = i / (TK / 4), c = (i % (TK / 4)) * 4;
        const bool ok = m0 + r < M && k0 + c < R;
        rt::cp_async16(stg + (r * TK + c) * 4,
                       ok ? tg + (size_t)(m0 + r) * R + k0 + c : tg, ok);
      }
      int8_t* wt = reinterpret_cast<int8_t*>(stg) + BM * TK * 4;
      const int cpr = ncb / 16;
      for (int i = tid; i < TK * cpr; i += THREADS) {
        const int r = i / cpr, c = (i % cpr) * 16;
        const int col = n0 + (w2_packed ? 2 * c : c);
        const bool ok = k0 + r < R && col < N;
        rt::cp_async16(wt + r * ncb + c,
                       ok ? w2 + (size_t)(k0 + r) * ldw2 +
                                (w2_packed ? n0 / 2 : n0) + c
                          : w2,
                       ok);
      }
    }
    rt::cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);
  // st = the max of the G partial row maxima (exact in any order) * 1/qm
  for (int row = tid; row < BM; row += THREADS) {
    const int m = m0 + row;
    float amax = 0.0f;
    if (m < M)
      for (int j = 0; j < G; ++j) amax = fmaxf(amax, pg[(size_t)j * M + m]);
    st[row] = amax > 0.0f ? amax * (1.0f / lim) : 1.0f;
  }
  int acc[MAXT][4];
#pragma unroll
  for (int j = 0; j < MAXT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
  const int tiles = (BM / 16) * (nc / 8);

  for (int s = 0; s < n_steps; ++s) {
    rt::cp_async_wait<STAGES - 2>();
    __syncthreads();  // step s landed everywhere; step s-1 is consumed
    issue(s + STAGES - 1);
    const unsigned char* stg = smem + (s % STAGES) * L.stage;
    const float* tt = reinterpret_cast<const float*>(stg);
    for (int i = tid; i < BM * TK; i += THREADS) {
      const int r = i / TK, c = i % TK;
      const float q = fminf(fmaxf(rintf(tt[i] / st[r]), -lim), lim);
      aq[r * LDQ + c] = static_cast<int8_t>(q);
    }
    rt::to_col_layout<THREADS>(BTw, reinterpret_cast<const int8_t*>(stg) +
                                        BM * TK * 4,
                               ncb, w2_packed != 0, TK, nc);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < MAXT; ++j) {
      const int tile = warp + j * WARPS;
      if (tile < tiles)
        rt::mma_tile(acc[j], aq + (tile / (nc / 8)) * 16 * LDQ, LDQ, BTw,
                     nc + 8, 0, (tile % (nc / 8)) * 8, TK);
    }
  }
#pragma unroll
  for (int j = 0; j < MAXT; ++j) {
    const int tile = warp + j * WARPS;
    if (tile >= tiles) continue;
    const int row = (tile / (nc / 8)) * 16 + g;
    const int n = n0 + (tile % (nc / 8)) * 8 + 2 * t;
    if (n >= N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + row + 8 * h;
      if (m >= M) continue;
      rt::store_y2(y, y0 + (size_t)m * N + n,
                   static_cast<float>(acc[j][2 * h]) * st[row + 8 * h],
                   static_cast<float>(acc[j][2 * h + 1]) * st[row + 8 * h],
                   out_bf16);
    }
  }
}

template <typename Kern, typename... Args>
int launch_kernel(Kern kern, dim3 grid, int cluster, size_t smem,
                  cudaStream_t stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, args...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int RSC>
int launch(const int8_t* xq, const float* sx, const int8_t* w1,
           const float* s1, const int8_t* w2, const float* s2, void* y,
           int E, int M, int K, int R, int N, int w1p, int w2p, int qm,
           int rs, int C, int Cn, int Ncl, int G, int out_bf16, float* tg,
           float* pg, cudaStream_t stream) {
  const dim3 rows(1, (M + BM - 1) / BM, E);
  if (G) {  // grouped: t and the row maxima, then phase 2 from them
    int e = launch_kernel(lrmm_kernel<BM, RSC>, dim3(G, rows.y, E), 1,
                          layout(BM, rs, 1, 1, 32).total, stream, xq, sx,
                          w1, s1, w2, s2, y, M, K, R, N, w1p, w2p, qm, rs, 1,
                          32, out_bf16, tg, pg);
    if (e) return e;
    return launch_kernel(lrmm_tail_kernel<BM>,
                         dim3((N + Ncl - 1) / Ncl, rows.y, E), 1,
                         tail_layout(BM).total, stream,
                         static_cast<const float*>(tg),
                         static_cast<const float*>(pg), w2, y, M, R, N, G,
                         w2p, qm, Ncl, out_bf16);
  }
  const int sw = Ncl / Cn;
  return launch_kernel(lrmm_kernel<BM, RSC>,
                       dim3(C * ((N + Ncl - 1) / Ncl), rows.y, E), C,
                       layout(BM, rs, C, Cn, sw < NC ? sw : NC).total,
                       stream, xq, sx, w1, s1, w2, s2, y, M, K, R, N, w1p,
                       w2p, qm, rs, Cn, Ncl, out_bf16,
                       static_cast<float*>(nullptr),
                       static_cast<float*>(nullptr));
}

}  // namespace

// Shared memory of the larger CTA of a launch of `bm` rows and rank
// slice `rs`: in a cluster of `c` CTAs with `cn` along N in phase 2, each
// taking `ncl / cn` of the cluster's columns; or, with `groups` slices,
// the grouped path's two kernels (the wrapper's chooser keeps it within
// the card's per-block limit).
extern "C" long long lrmm_smem_bytes(int bm, int rs, int c, int cn, int ncl,
                                     int groups) {
  return static_cast<long long>(smem_total(bm, rs, c, cn, ncl, groups));
}

// Shapes: K % 16 == 0, R % 32 == 0, N % 32 == 0, pointers 16-byte
// aligned; bm in {16, 32, 64}. On chip (groups == 0): rs in {32, 64,
// 128}, or a multiple of 32 in (128, 512] with bm <= 32, and C * rs >= R;
// C in {1, 2, 4, 8} CTAs per cluster, cn | C, ncl a multiple of 32 * cn.
// The grid is C * ceil(N / ncl) CTAs along x by ceil(M / bm) along y by
// E experts along z. Grouped (groups = ceil(R / 128), rs 128, C = cn =
// 1): `groups` x ceil(M / bm) x E CTAs write t into tg (E, M, R) and the
// row maxima into pg (E, groups, M), both float32, then ceil(N / ncl) x
// ceil(M / bm) x E CTAs of ncl in {32, 64, 128} columns write Y. Every
// operand is a contiguous stack of E matrices (xq (E, M, K), sx (E, M),
// w1 (E, K, R), s1 and s2 (E, R), w2 (E, R, N), y (E, M, N); packed
// widths halved). y is fp32, or bfloat16 when out_bf16 != 0 (the fp32
// value rounded once to nearest even). Returns the launches' CUDA error.
extern "C" int lrmm_launch(const int8_t* xq, const float* sx,
                           const int8_t* w1, const float* s1,
                           const int8_t* w2, const float* s2, void* y, int E,
                           int M, int K, int R, int N, int w1_packed,
                           int w2_packed, int act_qmax, int bm, int rs, int C,
                           int cn, int ncl, int groups, int out_bf16,
                           float* tg, float* pg, void* stream) {
  if (E < 1 || E > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (groups && (rs != GROUP_RS || C != 1 || !tg || !pg))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LRMM_CASE(BM, RSC, OK)                                              \
  if (bm == BM && (OK))                                                     \
    return launch<BM, RSC>(xq, sx, w1, s1, w2, s2, y, E, M, K, R, N,        \
                           w1_packed, w2_packed, act_qmax, rs, C, cn, ncl,  \
                           groups, out_bf16, tg, pg, s);
  LRMM_CASE(16, 32, rs == 32) LRMM_CASE(16, 64, rs == 64)
  LRMM_CASE(16, 128, rs == 128)
  LRMM_CASE(32, 32, rs == 32) LRMM_CASE(32, 64, rs == 64)
  LRMM_CASE(32, 128, rs == 128)
  LRMM_CASE(64, 32, rs == 32) LRMM_CASE(64, 64, rs == 64)
  LRMM_CASE(64, 128, rs == 128)
  const bool wide = rs > 128 && rs <= RS_WIDE && rs % 32 == 0 && !groups;
  LRMM_CASE(16, 0, wide) LRMM_CASE(32, 0, wide)
#undef LRMM_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
