// Paged attention for Hopper (sm_90a): span queries against one layer's
// blocked KV pool.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py::
// paged_attention (body `_kernel`). Query rows are (span position w, group
// member g) pairs of one kv head, W*G of them per batch row. Row (w, g)
// sits at position ctx + w and sees key slot kpos iff kpos <= ctx + w, over
// the row's whole block-table view (MB * bs slots). That is the reference's
// gather oracle (`models.attention._span_attend_gather`) at every span
// position: past q_len, and in idle rows, too, whose values a
// mixture-of-experts layer routes. The kernel walks the row's block table
// by physical block id and visits no block past the last key its tile
// sees. Scores are (q . k) * Dh^-0.5, optionally tanh-softcapped, under an
// online softmax (running max, denominator, numerator). int8 K/V are
// dequantized as (float)code * scale, the reference's order.
//
// The arithmetic after the fp32 inputs is float64, rounded once to fp32
// at the output, as in the plain version (kernels/paged_attention.py).
// The two sum in different orders, this file is built without fused
// multiply-adds while the CPU's float64 einsum uses them, and float64
// exp here is not correctly rounded, so the float64 results differ in
// their last bits; after the one rounding to fp32 the card and the CPU
// agree very likely, not always. That matters because the activations are
// requantized right after attention, where a last-bit difference flips an
// int8 code and, through the layers, may flip a greedy token.
//
// What bounds the function on this card: it is fp32 attention, 4 * Dh
// flops per key and query row. Decode steps (one query row per kv head)
// are bound by the K/V bytes and in practice by latency: how long the
// longest row's walk takes on one SM. A 256-row prefill tile is bound by
// the fp32 rate outside the tensor cores. Float64 is this kernel's own
// choice, for parity with the CPU, and is a cost above that bound.
//
// Design. The grid is (batch row x kv head x query tile) x key splits.
// Each CTA takes the keys [split * kps, ...) of its tile (any kps; the
// wrapper picks whole blocks so that decode covers the card), and writes
// its partial (running max m, denominator l, numerator acc) in float64 to
// a workspace; a second small kernel combines the splits of each row in
// split order -- deterministic, no atomics -- and rounds once to fp32.
// With one split the first kernel writes the output itself. K/V blocks
// come through a two-stage shared-memory ring with 16-byte cp.async
// (int8 codes and their scales raw, dequantized where they are read), so
// the next ~64 keys load while the current ones are consumed.
// - Decode tiles (W*G <= 16 query rows, QT = 16): all four warps take
//   keys, 16 of every 64 each; two lanes share a key, each summing half
//   of Dh, joined by a shuffle. Each warp keeps its own softmax state per
//   row in shared memory; the four are merged in warp order at the end.
// - Prefill tiles (QT = 64 rows, 16 per warp): S = Q.K^T and O += P.V run
//   on the FP64 tensor cores (mma.sync m8n8k4 .f64). A product of two
//   fp32 values is exact in float64, so the float64 semantics stay. A warp
//   with no rows in the tile (past W * G), or a 32-key chunk that none of
//   its rows sees (above the causal diagonal), is skipped. What remains is
//   bound by the float64 exp of the softmax on the FP64 pipes, then by the
//   products; the wrapper cuts long tiles into splits so that they do not
//   hold the launch up.
// Shared-memory rows are padded so that the lanes of a warp read distinct
// banks: K rows by Dh + 4 floats (or Dh + 16 bytes), V rows by Dh + 8.
//
// bfloat16 models (`attend_bf16_kernel`, paged_attention_bf16_launch): q,
// the pool (or int8 codes with fp32 scales) and the output are bfloat16,
// and the reference rounds inside the function: int8 K/V dequantized as
// bf16(code * bf16(scale)), scores to fp32 (scaled in fp32, softcapped
// and rounded again), the softmax's p to fp32 and then bfloat16 BEFORE
// the PV product, the output to fp32 and then bfloat16. Between those
// points the kernel computes in float64, as the plain version does. p's
// rounding needs each row's final max m and denominator l, which an
// online softmax does not know while it sums P.V, so the kernel takes two
// passes over the keys: pass 1 finds m and l (online, float64), pass 2
// recomputes each score, rounds p = exp(s - m) / l and sums p * v.
// - The keys of a tile are split over a thread-block cluster of S <= 8
//   CTAs (the wrapper plans S from the shapes alone, so that a decode
//   step covers the card). Rank r takes the keys [r * kps, ...). After
//   pass 1 each CTA pushes its rows' (m, l) into every peer's shared
//   memory (DSMEM); after a cluster barrier each combines the S of them
//   in rank order, so all derive the same (m, l), deterministically and
//   without atomics. After pass 2 each CTA pushes its float64 P.V
//   partials of a column to the rank that owns the column, which sums
//   them in rank order and rounds once.
// - Both products run on the FP64 tensor cores (mma.sync m8n8k4 .f64, as
//   the fp32 kernel's prefill tiles): a product of two bf16 values, or of
//   bf16 p and a bf16 v, is exact in float64, so only the order of the
//   float64 sums differs from the plain version. 8 warps a CTA, each 8
//   query rows by the 8-key n-tiles it takes. Decode tiles (W*G <= 16;
//   8 rows a tile) give each warp one n-tile of every 64-key stage, and
//   the warps' (m, l) and partials are combined in warp order; prefill
//   tiles (64 rows) give each warp 8 rows and every key, and skip the
//   n-tiles above its rows' causal diagonal.
// - K/V come through a two-stage ring of 64-key stages with 16-byte
//   cp.async, the next stage loading while the current one is consumed,
//   across the pass boundary too. int8 codes and their scales land raw
//   and are widened to bf16 in place once a stage has landed (each key
//   once, not once per warp that reads it). A split of at most two stages
//   loads V with K in pass 1 and keeps both resident for pass 2, which
//   then loads nothing; a longer one streams K in pass 1 and K and V
//   again in pass 2. Rows are padded by 32 bytes, so the fragment loads
//   fall on distinct banks; lane t of a QK^T product reads Dh elements
//   4t ... 4t + 3 of each 16 as one 8-byte load for four k-steps.
// What bounds it: at decode the K/V bytes and latency (each CTA's chain
// of loads, barriers and dependent products); a W 256 prefill tile the
// FP64 tensor cores (6 * Dh flops a visible (query, key) pair: QK^T in
// both passes and PV), then the float64 exp. Dh 32, 64, 128, 160 and
// 192 (one CTA an SM at 192: `bf16_min_ctas`).
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 128, WARPS = THREADS / 32;
constexpr int KEYS = 64;  // keys staged per step, rounded to whole blocks
constexpr double NEG = -2.3819763e38;  // masked score, as in the reference

__host__ __device__ inline int blocks_per_stage(int bs) {
  return bs >= KEYS ? 1 : KEYS / bs;
}

// Rows of a stage: its keys rounded up to a multiple of 64 (zero-filled).
__host__ __device__ inline int stage_rows(int bs) {
  return (blocks_per_stage(bs) * bs + 63) / 64 * 64;
}

// Byte strides of a K and a V row in shared memory, and a stage's size.
__host__ __device__ inline int k_stride(int dh, bool quant) {
  return quant ? dh + 16 : (dh + 4) * 4;
}
__host__ __device__ inline int v_stride(int dh, bool quant) {
  return quant ? dh + 16 : (dh + 8) * 4;
}
__host__ __device__ inline size_t stage_bytes(int dh, bool quant, int bs) {
  const int rows = stage_rows(bs);
  return (size_t)rows * (k_stride(dh, quant) + v_stride(dh, quant)) +
         (quant ? (size_t)rows * 8 : 0);
}

// Dynamic shared memory: the Q tile (QT x (Dh + 4) floats), decode tiles'
// per-warp softmax states (m, l, acc in float64), two ring stages.
__host__ __device__ inline size_t smem_bytes(int qt, int dh, bool quant,
                                             int bs) {
  const size_t q = (size_t)qt * (dh + 4) * 4;
  const size_t states =
      qt <= 16 ? (size_t)WARPS * qt * (dh + 2) * 8 : 0;
  return q + states + 2 * stage_bytes(dh, quant, bs);
}

__device__ __forceinline__ double warp_max(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// d += a * b on the FP64 tensor cores: A 8x4 (lane = 4*g + t holds
// A[g][t]), B 4x8 (B[t][g]), C/D 8x8 (C[g][2t], C[g][2t+1]).
__device__ __forceinline__ void dmma(double (&d)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, "
      "{%0,%1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

__device__ __forceinline__ double soft(double s, double cap) {
  return cap > 0.0 ? cap * tanh(s / cap) : s;
}

// Element d of a staged K or V row in float64: the fp32 value, or the
// int8 code times the row's scale in fp32 (the reference's dequantization).
template <bool QUANT>
__device__ __forceinline__ double kv_at(const unsigned char* row, int d,
                                        const float* scale) {
  if constexpr (QUANT)
    return static_cast<double>(
        static_cast<float>(reinterpret_cast<const int8_t*>(row)[d]) * *scale);
  return static_cast<double>(reinterpret_cast<const float*>(row)[d]);
}

// Where a tile stands: batch row, kv head, query rows and key range.
struct Tile {
  int b, hk, row0, G, ctx, active, tile_keys;
};

__device__ __forceinline__ Tile locate(int cta, int tiles, int qt, int W,
                                       int H, int Hk, int bs, int MB,
                                       const int* ctxs) {
  Tile t;
  const int tile = cta % tiles;
  t.hk = (cta / tiles) % Hk;
  t.b = cta / tiles / Hk;
  t.G = H / Hk;
  t.row0 = tile * qt;
  t.ctx = ctxs[t.b];
  t.active = min(qt, W * t.G - t.row0);  // rows of the tile
  const int last_pos = t.ctx + (t.row0 + t.active - 1) / t.G;
  t.tile_keys = min(last_pos + 1, MB * bs);
  return t;
}

// output row of tile row i: (b, w = (row0+i) / G, head hk*G + g)
__device__ __forceinline__ float* out_row(float* out, const Tile& t, int i,
                                          int W, int H, int dh) {
  const int r = t.row0 + i;
  return out + (((size_t)t.b * W + r / t.G) * H + t.hk * t.G + r % t.G) * dh;
}

template <int DH, bool QUANT, int QT>
__global__ void __launch_bounds__(THREADS)
attend_kernel(const float* __restrict__ q, const void* __restrict__ kp,
              const void* __restrict__ vp, const float* __restrict__ ks,
              const float* __restrict__ vs, const int* __restrict__ bt,
              const int* __restrict__ ctxs, float* __restrict__ out, double* __restrict__ ws_ml,
              double* __restrict__ ws_acc, int W, int H, int Hk, int bs,
              int MB, int kps, int tiles, double scale, double cap) {
  constexpr bool DECODE = QT <= 16;
  constexpr int QS = DH + 4;  // Q row stride (floats)
  constexpr int KSTR = QUANT ? DH + 16 : (DH + 4) * 4;
  constexpr int VSTR = QUANT ? DH + 16 : (DH + 8) * 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = gridDim.y, split = blockIdx.y;
  const int cta = blockIdx.x * S + split;
  const Tile tl = locate(blockIdx.x, tiles, QT, W, H, Hk, bs, MB, ctxs);
  const int k_lo = split * kps;
  if (k_lo >= tl.tile_keys) return;
  const int k_hi = min(k_lo + kps, tl.tile_keys);

  float* Qs = reinterpret_cast<float*>(smem);
  double* st_ml = reinterpret_cast<double*>(Qs + QT * QS);  // decode only
  double* st_acc = st_ml + (DECODE ? WARPS * QT * 2 : 0);
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      st_acc + (DECODE ? WARPS * QT * DH : 0));
  const int rows = stage_rows(bs), bpi = blocks_per_stage(bs);
  const size_t sbytes = stage_bytes(DH, QUANT, bs);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int blk_first = k_lo / bs, blk_end = (k_hi - 1) / bs + 1;
  const int n_stages = (blk_end - blk_first + bpi - 1) / bpi;

  // stage st holds blocks blk_first + st*bpi ...: K rows, V rows, and for
  // int8 the two scale planes; rows past the stage's blocks are zeros
  auto issue = [&](int st) {
    if (st < n_stages) {
      unsigned char* base = ring + (st & 1) * sbytes;
      unsigned char* Kd = base;
      unsigned char* Vd = base + (size_t)rows * KSTR;
      const int blk0 = blk_first + st * bpi;
      constexpr int CPR = QUANT ? DH / 16 : DH / 4;  // 16-byte chunks a row
      constexpr int ESZ = QUANT ? 1 : 4;
      for (int idx = tid; idx < rows * CPR; idx += THREADS) {
        const int j = idx / CPR, c = idx % CPR;
        const int blk = blk0 + j / bs;
        const bool ok = j < bpi * bs && blk < blk_end;
        size_t at = 0;
        if (ok) {
          const size_t id = static_cast<size_t>(bt[(size_t)tl.b * MB + blk]);
          at = (((id * bs + j % bs) * Hk + tl.hk) * DH) * ESZ + c * 16;
        }
        rt::cp_async16(Kd + j * KSTR + c * 16,
                       static_cast<const unsigned char*>(kp) + at, ok);
        rt::cp_async16(Vd + j * VSTR + c * 16,
                       static_cast<const unsigned char*>(vp) + at, ok);
      }
      if constexpr (QUANT) {
        float* ksd = reinterpret_cast<float*>(Vd + (size_t)rows * VSTR);
        float* vsd = ksd + rows;
        for (int j = tid; j < rows; j += THREADS) {
          const int blk = blk0 + j / bs;
          const bool ok = j < bpi * bs && blk < blk_end;
          size_t tok = 0;
          if (ok) {
            const size_t id = static_cast<size_t>(bt[(size_t)tl.b * MB + blk]);
            tok = (id * bs + j % bs) * Hk + tl.hk;
          }
          rt::cp_async4(ksd + j, ks + tok, ok);
          rt::cp_async4(vsd + j, vs + tok, ok);
        }
      }
    }
    rt::cp_async_commit();
  };

  issue(0);
  // the Q tile, rows past `active` zero
  for (int idx = tid; idx < QT * DH; idx += THREADS) {
    const int i = idx / DH, d = idx % DH;
    Qs[i * QS + d] =
        i < tl.active ? out_row(const_cast<float*>(q), tl, i, W, H, DH)[d]
                      : 0.0f;
  }
  if (DECODE) {
    for (int idx = tid; idx < WARPS * QT; idx += THREADS) {
      st_ml[2 * idx] = NEG;
      st_ml[2 * idx + 1] = 0.0;
    }
    for (int idx = tid; idx < WARPS * QT * DH; idx += THREADS)
      st_acc[idx] = 0.0;
  }

  const int g = lane >> 2, t = lane & 3;
  // prefill state: rows warp*16 + mt*8 + g of the tile
  constexpr int NDT = DH / 8;
  double o[2][NDT][2], m_r[2], l_r[2];
  int qpos_r[2];
  bool live_r[2];
  if (!DECODE) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int i = warp * 16 + mt * 8 + g;
      m_r[mt] = NEG;
      l_r[mt] = 0.0;
      live_r[mt] = i < tl.active;
      qpos_r[mt] = tl.ctx + (tl.row0 + i) / tl.G;
#pragma unroll
      for (int dn = 0; dn < NDT; ++dn) o[mt][dn][0] = o[mt][dn][1] = 0.0;
    }
  }

  for (int st = 0; st < n_stages; ++st) {
    __syncthreads();        // the stage about to be refilled is consumed
    issue(st + 1);
    rt::cp_async_wait<1>();  // this thread's copies of stage st landed
    __syncthreads();        // ... and everyone's
    const unsigned char* base = ring + (st & 1) * sbytes;
    const unsigned char* Kb = base;
    const unsigned char* Vb = base + (size_t)rows * KSTR;
    const float* ksc = reinterpret_cast<const float*>(Vb + (size_t)rows * VSTR);
    const float* vsc = ksc + rows;
    const int kbase = (blk_first + st * bpi) * bs;  // position of row 0

    auto kval = [&](int j, int d) {
      return kv_at<QUANT>(Kb + j * KSTR, d, ksc + j);
    };
    auto vval = [&](int j, int d) {
      return kv_at<QUANT>(Vb + j * VSTR, d, vsc + j);
    };

    if constexpr (DECODE) {
      // ---- decode: warp w takes keys [w*kpw, (w+1)*kpw) of the stage ----
      constexpr int DPL = DH / 32, HALF = DH / 2;
      const int kpw = rows / WARPS, half = lane >> 4;
      for (int i = 0; i < tl.active; ++i) {
        const int qpos = tl.ctx + (tl.row0 + i) / tl.G;
        const float* qi = Qs + i * QS;
        double* ml = st_ml + 2 * (warp * QT + i);
        double* ac = st_acc + (size_t)(warp * QT + i) * DH + lane * DPL;
        double m = ml[0], l = ml[1], acc[DPL];
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[e] = ac[e];
        for (int kc = 0; kc < kpw; kc += 16) {
          const int j = warp * kpw + kc + (lane & 15);
          const int kpos = kbase + j;
          const bool valid = kpos >= k_lo && kpos < k_hi && kpos <= qpos;
          double dot = 0.0;
          if constexpr (QUANT) {
            const float sk = ksc[j];
#pragma unroll
            for (int d0 = 0; d0 < HALF; d0 += 16) {
              const int d = half * HALF + d0;
              const int4 w = *reinterpret_cast<const int4*>(
                  Kb + j * KSTR + d);
              const int words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
              for (int u = 0; u < 16; ++u) {
                const int code = static_cast<int>(
                    static_cast<int8_t>(words[u / 4] >> (8 * (u % 4))));
                dot += static_cast<double>(qi[d + u]) *
                       static_cast<double>(static_cast<float>(code) * sk);
              }
            }
          } else {
#pragma unroll
            for (int d0 = 0; d0 < HALF; d0 += 4) {
              const int d = half * HALF + d0;
              const float4 kv = *reinterpret_cast<const float4*>(
                  Kb + j * KSTR + d * 4);
              dot += static_cast<double>(qi[d]) * static_cast<double>(kv.x);
              dot += static_cast<double>(qi[d + 1]) * static_cast<double>(kv.y);
              dot += static_cast<double>(qi[d + 2]) * static_cast<double>(kv.z);
              dot += static_cast<double>(qi[d + 3]) * static_cast<double>(kv.w);
            }
          }
          dot += __shfl_xor_sync(0xffffffffu, dot, 16);
          const double s = valid ? soft(dot * scale, cap) : NEG;
          const double m_new = fmax(m, warp_max(s));
          const double p = valid ? exp(s - m_new) : 0.0;
          const double alpha = exp(m - m_new);
          l = l * alpha + warp_sum(half == 0 ? p : 0.0);
#pragma unroll
          for (int e = 0; e < DPL; ++e) acc[e] *= alpha;
          for (int jj = 0; jj < 16; ++jj) {
            const double pj = __shfl_sync(0xffffffffu, p, jj);
            if (pj == 0.0) continue;  // warp-uniform: masked key
            const int key = warp * kpw + kc + jj;
#pragma unroll
            for (int e = 0; e < DPL; ++e)
              acc[e] += pj * vval(key, lane * DPL + e);
          }
          m = m_new;
        }
        if (lane == 0) {
          ml[0] = m;
          ml[1] = l;
        }
#pragma unroll
        for (int e = 0; e < DPL; ++e) ac[e] = acc[e];
      }
    } else {
      // ---- prefill: 32 keys at a time on the FP64 tensor cores -----------
      // a warp with none of its 16 rows in the tile, or a 32-key chunk that
      // none of its rows sees, skips the work (warp-uniform)
      if (warp * 16 >= tl.active) continue;
      const int last_row = min(warp * 16 + 15, tl.active - 1);
      const int warp_qpos = tl.ctx + (tl.row0 + last_row) / tl.G;
      for (int sc = 0; sc < rows; sc += 32) {
        const int k0 = kbase + sc;
        if (k0 > warp_qpos || k0 >= k_hi || k0 + 31 < k_lo) continue;
        double s[2][4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) s[mt][nt][0] = s[mt][nt][1] = 0.0;
#pragma unroll 4
        for (int kk = 0; kk < DH; kk += 4) {
          double a[2];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            a[mt] = static_cast<double>(
                Qs[(warp * 16 + mt * 8 + g) * QS + kk + t]);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const double b = kval(sc + nt * 8 + g, kk + t);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) dmma(s[mt][nt], a[mt], b);
          }
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          double mx = NEG;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int kpos = kbase + sc + nt * 8 + 2 * t + h;
              const bool valid = live_r[mt] && kpos >= k_lo && kpos < k_hi &&
                                 kpos <= qpos_r[mt];
              s[mt][nt][h] = valid ? soft(s[mt][nt][h] * scale, cap) : NEG;
              mx = fmax(mx, s[mt][nt][h]);
            }
          mx = fmax(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmax(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const double m_new = fmax(m_r[mt], mx);
          double rs = 0.0;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              double p = 0.0;
              if (s[mt][nt][h] > NEG) p = exp(s[mt][nt][h] - m_new);
              s[mt][nt][h] = p;
              rs += p;
            }
          rs += __shfl_xor_sync(0xffffffffu, rs, 1);
          rs += __shfl_xor_sync(0xffffffffu, rs, 2);
          const double alpha = exp(m_r[mt] - m_new);
          l_r[mt] = l_r[mt] * alpha + rs;
          m_r[mt] = m_new;
#pragma unroll
          for (int dn = 0; dn < NDT; ++dn) {
            o[mt][dn][0] *= alpha;
            o[mt][dn][1] *= alpha;
          }
        }
        // O += P.V: P[g][kk4 + t] sits in lane 4g + (kk4 % 8 + t) / 2
#pragma unroll
        for (int kk4 = 0; kk4 < 32; kk4 += 4) {
          const int nt = kk4 / 8, src = 4 * g + ((kk4 % 8) + t) / 2;
          double a[2];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const double p0 = __shfl_sync(0xffffffffu, s[mt][nt][0], src);
            const double p1 = __shfl_sync(0xffffffffu, s[mt][nt][1], src);
            a[mt] = (t & 1) ? p1 : p0;
          }
#pragma unroll
          for (int dn = 0; dn < NDT; ++dn) {
            const double b = vval(sc + kk4 + t, dn * 8 + g);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) dmma(o[mt][dn], a[mt], b);
          }
        }
      }
    }
  }

  // ---- this split's result: the output, or a partial for the combine --
  const bool final_out = S == 1;
  if constexpr (DECODE) {
    __syncthreads();
    for (int idx = tid; idx < tl.active * DH; idx += THREADS) {
      const int i = idx / DH, d = idx % DH;
      double M = NEG;
      for (int w = 0; w < WARPS; ++w) M = fmax(M, st_ml[2 * (w * QT + i)]);
      double L = 0.0, A = 0.0;
      for (int w = 0; w < WARPS; ++w) {
        const double e = exp(st_ml[2 * (w * QT + i)] - M);
        L += st_ml[2 * (w * QT + i) + 1] * e;
        A += st_acc[(size_t)(w * QT + i) * DH + d] * e;
      }
      if (final_out) {
        out_row(out, tl, i, W, H, DH)[d] =
            static_cast<float>(A / (L > 0.0 ? L : 1.0));
      } else {
        ws_acc[((size_t)cta * QT + i) * DH + d] = A;
        if (d == 0) {
          ws_ml[((size_t)cta * QT + i) * 2] = M;
          ws_ml[((size_t)cta * QT + i) * 2 + 1] = L;
        }
      }
    }
  } else {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int i = warp * 16 + mt * 8 + g;
      if (!live_r[mt]) continue;
      if (final_out) {
        const double l = l_r[mt] > 0.0 ? l_r[mt] : 1.0;
        float* orow = out_row(out, tl, i, W, H, DH);
#pragma unroll
        for (int dn = 0; dn < NDT; ++dn) {
          orow[dn * 8 + 2 * t] = static_cast<float>(o[mt][dn][0] / l);
          orow[dn * 8 + 2 * t + 1] = static_cast<float>(o[mt][dn][1] / l);
        }
      } else {
        double* wa = ws_acc + ((size_t)cta * QT + i) * DH;
#pragma unroll
        for (int dn = 0; dn < NDT; ++dn) {
          wa[dn * 8 + 2 * t] = o[mt][dn][0];
          wa[dn * 8 + 2 * t + 1] = o[mt][dn][1];
        }
        if (t == 0) {
          ws_ml[((size_t)cta * QT + i) * 2] = m_r[mt];
          ws_ml[((size_t)cta * QT + i) * 2 + 1] = l_r[mt];
        }
      }
    }
  }
}

// Combine the splits of each tile row in split order (m, l, acc ->
// acc_total / l_total) and round once to fp32. A CTA
// takes CR rows of a tile: the splits' (m, l) are loaded at once, one
// thread a row derives the split factors exp(m_j - M) and l_total in split
// order, then every (row, dim) of the CTA sums its acc_j in split order.
constexpr int CR = 16, CTHREADS = 256;

__host__ __device__ inline size_t combine_smem(int S) {
  return (size_t)CR * S * 3 * 8 + CR * 8;
}

template <int DH, int QT>
__global__ void __launch_bounds__(CTHREADS)
combine_kernel(const double* __restrict__ ws_ml,
               const double* __restrict__ ws_acc, const int* __restrict__ ctxs,
               float* __restrict__ out, int W, int H, int Hk, int bs, int MB,
               int kps, int S, int tiles) {
  extern __shared__ double cs[];
  double* ml = cs;                 // CR x S (m, l) pairs
  double* fac = ml + CR * S * 2;   // CR x S factors exp(m_j - M)
  double* tot = fac + CR * S;      // CR denominators
  const Tile tl = locate(blockIdx.x, tiles, QT, W, H, Hk, bs, MB, ctxs);
  const int r0 = blockIdx.y * CR, tid = threadIdx.x;
  const int rows = max(0, min(CR, tl.active - r0));
  if (rows == 0) return;
  const int ns = (tl.tile_keys + kps - 1) / kps;  // splits that ran
  const size_t base = (size_t)blockIdx.x * S;
  for (int idx = tid; idx < rows * ns; idx += CTHREADS) {
    const int i = idx / ns, j = idx % ns;
    const size_t r = (base + j) * QT + r0 + i;
    ml[2 * (i * S + j)] = ws_ml[2 * r];
    ml[2 * (i * S + j) + 1] = ws_ml[2 * r + 1];
  }
  __syncthreads();
  if (tid < rows) {
    const double* m = ml + 2 * tid * S;
    double M = NEG, L = 0.0;
    for (int j = 0; j < ns; ++j) M = fmax(M, m[2 * j]);
    for (int j = 0; j < ns; ++j) {
      const double e = exp(m[2 * j] - M);
      fac[tid * S + j] = e;
      L += m[2 * j + 1] * e;
    }
    tot[tid] = L > 0.0 ? L : 1.0;
  }
  __syncthreads();
  for (int idx = tid; idx < rows * DH; idx += CTHREADS) {
    const int i = idx / DH, d = idx % DH;
    double A = 0.0;
#pragma unroll 4
    for (int j = 0; j < ns; ++j)
      A += ws_acc[((base + j) * QT + r0 + i) * DH + d] * fac[i * S + j];
    out_row(out, tl, r0 + i, W, H, DH)[d] = static_cast<float>(A / tot[i]);
  }
}

template <int DH, bool QUANT, int QT>
int launch(const float* q, const void* k, const void* v, const float* ks,
           const float* vs, const int* bt, const int* ctx, float* out, double* ws_ml, double* ws_acc, int B, int W, int H,
           int Hk, int bs, int MB, int kps, int S, double scale, double cap,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(QT, DH, QUANT, bs);
  auto kern = attend_kernel<DH, QUANT, QT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (W * (H / Hk) + QT - 1) / QT;
  const dim3 grid(B * Hk * tiles, S);
  kern<<<grid, THREADS, smem, stream>>>(q, k, v, ks, vs, bt, ctx, out,
                                        ws_ml, ws_acc, W, H, Hk, bs, MB, kps,
                                        tiles, scale, cap);
  e = cudaGetLastError();
  if (e != cudaSuccess || S == 1) return static_cast<int>(e);
  const size_t csmem = combine_smem(S);
  if (csmem > 48 * 1024) {
    e = cudaFuncSetAttribute(combine_kernel<DH, QT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(csmem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  combine_kernel<DH, QT><<<dim3(B * Hk * tiles, QT / CR), CTHREADS, csmem,
                           stream>>>(ws_ml, ws_acc, ctx, out, W, H, Hk, bs,
                                     MB, kps, S, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory of one CTA (the wrapper checks it against the card's
// per-block limit).
extern "C" long long paged_attention_smem_bytes(int qt, int dh, int quant,
                                                int bs) {
  return static_cast<long long>(smem_bytes(qt, dh, quant != 0, bs));
}

// q (B, W, H, Dh) f32; k/v (NB, bs, Hk, Dh) f32, or int8 with ks/vs
// (NB, bs, Hk, 1) f32 scales when quant != 0; block_table (B, MB) i32;
// ctx_lens (B,) i32; out (B, W, H, Dh) f32. Dh in {32, 64, 128};
// qt (query rows per tile) 16 or 64; each tile's keys go to
// ceil(keys / kps) CTAs of S; with S > 1, ws_ml (tiles x S x qt x 2) and
// ws_acc (tiles x S x qt x Dh) float64 hold their partials. Returns the
// launches' CUDA error.
extern "C" int paged_attention_launch(
    const float* q, const void* k, const void* v, const float* ks,
    const float* vs, const int* block_table, const int* ctx_lens,
    float* out, double* ws_ml, double* ws_acc, int B,
    int W, int H, int Hk, int Dh, int bs, int MB, int quant, int qt, int kps,
    int S, double scale, double softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PA_CASE(DH, QT)                                                   \
  if (Dh == DH && qt == QT)                                               \
    return quant ? launch<DH, true, QT>(q, k, v, ks, vs, block_table,     \
                                        ctx_lens, out, ws_ml, ws_acc, B,  \
                                        W, H, Hk, bs, MB, kps, S, scale,  \
                                        softcap, s)                       \
                 : launch<DH, false, QT>(q, k, v, ks, vs, block_table,    \
                                         ctx_lens, out, ws_ml, ws_acc, B, \
                                         W, H, Hk, bs, MB, kps, S, scale, \
                                         softcap, s);
  PA_CASE(32, 16) PA_CASE(64, 16) PA_CASE(128, 16)
  PA_CASE(32, 64) PA_CASE(64, 64) PA_CASE(128, 64)
#undef PA_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// ------------------------------------------------------------ bfloat16 --
namespace {

constexpr int BTHREADS = 256, BWARPS = BTHREADS / 32;
constexpr int BKC = 64;          // keys a ring stage holds
constexpr int BQT_DECODE = 8, BQT_PREFILL = 64;  // query rows of a tile
constexpr int BCLUSTER = 8;      // most key splits (cluster ranks) a tile takes

// Byte stride of a bf16 row in shared memory (Q, K and V): 2 * Dh bytes
// and 32 of padding, so that the 8-byte fragment loads of a half warp (4
// rows) and the 2-byte ones of a warp (4 rows of 8 columns) fall on
// distinct banks. An int8 row lands raw in the second half of its row
// (bytes Dh ... 2 Dh - 1) and is widened in place.
__host__ __device__ constexpr int brow(int dh) { return dh * 2 + 32; }

// Where the regions of a CTA's dynamic shared memory start: the Q tile
// (bf16); each row's final (M, L) and, where warps split the keys, each
// warp's (m, l); the (m, l) the cluster's CTAs exchange (S slots a row);
// for decode tiles, the P.V column shares received from the cluster; then
// one region that holds the two ring stages during the passes and, after
// them, decode tiles' per-warp P.V partials or prefill tiles' received
// shares.
struct BLayout {
  size_t q, stat, mlx, recv, ring, stage, wpart, total;
};

__host__ __device__ inline BLayout bf16_layout(int qt, int dh, bool quant,
                                               int S) {
  const int wk = BWARPS * 8 / qt;  // warps along the keys: 8 or 1
  const bool own_recv = qt == BQT_DECODE;
  const size_t recv = S > 1 ? (size_t)S * qt * ((dh + S - 1) / S) * 8 : 0;
  const size_t wpart = wk > 1 ? (size_t)wk * qt * dh * 8 : 0;
  BLayout L;
  L.q = 0;
  L.stat = (size_t)qt * brow(dh);
  L.mlx = L.stat + (size_t)qt * 16 * (wk > 1 ? 1 + wk : 1);
  L.recv = L.mlx + (size_t)S * qt * 16;
  L.ring = L.recv + (own_recv ? recv : 0);
  L.stage = (size_t)BKC * 2 * brow(dh) + (quant ? BKC * 8 : 0);
  L.wpart = L.ring;
  if (!own_recv) L.recv = L.ring + wpart;
  const size_t after = wpart + (own_recv ? 0 : recv);
  L.total = L.ring + (2 * L.stage > after ? 2 * L.stage : after);
  return L;
}

// PTX split cluster barrier (as in lowrank_qmm.cu): arrive, wait later.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Four consecutive bf16 values (8 bytes) as float64, exactly.
__device__ __forceinline__ void bf16x4(const unsigned char* p,
                                       double (&v)[4]) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  v[0] = static_cast<double>(__uint_as_float(w.x << 16));
  v[1] = static_cast<double>(__uint_as_float(w.x & 0xffff0000u));
  v[2] = static_cast<double>(__uint_as_float(w.y << 16));
  v[3] = static_cast<double>(__uint_as_float(w.y & 0xffff0000u));
}

// A score from its float64 dot product (exact products, summed in
// float64): rounded to fp32, scaled in fp32 (one rounding of the exact
// product, as the plain version's float64 product rounded to fp32),
// softcapped in float64 and rounded again.
__device__ __forceinline__ double bf16_score(double dot, float scale,
                                             double cap) {
  float s = __fmul_rn(static_cast<float>(dot), scale);
  if (cap > 0.0) s = static_cast<float>(cap * tanh(s / cap));
  return static_cast<double>(s);
}

// CTAs an SM the compiler plans registers for: two up to Dh 160 (at most
// 128 registers a thread). At Dh 192 a warp's float64 output alone takes
// 96 registers a thread (24 m8n8 tiles), and a CTA's shared memory
// (108-140 KB) lets only one CTA on an SM at any split, so one it is: the
// cap rises to 255 and nothing spills.
__host__ __device__ constexpr int bf16_min_ctas(int dh) {
  return dh > 160 ? 1 : 2;
}

// One CTA: QT query rows of a (batch row, kv head) against the keys
// [rank * kps, ...) of the tile, rank being the CTA's rank in a cluster of
// S (see the file's header). Warp w takes rows (w / WK) * 8 ... + 7 and,
// of each 64-key stage, the 8-key n-tiles w % WK, w % WK + WK, ...
template <int DH, int QT, bool QUANT>
__global__ void __launch_bounds__(BTHREADS, bf16_min_ctas(DH))
attend_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                   const void* __restrict__ kp, const void* __restrict__ vp,
                   const float* __restrict__ ks, const float* __restrict__ vs,
                   const int* __restrict__ bt, const int* __restrict__ ctxs,
                   __nv_bfloat16* __restrict__ out, int W, int H, int Hk,
                   int bs, int MB, int kps, int tiles, float scale,
                   double cap) {
  constexpr int WK = BWARPS * 8 / QT;   // warps along the keys
  constexpr int NPW = 8 / WK;           // n-tiles a warp takes of a stage
  constexpr int NG = NPW < 4 ? NPW : 4;  // n-tiles a warp holds at once
  constexpr int NDT = DH / 8;           // 8-column tiles of the output
  constexpr int ROW = brow(DH);         // bytes a Q, K or V row
  constexpr int RAW = QUANT ? DH : DH * 2;  // bytes a pool row
  constexpr int CPR = RAW / 16;         // 16-byte copies a row
  constexpr bool OWN_RECV = QT == BQT_DECODE;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  // peers write into this CTA's shared memory only once all have started
  if (S > 1) cluster_arrive();
  const BLayout L = bf16_layout(QT, DH, QUANT, S);
  unsigned char* Qs = smem + L.q;
  double* stat = reinterpret_cast<double*>(smem + L.stat);  // (M, L) a row
  double* wstat = stat + 2 * QT;                            // WK x QT (m, l)
  double* mlx = reinterpret_cast<double*>(smem + L.mlx);    // S x QT (m, l)
  unsigned char* ring = smem + L.ring;
  double* wpart = reinterpret_cast<double*>(smem + L.wpart);
  double* recv = reinterpret_cast<double*>(smem + L.recv);

  const Tile tl = locate(blockIdx.x / S, tiles, QT, W, H, Hk, bs, MB, ctxs);
  const int slots = MB * bs;
  const int k_lo = rank * kps, k_hi = min(k_lo + kps, tl.tile_keys);
  const int n_ch = k_lo < k_hi ? (k_hi - k_lo + BKC - 1) / BKC : 0;
  const bool resident = n_ch <= 2;  // pass 2 reads pass 1's stages again
  const int n_steps = resident ? n_ch : 2 * n_ch;
  const int* bt_row = bt + (size_t)tl.b * MB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp / WK, wk = warp % WK;
  // this lane's query row (row g of the warp's 8) and the last key it sees
  const int i_row = wr * 8 + g;
  const bool live = i_row < tl.active;
  const int lim = live ? min(tl.ctx + (tl.row0 + i_row) / tl.G, slots - 1)
                       : -1;
  const bool warp_live = wr * 8 < tl.active;
  const int warp_lim = warp_live
      ? min(tl.ctx + (tl.row0 + min(wr * 8 + 7, tl.active - 1)) / tl.G,
            slots - 1)
      : -1;

  // step s < n_ch stages chunk s for pass 1 (K; V too when resident), step
  // n_ch + c chunk c again for pass 2 (K and V); keys past k_hi are zeros
  auto issue = [&](int step) {
    if (step < n_steps) {
      const bool pass2 = step >= n_ch;
      const int k0 = k_lo + (pass2 ? step - n_ch : step) * BKC;
      const bool with_v = pass2 || resident;
      unsigned char* Kd = ring + (step & 1) * L.stage + (QUANT ? DH : 0);
      unsigned char* Vd = Kd + BKC * ROW;
      for (int idx = tid; idx < BKC * CPR; idx += BTHREADS) {
        const int j = idx / CPR, c = idx % CPR, key = k0 + j;
        const bool ok = key < k_hi;
        size_t at = 0;
        if (ok) {
          const size_t slot = (size_t)bt_row[key / bs] * bs + key % bs;
          at = (slot * Hk + tl.hk) * RAW + c * 16;
        }
        rt::cp_async16(Kd + j * ROW + c * 16,
                       static_cast<const unsigned char*>(kp) + at, ok);
        if (with_v)
          rt::cp_async16(Vd + j * ROW + c * 16,
                         static_cast<const unsigned char*>(vp) + at, ok);
      }
      if constexpr (QUANT) {
        float* ksd = reinterpret_cast<float*>(ring + (step & 1) * L.stage +
                                              2 * BKC * ROW);
        for (int j = tid; j < BKC; j += BTHREADS) {
          const int key = k0 + j;
          const bool ok = key < k_hi;
          size_t tok = 0;
          if (ok)
            tok = ((size_t)bt_row[key / bs] * bs + key % bs) * Hk + tl.hk;
          rt::cp_async4(ksd + j, ks + tok, ok);
          if (with_v) rt::cp_async4(ksd + BKC + j, vs + tok, ok);
        }
      }
    }
    rt::cp_async_commit();
  };
  // an int8 stage widened in place to bf16(code * bf16(scale)), the
  // reference's dequantization: a thread takes a row, 16 codes at a time
  // from the first; chunk c's bf16 values overwrite the codes of chunks
  // 2c - Dh/16 and 2c - Dh/16 + 1, which it has read already
  auto widen = [&](unsigned char* base, bool with_v) {
    const float* scl = reinterpret_cast<const float*>(base + 2 * BKC * ROW);
    for (int r = tid; r < (with_v ? 2 : 1) * BKC; r += BTHREADS) {
      unsigned char* row = base + r * ROW;
      const float sc = bf16_round(scl[r]);
#pragma unroll 2
      for (int c = 0; c < DH / 16; ++c) {
        const int4 raw = *reinterpret_cast<const int4*>(row + DH + c * 16);
        const int words[4] = {raw.x, raw.y, raw.z, raw.w};
        __nv_bfloat162 o2[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int w = words[u / 2] >> (16 * (u % 2));
          o2[u] = __floats2bfloat162_rn(
              static_cast<float>(static_cast<int8_t>(w)) * sc,
              static_cast<float>(static_cast<int8_t>(w >> 8)) * sc);
        }
        int4* dst = reinterpret_cast<int4*>(row + c * 32);
        dst[0] = *reinterpret_cast<const int4*>(o2);
        dst[1] = *reinterpret_cast<const int4*>(o2 + 4);
      }
    }
    __syncthreads();
  };

  // the Q tile (rows past `active` zeros) joins the first stage's group
  for (int idx = tid; idx < QT * (DH / 8); idx += BTHREADS) {
    const int i = idx / (DH / 8), c = idx % (DH / 8), r = tl.row0 + i;
    const bool ok = i < tl.active;
    const size_t at =
        ok ? (((size_t)tl.b * W + r / tl.G) * H + tl.hk * tl.G + r % tl.G) *
                     DH + c * 8
           : 0;
    rt::cp_async16(Qs + i * ROW + c * 16, q + at, ok);
  }
  issue(0);

  // the scores of this lane's row against the group's n-tiles `nts` of a
  // stage whose first key is `kbase` (-inf where the row does not see
  // the key). The products run over Dh in blocks of 16: lane t's A and B
  // values are elements 4t ... 4t + 3 of a block, one per k-step, so one
  // 8-byte load feeds four products; the sum is over all of Dh either way.
  auto scores = [&](const unsigned char* Kb, int kbase, const int (&nts)[NG],
                    const bool (&on)[NG], double (&s)[NG][2]) {
#pragma unroll
    for (int j = 0; j < NG; ++j) s[j][0] = s[j][1] = 0.0;
    const unsigned char* qrow = Qs + i_row * ROW + 8 * t;
#pragma unroll 2
    for (int kb = 0; kb < DH; kb += 16) {
      double a[4];
      bf16x4(qrow + 2 * kb, a);
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        if (!on[j]) continue;
        double b[4];
        bf16x4(Kb + (nts[j] * 8 + g) * ROW + 2 * kb + 8 * t, b);
#pragma unroll
        for (int e = 0; e < 4; ++e) dmma(s[j], a[e], b[e]);
      }
    }
#pragma unroll
    for (int j = 0; j < NG; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key = kbase + nts[j] * 8 + 2 * t + h;
        s[j][h] = on[j] && key < k_hi && key <= lim
                      ? bf16_score(s[j][h], scale, cap)
                      : -INFINITY;
      }
  };
  // the n-tiles of group j0 of a stage, and which of them the warp's rows
  // see at all (warp-uniform)
  auto group = [&](int kbase, int j0, int (&nts)[NG], bool (&on)[NG]) {
    bool any = false;
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      nts[j] = wk + WK * (j0 + j);
      const int key0 = kbase + nts[j] * 8;
      on[j] = warp_live && key0 <= warp_lim && key0 < k_hi;
      any |= on[j];
    }
    return any;
  };

  // ---- pass 1: each row's running max m and denominator l (float64) ----
  double m = -INFINITY, l = 0.0;
  for (int step = 0; step < n_ch; ++step) {
    __syncthreads();  // the stage about to be refilled is consumed
    issue(step + 1);
    rt::cp_async_wait<1>();
    __syncthreads();
    unsigned char* Kb = ring + (step & 1) * L.stage;
    if constexpr (QUANT) widen(Kb, resident);
    const int kbase = k_lo + step * BKC;
#pragma unroll
    for (int j0 = 0; j0 < NPW; j0 += NG) {
      int nts[NG];
      bool on[NG];
      if (!group(kbase, j0, nts, on)) continue;
      double s[NG][2];
      scores(Kb, kbase, nts, on, s);
      double mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NG; ++j) mx = fmax(mx, fmax(s[j][0], s[j][1]));
      mx = fmax(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmax(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const double mn = fmax(m, mx);
      double part = 0.0;
#pragma unroll
      for (int j = 0; j < NG; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (s[j][h] != -INFINITY) part += exp(s[j][h] - mn);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      l = (m == -INFINITY ? 0.0 : l * exp(m - mn)) + part;
      m = mn;
    }
  }

  // ---- the CTA's (m, l) per row, then the cluster's, in rank order -----
  if (WK > 1) {
    if (t == 0) {
      wstat[2 * (wk * QT + i_row)] = m;
      wstat[2 * (wk * QT + i_row) + 1] = l;
    }
    __syncthreads();
    if (tid < QT) {
      double M = -INFINITY, Lt = 0.0;
      for (int w = 0; w < WK; ++w) M = fmax(M, wstat[2 * (w * QT + tid)]);
      for (int w = 0; w < WK; ++w) {
        const double lw = wstat[2 * (w * QT + tid) + 1];
        if (lw > 0.0) Lt += lw * exp(wstat[2 * (w * QT + tid)] - M);
      }
      stat[2 * tid] = M;
      stat[2 * tid + 1] = Lt;
    }
  } else if (t == 0) {
    stat[2 * i_row] = m;
    stat[2 * i_row + 1] = l;
  }
  if (S > 1) {
    __syncthreads();
    cluster_wait();  // every CTA of the cluster has started
    if (tid < QT)
      for (int r = 0; r < S; ++r) {
        double* dst = cluster.map_shared_rank(mlx + 2 * (rank * QT + tid), r);
        dst[0] = stat[2 * tid];
        dst[1] = stat[2 * tid + 1];
      }
    cluster.sync();  // every rank's (m, l) has arrived
    if (tid < QT) {
      double M = -INFINITY, Lt = 0.0;
      for (int r = 0; r < S; ++r) M = fmax(M, mlx[2 * (r * QT + tid)]);
      for (int r = 0; r < S; ++r) {
        const double lr = mlx[2 * (r * QT + tid) + 1];
        if (lr > 0.0) Lt += lr * exp(mlx[2 * (r * QT + tid)] - M);
      }
      stat[2 * tid] = M;
      stat[2 * tid + 1] = Lt;
    }
  }
  __syncthreads();
  const double M_row = live ? stat[2 * i_row] : 0.0;
  const double L_row = live && stat[2 * i_row + 1] > 0.0
                           ? stat[2 * i_row + 1] : 1.0;

  // ---- pass 2: p = bf16(fp32(exp(s - M) / L)), O += P.V in float64 ----
  double o[NDT][2];
#pragma unroll
  for (int dn = 0; dn < NDT; ++dn) o[dn][0] = o[dn][1] = 0.0;
  for (int c = 0; c < n_ch; ++c) {
    int slot = c;
    if (!resident) {
      const int step = n_ch + c;
      __syncthreads();
      issue(step + 1);
      rt::cp_async_wait<1>();
      __syncthreads();
      slot = step & 1;
      if constexpr (QUANT) widen(ring + slot * L.stage, true);
    }
    const unsigned char* Kb = ring + slot * L.stage;
    const unsigned char* Vb = Kb + BKC * ROW;
    const int kbase = k_lo + c * BKC;
#pragma unroll
    for (int j0 = 0; j0 < NPW; j0 += NG) {
      int nts[NG];
      bool on[NG];
      if (!group(kbase, j0, nts, on)) continue;
      double s[NG][2];
      scores(Kb, kbase, nts, on, s);
#pragma unroll
      for (int j = 0; j < NG; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          s[j][h] = s[j][h] == -INFINITY
                        ? 0.0
                        : static_cast<double>(bf16_round(static_cast<float>(
                              exp(s[j][h] - M_row) / L_row)));
      // P[g][key0 + t] of a 4-key step sits in lane 4g + (4e + t) / 2
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        if (!on[j]) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int src = 4 * g + 2 * e + (t >> 1);
          const double p0 = __shfl_sync(0xffffffffu, s[j][0], src);
          const double p1 = __shfl_sync(0xffffffffu, s[j][1], src);
          const double a = (t & 1) ? p1 : p0;
          const __nv_bfloat16* vrow = reinterpret_cast<const __nv_bfloat16*>(
              Vb + (nts[j] * 8 + 4 * e + t) * ROW);
#pragma unroll
          for (int dn = 0; dn < NDT; ++dn)
            dmma(o[dn], a,
                 static_cast<double>(__bfloat162float(vrow[dn * 8 + g])));
        }
      }
    }
  }

  // ---- the output: warps' partials in warp order, ranks' in rank order,
  // rounded once to fp32 and then bf16 ----------------------------------
  rt::cp_async_wait<0>();
  __syncthreads();  // no warp reads the ring any more
  // ... nor any CTA of the cluster, where the shares land in the ring
  if (S > 1 && !OWN_RECV) cluster.sync();
  auto out_at = [&](int i, int d) -> __nv_bfloat16* {
    const int r = tl.row0 + i;
    return out + (((size_t)tl.b * W + r / tl.G) * H + tl.hk * tl.G +
                  r % tl.G) * DH + d;
  };
  // column d's total of row i, from this CTA: to its owner or the output
  auto emit = [&](int i, int d, double v) {
    if (S == 1) {
      *out_at(i, d) = __float2bfloat16_rn(static_cast<float>(v));
    } else {
      const int share = (DH + S - 1) / S;
      double* dst = recv + (size_t)(rank * QT + i) * share + d / S;
      *cluster.map_shared_rank(dst, d % S) = v;
    }
  };
  if (WK > 1) {
#pragma unroll
    for (int dn = 0; dn < NDT; ++dn) {
      double* wp = wpart + ((size_t)wk * QT + i_row) * DH + dn * 8 + 2 * t;
      wp[0] = o[dn][0];
      wp[1] = o[dn][1];
    }
    __syncthreads();
    for (int idx = tid; idx < tl.active * DH; idx += BTHREADS) {
      const int i = idx / DH, d = idx % DH;
      double v = 0.0;
      for (int w = 0; w < WK; ++w) v += wpart[((size_t)w * QT + i) * DH + d];
      emit(i, d, v);
    }
  } else if (live) {
#pragma unroll
    for (int dn = 0; dn < NDT; ++dn) {
      emit(i_row, dn * 8 + 2 * t, o[dn][0]);
      emit(i_row, dn * 8 + 2 * t + 1, o[dn][1]);
    }
  }
  if (S > 1) {
    cluster.sync();  // every partial of this CTA's columns has arrived
    const int share = (DH + S - 1) / S;
    for (int idx = tid; idx < tl.active * share; idx += BTHREADS) {
      const int i = idx / share, j = idx % share, d = j * S + rank;
      if (d >= DH) continue;
      double v = 0.0;
      for (int r = 0; r < S; ++r) v += recv[(size_t)(r * QT + i) * share + j];
      *out_at(i, d) = __float2bfloat16_rn(static_cast<float>(v));
    }
  }
  // after the last cluster barrier no CTA touches another's shared memory,
  // so each may leave on its own
}

template <int DH, int QT, bool QUANT>
int launch_bf16(const void* q, const void* k, const void* v, const float* ks,
                const float* vs, const int* bt, const int* ctx, void* out,
                int B, int W, int H, int Hk, int bs, int MB, int kps, int S,
                float scale, double cap, cudaStream_t stream) {
  const size_t smem = bf16_layout(QT, DH, QUANT, S).total;
  auto kern = attend_bf16_kernel<DH, QT, QUANT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (W * (H / Hk) + QT - 1) / QT;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * Hk * tiles * S, 1, 1);
  cfg.blockDim = dim3(BTHREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern,
                         static_cast<const __nv_bfloat16*>(q), k, v, ks, vs,
                         bt, ctx, static_cast<__nv_bfloat16*>(out), W, H, Hk,
                         bs, MB, kps, tiles, scale, cap);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory of one CTA of the bfloat16 kernel: qt query rows (8 or
// 64), head dim dh, an int8 pool when quant != 0, S CTAs a cluster.
extern "C" long long paged_attention_bf16_smem_bytes(int qt, int dh,
                                                     int quant, int S) {
  return static_cast<long long>(bf16_layout(qt, dh, quant != 0, S).total);
}

// q (B, W, H, Dh) bf16; k/v (NB, bs, Hk, Dh) bf16, or int8 with ks/vs
// (NB, bs, Hk, 1) f32 scales when quant != 0; block_table (B, MB) i32;
// ctx_lens (B,) i32; out (B, W, H, Dh) bf16. Dh in {32, 64, 128, 160, 192};
// qt (query rows a tile) 8 or 64; each tile's keys go to the S <= 8 CTAs
// of a cluster, kps keys each (S * kps >= MB * bs); scale is fp32
// Dh^-0.5. Returns the launch's CUDA error.
extern "C" int paged_attention_bf16_launch(
    const void* q, const void* k, const void* v, const float* ks,
    const float* vs, const int* block_table, const int* ctx_lens, void* out,
    int B, int W, int H, int Hk, int Dh, int bs, int MB, int quant, int qt,
    int kps, int S, double scale, double softcap, void* stream) {
  if (S < 1 || S > BCLUSTER || kps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float sc = static_cast<float>(scale);
#define PB_CASE(DH, QT)                                                     \
  if (Dh == DH && qt == QT)                                                 \
    return quant ? launch_bf16<DH, QT, true>(q, k, v, ks, vs, block_table,  \
                                             ctx_lens, out, B, W, H, Hk, bs, \
                                             MB, kps, S, sc, softcap, s)    \
                 : launch_bf16<DH, QT, false>(q, k, v, ks, vs, block_table, \
                                              ctx_lens, out, B, W, H, Hk,   \
                                              bs, MB, kps, S, sc, softcap,  \
                                              s);
  PB_CASE(32, BQT_DECODE) PB_CASE(64, BQT_DECODE)
  PB_CASE(128, BQT_DECODE) PB_CASE(160, BQT_DECODE)
  PB_CASE(192, BQT_DECODE)
  PB_CASE(32, BQT_PREFILL) PB_CASE(64, BQT_PREFILL)
  PB_CASE(128, BQT_PREFILL) PB_CASE(160, BQT_PREFILL)
  PB_CASE(192, BQT_PREFILL)
#undef PB_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
