// Paged attention for Hopper (sm_90a): span queries against one layer's
// blocked KV pool.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py::
// paged_attention (body `_kernel`). Query rows are (span position w, group
// member g) pairs of one kv head, W*G of them per batch row. Row (w, g)
// sits at position ctx + w and sees key slot kpos iff kpos <= ctx + w. The
// kernel walks the row's block table by physical block id, visiting only
// the ceil((ctx + q_len) / bs) valid blocks and never an entry at or past
// that count (the trash-block padding). Scores are (q . k) * Dh^-0.5,
// optionally tanh-softcapped, under an online softmax (running max,
// denominator, numerator). int8 K/V are dequantized as (float)code * scale,
// the reference's order. Idle rows (q_len == 0) and span positions past
// q_len write zeros.
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
// are bound by the K/V bytes and in practice by latency; a 256-row prefill
// tile is bound by the fp32 rate outside the tensor cores. Float64 is this
// kernel's own choice, for parity with the CPU, and runs at about half
// that rate: a cost above the bound, not part of it.
//
// Design: one CTA per (batch row, kv head, tile of 16 query rows) -- the
// query rows of a 256-token prefill chunk spread over 16 CTAs instead of
// waiting in one. 4 warps; each warp owns 4 query rows, each lane Dh/32
// output dims. A CTA stages whole blocks, about 64 keys at a time, in
// shared memory (16-byte loads of fp32 K/V, 4-byte loads of int8 codes,
// dequantized on the way), so a walk over a 512-token context waits on
// device memory 8 times, not 32. Lane j scores key j of a 32-key chunk
// against the warp's query row, warp shuffles give the chunk's max and
// sum, and the probabilities are broadcast lane by lane into the PV
// update. The tile stops at the block that holds its last query position.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int QT = 16, THREADS = 128, WARPS = THREADS / 32,
              RPW = QT / WARPS;
constexpr int KEYS = 64;  // keys staged per step, rounded to whole blocks
constexpr double NEG = -2.3819763e38;  // masked score, as in the reference

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

template <int DPL, bool QUANT>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const float* __restrict__ q, const void* __restrict__ kp,
                       const void* __restrict__ vp,
                       const float* __restrict__ ks,
                       const float* __restrict__ vs,
                       const int* __restrict__ bt, const int* __restrict__ ctxs,
                       const int* __restrict__ qls, float* __restrict__ out,
                       int W, int H, int Hk, int bs, int MB, double scale,
                       double cap) {
  constexpr int DH = 32 * DPL, D4 = DH / 4;
  extern __shared__ float sm[];
  const int bpi = max(1, KEYS / bs);    // blocks staged per step
  float* Qs = sm;                       // QT x DH
  float* Vs = Qs + QT * DH;             // bpi*bs x DH (16-byte aligned)
  float* Ks = Vs + bpi * bs * DH;       // bpi*bs x (DH + 1): padded rows

  const int b = blockIdx.x, hk = blockIdx.y, row0 = blockIdx.z * QT;
  const int G = H / Hk, WG = W * G;
  const int ctx = ctxs[b], ql = qls[b];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int active = min(QT, max(0, ql * G - row0));  // valid rows of tile

  // output index of tile row i: (b, w = (row0+i) / G, head hk*G + g)
  auto out_row = [&](int i) {
    const int r = row0 + i;
    return out + (((size_t)b * W + r / G) * H + hk * G + r % G) * DH;
  };

  // rows past the span or idle: zeros
  for (int idx = threadIdx.x; idx < QT * DH; idx += THREADS) {
    const int i = idx / DH;
    if (i >= active && row0 + i < WG) out_row(i)[idx % DH] = 0.0f;
  }
  if (active == 0) return;

  for (int idx = threadIdx.x; idx < QT * DH; idx += THREADS) {
    const int i = idx / DH, r = row0 + i;
    Qs[idx] = i < active
                  ? q[(((size_t)b * W + r / G) * H + hk * G + r % G) * DH +
                      idx % DH]
                  : 0.0f;
  }

  const int nb = min((ctx + ql + bs - 1) / bs, MB);
  const int last_pos = ctx + (row0 + active - 1) / G;
  const int nblk = min(nb, last_pos / bs + 1);

  double m_i[RPW], l_i[RPW], acc[RPW][DPL];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m_i[r] = NEG;
    l_i[r] = 0.0;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[r][e] = 0.0;
  }

  for (int blk0 = 0; blk0 < nblk; blk0 += bpi) {
    const int nkeys = min(bpi, nblk - blk0) * bs;
    __syncthreads();  // the previous keys are consumed (and Qs is ready)
    for (int idx = threadIdx.x; idx < nkeys * D4; idx += THREADS) {
      const int j = idx / D4, d = (idx % D4) * 4;
      const size_t id = static_cast<size_t>(bt[(size_t)b * MB + blk0 + j / bs]);
      const size_t at = ((id * bs + j % bs) * Hk + hk) * DH + d;
      float4 kv, vv;
      if (QUANT) {
        const size_t tok = at / DH;
        const char4 kc = *reinterpret_cast<const char4*>(
            static_cast<const int8_t*>(kp) + at);
        const char4 vc = *reinterpret_cast<const char4*>(
            static_cast<const int8_t*>(vp) + at);
        const float sk = ks[tok], sv = vs[tok];
        kv = make_float4(static_cast<float>(kc.x) * sk,
                         static_cast<float>(kc.y) * sk,
                         static_cast<float>(kc.z) * sk,
                         static_cast<float>(kc.w) * sk);
        vv = make_float4(static_cast<float>(vc.x) * sv,
                         static_cast<float>(vc.y) * sv,
                         static_cast<float>(vc.z) * sv,
                         static_cast<float>(vc.w) * sv);
      } else {
        kv = *reinterpret_cast<const float4*>(static_cast<const float*>(kp) +
                                              at);
        vv = *reinterpret_cast<const float4*>(static_cast<const float*>(vp) +
                                              at);
      }
      float* kr = Ks + j * (DH + 1) + d;
      kr[0] = kv.x;
      kr[1] = kv.y;
      kr[2] = kv.z;
      kr[3] = kv.w;
      *reinterpret_cast<float4*>(Vs + j * DH + d) = vv;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int i = warp + r * WARPS;
      if (i >= active) continue;  // warp-uniform
      const int qpos = ctx + (row0 + i) / G;
      const float* qi = Qs + i * DH;
      for (int j0 = 0; j0 < nkeys; j0 += 32) {
        const int j = j0 + lane;
        const bool valid = j < nkeys && blk0 * bs + j <= qpos;
        double s = NEG;
        if (valid) {
          const float* kj = Ks + j * (DH + 1);
          double dot = 0.0;
#pragma unroll 16
          for (int d = 0; d < DH; ++d)
            dot += static_cast<double>(qi[d]) * static_cast<double>(kj[d]);
          s = dot * scale;
          if (cap > 0.0) s = cap * tanh(s / cap);
        }
        const double m_new = fmax(m_i[r], warp_max(s));
        const double p = valid ? exp(s - m_new) : 0.0;
        const double alpha = exp(m_i[r] - m_new);
        l_i[r] = l_i[r] * alpha + warp_sum(p);
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[r][e] *= alpha;
        const int nj = min(32, nkeys - j0);
        for (int jj = 0; jj < nj; ++jj) {
          const double pj = __shfl_sync(0xffffffffu, p, jj);
          const float* vj = Vs + (j0 + jj) * DH + lane * DPL;
#pragma unroll
          for (int e = 0; e < DPL; ++e) acc[r][e] += pj * vj[e];
        }
        m_i[r] = m_new;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int i = warp + r * WARPS;
    if (i >= active) continue;
    const double l = l_i[r] > 0.0 ? l_i[r] : 1.0;
    float* o = out_row(i) + lane * DPL;
#pragma unroll
    for (int e = 0; e < DPL; ++e) o[e] = static_cast<float>(acc[r][e] / l);
  }
}

template <int DPL, bool QUANT>
int launch(const float* q, const void* k, const void* v, const float* ks,
           const float* vs, const int* bt, const int* ctx, const int* ql,
           float* out, int B, int W, int H, int Hk, int bs, int MB,
           double scale, double cap, cudaStream_t stream) {
  constexpr int DH = 32 * DPL;
  const int keys = (KEYS / bs > 1 ? KEYS / bs : 1) * bs;
  const size_t smem = (size_t)(QT * DH + keys * (DH + 1) + keys * DH) * 4;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<DPL, QUANT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int G = H / Hk;
  dim3 grid(B, Hk, (W * G + QT - 1) / QT);
  paged_attention_kernel<DPL, QUANT><<<grid, THREADS, smem, stream>>>(
      q, k, v, ks, vs, bt, ctx, ql, out, W, H, Hk, bs, MB, scale, cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, W, H, Dh) f32; k/v (NB, bs, Hk, Dh) f32, or int8 with ks/vs
// (NB, bs, Hk, 1) f32 scales when quant != 0; block_table (B, MB) i32;
// ctx_lens, q_lens (B,) i32; out (B, W, H, Dh) f32. Dh in {32, 64, 128}.
// Returns the launch's CUDA error.
extern "C" int paged_attention_launch(const float* q, const void* k,
                                      const void* v, const float* ks,
                                      const float* vs, const int* block_table,
                                      const int* ctx_lens, const int* q_lens,
                                      float* out, int B, int W, int H, int Hk,
                                      int Dh, int bs, int MB, int quant,
                                      double scale, double softcap,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PA_CASE(DPL)                                                        \
  if (Dh == 32 * DPL)                                                       \
    return quant ? launch<DPL, true>(q, k, v, ks, vs, block_table, ctx_lens, \
                                     q_lens, out, B, W, H, Hk, bs, MB, scale, \
                                     softcap, s)                              \
                 : launch<DPL, false>(q, k, v, ks, vs, block_table, ctx_lens, \
                                      q_lens, out, B, W, H, Hk, bs, MB,       \
                                      scale, softcap, s);
  PA_CASE(1)
  PA_CASE(2)
  PA_CASE(4)
#undef PA_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
