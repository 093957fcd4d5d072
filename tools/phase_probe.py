#!/usr/bin/env python3
"""Phase breakdown of the CUDA kernels `quant_matmul`, `lowrank_qmm` and
`paged_attention` on one NVIDIA GPU.

    python3 tools/phase_probe.py [--src <root of a checkout>]
                                 [--kernels quant_matmul,lowrank_qmm,...]

It copies the kernels' sources from the checkout (default: this one)
into `build/phase_probe/`, adds `%globaltimer` stamps taken by thread 0
of every CTA, builds them with nvcc, launches each at the serving path's
shapes (the L2 cache flushed first), and prints each phase's mean and
slowest CTA in microseconds beside the launch's CUDA-event time, plus
ptxas's register and spill lines. The bfloat16 attention kernel
(`paged_attention_bf16`) is probed at chip_smoke.py's bf16 shapes, and
timed there beside copies of itself with one cost taken out (the
float64 exp, the DMMAs, the conversions to float64). It knows two
versions of each of the other kernels:
the first (one CTA per 64 x 128 output tile, single-buffered; one CTA
per row block and N tile; one CTA per attention tile) and the second
(split-K thread-block clusters and a cp.async ring; thread-block
clusters; split-KV with tensor-core prefill tiles). The kernels of the
main path carry no timing code: the stamps exist only in these copies.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "phase_probe"

STAMP = '''__device__ unsigned long long g_st[8192 * 8];
__device__ __forceinline__ unsigned long long gt() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
namespace {
'''

LRMM_PATCHES = [
    ("namespace {\n", STAMP),
    ("  // ---- phase 1: T = Xq @ W1q, RT columns of R at a time ----------------\n",
     "  unsigned long long tl = 0, tm = 0, tb = 0, a0, a1, a2;\n"
     "  // ---- phase 1: T = Xq @ W1q, RT columns of R at a time ----------------\n"),
    ("      rt::load_rows<THREADS, BMT, BK>(As, LDS, xq, K, m0, M, k0, K);\n",
     "      a0 = gt();\n"
     "      rt::load_rows<THREADS, BMT, BK>(As, LDS, xq, K, m0, M, k0, K);\n"),
    ("                                         k0, r0);\n      __syncthreads();\n",
     "                                         k0, r0);\n      __syncthreads();\n"
     "      a1 = gt();\n"),
    ("                        Bs + wn * (RT / WN) * LDS, LDS, BK);\n      __syncthreads();\n",
     "                        Bs + wn * (RT / WN) * LDS, LDS, BK);\n      __syncthreads();\n"
     "      a2 = gt(); tl += a1 - a0; tm += a2 - a1;\n"),
    ("  // ---- boundary: fold", "  a0 = gt();\n  // ---- boundary: fold"),
    ("  // ---- phase 2: Y", "  a1 = gt(); tb = a1 - a0;\n  // ---- phase 2: Y"),
    ("        *reinterpret_cast<float2*>(y + (size_t)(m + 8) * N + n) = o;\n"
     "      }\n    }\n  }\n}\n",
     "        *reinterpret_cast<float2*>(y + (size_t)(m + 8) * N + n) = o;\n"
     "      }\n    }\n  }\n  __syncthreads();\n"
     "  if (threadIdx.x == 0) {\n"
     "    const int c = blockIdx.x * gridDim.y + blockIdx.y;\n"
     "    if (c < 8192) { g_st[8 * c] = tl; g_st[8 * c + 1] = tm;\n"
     "      g_st[8 * c + 2] = tb; g_st[8 * c + 3] = gt() - a1; }\n  }\n}\n"),
]

PA_PATCHES = [
    ("namespace {\n", STAMP),
    ("  for (int blk0 = 0; blk0 < nblk; blk0 += bpi) {\n"
     "    const int nkeys = min(bpi, nblk - blk0) * bs;\n    __syncthreads();",
     "  unsigned long long tl = 0, ts = 0, tp = 0, a0, a1;\n"
     "  const unsigned long long tstart = gt();\n"
     "  for (int blk0 = 0; blk0 < nblk; blk0 += bpi) {\n"
     "    const int nkeys = min(bpi, nblk - blk0) * bs;\n    __syncthreads();\n"
     "    a0 = gt();"),
    ("      *reinterpret_cast<float4*>(Vs + j * DH + d) = vv;\n    }\n"
     "    __syncthreads();\n",
     "      *reinterpret_cast<float4*>(Vs + j * DH + d) = vv;\n    }\n"
     "    __syncthreads();\n    a1 = gt(); tl += a1 - a0;\n"),
    ("      for (int j0 = 0; j0 < nkeys; j0 += 32) {\n        const int j = j0 + lane;",
     "      for (int j0 = 0; j0 < nkeys; j0 += 32) {\n        a0 = gt();\n"
     "        const int j = j0 + lane;"),
    ("        const int nj = min(32, nkeys - j0);",
     "        a1 = gt(); ts += a1 - a0;\n        const int nj = min(32, nkeys - j0);"),
    ("        m_i[r] = m_new;\n      }", "        m_i[r] = m_new;\n        tp += gt() - a1;\n      }"),
    ("    for (int e = 0; e < DPL; ++e) o[e] = static_cast<float>(acc[r][e] / l);\n  }\n}\n",
     "    for (int e = 0; e < DPL; ++e) o[e] = static_cast<float>(acc[r][e] / l);\n  }\n"
     "  if (threadIdx.x == 0) {\n"
     "    const int c = (blockIdx.x * gridDim.y + blockIdx.y) * gridDim.z + blockIdx.z;\n"
     "    if (c < 8192) { g_st[8 * c] = tl; g_st[8 * c + 1] = ts;\n"
     "      g_st[8 * c + 2] = tp; g_st[8 * c + 3] = gt() - tstart; }\n  }\n}\n"),
]

# clusters of 8 that can be resident at once, for the decode tile
CLUSTERS = '''extern "C" int probe_max_clusters() {
  const int smem = static_cast<int>(layout(16, 32, 8, 1, 32).total);
  auto kern = lrmm_kernel<16, 32>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(128, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute a[1];
  a[0].id = cudaLaunchAttributeClusterDimension;
  a[0].val.clusterDim.x = 8;
  a[0].val.clusterDim.y = 1;
  a[0].val.clusterDim.z = 1;
  cfg.attrs = a;
  cfg.numAttrs = 1;
  int n = -1;
  cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
  return n;
}
'''

# The second (cluster / split-KV) version: per CTA, the time waiting on
# the copy ring and barriers, and each phase's own work.
LRMM2_PATCHES = [
    ("namespace {\n", STAMP),
    ("  cg::cluster_group cluster = cg::this_cluster();\n",
     "  const unsigned long long t_in = gt();\n"
     "  cg::cluster_group cluster = cg::this_cluster();\n"),
    ("  for (int s = 0; s < n_steps; ++s) {\n",
     "  unsigned long long pw = 0, p1 = 0, pb = 0, p2 = 0, a0, a1;\n"
     "  const unsigned long long t0 = gt();\n"
     "  for (int s = 0; s < n_steps; ++s) {\n    a0 = gt();\n"),
    ("    issue(s + STAGES - 1);\n",
     "    issue(s + STAGES - 1);\n    a1 = gt(); pw += a1 - a0; a0 = a1;\n"),
    ("      if (s != n1 - 1) continue;\n",
     "      a1 = gt(); p1 += a1 - a0; a0 = a1;\n"
     "      if (s != n1 - 1) continue;\n"),
    ("      // the first phase-2 step's barrier publishes tq_grp\n",
     "      pb += gt() - a0;\n"),
    ("    if (ks != n2k - 1) continue;\n",
     "    a1 = gt(); p2 += a1 - a0; a0 = a1;\n    if (ks != n2k - 1) continue;\n"),
    ("  // so each may leave on its own\n}\n",
     "  // so each may leave on its own\n"
     "  if (threadIdx.x == 0) {\n"
     "    const int c = blockIdx.y * gridDim.x + blockIdx.x;\n"
     "    if (c < 8192) { g_st[8 * c] = pw; g_st[8 * c + 1] = p1;\n"
     "      g_st[8 * c + 2] = pb; g_st[8 * c + 3] = p2;\n"
     "      g_st[8 * c + 4] = t_in; g_st[8 * c + 5] = gt(); }\n  }\n}\n"),
    ("extern \"C\" long long lrmm_smem_bytes", CLUSTERS
     + "extern \"C\" long long lrmm_smem_bytes"),
]

PA2_PATCHES = [
    ("namespace {\n", STAMP),
    ("  const int S = gridDim.y, split = blockIdx.y;\n",
     "  const unsigned long long t_in = gt();\n"
     "  const int S = gridDim.y, split = blockIdx.y;\n"),
    ("  for (int st = 0; st < n_stages; ++st) {\n",
     "  unsigned long long pw = 0, ps = 0, pm = 0, pv = 0, a0, a1;\n"
     "  for (int st = 0; st < n_stages; ++st) {\n    a0 = gt();\n"),
    ("    __syncthreads();        // ... and everyone's\n",
     "    __syncthreads();        // ... and everyone's\n    pw += gt() - a0;\n"),
    ("        for (int kc = 0; kc < kpw; kc += 16) {\n",
     "        for (int kc = 0; kc < kpw; kc += 16) {\n          a0 = gt();\n"),
    ("          for (int jj = 0; jj < 16; ++jj) {\n",
     "          a1 = gt(); ps += a1 - a0;\n"
     "          for (int jj = 0; jj < 16; ++jj) {\n"),
    ("          m = m_new;\n", "          m = m_new;\n          pv += gt() - a1;\n"),
    ("      for (int sc = 0; sc < rows; sc += 32) {\n",
     "      for (int sc = 0; sc < rows; sc += 32) {\n        a0 = gt();\n"),
    ("#pragma unroll\n        for (int mt = 0; mt < 2; ++mt) {\n          double mx = NEG;",
     "        a1 = gt(); ps += a1 - a0; a0 = a1;\n"
     "#pragma unroll\n        for (int mt = 0; mt < 2; ++mt) {\n          double mx = NEG;"),
    ("        // O += P.V", "        a1 = gt(); pm += a1 - a0; a0 = a1;\n        // O += P.V"),
    ("            for (int mt = 0; mt < 2; ++mt) dmma(o[mt][dn], a[mt], b);\n"
     "          }\n        }\n",
     "            for (int mt = 0; mt < 2; ++mt) dmma(o[mt][dn], a[mt], b);\n"
     "          }\n        }\n        pv += gt() - a0;\n"),
    ("  // ---- this split's result: the output, or a partial for the combine --\n",
     "  if (threadIdx.x == 0) {\n"
     "    const int c = blockIdx.x * gridDim.y + blockIdx.y;\n"
     "    if (c < 8192) { g_st[8 * c] = pw; g_st[8 * c + 1] = ps;\n"
     "      g_st[8 * c + 2] = pm; g_st[8 * c + 3] = pv;\n"
     "      g_st[8 * c + 4] = t_in; g_st[8 * c + 5] = gt(); }\n  }\n"
     "  // ---- this split's result: the output, or a partial for the combine --\n"),
]

# The bfloat16 kernel (clusters of key splits, FP64 tensor cores, a
# cp.async ring): per CTA, the staging (ring waits and barriers at the head
# of each step, both passes, and an int8 stage's widening to bf16), pass
# 1's products and online softmax, the exchange
# of (m, l) (the warps' and, with S > 1, the cluster's through DSMEM and
# its barrier), pass 2's products, and the output (the warps' partials,
# the DSMEM pushes, the cluster barriers, the owners' sums and stores).
PAB_PATCHES = [
    ("namespace {\n", STAMP),
    ("  // peers write into this CTA's shared memory only once all have "
     "started\n  if (S > 1) cluster_arrive();\n",
     "  const unsigned long long t_in = gt();\n"
     "  unsigned long long pw = 0, p1 = 0, px = 0, p2 = 0, po = 0, a0, a1;\n"
     "  if (S > 1) cluster_arrive();\n"),
    ("  for (int step = 0; step < n_ch; ++step) {\n    __syncthreads();",
     "  for (int step = 0; step < n_ch; ++step) {\n    a0 = gt();\n"
     "    __syncthreads();"),
    ("    if constexpr (QUANT) widen(Kb, resident);\n",
     "    if constexpr (QUANT) widen(Kb, resident);\n"
     "    a1 = gt(); pw += a1 - a0; a0 = a1;\n"),
    ("      m = mn;\n    }\n  }\n",
     "      m = mn;\n    }\n    p1 += gt() - a0;\n  }\n  a0 = gt();\n"),
    ("  __syncthreads();\n  const double M_row",
     "  __syncthreads();\n  px = gt() - a0;\n  const double M_row"),
    ("  for (int c = 0; c < n_ch; ++c) {\n    int slot = c;\n",
     "  for (int c = 0; c < n_ch; ++c) {\n    a0 = gt();\n    int slot = c;\n"),
    ("      if constexpr (QUANT) widen(ring + slot * L.stage, true);\n    }\n",
     "      if constexpr (QUANT) widen(ring + slot * L.stage, true);\n    }\n"
     "    a1 = gt(); pw += a1 - a0; a0 = a1;\n"),
    ("(vrow[dn * 8 + g])));\n        }\n      }\n    }\n  }\n",
     "(vrow[dn * 8 + g])));\n        }\n      }\n    }\n"
     "    p2 += gt() - a0;\n  }\n"),
    ("  rt::cp_async_wait<0>();\n  __syncthreads();  // no warp reads the "
     "ring any more\n",
     "  a0 = gt();\n  rt::cp_async_wait<0>();\n"
     "  __syncthreads();  // no warp reads the ring any more\n"),
    ("  // so each may leave on its own\n}\n\ntemplate <int DH, int QT, "
     "bool QUANT>\n",
     "  // so each may leave on its own\n"
     "  po = gt() - a0;\n"
     "  if (threadIdx.x == 0 && blockIdx.x < 8192) {\n"
     "    const int c = blockIdx.x;\n"
     "    g_st[8 * c] = pw; g_st[8 * c + 1] = p1; g_st[8 * c + 2] = px;\n"
     "    g_st[8 * c + 3] = p2; g_st[8 * c + 4] = po;\n"
     "    g_st[8 * c + 5] = t_in; g_st[8 * c + 6] = gt();\n  }\n"
     "}\n\ntemplate <int DH, int QT, bool QUANT>\n"),
]

# Copies of the bfloat16 kernel with one cost taken out, timed beside it
# (their outputs are wrong): the float64 exp, the DMMAs (each replaced by
# two DADDs), and the bf16 -> float64 conversions of the fragments and the
# int8 pool's widening.
BF16_MARK = "// ------------------------------------------------------------ bfloat16 --"
BF16_COSTS = {
    "exp": [("exp(", "(")],
    "dmma": [("dmma(s[j], a[e], b[e])", "dadd2(s[j], a[e], b[e])"),
             ("            dmma(o[dn], a,\n", "            dadd2(o[dn], a,\n"),
             ("__device__ __forceinline__ float bf16_round(",
              "__device__ __forceinline__ void dadd2(double (&d)[2], double a, "
              "double b) {\n  d[0] += a;\n  d[1] += b;\n}\n\n"
              "__device__ __forceinline__ float bf16_round(")],
    "conversions": [
        ("static_cast<double>(__uint_as_float(w.x << 16))",
         "__hiloint2double(w.x << 13, 0)"),
        ("static_cast<double>(__uint_as_float(w.x & 0xffff0000u))",
         "__hiloint2double(w.x & 0xffff0000u, 0)"),
        ("static_cast<double>(__uint_as_float(w.y << 16))",
         "__hiloint2double(w.y << 13, 0)"),
        ("static_cast<double>(__uint_as_float(w.y & 0xffff0000u))",
         "__hiloint2double(w.y & 0xffff0000u, 0)"),
        ("static_cast<double>(__bfloat162float(vrow[dn * 8 + g]))",
         "__hiloint2double(reinterpret_cast<const unsigned short*>(vrow)"
         "[dn * 8 + g] << 13, 0)"),
        ("if constexpr (QUANT) widen(", "if constexpr (false) widen(")],
}


def bf16_variants(csrc: pathlib.Path) -> list[str]:
    """Write the cost variants of the bfloat16 kernel (and an untouched
    copy, "pab_as_is") next to the stamped one; their library names."""
    text = (csrc / "paged_attention.cu").read_text()
    cut = text.index(BF16_MARK)
    names = ["pab_as_is"]
    (OUT / "pab_as_is.cu").write_text(text)
    for name, patches in BF16_COSTS.items():
        body = text[cut:]
        for old, new in patches:
            if old not in body:
                raise SystemExit(f"phase_probe: no '{old}' in the bf16 kernel")
            body = body.replace(old, new)
        (OUT / f"pab_no_{name}.cu").write_text(text[:cut] + body)
        names.append(f"pab_no_{name}")
    return names


# quant_matmul, first version (one CTA per 64 x 128 tile, single-buffered
# K loop): per CTA, the loads (A and W, waited for), the transposed stores
# of W (and the barrier), the products and the epilogue. The weight loads
# are forced to land before the stamp by using their registers in an
# empty asm statement, in a copy of common.cuh that only this kernel
# includes.
QMM1_COMMON_PATCHES = [
    ("int n0) {\n  constexpr int NG = NT / 4",
     "int n0, unsigned long long& tmid) {\n  constexpr int NG = NT / 4"),
    ("#pragma unroll\n  for (int it = 0; it < ITEMS; ++it) {\n"
     "    const int i = threadIdx.x + it * THREADS;\n    if (i >= N) continue;",
     "#pragma unroll\n  for (int it = 0; it < ITEMS; ++it)\n"
     "    asm volatile(\"\" ::\"r\"(r[it][0]), \"r\"(r[it][1]), \"r\"(r[it][2]),\n"
     "                 \"r\"(r[it][3]));\n"
     "  asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(tmid));\n"
     "#pragma unroll\n  for (int it = 0; it < ITEMS; ++it) {\n"
     "    const int i = threadIdx.x + it * THREADS;\n    if (i >= N) continue;"),
]

QMM1_PATCHES = [
    ('#include "common.cuh"\n', '#include "qmm_common.cuh"\n'),
    ("namespace {\n", STAMP),
    ("  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;\n",
     "  const unsigned long long t_in = gt();\n"
     "  unsigned long long pl = 0, pt = 0, pm = 0, a0, a1, tm = 0;\n"
     "  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;\n"),
    ("    rt::load_rows<THREADS, BM, BK>(As, LDS, xq, K, m0, M, k0, K);\n",
     "    a0 = gt();\n"
     "    rt::load_rows<THREADS, BM, BK>(As, LDS, xq, K, m0, M, k0, K);\n"),
    ("                                       n0);\n    __syncthreads();\n",
     "                                       n0, tm);\n    __syncthreads();\n"
     "    a1 = gt(); pl += tm - a0; pt += a1 - tm;\n"),
    ("                     BK);\n    __syncthreads();\n  }\n",
     "                     BK);\n    __syncthreads();\n    pm += gt() - a1;\n  }\n"
     "  const unsigned long long te = gt();\n"),
    ("      *reinterpret_cast<float2*>(y + (size_t)(m + 8) * N + n) = o;\n"
     "    }\n  }\n}\n",
     "      *reinterpret_cast<float2*>(y + (size_t)(m + 8) * N + n) = o;\n"
     "    }\n  }\n"
     "  if (threadIdx.x == 0) {\n"
     "    const int c = blockIdx.y * gridDim.x + blockIdx.x;\n"
     "    if (c < 8192) { g_st[8 * c] = pl; g_st[8 * c + 1] = pt;\n"
     "      g_st[8 * c + 2] = pm; g_st[8 * c + 3] = gt() - te;\n"
     "      g_st[8 * c + 4] = t_in; g_st[8 * c + 5] = gt(); }\n  }\n}\n"),
]

# quant_matmul, second version (split-K clusters, cp.async ring): per
# CTA, the waits (ring and barrier at the head of each step), the
# transpose/unpack into the mma layout and its barrier (wider tiles; a
# strip builds its fragments in registers, inside the products), the
# products, the reductions (the warps' sums through shared memory, the DSMEM
# pushes and the cluster barrier; 0 where a CTA writes its own sums) and
# the epilogue.
QMM2_END = ("  if (threadIdx.x == 0) {\n"
            "    const int c = blockIdx.y * gridDim.x + blockIdx.x;\n"
            "    if (c < 8192) { g_st[8 * c] = pw; g_st[8 * c + 1] = pt;\n"
            "      g_st[8 * c + 2] = pm; g_st[8 * c + 3] = pr;\n"
            "      g_st[8 * c + 4] = gt() - a0; g_st[8 * c + 5] = t_in;\n"
            "      g_st[8 * c + 6] = gt(); }\n  }\n")

QMM2_PATCHES = [
    ("namespace {\n", STAMP),
    ("  using W = Warps<BM, BN>;\n  cg::cluster_group",
     "  using W = Warps<BM, BN>;\n"
     "  const unsigned long long t_in = gt();\n"
     "  unsigned long long pw = 0, pt = 0, pm = 0, pr = 0, a0, a1;\n"
     "  cg::cluster_group"),
    ("  for (int s = 0; s < n_steps; ++s) {\n",
     "  for (int s = 0; s < n_steps; ++s) {\n    a0 = gt();\n"),
    ("    issue(s + STAGES - 1);\n",
     "    issue(s + STAGES - 1);\n    a1 = gt(); pw += a1 - a0; a0 = a1;\n"),
    ("packed != 0, BK, BN);\n      __syncthreads();\n",
     "packed != 0, BK, BN);\n      __syncthreads();\n"
     "      a1 = gt(); pt += a1 - a0; a0 = a1;\n"),
    ("wn * W::NT * 8, kd);\n    }\n  }\n",
     "wn * W::NT * 8, kd);\n    }\n    pm += gt() - a0;\n  }\n"
     "  a0 = gt();\n"),
    ("    return;\n  }\n\n  // ---- reductions",
     QMM2_END + "    return;\n  }\n\n  // ---- reductions"),
    ("  if (C == 1) {\n    for (int i = tid; i < rows * BN;",
     "  a1 = gt(); pr = a1 - a0; a0 = a1;\n"
     "  if (C == 1) {\n    for (int i = tid; i < rows * BN;"),
    ("    return;\n  }\n  const int share",
     QMM2_END + "    return;\n  }\n  const int share"),
    ("  cluster.sync();  // every partial of this CTA's columns has arrived\n",
     "  cluster.sync();  // every partial of this CTA's columns has arrived\n"
     "  a1 = gt(); pr += a1 - a0; a0 = a1;\n"),
    ("  // so each may leave on its own\n}\n",
     "  // so each may leave on its own\n" + QMM2_END + "}\n"),
]

READ = '''
extern "C" int probe_read(unsigned long long* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, g_st, sizeof(unsigned long long) * 8 * n);
}
extern "C" int probe_clear() {
  void* p = nullptr;
  cudaGetSymbolAddress(&p, g_st);
  return (int)cudaMemset(p, 0, sizeof(unsigned long long) * 8 * 8192);
}
'''


def instrument(src: pathlib.Path, patches, dst: pathlib.Path,
               tail: str = READ) -> bool:
    """Write `src` with the stamps of `patches` (and `tail`) to `dst`;
    False when a patch finds no place in it (another version)."""
    text = src.read_text()
    for old, new in patches:
        if old not in text:
            return False
        text = text.replace(old, new, 1)
    dst.write_text(text + tail)
    return True


def build_probes(csrc: pathlib.Path, build, names) -> None:
    nvcc = build._nvcc()
    procs = [(n, subprocess.Popen(
        [nvcc, *build.NVCC_FLAGS, "-I", str(csrc), "-o", str(OUT / f"{n}.so"),
         str(OUT / f"{n}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)) for n in names]
    for n, p in procs:
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed for {n}:\n{log}")
        if n.startswith("pab_"):        # the bf16 kernel's cost variants
            continue
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {n}: {line.strip()}")


def stamps(lib, ctas: int, torch, nph: int = 4):
    """The (CTA, 8) stamps of CTAs that wrote any: `nph` phase sums in
    microseconds, then (where the version takes them) entry and exit
    times in nanoseconds."""
    buf = (ctypes.c_ulonglong * (8 * ctas))()
    if lib.probe_read(ctypes.addressof(buf), ctas):
        raise RuntimeError("reading the stamps failed")
    a = torch.tensor(list(buf), dtype=torch.float64).reshape(ctas, 8)
    a = a[a[:, :nph].sum(1) > 0]
    a[:, :nph] /= 1e3
    return a


def report(res, key, a, ctas, us, nph: int = 4):
    """Phase means [slowest CTA]; with entry/exit stamps, the span from
    the first CTA's entry to the last one's exit and the spread of the
    entries (CTAs that waited for a free SM)."""
    span = spread = None
    if a[:, nph].min() > 0:
        t0 = a[:, nph].min()
        span = float(a[:, nph + 1].max() - t0) / 1e3
        spread = float(a[:, nph].max() - t0) / 1e3
    print(f"  {key}: " + " ".join(
        f"{a[:, i].mean():.2f} [{a[:, i].max():.2f}]" for i in range(nph))
        + f" | {len(a)} of {ctas} CTAs, {us:.1f} us"
        + ("" if span is None else
           f"; CTAs span {span:.1f} us, entries spread {spread:.1f} us"))
    res[key] = dict(us=us, ctas=ctas, live=len(a), span_us=span,
                    entry_spread_us=spread, mean=a[:, :nph].mean(0).tolist(),
                    max=a[:, :nph].max(0).values.tolist())


def stamped_lib(name: str, so: str, mod):
    """The stamped library `so` put in place of kernel `name`'s built one,
    so that the wrapper `mod` launches it."""
    from repro_torch.kernels import build

    lib = ctypes.CDLL(str(OUT / f"{so}.so"))
    for fn, (ret, args) in mod._SIGNATURES.items():
        getattr(lib, fn).restype = ret
        getattr(lib, fn).argtypes = list(args)
    lib.probe_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    build._LIBS[name] = lib
    return lib


# quant_matmul at the serving shapes: the quant-only plan's packed W4
# linears at decode, the W8 lm head, and a prefill step's mlp/up
QMM_SHAPES = ((8, 512, 512, True), (8, 512, 2048, True), (8, 2048, 512, True),
              (8, 512, 32000, False), (2048, 512, 2048, True))


def probe_qmm(torch, timer, res, version, nph, ctas_of, phases) -> None:
    """quant_matmul through its wrapper, with the stamped library."""
    from repro_torch.core.quant import pack_int4
    from repro_torch.kernels import quant_matmul as qm

    lib = stamped_lib("quant_matmul", "qmm", qm)
    print(f"quant_matmul ({version} version), us per CTA, mean [slowest]: "
          + ", ".join(phases))
    g = torch.Generator(device="cuda").manual_seed(1)
    for m, k, n, packed in QMM_SHAPES:
        qmx = 7 if packed else 127
        xq = torch.randint(-127, 128, (m, k), generator=g, device="cuda",
                           dtype=torch.int8)
        sx = torch.rand((m, 1), generator=g, device="cuda") + 0.01
        w = torch.randint(-qmx, qmx + 1, (k, n), generator=g, device="cuda",
                          dtype=torch.int8)
        wq = pack_int4(w) if packed else w
        sw = torch.rand((1, n), generator=g, device="cuda") * 0.01

        def call():
            return qm.quant_matmul(xq, sx, wq, sw, w_packed=packed)

        us = timer(call) * 1e3
        lib.probe_clear()
        timer.flush.zero_()
        call()
        torch.cuda.synchronize()
        ctas = ctas_of(qm, m, k, n, packed)
        report(res, f"quant_matmul M{m} K{k} N{n} {'W4' if packed else 'W8'}",
               stamps(lib, ctas, torch, nph), ctas, us, nph)


def _qmm1_ctas(qm, m, k, n, packed):
    return -(-n // 128) * -(-m // 64)


def _qmm2_ctas(qm, m, k, n, packed):
    from repro_torch.kernels import build

    tl = qm.choose_tiles(m, k, n, packed, 132,
                         build._LIBS["quant_matmul"].qmm_smem_bytes)
    return tl.ctas(m, n)


QMM_VERSIONS = (
    ("first", QMM1_PATCHES, QMM1_COMMON_PATCHES, 4, _qmm1_ctas,
     ("loads (waited)", "W transposed stores and barrier", "products",
      "epilogue")),
    ("second", QMM2_PATCHES, None, 5, _qmm2_ctas,
     ("waits (ring, barriers)", "transpose/unpack and barrier",
      "products", "reductions", "epilogue")),
)


LRMM_SHAPES = ((8, 512, 256, 512), (8, 512, 256, 2048), (8, 2048, 256, 512),
               (2048, 512, 256, 2048))


def lrmm_inputs(torch, g, m, k, r, n):
    from repro_torch.core.quant import pack_int4
    from repro_torch.kernels.ops import quantize_acts

    xq, sx = quantize_acts(torch.randn((m, k), generator=g, device="cuda"),
                           127)
    w1 = pack_int4(torch.randint(-7, 8, (k, r), generator=g, device="cuda",
                                 dtype=torch.int8))
    w2 = pack_int4(torch.randint(-7, 8, (r, n), generator=g, device="cuda",
                                 dtype=torch.int8))
    s1 = torch.rand((1, r), generator=g, device="cuda") * 0.1
    s2 = torch.rand((r, 1), generator=g, device="cuda") * 0.1
    return xq, sx, w1, s1, w2, s2


def probe_first(torch, cs, timer, res) -> None:
    """The first version's kernels, launched through their C entry points."""
    from repro_torch.kernels import lowrank_qmm as lrm

    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    L = ctypes.CDLL(str(OUT / "lrmm.so"))
    L.lrmm_launch.restype = I
    L.lrmm_launch.argtypes = [P] * 7 + [I] * 9 + [P]
    L.lrmm_smem_bytes.restype = ctypes.c_longlong
    L.lrmm_smem_bytes.argtypes = [I, I]
    L.probe_read.argtypes = [P, I]
    A = ctypes.CDLL(str(OUT / "pa.so"))
    A.paged_attention_launch.restype = I
    A.paged_attention_launch.argtypes = [P] * 9 + [I] * 8 + [D, D, P]
    A.probe_read.argtypes = [P, I]
    stream = torch.cuda.current_stream().cuda_stream

    print("lowrank_qmm, us per CTA, mean [slowest]: phase-1 load, phase-1 "
          "mma, boundary, phase 2")
    g = torch.Generator(device="cuda").manual_seed(2)
    for m, k, r, n in LRMM_SHAPES:
        xq, sx, w1, s1, w2, s2 = lrmm_inputs(torch, g, m, k, r, n)
        y = torch.empty((m, n), device="cuda")
        bm, split = lrm.choose_tiles(m, r, n, 132, L.lrmm_smem_bytes)

        def launch():
            err = L.lrmm_launch(xq.data_ptr(), sx.data_ptr(), w1.data_ptr(),
                                s1.data_ptr(), w2.data_ptr(), s2.data_ptr(),
                                y.data_ptr(), m, k, r, n, 1, 1, 127, bm,
                                split, stream)
            if err:
                raise RuntimeError(f"launch failed: {err}")

        us = timer(launch) * 1e3
        L.probe_clear()
        timer.flush.zero_()
        launch()
        torch.cuda.synchronize()
        ctas = -(-m // bm) * split
        report(res, f"lowrank_qmm M{m} K{k} N{n}", stamps(L, ctas, torch),
               ctas, us)

    print("paged_attention, us per CTA, mean [slowest]: loads, scores, PV, "
          "total")
    g = torch.Generator(device="cuda").manual_seed(3)
    for kv_bits in (16, 8):
        for w in (1, 256):
            q, pool, table, ctx_t, ql_t, _, _ = cs._span_batch(torch, g, w,
                                                               kv_bits)
            b, _, h, dh = q.shape
            _, bs, hk, _ = pool["k"].shape
            quant = kv_bits == 8
            out = torch.empty_like(q)

            def launch():
                err = A.paged_attention_launch(
                    q.data_ptr(), pool["k"].data_ptr(), pool["v"].data_ptr(),
                    pool["ks"].data_ptr() if quant else None,
                    pool["vs"].data_ptr() if quant else None,
                    table.data_ptr(), ctx_t.data_ptr(), ql_t.data_ptr(),
                    out.data_ptr(), b, w, h, hk, dh, bs, table.shape[1],
                    int(quant), dh ** -0.5, 0.0, stream)
                if err:
                    raise RuntimeError(f"launch failed: {err}")

            us = timer(launch) * 1e3
            A.probe_clear()
            timer.flush.zero_()
            launch()
            torch.cuda.synchronize()
            ctas = b * hk * -(-w * (h // hk) // 16)
            report(res, f"paged_attention W{w} kv{kv_bits}",
                   stamps(A, ctas, torch), ctas, us)


def probe_second(torch, cs, timer, res) -> None:
    """The cluster / split-KV kernels, launched through the wrappers with
    the stamped libraries in place of the built ones."""
    from repro_torch.kernels import lowrank_qmm as lrm
    from repro_torch.kernels import paged_attention as pa

    libs = {"lowrank_qmm": stamped_lib("lowrank_qmm", "lrmm", lrm),
            "paged_attention": stamped_lib("paged_attention", "pa", pa)}

    print(f"lowrank_qmm: {libs['lowrank_qmm'].probe_max_clusters()} clusters "
          "of 8 decode CTAs fit on the card at once")
    print("lowrank_qmm, us per CTA, mean [slowest]: waits (ring, barriers), "
          "phase 1, boundary (with cluster syncs), phase 2 products")
    g = torch.Generator(device="cuda").manual_seed(2)
    for m, k, r, n in LRMM_SHAPES:
        args = lrmm_inputs(torch, g, m, k, r, n)
        kw = dict(w1_packed=True, w2_packed=True)
        us = timer(lambda: lrm.lowrank_qmm(*args, **kw)) * 1e3
        libs["lowrank_qmm"].probe_clear()
        timer.flush.zero_()
        lrm.lowrank_qmm(*args, **kw)
        torch.cuda.synchronize()
        ctas = lrm.choose_tiles(m, r, n, 132, libs["lowrank_qmm"]
                                .lrmm_smem_bytes).ctas(m, n)
        report(res, f"lowrank_qmm M{m} K{k} N{n}",
               stamps(libs["lowrank_qmm"], ctas, torch), ctas, us)

    print("paged_attention, us per CTA with keys, mean [slowest]: waits "
          "(ring, barriers), scores (decode: with softmax), softmax, PV")
    g = torch.Generator(device="cuda").manual_seed(3)
    for kv_bits in (16, 8):
        for w in (1, 256):
            q, pool, table, ctx_t, _, _, _ = cs._span_batch(torch, g, w,
                                                            kv_bits)
            b, _, h, _ = q.shape
            _, bs, hk, _ = pool["k"].shape
            qt, kps, splits = pa.choose_splits(b, hk, w, h // hk,
                                               table.shape[1], bs, 132)

            def call():
                return pa.paged_attention(q, pool, table, ctx_t)

            us = timer(call) * 1e3
            libs["paged_attention"].probe_clear()
            timer.flush.zero_()
            call()
            torch.cuda.synchronize()
            ctas = b * hk * -(-w * (h // hk) // qt) * splits
            report(res, f"paged_attention W{w} kv{kv_bits} split {kps}",
                   stamps(libs["paged_attention"], ctas, torch), ctas, us)


def probe_bf16(torch, cs, timer, res) -> None:
    """The bfloat16 kernel at phase 2's timed shapes (phi3 and stablelm,
    decode B 8 and a W 256 prefill, a bf16 and an int8 pool) and at the
    4096-key decode, through the wrapper with the stamped library; at the
    timed shapes also the untouched kernel and its cost variants."""
    from repro_torch.kernels import paged_attention as pa

    from repro_torch.kernels import build

    lib = stamped_lib("paged_attention", "pab", pa)
    variants = {}
    for name in ("pab_as_is", *(f"pab_no_{n}" for n in BF16_COSTS)):
        v = ctypes.CDLL(str(OUT / f"{name}.so"))
        for fn, (ret, args) in pa._SIGNATURES.items():
            getattr(v, fn).restype = ret
            getattr(v, fn).argtypes = list(args)
        variants[name] = v
    print("paged_attention bf16, us per CTA, mean [slowest]: staging (ring "
          "waits, barriers, int8 widening), pass 1, (m, l) exchange, pass 2, "
          "output")
    g = torch.Generator(device="cuda").manual_seed(21)
    cases = [(w, kv, h, hk, dh, None) for kv in (16, 8)
             for h, hk, dh in cs.BF16_ATTN for w in (1, 256)]
    cases += [(1, kv, h, hk, dh, cs.BF16_LONG_DECODE) for kv in (16, 8)
              for h, hk, dh in cs.BF16_ATTN]
    for w, kv_bits, h, hk, dh, lens in cases:
        q, pool, table, ctx_t, _, _, _ = cs._span_batch(
            torch, g, w, kv_bits, h=h, dh=dh, hk=hk, dtype=torch.bfloat16,
            lens=lens)
        b = q.shape[0]
        qt, kps, splits = pa.choose_bf16_splits(b, hk, w, h // hk,
                                                table.shape[1], 16, 132)

        def call():
            return pa.paged_attention(q, pool, table, ctx_t)

        us = timer(call) * 1e3
        lib.probe_clear()
        timer.flush.zero_()
        call()
        torch.cuda.synchronize()
        ctas = b * hk * -(-w * (h // hk) // qt) * splits
        key = (f"bf16 W{w} kv{kv_bits} H{h} Dh{dh} keys "
               f"{table.shape[1] * 16} qt {qt} splits {splits} of {kps}")
        report(res, key, stamps(lib, ctas, torch, 5), ctas, us, 5)
        if lens is not None:
            continue
        times = {}
        for name, vlib in variants.items():
            build._LIBS["paged_attention"] = vlib
            times[name] = timer(call) * 1e3
        build._LIBS["paged_attention"] = lib
        print("    as is / without " + " / ".join(
            n.removeprefix("pab_no_") for n in list(times)[1:]) + ": "
            + " / ".join(f"{v:.1f}" for v in times.values()) + " us")
        res[key]["without_us"] = times


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=pathlib.Path, default=ROOT,
                    help="root of a checkout (default: this one)")
    ap.add_argument("--kernels", default="quant_matmul,lowrank_qmm,"
                    "paged_attention,paged_attention_bf16",
                    help="comma-separated kernels to probe (lowrank_qmm and "
                    "paged_attention go together)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("phase_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src / "src"))
    sys.path.insert(0, str(args.src))
    import chip_smoke as cs
    from repro_torch.kernels import build

    csrc = args.src / "src" / "repro_torch" / "kernels" / "csrc"
    OUT.mkdir(parents=True, exist_ok=True)
    wanted = set(args.kernels.split(","))
    runs, sos, found = [], [], {}
    if "quant_matmul" in wanted:
        for name, patches, common, nph, ctas_of, phases in QMM_VERSIONS:
            if ((not common or instrument(csrc / "common.cuh", common,
                                          OUT / "qmm_common.cuh", tail=""))
                    and instrument(csrc / "quant_matmul.cu", patches,
                                   OUT / "qmm.cu")):
                break
        else:
            print(f"phase_probe: {csrc} holds no known quant_matmul",
                  file=sys.stderr)
            return 1
        found["quant_matmul"] = name
        sos.append("qmm")
        runs.append(lambda timer, res, a=(name, nph, ctas_of, phases):
                    probe_qmm(torch, timer, res, *a))
    if wanted & {"lowrank_qmm", "paged_attention"}:
        versions = (("first", LRMM_PATCHES, PA_PATCHES, probe_first),
                    ("second", LRMM2_PATCHES, PA2_PATCHES, probe_second))
        for name, lp, ap_, run in versions:
            if (instrument(csrc / "lowrank_qmm.cu", lp, OUT / "lrmm.cu")
                    and instrument(csrc / "paged_attention.cu", ap_,
                                   OUT / "pa.cu")):
                break
        else:
            print(f"phase_probe: {csrc} holds neither known version of "
                  "lowrank_qmm and paged_attention", file=sys.stderr)
            return 1
        found["lowrank_qmm, paged_attention"] = name
        sos += ["lrmm", "pa"]
        runs.append(lambda timer, res, run=run: run(torch, cs, timer, res))
    if "paged_attention_bf16" in wanted:
        if not instrument(csrc / "paged_attention.cu", PAB_PATCHES,
                          OUT / "pab.cu"):
            print(f"phase_probe: {csrc} holds no known bf16 paged_attention",
                  file=sys.stderr)
            return 1
        found["paged_attention_bf16"] = "cluster"
        sos += ["pab", *bf16_variants(csrc)]
        runs.append(lambda timer, res: probe_bf16(torch, cs, timer, res))
    print("phase_probe: " + "; ".join(f"{k}: {v} version"
                                      for k, v in found.items())
          + f", from {csrc}")
    build_probes(csrc, build, sos)
    res: dict = {}
    timer = cs.Timer(torch)
    for run in runs:
        run(timer, res)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    print(json.dumps({"versions": found, "device": smi, "phases": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
