"""Fused ITERA cascade: wrapper of `csrc/lowrank_qmm.cu` and its plain
version (port of `repro.kernels.lowrank_qmm`, the paper's §V-B engine).

The (M, R) intermediate lives only in the shared memory of the thread-block
clusters that compute it; the wrapper allocates the output and nothing
else. `choose_tiles` is the launch's partition, a pure function of the
shapes, so it runs (and is tested) on the CPU. On a CUDA tensor
`lowrank_qmm` launches the kernel (or raises); on a CPU tensor it runs the
plain version. Y is float32, or bfloat16 rounded once to nearest even from
the float32 value (the kernel's epilogue writes it), as `quant_matmul`'s.
"""
from __future__ import annotations

import ctypes
import typing

import torch

from repro_torch.core.quant import unpack_int4
from repro_torch.kernels import build
from repro_torch.kernels.build import SMEM_LIMIT
from repro_torch.kernels.quant_matmul import _check, out_dtype_ok
from repro_torch.kernels.ref import lowrank_qmm_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "lrmm_launch": (_I, (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _I, _I, _I, _I, _I, _I, _I, _I, _P)),
    "lrmm_smem_bytes": (ctypes.c_longlong, (_I, _I, _I, _I, _I)),
}
CLUSTER = 8          # CTAs per cluster at most (the portable maximum)
RS_MAX = 128         # widest rank slice one CTA of the kernel takes


class Tiles(typing.NamedTuple):
    """One launch's partition (see csrc/lowrank_qmm.cu): `bm` rows per
    CTA; clusters of `cluster` CTAs, each computing phase 1 for `rs`
    columns of R; in phase 2 the cluster is (cluster / cn) R groups x
    `cn` column shares of its `ncl` columns of N."""
    bm: int
    rs: int
    cluster: int
    cn: int
    ncl: int

    def ctas(self, m: int, n: int) -> int:
        """CTAs of the launch for an (m, n) output."""
        return self.cluster * -(-n // self.ncl) * -(-m // self.bm)


def lowrank_qmm_plain(xq, sx, w1q, s1, w2q, s2, *, w1_packed=False,
                      w2_packed=False, act_qmax=127, out_dtype=None):
    """The kernel's arithmetic in plain PyTorch (CPU or CUDA tensors; one
    matrix or an expert stack); a bfloat16 Y is the float32 one rounded to
    nearest even."""
    w1 = unpack_int4(w1q) if w1_packed else w1q
    w2 = unpack_int4(w2q) if w2_packed else w2q
    y = lowrank_qmm_ref(xq, sx, w1, s1, w2, s2, act_qmax)
    return y.to(out_dtype_ok(out_dtype))


NC = 128             # widest phase-2 column chunk a CTA accumulates at once
_STAGES = 3


def smem_bytes(bm: int, rs: int, c: int, cn: int, ncl: int) -> int:
    """Shared memory of one CTA, in Python: csrc `lrmm_smem_bytes` (its
    `layout`), so `choose_tiles` runs with no library built. A ring of 3
    stages, each the larger of the Xq + W1 and the W2 tiles; the
    transposed tile; T; the pushed partials when c > cn; the CTA's Tq
    slice and its R group's; every rank's row max; st."""
    bk = (128 if rs >= 128 else 16384 // rs) if bm == 16 else 128
    nc = min(NC, ncl // cn)
    bk2 = min(bk, rs * cn)
    stage = max(bm * (bk + 16) + bk * rs, bk2 * nc)
    bt = max(bk // 4 * (rs + 8), bk2 // 4 * (nc + 8)) * 4
    red = bm * nc * 4 if c > cn else 0
    return (_STAGES * stage + bt + bm * rs * 4 + red + bm * (rs + 16)
            + bm * (rs * cn + 16) + CLUSTER * bm * 4 + bm * 4)


def hbm_bytes_moved(m: int, k: int, r: int, n: int, w1_packed: bool,
                    w2_packed: bool, tiles: Tiles) -> int:
    """Device bytes one launch moves under its partition `tiles` (the
    kernel's padded K, R and N): every CTA reads its row block's Xq and
    scales for phase 1 (C a cluster, one cluster for each span of N
    columns); each cluster reads W1 and both scale vectors once, since
    its CTAs split R; each row block reads W2 once; Y is written once.
    The (M, R) intermediate stays on chip. At least `ops.lrmm_hbm_bytes`,
    which counts every operand once."""
    spans, rows = -(-n // tiles.ncl), -(-m // tiles.bm)
    w1 = k * r // 2 if w1_packed else k * r
    w2 = r * n // 2 if w2_packed else r * n
    return ((m * k + m * 4) * tiles.cluster * spans
            + (w1 + 2 * r * 4) * spans * rows + w2 * rows + m * n * 4)


def choose_tiles(m: int, r: int, n: int, num_sms: int, smem_bytes,
                 experts: int = 1) -> Tiles:
    """The launch's partition, from the shapes, the card's SM count and
    `smem_bytes(bm, rs, cluster, cn, ncl)`, the kernel's shared memory per
    CTA.

    The cluster takes C = the fewest CTAs (a power of two, at most 8)
    whose 32-column slices cover R, and each CTA the narrowest slice
    (32, 64 or 128 columns) with C * rs >= R. bm is the fewest rows that
    cover small M (a decode step has M = max_batch). The cluster's span
    of N columns is the widest power of two times 32 that still gives
    about one wave (7/8 of the SMs) -- a wider span recomputes phase 1
    less often -- and cn, the CTAs that split that span in phase 2, the
    most that leave each at least 32 columns. bm halves until a CTA fits
    shared memory. A stack of `experts` cascades launches `experts` times
    the clusters, which counts towards the wave."""
    if r % 32 or n % 32 or r <= 0 or n <= 0:
        raise ValueError(f"lowrank_qmm kernel needs R % 32 == N % 32 == 0, "
                         f"got R={r} N={n}")
    c = 1
    while c < CLUSTER and c * 32 < r:
        c *= 2
    rs = 32
    while c * rs < r:
        rs *= 2
    if rs > RS_MAX:
        raise ValueError(f"rank {r} exceeds the kernel's {CLUSTER * RS_MAX}")
    top = 32
    while top < n:
        top *= 2
    bm = 16 if m <= 16 else 32 if m <= 32 else 64
    while True:
        m_blocks = -(-m // bm) * experts
        ncl = top
        while ncl > 32 and m_blocks * -(-n // ncl) * c < num_sms * 7 / 8:
            ncl //= 2
        cn = c
        while cn > 1 and ncl // cn < 32:
            cn //= 2
        if smem_bytes(bm, rs, c, cn, ncl) <= SMEM_LIMIT:
            return Tiles(bm, rs, c, cn, ncl)
        if bm == 16:
            raise ValueError(f"rank {r} does not fit one CTA's shared memory")
        bm //= 2


def lowrank_qmm(xq, sx, w1q, s1, w2q, s2, *, w1_packed=False,
                w2_packed=False, act_qmax=127,
                out_dtype=None) -> torch.Tensor:
    """Y[M, N] = cascade((Xq @ W1q) @ W2q), requantized at the phase
    boundary to ±act_qmax, in out_dtype (float32 by default, or
    bfloat16).

    xq (M, K) int8, sx (M, 1) f32; w1q (K, R) int8 or (K, R/2) packed
    along R, s1 (1, R) f32; w2q (R, N) int8 or (R, N/2) packed along N,
    s2 (R, 1) f32. Or a stack of E such operand sets, a mixture-of-experts
    projection: xq (E, M, K) ... s2 (E, R, 1) -> Y (E, M, N), in ONE
    launch. The CUDA kernel needs K % 16 == 0, R % 32 == 0 and N % 32 == 0
    (`ops.lrmm` pads to that) and R <= 1024."""
    out_dtype = out_dtype_ok(out_dtype)
    if xq.device.type == "cpu":
        return lowrank_qmm_plain(xq, sx, w1q, s1, w2q, s2,
                                 w1_packed=w1_packed, w2_packed=w2_packed,
                                 act_qmax=act_qmax, out_dtype=out_dtype)
    if xq.device.type != "cuda":
        raise ValueError(f"lowrank_qmm runs on cuda or cpu, not {xq.device}")
    lead = xq.shape[:-2]
    e = xq.shape[0] if lead else 1
    m, k = xq.shape[-2:]
    r = w1q.shape[-1] * 2 if w1_packed else w1q.shape[-1]
    n = w2q.shape[-1] * 2 if w2_packed else w2q.shape[-1]
    if len(lead) > 1:
        raise ValueError(f"lowrank_qmm takes (M, K) or (E, M, K) "
                         f"activations, got {tuple(xq.shape)}")
    if k % 16 or r % 32 or n % 32:
        raise ValueError(f"lowrank_qmm kernel needs K % 16, R % 32, N % 32 "
                         f"== 0, got K={k} R={r} N={n}")
    if not 1 <= act_qmax <= 127:
        raise ValueError(f"act_qmax must be in [1, 127], got {act_qmax}")
    dev = xq.device
    _check(xq, "xq", torch.int8, (*lead, m, k), dev, align=16)
    _check(sx, "sx", torch.float32, (*lead, m, 1), dev)
    _check(w1q, "w1q", torch.int8, (*lead, k, w1q.shape[-1]), dev, align=16)
    _check(s1, "s1", torch.float32, (*lead, 1, r), dev)
    _check(w2q, "w2q", torch.int8, (*lead, r, w2q.shape[-1]), dev, align=16)
    _check(s2, "s2", torch.float32, (*lead, r, 1), dev)
    y = torch.empty((*lead, m, n), dtype=out_dtype, device=dev)
    if m == 0:
        return y
    lib = build.load("lowrank_qmm", _SIGNATURES)
    tl = choose_tiles(m, r, n, build.sm_count(dev.index or 0),
                      lib.lrmm_smem_bytes, e)
    err = lib.lrmm_launch(xq.data_ptr(), sx.data_ptr(), w1q.data_ptr(),
                          s1.data_ptr(), w2q.data_ptr(), s2.data_ptr(),
                          y.data_ptr(), e, m, k, r, n, int(w1_packed),
                          int(w2_packed), int(act_qmax), tl.bm, tl.rs,
                          tl.cluster, tl.cn, tl.ncl,
                          int(out_dtype == torch.bfloat16),
                          build.stream_handle(dev))
    build.check(err, "lowrank_qmm")
    build.LAUNCHES["lowrank_qmm"] += 1
    build.LAUNCH_RANKS[r] += 1
    build.LAUNCH_SHAPES["lowrank_qmm", tl.bm, k, r, n, bool(w1_packed),
                        bool(w2_packed), e] += 1
    return y
