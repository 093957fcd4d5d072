"""Fused ITERA cascade: wrapper of `csrc/lowrank_qmm.cu` and its plain
version (port of `repro.kernels.lowrank_qmm`, the paper's §V-B engine).

Up to R 4096 the (M, R) intermediate lives only in the shared memory of
the thread-block clusters that compute it, and the wrapper allocates the
output and nothing else. Past that (the grouped path, two launches) the
wrapper also allocates the float32 t and the slices' row maxima that the
first launch writes and the second reads. `choose_tiles` is the launch's
partition, a pure function of the shapes, so it runs (and is tested) on
the CPU. On a CUDA tensor `lowrank_qmm` launches the kernel (or raises);
on a CPU tensor it runs the plain version. Y is float32, or bfloat16 rounded once to nearest even from
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
                         _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P)),
    "lrmm_smem_bytes": (ctypes.c_longlong, (_I, _I, _I, _I, _I, _I)),
}
CLUSTER = 8          # CTAs per cluster at most (the portable maximum)
RS_MAX = 128         # widest rank slice fixed at compile time
RS_WIDE = 512        # widest wide slice (read at run time): R <= 4096 on chip
RS_DEEP = 352        # widest wide slice a decode CTA takes 128 K-rows a step
GROUP_RS = 128       # the grouped path's slice of R


class Tiles(typing.NamedTuple):
    """One launch's partition (see csrc/lowrank_qmm.cu): `bm` rows per
    CTA; clusters of `cluster` CTAs, each computing phase 1 for `rs`
    columns of R; in phase 2 the cluster is (cluster / cn) R groups x
    `cn` column shares of its `ncl` columns of N. With `groups` > 0 the
    grouped path: `groups` slices of `rs` columns of R, one CTA each
    (cluster == cn == 1), write t and their row maxima to device memory,
    then one CTA per `ncl` columns of N runs phase 2 over all of R."""
    bm: int
    rs: int
    cluster: int
    cn: int
    ncl: int
    groups: int = 0

    @property
    def path(self) -> str:
        """"cluster" (T on chip) or "grouped" (T through device memory)."""
        return "grouped" if self.groups else "cluster"

    @property
    def launches(self) -> int:
        """Kernel launches of one call."""
        return 2 if self.groups else 1

    def ctas(self, m: int, n: int) -> int:
        """CTAs of the launch (of its phase-2 launch on the grouped path)
        for an (m, n) output."""
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
_TK = 64             # R rows a step of the grouped path's second launch


def _bk(bm: int, rs: int) -> int:
    """Depth of a phase-1 K step (csrc `bk_of`)."""
    if rs > RS_MAX:
        return 128 if bm == 16 and rs <= RS_DEEP else 64
    return (128 if rs >= 128 else 16384 // rs) if bm == 16 else 128


def _cta_bytes(bm: int, rs: int, c: int, cn: int, nc: int) -> int:
    """csrc `layout`: a ring of 3 stages, each the larger of the Xq + W1
    and the W2 tiles; the transposed tile; T; the pushed partials when
    c > cn; the CTA's Tq slice and its R group's; every rank's row max;
    st."""
    bk = _bk(bm, rs)
    bk2 = min(128 if rs > RS_MAX else bk, rs * cn)
    stage = max(bm * (bk + 16) + bk * rs, bk2 * nc)
    bt = max(bk // 4 * (rs + 8), bk2 // 4 * (nc + 8)) * 4
    red = bm * nc * 4 if c > cn else 0
    return (_STAGES * stage + bt + bm * rs * 4 + red + bm * (rs + 16)
            + bm * (rs * cn + 16) + CLUSTER * bm * 4 + bm * 4)


def smem_bytes(bm: int, rs: int, c: int, cn: int, ncl: int,
               groups: int = 0) -> int:
    """Shared memory of the launch's larger CTA, in Python: csrc
    `lrmm_smem_bytes`, so `choose_tiles` runs with no library built. On
    the grouped path the larger of its first kernel's CTA (a cluster of
    one, 32-column phase-2 chunks it never runs) and its second's: a ring
    of t (float32) and W2 tiles, Tq, the transposed tile, st."""
    if groups:
        tail = (_STAGES * (bm * _TK * 4 + _TK * NC) + bm * (_TK + 16)
                + _TK // 4 * (NC + 8) * 4 + bm * 4)
        return max(_cta_bytes(bm, rs, 1, 1, 32), tail)
    return _cta_bytes(bm, rs, c, cn, min(NC, ncl // cn))


def hbm_bytes_moved(m: int, k: int, r: int, n: int, w1_packed: bool,
                    w2_packed: bool, tiles: Tiles) -> int:
    """Device bytes one launch moves under its partition `tiles` (the
    kernel's padded K, R and N): every CTA reads its row block's Xq and
    scales for phase 1 (C a cluster, one cluster for each span of N
    columns); each cluster reads W1 and both scale vectors once, since
    its CTAs split R; each row block reads W2 once; Y is written once.
    On the cluster path the (M, R) intermediate stays on chip. On the
    grouped path phase 1 runs once (each of the G slice CTAs of a row
    block reads its Xq), t (float32) and the G row maxima are written
    once and read by every span of `ncl` columns. At least
    `ops.lrmm_hbm_bytes`, which counts every operand once."""
    spans, rows = -(-n // tiles.ncl), -(-m // tiles.bm)
    w1 = k * r // 2 if w1_packed else k * r
    w2 = r * n // 2 if w2_packed else r * n
    if tiles.groups:
        t_bytes = m * r * 4 + tiles.groups * m * 4
        return ((m * k + m * 4) * tiles.groups + (w1 + 2 * r * 4) * rows
                + t_bytes * (1 + spans) + w2 * rows + m * n * 4)
    return ((m * k + m * 4) * tiles.cluster * spans
            + (w1 + 2 * r * 4) * spans * rows + w2 * rows + m * n * 4)


def choose_tiles(m: int, r: int, n: int, num_sms: int, smem_bytes,
                 experts: int = 1) -> Tiles:
    """The launch's partition, from the shapes, the card's SM count and
    `smem_bytes(bm, rs, cluster, cn, ncl, groups)`, the kernel's shared
    memory per CTA.

    Up to R 1024 the cluster takes C = the fewest CTAs (a power of two,
    at most 8) whose 32-column slices cover R, and each CTA the narrowest
    slice (32, 64 or 128 columns) with C * rs >= R; up to 8 * RS_WIDE
    (4096) C is 8 and rs the narrowest multiple of 32 that covers R in
    8, with bm at most 32. bm is the fewest rows that cover small M (a
    decode step has M = max_batch). The cluster's span of N columns is
    the widest power of two times 32 that still gives about one wave (7/8
    of the SMs) -- a wider span recomputes phase 1 less often -- and cn,
    the CTAs that split that span in phase 2, the most that leave each at
    least 32 columns; a wide slice's CTA takes a whole SM, so its span
    widens until the launch takes at most half the SMs (clusters of 8
    resident in one round, whatever the card's GPCs hold). bm halves
    until a CTA fits shared memory, and at bm 16 cn does. Past 4096 the grouped path: R in slices of GROUP_RS,
    and phase 2 in spans of the widest of 128, 64 or 32 columns that
    gives about a wave. A stack of `experts` cascades launches `experts`
    times the CTAs, which counts towards the wave."""
    if r % 32 or n % 32 or r <= 0 or n <= 0:
        raise ValueError(f"lowrank_qmm kernel needs R % 32 == N % 32 == 0, "
                         f"got R={r} N={n}")
    bm = 16 if m <= 16 else 32 if m <= 32 else 64
    wave = num_sms * 7 / 8
    if r > CLUSTER * RS_WIDE:
        groups = -(-r // GROUP_RS)
        ncl = NC
        while ncl > 32 and -(-m // bm) * experts * -(-n // ncl) < wave:
            ncl //= 2
        while smem_bytes(bm, GROUP_RS, 1, 1, ncl, groups) > SMEM_LIMIT:
            if bm == 16:
                raise ValueError(f"rank {r} does not fit one CTA's shared "
                                 f"memory")
            bm //= 2
        return Tiles(bm, GROUP_RS, 1, 1, ncl, groups)
    if r <= CLUSTER * RS_MAX:
        c = 1
        while c < CLUSTER and c * 32 < r:
            c *= 2
        rs = 32
        while c * rs < r:
            rs *= 2
    else:
        c, rs = CLUSTER, -(-r // (CLUSTER * 32)) * 32
        bm = min(bm, 32)
    top = 32
    while top < n:
        top *= 2
    while True:
        m_blocks = -(-m // bm) * experts
        ncl = top
        while ncl > 32 and m_blocks * -(-n // ncl) * c < wave:
            ncl //= 2
        if rs > RS_MAX:     # one CTA an SM: keep the clusters to one round
            while ncl < top and m_blocks * -(-n // ncl) * c > num_sms // 2:
                ncl *= 2
        cn = c
        while cn > 1 and ncl // cn < 32:
            cn //= 2
        while True:
            if smem_bytes(bm, rs, c, cn, ncl, 0) <= SMEM_LIMIT:
                return Tiles(bm, rs, c, cn, ncl)
            if bm > 16 or cn == 1:
                break
            cn //= 2
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
    (`ops.lrmm` pads to that); every such R runs, up to 4096 as one
    launch with T on chip, past it as the grouped path's two launches
    (counted as one call in `build.LAUNCHES`)."""
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
    tg = pg = None
    if tl.groups:       # the grouped path's t and row maxima
        tg = torch.empty((e, m, r), dtype=torch.float32, device=dev)
        pg = torch.empty((e, tl.groups, m), dtype=torch.float32, device=dev)
    err = lib.lrmm_launch(xq.data_ptr(), sx.data_ptr(), w1q.data_ptr(),
                          s1.data_ptr(), w2q.data_ptr(), s2.data_ptr(),
                          y.data_ptr(), e, m, k, r, n, int(w1_packed),
                          int(w2_packed), int(act_qmax), tl.bm, tl.rs,
                          tl.cluster, tl.cn, tl.ncl, tl.groups,
                          int(out_dtype == torch.bfloat16),
                          None if tg is None else tg.data_ptr(),
                          None if pg is None else pg.data_ptr(),
                          build.stream_handle(dev))
    build.check(err, "lowrank_qmm")
    build.LAUNCHES["lowrank_qmm"] += 1
    build.LAUNCH_RANKS[r] += 1
    build.LAUNCH_SHAPES["lowrank_qmm", tl.bm, k, r, n, bool(w1_packed),
                        bool(w2_packed), e] += 1
    return y
