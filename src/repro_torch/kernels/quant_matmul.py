"""Dense WxAy matmul: wrapper of `csrc/quant_matmul.cu` and its plain
version (port of `repro.kernels.quant_matmul`, the paper's §V-A engine).

`choose_tiles` is the launch's partition, a pure function of the shapes,
so it runs (and is tested) on the CPU. On a CUDA tensor `quant_matmul`
launches the CUDA kernel (or raises); on a CPU tensor it runs the plain
version. Nothing else chooses the path.

Y is float32 or, with out_dtype bfloat16 (a bfloat16 model's linears),
the float32 value rounded once to nearest even, as the reference's
`.astype(out_dtype)`: the kernel writes it from its epilogue.
"""
from __future__ import annotations

import ctypes
import typing

import torch

from repro_torch.core.quant import unpack_int4
from repro_torch.kernels import build
from repro_torch.kernels.ref import quant_matmul_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "qmm_launch": (_I, (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                        _I, _I, _I, _P)),
    "qmm_smem_bytes": (ctypes.c_longlong, (_I, _I, _I, _I, _I, _I)),
}
CLUSTER = 8            # CTAs per cluster at most (the portable maximum)
STRIP_STAGE = 16384    # weight bytes of one K step of a 16-row strip
# shared memory a CTA may take so that two share an SM (228 KB an SM,
# 1 KB of it reserved for each CTA)
SMEM_TWO_PER_SM = 115712


class Tiles(typing.NamedTuple):
    """One launch's partition (see csrc/quant_matmul.cu): `bm` x `bn`
    output tiles, each computed by a cluster of `cluster` CTAs, CTA r
    taking K rows [r * kslice, (r + 1) * kslice) in steps of `bk`."""
    bm: int
    bn: int
    bk: int
    cluster: int
    kslice: int

    def ctas(self, m: int, n: int) -> int:
        """CTAs of the launch for an (m, n) output."""
        return self.cluster * -(-n // self.bn) * -(-m // self.bm)


OUT_DTYPES = (torch.float32, torch.bfloat16)


def out_dtype_ok(out_dtype) -> torch.dtype:
    """out_dtype (None: float32) if an integer kernel writes it, else
    raise."""
    out_dtype = out_dtype or torch.float32
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"the integer kernels write float32 or bfloat16, "
                        f"not {out_dtype}")
    return out_dtype


def quant_matmul_plain(xq, sx, wq, sw, *, w_packed: bool = False,
                       out_dtype=None):
    """The kernel's arithmetic in plain PyTorch (CPU or CUDA tensors; one
    matrix or an expert stack); a bfloat16 Y is the float32 one rounded to
    nearest even."""
    y = quant_matmul_ref(xq, sx, unpack_int4(wq) if w_packed else wq, sw)
    return y.to(out_dtype_ok(out_dtype))


# (bm, bn) tiles the kernel is compiled for (csrc/quant_matmul.cu QMM_TILES)
TILE_SHAPES = ((16, 32), (16, 64), (16, 128), (64, 64), (64, 128),
               (128, 64), (128, 128))
_STAGES, _WARPS = 3, 8


def _strip_ws(rb: int, packed: bool) -> int:
    """csrc `strip_ws`: a strip's raw weight rows of `rb` bytes padded in
    16-byte steps until the 4 k-quads a warp reads at once, each starting
    at its own row, fall on disjoint banks."""
    width = 4 if packed else 8          # words the 8 lanes of a quad read
    s = rb
    while any(min(d, 32 - d) < width
              for j in range(4) for t1 in range(4) for t2 in range(t1 + 1, 4)
              for d in [((4 * t1 + ((j + t1) & 3)) * (s // 4)
                         - (4 * t2 + ((j + t2) & 3)) * (s // 4)) % 32]):
        s += 16
    return s


def smem_bytes(bm: int, bn: int, bk: int, packed, c: int,
               kslice: int) -> int:
    """Shared memory of one CTA, in Python: csrc `qmm_smem_bytes` (its
    `layout`), so `choose_tiles` runs with no library built. A ring of as
    many stages as the CTA has K steps (at most 3), each an Xq tile with
    rows padded by 16 bytes and a raw weight tile (a strip pads its rows
    against bank conflicts); a wider tile's transposed copy; the tile's
    scales; the warps' partial sums when warps or a cluster split K; the
    cluster's pushed partials. -1 for a tile the kernel lacks."""
    if (bm, bn) not in TILE_SHAPES:
        return -1
    strip = bm == 16
    kw = _WARPS // (bn // 32) if strip else 1    # warps sharing a K slab
    rb = bn // 2 if packed else bn
    stage = bm * (bk + 16) + bk * (_strip_ws(rb, bool(packed)) if strip
                                   else rb)
    total = min(-(-kslice // bk), _STAGES) * stage
    total += 0 if strip else bk // 4 * (bn + 8) * 4
    total += (bm + bn) * 4
    total += kw * bm * bn * 4 if c > 1 or kw > 1 else 0
    return total + (bm * bn * 4 if c > 1 else 0)


def hbm_bytes_moved(m: int, k: int, n: int, packed: bool,
                    tiles: Tiles) -> int:
    """Device bytes one launch moves under its partition `tiles` (the
    kernel's padded K and N): each column tile reads the Xq rows and
    their scales once (a cluster's CTAs split K between them), each row
    block the weight (halved when packed) and its scales, and Y is
    written once. At least `ops.qmm_hbm_bytes`, which counts every
    operand once."""
    cols, rows = -(-n // tiles.bn), -(-m // tiles.bm)
    w = k * n // 2 if packed else k * n
    return (m * k + m * 4) * cols + (w + n * 4) * rows + m * n * 4


def choose_tiles(m: int, k: int, n: int, packed: bool, num_sms: int,
                 smem_bytes, experts: int = 1) -> Tiles:
    """The launch's partition, from the shapes, the card's SM count and
    `smem_bytes(bm, bn, bk, packed, cluster, kslice)`, the kernel's shared
    memory per CTA.

    bm: one 16-row strip at M <= 16 (a decode step), 64 rows up to M 256,
    else 128. bn: 128 columns, halved (to 32 for a strip, 64 for wider
    tiles) while the tiles alone leave SMs idle. cluster: doubled (to 8)
    while twice the CTAs still fit one wave and each CTA keeps a K slice
    of at least 64 rows, then halved while the last CTA's slice would be
    empty (K 528 at M 8). bk: a strip takes up to STRIP_STAGE weight
    bytes of its slice a step (a step costs a barrier however small),
    wider tiles 128 rows; bk halves until a CTA fits two to an SM. A
    stack of `experts` matrices launches `experts` times the tiles, which
    counts towards filling the card."""
    if k <= 0 or n <= 0 or m < 0 or k % 16 or n % 32:
        raise ValueError(f"quant_matmul kernel needs K % 16 == 0 and N % 32 "
                         f"== 0, got K={k} N={n}")
    bm = 16 if m <= 16 else 64 if m <= 256 else 128
    rows = max(1, -(-m // bm)) * experts
    bn = 128
    while bn > (32 if bm == 16 else 64) and rows * -(-n // bn) < num_sms:
        bn //= 2
    tiles = rows * -(-n // bn)
    c = 1
    while (c < CLUSTER and tiles * 2 * c <= num_sms
           and k >= 2 * c * 64):
        c *= 2
    kslice = -(-k // (32 * c)) * 32
    while (c - 1) * kslice >= k:    # no CTA's K slice may be empty
        c //= 2
        kslice = -(-k // (32 * c)) * 32
    bnb = bn // 2 if packed else bn
    bk = min(STRIP_STAGE // bnb, kslice) if bm == 16 else 128
    while smem_bytes(bm, bn, bk, int(packed), c, kslice) > SMEM_TWO_PER_SM:
        if bk <= 32:
            raise ValueError(f"no K step of a {bm} x {bn} tile fits two "
                             f"CTAs' shared memory on an SM")
        bk = max(32, bk // 2 // 32 * 32)
    return Tiles(bm, bn, bk, c, kslice)


def _check(t: torch.Tensor, name: str, dtype, shape, device,
           align: int = 4) -> None:
    """Raise unless `t` is what a kernel argument must be: on `device`,
    of `dtype` and `shape`, contiguous, and `align`-byte aligned (the
    width of the kernel's vector loads)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


def quant_matmul(xq, sx, wq, sw, *, w_packed: bool = False,
                 out_dtype=None) -> torch.Tensor:
    """Y[M, N] = (Xq @ Wq as f32) * sx * sw, in out_dtype (float32 by
    default, or bfloat16).

    xq (M, K) int8; sx (M, 1) f32; wq (K, N) int8, or (K, N/2) packed W4
    nibbles along N when w_packed; sw (1, N) f32. Or a stack of E such
    operand sets, a mixture-of-experts projection: xq (E, M, K) ... sw
    (E, 1, N) -> Y (E, M, N), in ONE launch. The CUDA kernel copies whole
    16-byte chunks of weight rows, so it needs K % 16 == 0 and N % 32 == 0
    (`ops.qmm` pads to that)."""
    out_dtype = out_dtype_ok(out_dtype)
    if xq.device.type == "cpu":
        return quant_matmul_plain(xq, sx, wq, sw, w_packed=w_packed,
                                  out_dtype=out_dtype)
    if xq.device.type != "cuda":
        raise ValueError(f"quant_matmul runs on cuda or cpu, not {xq.device}")
    lead = xq.shape[:-2]
    e = xq.shape[0] if lead else 1
    m, k = xq.shape[-2:]
    n = wq.shape[-1] * 2 if w_packed else wq.shape[-1]
    if k % 16 or n % 32:
        raise ValueError(f"quant_matmul kernel needs K % 16 == 0 and N % 32 "
                         f"== 0, got K={k} N={n}")
    if len(lead) > 1:
        raise ValueError(f"quant_matmul takes (M, K) or (E, M, K) "
                         f"activations, got {tuple(xq.shape)}")
    dev = xq.device
    _check(xq, "xq", torch.int8, (*lead, m, k), dev, align=16)
    _check(sx, "sx", torch.float32, (*lead, m, 1), dev)
    _check(wq, "wq", torch.int8, (*lead, k, wq.shape[-1]), dev, align=16)
    _check(sw, "sw", torch.float32, (*lead, 1, n), dev)
    y = torch.empty((*lead, m, n), dtype=out_dtype, device=dev)
    if m == 0:
        return y
    lib = build.load("quant_matmul", _SIGNATURES)
    tl = choose_tiles(m, k, n, w_packed, build.sm_count(dev.index or 0),
                      lib.qmm_smem_bytes, e)
    err = lib.qmm_launch(xq.data_ptr(), sx.data_ptr(), wq.data_ptr(),
                         sw.data_ptr(), y.data_ptr(), e, m, k, n,
                         int(w_packed), tl.bm, tl.bn, tl.bk, tl.cluster,
                         tl.kslice, int(out_dtype == torch.bfloat16),
                         build.stream_handle(dev))
    build.check(err, "quant_matmul")
    build.LAUNCHES["quant_matmul"] += 1
    build.LAUNCH_SHAPES["quant_matmul", k, n] += 1
    return y
