"""Fused ITERA cascade: wrapper of `csrc/lowrank_qmm.cu` and its plain
version (port of `repro.kernels.lowrank_qmm`, the paper's §V-B engine).

The (M, R) intermediate lives only in each CTA's shared memory; the
wrapper allocates the output and nothing else. On a CUDA tensor
`lowrank_qmm` launches the kernel (or raises); on a CPU tensor it runs the
plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.quant import unpack_int4
from repro_torch.kernels import build
from repro_torch.kernels.quant_matmul import _check
from repro_torch.kernels.ref import lowrank_qmm_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "lrmm_launch": (_I, (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _I, _I, _I, _P)),
    "lrmm_smem_bytes": (ctypes.c_longlong, (_I, _I)),
}
BN = 128            # phase-2 column tile of the kernel
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90


def lowrank_qmm_plain(xq, sx, w1q, s1, w2q, s2, *, w1_packed=False,
                      w2_packed=False, act_qmax=127):
    """The kernel's arithmetic in plain PyTorch (CPU or CUDA tensors)."""
    w1 = unpack_int4(w1q) if w1_packed else w1q
    w2 = unpack_int4(w2q) if w2_packed else w2q
    return lowrank_qmm_ref(xq, sx, w1, s1, w2, s2, act_qmax)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def choose_tiles(m: int, r: int, n: int, num_sms: int, smem_bytes):
    """(bm, n_split): the fewest rows a CTA holds that cover small M (a
    decode step has M = max_batch), shrunk until BM x R fits shared
    memory; then enough CTAs along N for about one wave on the card."""
    bm = 16 if m <= 16 else 32 if m <= 32 else 64
    while bm > 16 and smem_bytes(bm, r) > SMEM_LIMIT:
        bm //= 2
    if smem_bytes(bm, r) > SMEM_LIMIT:
        raise ValueError(f"rank {r} does not fit one CTA's shared memory")
    m_blocks = -(-m // bm)
    n_tiles = -(-n // BN)
    return bm, max(1, min(n_tiles, -(-num_sms // m_blocks)))


def lowrank_qmm(xq, sx, w1q, s1, w2q, s2, *, w1_packed=False,
                w2_packed=False, act_qmax=127) -> torch.Tensor:
    """Y[M, N] f32 = cascade((Xq @ W1q) @ W2q), requantized at the phase
    boundary to ±act_qmax.

    xq (M, K) int8, sx (M, 1) f32; w1q (K, R) int8 or (K, R/2) packed
    along R, s1 (1, R) f32; w2q (R, N) int8 or (R, N/2) packed along N,
    s2 (R, 1) f32. The CUDA kernel needs K % 16 == 0, R % 4 == 0 and
    N % 4 == 0 (`ops.lrmm` pads to that)."""
    if xq.device.type == "cpu":
        return lowrank_qmm_plain(xq, sx, w1q, s1, w2q, s2,
                                 w1_packed=w1_packed, w2_packed=w2_packed,
                                 act_qmax=act_qmax)
    if xq.device.type != "cuda":
        raise ValueError(f"lowrank_qmm runs on cuda or cpu, not {xq.device}")
    m, k = xq.shape
    r = w1q.shape[1] * 2 if w1_packed else w1q.shape[1]
    n = w2q.shape[1] * 2 if w2_packed else w2q.shape[1]
    if k % 16 or r % 4 or n % 4:
        raise ValueError(f"lowrank_qmm kernel needs K % 16, R % 4, N % 4 == "
                         f"0, got K={k} R={r} N={n}")
    if not 1 <= act_qmax <= 127:
        raise ValueError(f"act_qmax must be in [1, 127], got {act_qmax}")
    dev = xq.device
    _check(xq, "xq", torch.int8, (m, k), dev, align=16)
    _check(sx, "sx", torch.float32, (m, 1), dev)
    _check(w1q, "w1q", torch.int8, (k, w1q.shape[1]), dev)
    _check(s1, "s1", torch.float32, (1, r), dev)
    _check(w2q, "w2q", torch.int8, (r, w2q.shape[1]), dev)
    _check(s2, "s2", torch.float32, (r, 1), dev)
    y = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0:
        return y
    lib = build.load("lowrank_qmm", _SIGNATURES)
    bm, n_split = choose_tiles(m, r, n, _sm_count(dev.index or 0),
                               lib.lrmm_smem_bytes)
    err = lib.lrmm_launch(xq.data_ptr(), sx.data_ptr(), w1q.data_ptr(),
                          s1.data_ptr(), w2q.data_ptr(), s2.data_ptr(),
                          y.data_ptr(), m, k, r, n, int(w1_packed),
                          int(w2_packed), int(act_qmax), bm, n_split,
                          build.stream_handle(dev))
    build.check(err, "lowrank_qmm")
    build.LAUNCHES["lowrank_qmm"] += 1
    return y
