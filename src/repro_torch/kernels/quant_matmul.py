"""Dense WxAy matmul: wrapper of `csrc/quant_matmul.cu` and its plain
version (port of `repro.kernels.quant_matmul`, the paper's §V-A engine).

On a CUDA tensor `quant_matmul` launches the CUDA kernel (or raises); on a
CPU tensor it runs the plain version. Nothing else chooses the path.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quant import unpack_int4
from repro_torch.kernels import build
from repro_torch.kernels.ref import quant_matmul_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"qmm_launch": (_I, (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P))}


def quant_matmul_plain(xq, sx, wq, sw, *, w_packed: bool = False):
    """The kernel's arithmetic in plain PyTorch (CPU or CUDA tensors)."""
    return quant_matmul_ref(xq, sx, unpack_int4(wq) if w_packed else wq, sw)


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


def quant_matmul(xq, sx, wq, sw, *, w_packed: bool = False) -> torch.Tensor:
    """Y[M, N] f32 = (Xq @ Wq as f32) * sx * sw.

    xq (M, K) int8; sx (M, 1) f32; wq (K, N) int8, or (K, N/2) packed W4
    nibbles along N when w_packed; sw (1, N) f32. The CUDA kernel needs
    K % 16 == 0 and N % 4 == 0 (`ops.qmm` pads to that)."""
    if xq.device.type == "cpu":
        return quant_matmul_plain(xq, sx, wq, sw, w_packed=w_packed)
    if xq.device.type != "cuda":
        raise ValueError(f"quant_matmul runs on cuda or cpu, not {xq.device}")
    m, k = xq.shape
    n = wq.shape[1] * 2 if w_packed else wq.shape[1]
    if k % 16 or n % 4:
        raise ValueError(f"quant_matmul kernel needs K % 16 == 0 and N % 4 "
                         f"== 0, got K={k} N={n}")
    dev = xq.device
    _check(xq, "xq", torch.int8, (m, k), dev, align=16)
    _check(sx, "sx", torch.float32, (m, 1), dev)
    _check(wq, "wq", torch.int8, (k, wq.shape[1]), dev)
    _check(sw, "sw", torch.float32, (1, n), dev)
    y = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0:
        return y
    lib = build.load("quant_matmul", _SIGNATURES)
    err = lib.qmm_launch(xq.data_ptr(), sx.data_ptr(), wq.data_ptr(),
                         sw.data_ptr(), y.data_ptr(), m, k, n, int(w_packed),
                         build.stream_handle(dev))
    build.check(err, "quant_matmul")
    build.LAUNCHES["quant_matmul"] += 1
    return y
