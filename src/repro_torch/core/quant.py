"""Symmetric fixed-point quantization (port of `repro.core.quant`).

Vector-wise scales (paper §VIII-B): one fp32 scale per output column of a
(K, N) weight, per rank vector of the ITERA factors. W4 weights can be
*packed* two nibbles per int8 byte along the last axis; the CUDA kernels
sign-extend the nibbles in registers before the int8 tensor-core product,
so HBM moves wl/8 bytes per weight. The byte layout (element 2i in the LOW
nibble of byte i) and the packing rule are the reference's, so compressed
checkpoints move between the two packages byte for byte.
"""
from __future__ import annotations

import dataclasses

import torch


def qmax(wl: int) -> int:
    """Largest magnitude representable by a symmetric signed `wl`-bit code."""
    if wl < 2:
        raise ValueError(f"word length must be >= 2, got {wl}")
    return 2 ** (wl - 1) - 1


def symmetric_scale(absmax: torch.Tensor, m: int) -> torch.Tensor:
    """The symmetric scale absmax / m (1 where absmax is 0), in float32.

    Taken as absmax * float32(1 / m): the reference divides by the
    constant m inside jit, which XLA lowers to a multiply by the float32
    reciprocal, so this gives the reference's scales bit for bit (a true
    division differs from it in the last bit for a few percent of
    values). The CUDA kernels take the same product."""
    return torch.where(absmax > 0, absmax * (1.0 / m),
                       torch.ones_like(absmax)).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class QuantizedTensor:
    """A symmetric per-axis quantized tensor.

    values : int8 codes. Carrier layout: one int8 per code. Packed layout
             (`packed=True`, wl == 4 only): two nibble codes per byte along
             the LAST axis, so `values.shape[-1]` is half the logical width.
    scale  : fp32 scale, broadcastable against the logical values.
    wl     : weight word length in bits (the code range).
    axis   : reduction axis the scales are shared along.
    packed : True when `values` holds the packed-nibble layout.
    act_wl : word length the activations feeding this weight's matmul are
             quantized to at run time (the plan's WxAy "Ay").
    """

    values: torch.Tensor
    scale: torch.Tensor
    wl: int
    axis: int
    packed: bool = False
    act_wl: int = 8

    @property
    def shape(self):
        """LOGICAL shape (unpacked), regardless of residency layout."""
        s = tuple(self.values.shape)
        if self.packed:
            return (*s[:-1], s[-1] * 2)
        return s

    def dequant(self) -> torch.Tensor:
        v = unpack_int4(self.values) if self.packed else self.values
        return v.to(torch.float32) * self.scale

    def storage_bits(self) -> int:
        """Bits the resident arrays occupy: 8 per stored byte plus fp32
        scales (a W4 carrier that was not packed costs the full 8)."""
        return self.values.numel() * 8 + self.scale.numel() * 32

    def to(self, device) -> "QuantizedTensor":
        return dataclasses.replace(self, values=self.values.to(device),
                                   scale=self.scale.to(device))


BLOCK_ELEMENTS = 2 ** 28  # elements of one column block (`column_blocks`)


def column_blocks(t: torch.Tensor) -> list[slice]:
    """Slices of `t`'s last axis, each taking at most BLOCK_ELEMENTS of
    its elements (at least one column). Work that treats each column on
    its own (a product's output columns, per-column scales) goes block by
    block with no bit changed and bounded temporaries: a float64 copy of
    an 18432 x 256,000 head's codes would take 37.7 GB."""
    n = t.shape[-1]
    cols = max(1, BLOCK_ELEMENTS * n // max(t.numel(), 1))
    return [slice(j, j + cols) for j in range(0, max(n, 1), cols)]


def quantize(x: torch.Tensor, wl: int, axis: int = 0) -> QuantizedTensor:
    """Symmetric per-vector quantization of `x`, scales shared along
    `axis` (the reduction axis of the matmul the tensor feeds). A tensor
    of more than BLOCK_ELEMENTS elements whose scales run along another
    axis than the last goes in `column_blocks`, each with its own scales
    (a bfloat16 head of 18432 x 256,000 would otherwise take several
    18.9 GB float32 copies at once)."""
    m = qmax(wl)
    if (x.numel() > BLOCK_ELEMENTS and axis % x.ndim != x.ndim - 1
            and x.shape[-1] > 1):
        parts = [quantize(x[..., cols], wl, axis)
                 for cols in column_blocks(x)]
        return QuantizedTensor(torch.cat([p.values for p in parts], -1),
                               torch.cat([p.scale for p in parts], -1), wl,
                               axis)
    scale = symmetric_scale(x.abs().amax(dim=axis, keepdim=True), m)
    q = torch.clamp(torch.round(x / scale), -m, m).to(torch.int8)
    return QuantizedTensor(q, scale, wl, axis)


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """Pack int8-carried int4 codes two per byte along the last axis:
    element 2i in the low nibble of byte i, element 2i+1 in the high
    nibble. Values must lie in [-8, 7]; the last dim must be even."""
    if codes.shape[-1] % 2:
        raise ValueError(
            f"pack_int4 needs an even last dim, got shape {tuple(codes.shape)}")
    c = codes.to(torch.int32)
    lo = c[..., 0::2] & 0x0F
    hi = (c[..., 1::2] & 0x0F) << 4
    return (lo | hi).to(torch.uint8).view(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_int4 (sign-extends each nibble), in int8: the low
    nibble shifted to the top and arithmetically back, the high nibble
    shifted down arithmetically."""
    lo = torch.bitwise_right_shift(torch.bitwise_left_shift(packed, 4), 4)
    hi = torch.bitwise_right_shift(packed, 4)
    out = torch.stack([lo, hi], dim=-1)
    return out.reshape(*packed.shape[:-1], packed.shape[-1] * 2)


def packed_pad_ok(dim: int) -> bool:
    """The reference's packing rule, kept so both packages store the same
    bytes: the TPU kernels pad a packed axis to a multiple of 256 lanes and
    its int8 carrier to 128, and pack only where the two round-ups agree.
    The CUDA kernels need only a packed axis divisible by 4 (whole 2-byte
    loads), so every axis this rule admits is one they take."""
    return -(-dim // 256) * 256 == -(-dim // 128) * 128


def packs(wl: int, dim: int) -> bool:
    """Whether a `wl`-bit weight is stored packed along a last axis of
    `dim`: W4 with an even axis that `packed_pad_ok` admits. The one
    packing rule: compression (`packable`), the H100 cost model and the
    launch keys it is checked with all ask it."""
    return wl == 4 and dim % 2 == 0 and packed_pad_ok(dim)


def packable(q: QuantizedTensor) -> bool:
    """W4 codes that `packs` admits, not already packed."""
    return not q.packed and packs(q.wl, int(q.values.shape[-1]))


def pack_weights(q: QuantizedTensor) -> QuantizedTensor:
    """Move a W4 tensor to the packed layout (exact: codes unchanged).
    Non-packable tensors are returned as they are."""
    if not packable(q):
        return q
    return dataclasses.replace(q, values=pack_int4(q.values), packed=True)


def unpack_weights(q: QuantizedTensor) -> QuantizedTensor:
    """Inverse of pack_weights: back to the int8-carrier layout."""
    if not q.packed:
        return q
    return dataclasses.replace(q, values=unpack_int4(q.values), packed=False)
