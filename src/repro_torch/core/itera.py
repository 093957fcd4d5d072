"""ITERA-LLM iterative tensor decomposition (paper Alg. 1) and the
SVD-then-quantize baseline (paper §VIII-B), port of `repro.core.itera`.

Each step of Algorithm 1 takes the top singular pair of the current
residual, quantizes the rank-1 pair (one scale per singular vector), and
subtracts the QUANTIZED product from the residual, so later steps
compensate the quantization error of earlier ones. Two rank-1 engines, as
in the reference: "power" (power iteration, the default) and "svd" (the
exact top triple of a full SVD of the residual, the paper's listing).
Scan-stacked weights (..., K, N) run as one batch, where the reference
vmaps.

The power engine's random warm starts come from a CPU `torch.Generator`
seeded per step (`seed`, k), so a rank-r decomposition is exactly the
first r steps of a longer one (`truncate` relies on this) and the CPU and
CUDA runs start from the same vectors. They are not jax's numbers, so
codes differ from the reference's; the tests compare reconstruction error
instead. SVDs are `torch.linalg.svd` (LAPACK on the CPU, cuSOLVER on the
card): singular values agree with jax's to float32 rounding, but each
singular vector's sign is the library's choice, so the svd paths give the
reference's codes up to a sign per component and a last-bit flip of a
few codes.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.quant import QuantizedTensor, qmax, symmetric_scale


@dataclasses.dataclass(frozen=True)
class LowRankQ:
    """Quantized rank-r factorization W ≈ dequant(w1) @ dequant(w2).

    w1: (K, r) codes, scale (1, r); w2: (r, N) codes, scale (r, 1).
    A storage node: `models.layers.apply_linear` dispatches it to
    `kernels.ops.lrmm`, y = (x @ W1') @ W2' without reconstructing W.
    """

    w1: QuantizedTensor
    w2: QuantizedTensor

    @property
    def rank(self) -> int:
        return self.w1.shape[-1]

    @property
    def act_wl(self) -> int:
        return self.w1.act_wl

    def dequant_product(self) -> torch.Tensor:
        return self.w1.dequant() @ self.w2.dequant()

    def storage_bits(self) -> int:
        return self.w1.storage_bits() + self.w2.storage_bits()

    def nops(self, batch_m: int) -> int:
        """MACs for a batch of M rows: M·K·r + M·r·N (paper's NOps metric)."""
        k, r = map(int, self.w1.shape)
        _, n = map(int, self.w2.shape)
        return batch_m * r * (k + n)

    def to(self, device) -> "LowRankQ":
        return LowRankQ(self.w1.to(device), self.w2.to(device))


def warm_start(seed: int, k: int, n: int) -> torch.Tensor:
    """Unit-norm random start vector of step k (fp32, on the CPU)."""
    g = torch.Generator().manual_seed(seed * 1_000_003 + k)
    v0 = torch.randn(n, generator=g, dtype=torch.float32)
    return v0 / torch.linalg.vector_norm(v0)


def _rank1_power(r_mat: torch.Tensor, v0: torch.Tensor, iters: int = 24):
    """Top singular triple of each (K, N) matrix of the (B, K, N) batch by
    power iteration on RᵀR, warm-started at v0 (B, N)."""
    v = v0
    for _ in range(iters):
        u = torch.matmul(r_mat, v[..., None])[..., 0]
        u = u / (torch.linalg.vector_norm(u, dim=-1, keepdim=True) + 1e-30)
        v = torch.matmul(u[..., None, :], r_mat)[..., 0, :]
        v = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-30)
    u = torch.matmul(r_mat, v[..., None])[..., 0]
    s = torch.linalg.vector_norm(u, dim=-1, keepdim=True)
    return u / (s + 1e-30), s, v


def _rank1_svd(r_mat: torch.Tensor):
    """Exact top singular triple of each matrix of the (B, K, N) batch via
    a full SVD (paper listing: SVD(R)_1)."""
    u, s, vt = torch.linalg.svd(r_mat, full_matrices=False)
    return u[..., :, 0], s[..., 0:1], vt[..., 0, :]


def _quant_vec(x: torch.Tensor, wl: int):
    """Single-scale symmetric quantization of each singular vector of the
    (B, D) batch: codes (B, D) int8 and scales (B, 1) fp32."""
    m = qmax(wl)
    scale = symmetric_scale(x.abs().amax(dim=-1, keepdim=True), m)
    q = torch.clamp(torch.round(x / scale), -m, m).to(torch.int8)
    return q, scale


def itera_decompose(w: torch.Tensor, rank: int, wl: int, *,
                    method: str = "power", power_iters: int = 24,
                    seed: int = 0) -> LowRankQ:
    """Paper Algorithm 1 on a (..., K, N) weight with the "power" (default)
    or "svd" rank-1 engine. Returns LowRankQ with int8-carried codes and
    fp32 per-vector scales; leading dims stay leading dims of every
    factor array."""
    if method not in ("power", "svd"):
        raise ValueError(f"unknown rank-1 engine {method!r}")
    lead = tuple(w.shape[:-2])
    k_dim, n_dim = int(w.shape[-2]), int(w.shape[-1])
    resid = w.to(torch.float32).reshape(-1, k_dim, n_dim).clone()
    b = resid.shape[0]
    dev = resid.device
    w1 = torch.empty((b, k_dim, rank), dtype=torch.int8, device=dev)
    w2 = torch.empty((b, rank, n_dim), dtype=torch.int8, device=dev)
    s1 = torch.empty((b, rank), dtype=torch.float32, device=dev)
    s2 = torch.empty((b, rank), dtype=torch.float32, device=dev)
    for k in range(rank):
        if method == "svd":
            u, s, v = _rank1_svd(resid)
        else:
            v0 = warm_start(seed, k, n_dim).to(dev).expand(b, n_dim)
            u, s, v = _rank1_power(resid, v0, power_iters)
        sq = torch.sqrt(torch.clamp(s, min=0.0))
        q1, sc1 = _quant_vec(u * sq, wl)
        q2, sc2 = _quant_vec(v * sq, wl)
        # the residual update uses the QUANTIZED product: the error
        # compensation at the heart of the paper
        resid -= ((q1.to(torch.float32) * sc1)[:, :, None]
                  * (q2.to(torch.float32) * sc2)[:, None, :])
        w1[:, :, k] = q1
        w2[:, k, :] = q2
        s1[:, k] = sc1[:, 0]
        s2[:, k] = sc2[:, 0]
    return LowRankQ(
        QuantizedTensor(w1.reshape(*lead, k_dim, rank),
                        s1.reshape(*lead, 1, rank), wl, axis=0),
        QuantizedTensor(w2.reshape(*lead, rank, n_dim),
                        s2.reshape(*lead, rank, 1), wl, axis=1))


def svd_decompose(w: torch.Tensor, rank: int, wl: int) -> LowRankQ:
    """Baseline (paper §VIII-B): one-shot truncated SVD of a (..., K, N)
    weight, then vector-wise quantization of the produced factors; the
    same storage format as ITERA.

    The scales are the reference's `max(absmax, 1e-30) / qmax` taken as
    a multiply by the float32 reciprocal (the reference divides by the
    constant under jit, which XLA lowers to that product); the codes
    divide by the scales truly."""
    w = w.to(torch.float32)
    u, s, vt = torch.linalg.svd(w, full_matrices=False)
    sq = torch.sqrt(torch.clamp(s[..., :rank], min=0.0))
    w1f = u[..., :, :rank] * sq[..., None, :]          # (..., K, r)
    w2f = vt[..., :rank, :] * sq[..., :, None]         # (..., r, N)
    m = qmax(wl)
    inv = 1.0 / m
    s1 = torch.clamp(w1f.abs().amax(dim=-2, keepdim=True), min=1e-30) * inv
    s2 = torch.clamp(w2f.abs().amax(dim=-1, keepdim=True), min=1e-30) * inv
    w1q = torch.clamp(torch.round(w1f / s1), -m, m).to(torch.int8)
    w2q = torch.clamp(torch.round(w2f / s2), -m, m).to(torch.int8)
    return LowRankQ(QuantizedTensor(w1q, s1, wl, axis=0),
                    QuantizedTensor(w2q, s2, wl, axis=1))


def truncate(lr: LowRankQ, rank: int) -> LowRankQ:
    """First-r-components decomposition: for ITERA equal to running
    Algorithm 1 with target rank r (by the per-step warm starts), for the
    SVD baseline to truncated SVD + vector-wise quantization."""
    if lr.w1.packed or lr.w2.packed:
        raise ValueError("truncate() operates on carrier-layout factors; "
                         "unpack_weights the node first")
    return LowRankQ(
        dataclasses.replace(lr.w1, values=lr.w1.values[..., :rank],
                            scale=lr.w1.scale[..., :rank]),
        dataclasses.replace(lr.w2, values=lr.w2.values[..., :rank, :],
                            scale=lr.w2.scale[..., :rank, :]),
    )


def reconstruction_error(w: torch.Tensor, lr: LowRankQ) -> torch.Tensor:
    """Relative Frobenius reconstruction error ‖W − W1'W2'‖_F / ‖W‖_F."""
    return torch.linalg.norm(w - lr.dequant_product()) / (
        torch.linalg.norm(w) + 1e-30)
