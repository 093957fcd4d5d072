"""ITERA-LLM iterative tensor decomposition (paper Alg. 1), port of
`repro.core.itera`.

Each step takes the top singular pair of the current residual by power
iteration, quantizes the rank-1 pair (one scale per singular vector), and
subtracts the QUANTIZED product from the residual, so later steps
compensate the quantization error of earlier ones. Scan-stacked weights
(..., K, N) run as one batch through `torch.matmul`, where the reference
vmaps.

The random warm starts come from a CPU `torch.Generator` seeded per step
(`seed`, k), so a rank-r decomposition is exactly the first r steps of a
longer one (`truncate` relies on this) and the CPU and CUDA runs start
from the same vectors. They are not jax's numbers, so codes differ from
the reference's; the tests compare reconstruction error instead.
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


def _quant_vec(x: torch.Tensor, wl: int):
    """Single-scale symmetric quantization of each singular vector of the
    (B, D) batch: codes (B, D) int8 and scales (B, 1) fp32."""
    m = qmax(wl)
    scale = symmetric_scale(x.abs().amax(dim=-1, keepdim=True), m)
    q = torch.clamp(torch.round(x / scale), -m, m).to(torch.int8)
    return q, scale


def itera_decompose(w: torch.Tensor, rank: int, wl: int, *,
                    power_iters: int = 24, seed: int = 0) -> LowRankQ:
    """Paper Algorithm 1 on a (..., K, N) weight. Returns LowRankQ with
    int8-carried codes and fp32 per-vector scales; leading dims stay
    leading dims of every factor array."""
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


def truncate(lr: LowRankQ, rank: int) -> LowRankQ:
    """First-r-components decomposition (equal to running Algorithm 1 with
    target rank r, by the per-step warm starts)."""
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
