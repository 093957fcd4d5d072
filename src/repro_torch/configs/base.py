"""Model configuration schema (the port's copy of `repro.configs.base`).

Only the fields the port reads are kept: the dense and mixture-of-experts
layouts with causal attention (optionally windowed, or local and global
layers in alternation: `local_global_period`, `local_window`), the
attention-free Mamba layout ("ssm") and the Mamba2 backbone with a shared
attention block ("hybrid", `hybrid_period`), the whole-sequence
attention's implementation, the MLP and norm flavors, the experts
(`MoEConfig`) and the Mamba blocks (`SSMConfig`), the KV-cache word
length, the input frontend, and the training-time policy (remat, the
loss's chunk). Field names and defaults match the reference, so a config
reads the same in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    num_shared: int = 0            # shared (always-on) experts, deepseek-style
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    version: int = 1               # 1 = Mamba1 selective scan, 2 = Mamba2 SSD
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64             # Mamba2 only
    dt_rank: Optional[int] = None  # default d_model // 16
    chunk: int = 128               # chunked-scan block (perf option)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    layout: str = "dense"          # dense | moe | ssm | hybrid
    num_layers: int = 4
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 1024
    head_dim: Optional[int] = None  # default d_model // num_heads

    # attention flavor
    attn_window: Optional[int] = None
    local_global_period: int = 0            # >0: alternate local/global
    local_window: int = 4096                # window of the "local" layers
    logit_softcap: float = 0.0
    final_softcap: float = 0.0
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0
    pos_emb: str = "rope"                   # rope | sinusoidal | none
    attn_impl: str = "auto"                 # auto | full | chunked
    attn_chunk: int = 1024                  # KV block for chunked attention

    # MLP flavor
    mlp_act: str = "swiglu"                 # swiglu | relu2 | gelu | geglu

    # mixture-of-experts / ssm blocks
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid_period: int = 6                  # Zamba2: shared attn every N blocks

    # modality frontend stub: "none" -> token ids; "audio"/"vision" ->
    # precomputed frame/patch embeddings are fed directly
    frontend: str = "none"

    # numerics / norms
    kv_cache_bits: int = 16                 # 16 (model dtype) | 8 (int8+scales)
    norm: str = "rmsnorm"                   # rmsnorm | layernorm
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    tie_embeddings: bool = False

    # training-time policy
    remat: bool = True
    remat_policy: str = "full"              # full | dots (save matmul outs)
    loss_chunk: int = 2048                  # sequence-chunked loss block

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def is_attention_free(self) -> bool:
        return self.layout == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: SSM / hybrid / bounded-window attention."""
        if self.layout in ("ssm", "hybrid"):
            return True
        return self.attn_window is not None and self.local_global_period == 0

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), by the
        reference's formula."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        n = V * d
        if not self.tie_embeddings:
            n += V * d
        hd = self.head_dim
        attn = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd \
            + self.num_heads * hd * d
        mlp = self._mlp_mats() * d * self.d_ff
        if self.layout == "dense":
            return n + L * (attn + mlp)
        if self.layout == "moe":
            e = self.moe.num_experts + self.moe.num_shared
            return n + L * (attn + e * mlp + d * self.moe.num_experts)
        di = d * self.ssm.expand
        if self.layout == "ssm":
            dtr = self.ssm.dt_rank or d // 16
            blk = d * 2 * di + di * (dtr + 2 * self.ssm.d_state) \
                + dtr * di + di * d + di * self.ssm.d_conv \
                + di * self.ssm.d_state
            return n + L * blk
        if self.layout == "hybrid":
            nh = di // self.ssm.head_dim
            blk = d * (2 * di + 2 * self.ssm.d_state + nh) + di * d \
                + di * self.ssm.d_conv
            # mamba2 blocks (no per-block MLP), one shared attention + MLP
            return n + L * blk + attn + mlp
        raise ValueError(self.layout)

    def active_param_count(self) -> int:
        """Active parameters per token (moe: the top-k and shared experts
        only)."""
        if self.layout != "moe":
            return self.param_count()
        mlp = self._mlp_mats() * self.d_model * self.d_ff
        e_all = self.moe.num_experts + self.moe.num_shared
        e_act = self.moe.top_k + self.moe.num_shared
        return self.param_count() - self.num_layers * (e_all - e_act) * mlp

    def _mlp_mats(self) -> int:
        return 3 if self.mlp_act in ("swiglu", "geglu") else 2
