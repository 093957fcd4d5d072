"""Model configuration schema (the port's copy of `repro.configs.base`).

Only the fields the port reads are kept: dense layouts with causal
attention (optionally windowed; `local_global_period` only so that the
port can refuse the local/global pairing), the whole-sequence attention's
implementation, the MLP and norm flavors, the KV-cache word length, the
input frontend, and the training-time policy (remat, the loss's chunk).
Field names and defaults match the reference, so a config reads the same
in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    layout: str = "dense"          # dense (the only layout ported so far)
    num_layers: int = 4
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 1024
    head_dim: Optional[int] = None  # default d_model // num_heads

    # attention flavor
    attn_window: Optional[int] = None
    local_global_period: int = 0
    logit_softcap: float = 0.0
    final_softcap: float = 0.0
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0
    pos_emb: str = "rope"                   # rope | sinusoidal | none
    attn_impl: str = "auto"                 # auto | full | chunked
    attn_chunk: int = 1024                  # KV block for chunked attention

    # MLP flavor
    mlp_act: str = "swiglu"                 # swiglu | relu2 | gelu | geglu

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
