"""gemma2-9b [dense] (copy of `repro.configs.gemma2_9b`): local and global
attention layers in alternation (local window 4096 on even layers), logit
soft caps, GeGLU, head_dim 256 decoupled from d_model / H, tied
embeddings, bfloat16. [arXiv:2408.00118; hf]"""
from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b",
        layout="dense",
        num_layers=42,
        d_model=3584,
        num_heads=16,
        num_kv_heads=8,
        head_dim=256,
        d_ff=14336,
        vocab_size=256000,
        local_global_period=2,
        local_window=4096,
        logit_softcap=50.0,
        final_softcap=30.0,
        mlp_act="geglu",
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b-smoke",
        layout="dense",
        num_layers=4,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=128,
        vocab_size=256,
        local_global_period=2,
        local_window=8,
        logit_softcap=50.0,
        final_softcap=30.0,
        mlp_act="geglu",
        tie_embeddings=True,
        dtype="float32",
        remat=False,
    )
