"""phi3-medium-14b [dense] (copy of `repro.configs.phi3_medium_14b`):
RoPE + SwiGLU + GQA kv=10, bfloat16. [arXiv:2404.14219; unverified]"""
from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-14b",
        layout="dense",
        num_layers=40,
        d_model=5120,
        num_heads=40,
        num_kv_heads=10,
        d_ff=17920,
        vocab_size=100352,
        mlp_act="swiglu",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-14b-smoke",
        layout="dense",
        num_layers=2,
        d_model=80,
        num_heads=4,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=256,
        mlp_act="swiglu",
        dtype="float32",
        remat=False,
    )
