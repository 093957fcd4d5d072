"""stablelm-12b [dense] (copy of `repro.configs.stablelm_12b`): GQA
kv=8, LayerNorm, 25% partial rotary, bfloat16.
[hf:stabilityai/stablelm-2-1_6b; hf]"""
from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="stablelm-12b",
        layout="dense",
        num_layers=40,
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        d_ff=13824,
        vocab_size=100352,
        mlp_act="swiglu",
        norm="layernorm",
        rotary_pct=0.25,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="stablelm-12b-smoke",
        layout="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=192,
        vocab_size=256,
        mlp_act="swiglu",
        norm="layernorm",
        rotary_pct=0.25,
        dtype="float32",
        remat=False,
    )
