"""nemotron-4-340b [dense] (copy of `repro.configs.nemotron_4_340b`): GQA
kv=8, squared-ReLU MLP (no gate: six linears a layer), LayerNorm with a
bias, half the head dims rotary, bfloat16. [arXiv:2402.16819; unverified]"""
from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-340b",
        layout="dense",
        num_layers=96,
        d_model=18432,
        num_heads=96,
        num_kv_heads=8,
        d_ff=73728,
        vocab_size=256000,
        mlp_act="relu2",                  # squared ReLU
        norm="layernorm",
        rope_theta=10000.0,
        rotary_pct=0.5,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-340b-smoke",
        layout="dense",
        num_layers=2,
        d_model=96,
        num_heads=6,
        num_kv_heads=2,
        d_ff=384,
        vocab_size=256,
        mlp_act="relu2",
        norm="layernorm",
        rotary_pct=0.5,
        dtype="float32",
        remat=False,
    )
