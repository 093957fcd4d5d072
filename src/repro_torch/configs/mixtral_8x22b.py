"""mixtral-8x22b [moe] (copy of `repro.configs.mixtral_8x22b`): 8 experts
top-2, GQA kv=8, sliding-window attention. [arXiv:2401.04088; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b",
        layout="moe",
        num_layers=56,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        d_ff=16384,
        vocab_size=32768,
        attn_window=4096,                 # SWA: an O(window) rolling cache
        moe=MoEConfig(num_experts=8,
                      top_k=2,
                      capacity_factor=1.25),
        mlp_act="swiglu",
        rope_theta=1e6,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b-smoke",
        layout="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        attn_window=8,
        # cf = E/k: dropless in the smoke tests (prefix consistency)
        moe=MoEConfig(num_experts=4, top_k=2, capacity_factor=2.0),
        mlp_act="swiglu",
        dtype="float32",
        remat=False,
    )
