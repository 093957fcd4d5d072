"""deepseek-moe-16b [moe] (copy of `repro.configs.deepseek_moe_16b`):
2 shared + 64 routed experts top-6, fine-grained. [arXiv:2401.06066; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b",
        layout="moe",
        num_layers=28,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=1408,                        # per fine-grained expert
        vocab_size=102400,
        moe=MoEConfig(num_experts=64,
                      top_k=6,
                      num_shared=2,
                      capacity_factor=1.25),
        mlp_act="swiglu",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b-smoke",
        layout="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=48,
        vocab_size=256,
        # cf = E/k: dropless in the smoke tests (prefix consistency)
        moe=MoEConfig(num_experts=8, top_k=3, num_shared=1,
                      capacity_factor=2.7),
        mlp_act="swiglu",
        dtype="float32",
        remat=False,
    )
