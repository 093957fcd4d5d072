"""zamba2-2.7b [hybrid] (copy of `repro.configs.zamba2_2p7b`): Mamba2
backbone with a shared-weight attention block invoked every
`hybrid_period` layers (fresh KV cache per invocation).
[arXiv:2411.15242; hf]"""
from repro_torch.configs.base import ModelConfig, SSMConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b",
        layout="hybrid",
        num_layers=54,
        d_model=2560,
        num_heads=32,
        num_kv_heads=32,
        d_ff=10240,                      # shared transformer block MLP
        vocab_size=32000,
        hybrid_period=6,                 # 9 shared-attn invocations
        ssm=SSMConfig(version=2, d_state=64, d_conv=4, expand=2,
                      head_dim=64),
        mlp_act="gelu",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b-smoke",
        layout="hybrid",
        num_layers=4,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        hybrid_period=2,
        ssm=SSMConfig(version=2, d_state=8, d_conv=4, expand=2, head_dim=32),
        mlp_act="gelu",
        dtype="float32",
        remat=False,
    )
