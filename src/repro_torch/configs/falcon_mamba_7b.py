"""falcon-mamba-7b [ssm] (copy of `repro.configs.falcon_mamba_7b`):
attention-free Mamba1 architecture. [arXiv:2410.05355; unverified]"""
from repro_torch.configs.base import ModelConfig, SSMConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b",
        layout="ssm",
        num_layers=64,
        d_model=4096,
        num_heads=1,                     # unused (attention-free)
        num_kv_heads=1,
        head_dim=64,
        d_ff=0,
        vocab_size=65024,
        ssm=SSMConfig(version=1, d_state=16, d_conv=4, expand=2,
                      dt_rank=256),
        pos_emb="none",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b-smoke",
        layout="ssm",
        num_layers=2,
        d_model=64,
        num_heads=1,
        num_kv_heads=1,
        head_dim=64,
        d_ff=0,
        vocab_size=256,
        ssm=SSMConfig(version=1, d_state=8, d_conv=4, expand=2, dt_rank=8),
        pos_emb="none",
        dtype="float32",
        remat=False,
    )
