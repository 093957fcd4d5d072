"""chameleon-34b [vlm] (copy of `repro.configs.chameleon_34b`): an
early-fusion decoder over a unified text + VQ-image token vocabulary. The
VQ image tokenizer is a stub: training feeds rows of a seeded embedding
table (`data.pipeline.lift_to_embeddings`); serving takes token ids.
[arXiv:2405.09818; unverified]"""
from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b",
        layout="dense",
        num_layers=48,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=22016,
        vocab_size=65536,                # text + VQ codes, early fusion
        frontend="vision",
        mlp_act="swiglu",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b-smoke",
        layout="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=160,
        vocab_size=256,
        frontend="vision",
        mlp_act="swiglu",
        dtype="float32",
        remat=False,
    )
