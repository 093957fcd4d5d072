"""musicgen-medium [audio] (copy of `repro.configs.musicgen_medium`): a
decoder-only transformer over EnCodec tokens. The EnCodec frontend is a
stub: training feeds rows of a seeded embedding table
(`data.pipeline.lift_to_embeddings`); serving takes codec token ids.
[arXiv:2306.05284; hf]"""
from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        layout="dense",
        num_layers=48,
        d_model=1536,
        num_heads=24,
        num_kv_heads=24,
        d_ff=6144,
        vocab_size=2048,                  # EnCodec codebook
        frontend="audio",
        pos_emb="sinusoidal",
        mlp_act="gelu",
        norm="layernorm",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium-smoke",
        layout="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=128,
        frontend="audio",
        pos_emb="sinusoidal",
        mlp_act="gelu",
        norm="layernorm",
        dtype="float32",
        remat=False,
    )
