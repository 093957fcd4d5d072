"""opus-mt proxy, the paper's own model family (copy of
`repro.configs.opus_mt`): a 12-layer decoder-only stand-in with OPUS-MT's
linear-layer geometry (d_model 512, 8 heads, d_ff 2048, vocab 32000)."""
from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="opus-mt",
        layout="dense",
        num_layers=12,
        d_model=512,
        num_heads=8,
        num_kv_heads=8,
        d_ff=2048,
        vocab_size=32000,
        mlp_act="gelu",
        norm="layernorm",
        pos_emb="sinusoidal",
        dtype="float32",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="opus-mt-smoke",
        layout="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        mlp_act="gelu",
        norm="layernorm",
        pos_emb="sinusoidal",
        dtype="float32",
        remat=False,
    )
