"""Architecture registry of the port: opus-mt, and phi3-medium-14b,
stablelm-12b, gemma2-9b (local and global attention layers in
alternation), nemotron-4-340b (squared ReLU), and the two modality-frontend
archs chameleon-34b and musicgen-medium (bfloat16 at full size) in the
dense layout; the two mixture-of-experts architectures, deepseek-moe-16b
and mixtral-8x22b; the attention-free Mamba1 falcon-mamba-7b (layout
"ssm") and the Mamba2 hybrid zamba2-2.7b (layout "hybrid")."""
from __future__ import annotations

from repro_torch.configs import (chameleon_34b, deepseek_moe_16b,
                                 falcon_mamba_7b, gemma2_9b, mixtral_8x22b,
                                 musicgen_medium, nemotron_4_340b, opus_mt,
                                 phi3_medium_14b, stablelm_12b, zamba2_2p7b)
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

_MODULES = {"opus-mt": opus_mt, "deepseek-moe-16b": deepseek_moe_16b,
            "mixtral-8x22b": mixtral_8x22b,
            "phi3-medium-14b": phi3_medium_14b,
            "stablelm-12b": stablelm_12b, "gemma2-9b": gemma2_9b,
            "nemotron-4-340b": nemotron_4_340b,
            "chameleon-34b": chameleon_34b,
            "musicgen-medium": musicgen_medium,
            "falcon-mamba-7b": falcon_mamba_7b,
            "zamba2-2.7b": zamba2_2p7b}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = _MODULES[arch]
    return mod.smoke() if smoke else mod.full()


__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "get_config"]
