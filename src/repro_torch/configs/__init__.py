"""Architecture registry of the port. Only opus-mt is ported so far; the
other architectures of `repro.configs` come with later slices."""
from __future__ import annotations

from repro_torch.configs import opus_mt
from repro_torch.configs.base import ModelConfig

_MODULES = {"opus-mt": opus_mt}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = _MODULES[arch]
    return mod.smoke() if smoke else mod.full()


__all__ = ["ModelConfig", "get_config"]
