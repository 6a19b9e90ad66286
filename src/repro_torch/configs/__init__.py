"""Architecture config registry of the port.

``get_config(name)`` returns the exact published config;
``get_config(name, reduced=True)`` the structurally identical smoke
variant. ``ARCH_NAMES`` lists only the architectures the port can
build; the reference's others raise ``KeyError`` until their families
are ported (ROADMAP A11).
"""
from __future__ import annotations

from repro_torch.configs import mamba2_1_3b, qwen3_4b
from repro_torch.configs.base import (AUDIO, DENSE, FAMILIES, HYBRID, MOE,
                                      SSM, VLM, ModelConfig)

_REGISTRY = {m.CONFIG.name: m.CONFIG for m in (qwen3_4b, mamba2_1_3b)}

ARCH_NAMES = tuple(_REGISTRY)


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"arch {name!r} is not ported (ROADMAP A11); "
                       f"available: {sorted(_REGISTRY)}")
    cfg = _REGISTRY[name]
    return cfg.reduced() if reduced else cfg


__all__ = ["ARCH_NAMES", "ModelConfig", "get_config", "DENSE", "MOE", "SSM",
           "HYBRID", "VLM", "AUDIO", "FAMILIES"]
