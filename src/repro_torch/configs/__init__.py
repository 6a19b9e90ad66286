"""Architecture config registry of the port.

``get_config(name)`` returns the exact published config;
``get_config(name, reduced=True)`` the structurally identical smoke
variant; ``get_shape`` the input-shape cells of ``SHAPES``.
``ARCH_NAMES`` lists the reference's ten architectures in its registry
order; the port builds every one of them.
"""
from __future__ import annotations

from repro_torch.configs import (gemma3_1b, hymba_1_5b, internvl2_1b,
                                 mamba2_1_3b, mistral_nemo_12b, qwen3_4b,
                                 qwen3_moe_30b_a3b, qwen3_moe_235b_a22b,
                                 qwen25_14b, whisper_tiny)
from repro_torch.configs.base import (AUDIO, DENSE, FAMILIES, HYBRID,
                                      LONG_CONTEXT_ARCHS, MOE, SHAPES, SSM,
                                      VLM, ModelConfig, ShapeConfig,
                                      shape_applicable)

_REGISTRY = {m.CONFIG.name: m.CONFIG
             for m in (mistral_nemo_12b, gemma3_1b, qwen25_14b, qwen3_4b,
                       hymba_1_5b, qwen3_moe_235b_a22b, qwen3_moe_30b_a3b,
                       internvl2_1b, whisper_tiny, mamba2_1_3b)}

ARCH_NAMES = tuple(_REGISTRY)


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; "
                       f"available: {sorted(_REGISTRY)}")
    cfg = _REGISTRY[name]
    return cfg.reduced() if reduced else cfg


def get_shape(name: str, reduced: bool = False) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(SHAPES)}")
    shp = SHAPES[name]
    return shp.reduced() if reduced else shp


__all__ = ["ARCH_NAMES", "SHAPES", "LONG_CONTEXT_ARCHS", "ModelConfig",
           "ShapeConfig", "get_config", "get_shape", "shape_applicable",
           "DENSE", "MOE", "SSM", "HYBRID", "VLM", "AUDIO", "FAMILIES"]
