"""Config registry: ``get_config(name)`` / ``get_reduced(name)`` (port of
``repro.configs``; every architecture of the reference is registered)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (INPUT_SHAPES,  # noqa: F401
                                      CompressorConfig, FedConfig,
                                      FleetConfig, InputShape, MLAConfig,
                                      ModelConfig, MoEConfig, RGLRUConfig,
                                      ScaleConfig, SSMConfig, SwitchConfig,
                                      reduce_model)

# canonical ids -> module names, in the reference's order (the sweep's)
ALIASES = {
    "qwen3-4b": "qwen3_4b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "mamba2-130m": "mamba2_130m",
    "minitron-4b": "minitron_4b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "smollm-360m": "smollm_360m",
    "llama-3.2-vision-90b": "llama32_vision_90b",
    "gemma3-4b": "gemma3_4b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "whisper-small": "whisper_small",
}


def _module(name: str):
    mod = ALIASES.get(name)
    if mod is None:
        raise KeyError(f"unknown architecture {name!r}; known: "
                       f"{sorted(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    return _module(name).reduced()


def all_arch_names() -> list:
    return list(ALIASES)
