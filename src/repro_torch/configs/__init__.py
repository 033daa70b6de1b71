"""Config registry: ``get_config(name)`` / ``get_reduced(name)`` (port of
``repro.configs``; only the architectures ported so far are registered)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (CompressorConfig,  # noqa: F401
                                      FedConfig, FleetConfig, ModelConfig,
                                      ScaleConfig, SwitchConfig,
                                      reduce_model)

ALIASES = {"smollm-360m": "smollm_360m"}


def _module(name: str):
    mod = ALIASES.get(name)
    if mod is None:
        raise NotImplementedError(
            f"architecture {name!r} is not ported yet; ported: "
            f"{sorted(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    return _module(name).reduced()
