"""Model registry: dispatch on ``ModelConfig.family`` (port of
``repro.models``; only the dense training forward is ported so far)."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


class ModelFns(NamedTuple):
    init: object             # (gen, cfg, device) -> params
    forward: object          # (params, cfg, tokens) -> logits


def build(cfg: ModelConfig) -> ModelFns:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet")
    from repro_torch.models import transformer as m
    return ModelFns(init=m.init, forward=m.forward)


def params_from_numpy(tree, device=None):
    """A nested dict (or list) of numpy arrays -- e.g. the JAX package's
    parameters after ``jax.device_get`` -- as the port's tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return torch.from_numpy(np.array(tree, copy=True)).to(device)
