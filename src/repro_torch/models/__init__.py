"""Model registry: dispatch on ``ModelConfig.family`` (port of
``repro.models``).  Every family trains and serves: ``dense`` and ``vlm``
(the transformer, homogeneous or patterned, with interleaved
cross-attention layers), ``moe`` (MLA, routed experts, MTP), ``ssm``,
``hybrid`` and ``audio`` (the whisper encoder-decoder); serving is
prefill, one-token decode and their caches.  Under a rank mesh with a
model axis, ``ModelFns.tensor_plan`` gives the leaves the dense family's
layers split over it (``sharding.partition.tensor_plan``): the round
engine takes the plan (``engine.rounds.init_state(..., plan=...)``), and
the layers read their local head counts and blocks from the shapes they
are given."""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding import partition


class ModelFns(NamedTuple):
    init: object             # (gen, cfg, device) -> params
    forward: object          # (params, cfg, tokens[, media=]) -> logits,
                             # or for moe (logits, aux[, mtp_logits]);
                             # media [B, M, d_media or d] for vlm / audio
    param_shapes: object     # cfg -> the params' tree of leaf shapes
    prefill: object          # (params, cfg, tokens, cache_len[, media=])
                             # -> (logits [B, 1, V], cache)
    decode_step: object      # (params, cfg, token, cache, pos) ->
                             # (logits [B, 1, V], cache)
    init_decode_cache: object  # (cfg, batch, cache_len[, media, params,
                               # device]) -> cache
    param_rules: object      # [(path regex, logical axes)] (models.rules)
    tensor_plan: object      # (spec[, size]) -> sharding.partition.
                             # TensorPlan: the leaves the model axis of
                             # the active rank mesh splits (none outside
                             # the dense family)


def build(cfg: ModelConfig) -> ModelFns:
    if cfg.family in ("dense", "vlm"):
        from repro_torch.models import transformer as m
        from repro_torch.models.rules import dense_rules as rules
    elif cfg.family == "moe":
        from repro_torch.models import moe_transformer as m
        from repro_torch.models.rules import moe_rules as rules
    elif cfg.family == "ssm":
        from repro_torch.models import mamba2 as m
        from repro_torch.models.rules import ssm_rules as rules
    elif cfg.family == "hybrid":
        from repro_torch.models import griffin as m
        from repro_torch.models.rules import hybrid_rules as rules
    elif cfg.family == "audio":
        from repro_torch.models import whisper as m
        from repro_torch.models.rules import audio_rules as rules
    else:
        raise ValueError(f"unknown family {cfg.family}")
    return ModelFns(m.init, m.forward, m.param_shapes, m.prefill,
                    m.decode_step, m.init_decode_cache, rules(cfg),
                    functools.partial(partition.tensor_plan, cfg))


def params_from_numpy(tree, device=None):
    """A nested dict (or list) of numpy arrays -- e.g. the JAX package's
    parameters after ``jax.device_get`` -- as the port's tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return torch.from_numpy(np.array(tree, copy=True)).to(device)
