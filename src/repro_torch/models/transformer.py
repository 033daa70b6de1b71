"""Dense decoder-only transformer, homogeneous stack, training forward (port
of ``repro.models.transformer``: ``init`` and ``forward`` for the dense
stack; patterned stacks, prefill and decode are not ported yet).

Parameters are a nested dict laid out as the reference's pytree, per-layer
leaves stacked on a leading ``[n_layers]`` axis::

    {"embed": [V, d], "ln_f": [d],
     "layers": {"attn": {"wq", "wk", "wv", "wo"}, "ln1": [L, d], "ln2": [L, d],
                "mlp": {"w_gate", "w_up", "w_down"}}}
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.local_global_ratio or cfg.cross_attn_every:
        raise NotImplementedError(
            "patterned transformer stacks are not ported yet")


def param_shapes(cfg: ModelConfig) -> dict:
    """Nested dict of leaf shapes (the layout :func:`init` fills)."""
    _check_dense(cfg)
    d, L, hd = cfg.d_model, cfg.n_layers, cfg.resolved_head_dim
    shapes = {"embed": (cfg.vocab, d), "ln_f": (d,)}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab)
    attn = attention.attn_shapes(d, cfg.n_heads, cfg.n_kv_heads, hd)
    shapes["layers"] = {
        "attn": {k: (L,) + s for k, s in attn.items()},
        "ln1": (L, d), "ln2": (L, d),
        "mlp": {"w_gate": (L, d, cfg.d_ff), "w_up": (L, d, cfg.d_ff),
                "w_down": (L, cfg.d_ff, d)}}
    return shapes


def init(gen: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    """Random weights (the reference's distributions, not its bits): fan-in
    scaled normals per layer, 0.02-scaled embedding, zero norm gains."""
    def make(path, shape):
        if path[-1] in ("ln1", "ln2", "ln_f"):
            return torch.zeros(shape, dtype=torch.float32, device=device)
        if path[-1] == "embed":
            return common.embed_init(gen, *shape, device=device)
        # per-layer fan-in is the first axis after the stacked layer axis
        return common.dense_init(gen, shape, in_axis=len(shape) - 2,
                                 device=device)

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        return make(path, tree)
    return walk(param_shapes(cfg), ())


def _mlp(p, x):
    return common.swiglu(x, p["w_gate"], p["w_up"], p["w_down"])


def _logits(params, cfg: ModelConfig, h):
    h = common.rms_norm(h, params["ln_f"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ w


def forward(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """tokens ``[B, S]`` -> logits ``[B, S, V]``."""
    _check_dense(cfg)
    B, S = tokens.shape
    h = params["embed"][tokens] * math.sqrt(float(cfg.d_model))
    positions = torch.arange(S, device=tokens.device)
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
              head_dim=cfg.resolved_head_dim, positions=positions,
              theta=cfg.rope_theta, window=cfg.window)
    # unbind once per stacked leaf: its backward stacks the per-layer
    # gradients in one allocation (indexing layer by layer would build a
    # full-stack zero gradient for every layer)
    layers = params["layers"]
    attn = {k: v.unbind(0) for k, v in layers["attn"].items()}
    mlp = {k: v.unbind(0) for k, v in layers["mlp"].items()}
    ln1, ln2 = layers["ln1"].unbind(0), layers["ln2"].unbind(0)
    for i in range(cfg.n_layers):
        a = attention.self_attention(
            {k: v[i] for k, v in attn.items()},
            common.rms_norm(h, ln1[i], cfg.norm_eps), **kw)
        h = h + a
        h = h + _mlp({k: v[i] for k, v in mlp.items()},
                     common.rms_norm(h, ln2[i], cfg.norm_eps))
    return _logits(params, cfg, h)
