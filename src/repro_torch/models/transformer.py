"""Dense decoder-only transformer, training forward (port of
``repro.models.transformer``: ``init`` and ``forward`` for homogeneous
stacks and for patterned stacks -- local:global windows, or the VLM's
interleaved cross-attention layers -- with optional qk-norm; prefill and
decode are not ported yet).

Parameters are a nested dict laid out as the reference's pytree.  A
homogeneous stack keeps its per-layer leaves stacked on a leading
``[n_layers]`` axis::

    {"embed": [V, d], "ln_f": [d],
     "layers": {"attn": {"wq", "wk", "wv", "wo"[, "q_norm", "k_norm"]},
                "ln1": [L, d], "ln2": [L, d],
                "mlp": {"w_gate", "w_up", "w_down"}}}

A patterned stack holds ``"blocks"``, a list of P per-position stacks over
the ``n_full`` whole periods (``[]`` when there is none), and ``"rest"``,
a list of the remainder's unstacked layers.  One period is
``local_global_ratio`` local layers and one global layer, or
``cross_attn_every - 1`` self layers and one cross layer, whose ``attn``
is ``{"wq", "wk", "wv", "wo", "gate"}`` (``gate`` a scalar per layer, 0 at
init); the VLM adds ``"media_proj": [d_media, d]`` when the media are
not ``d``-wide.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common


def _is_patterned(cfg: ModelConfig) -> bool:
    return bool(cfg.local_global_ratio or cfg.cross_attn_every)


def _period(cfg: ModelConfig) -> int:
    if cfg.cross_attn_every:
        return cfg.cross_attn_every
    if cfg.local_global_ratio:
        return cfg.local_global_ratio + 1
    return 1


def _pos_plan(cfg: ModelConfig, pos: int) -> dict:
    """Kind and window of position ``pos`` within a pattern period."""
    P = _period(cfg)
    kind = "self"
    window = cfg.window
    if cfg.cross_attn_every and pos == P - 1:
        kind = "cross"
    if cfg.local_global_ratio:
        window = 0 if pos == P - 1 else cfg.window
    return {"kind": kind, "window": window}


def layer_plan(cfg: ModelConfig) -> list:
    return [_pos_plan(cfg, i % _period(cfg)) for i in range(cfg.n_layers)]


def _split_blocks(cfg: ModelConfig):
    P = _period(cfg)
    n_full = cfg.n_layers // P
    return P, n_full, cfg.n_layers - n_full * P


def _layer_shapes(cfg: ModelConfig, kind: str = "self") -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    if kind == "cross":       # media are projected to d before the layer
        attn = attention.cross_attn_shapes(d, d, cfg.n_heads, cfg.n_kv_heads,
                                           hd)
    else:
        attn = attention.attn_shapes(d, cfg.n_heads, cfg.n_kv_heads, hd,
                                     cfg.qk_norm)
    return {"ln1": (d,), "ln2": (d,), "attn": attn,
            "mlp": {"w_gate": (d, cfg.d_ff), "w_up": (d, cfg.d_ff),
                    "w_down": (cfg.d_ff, d)}}


def param_shapes(cfg: ModelConfig) -> dict:
    """The tree of leaf shapes :func:`init` fills."""
    shapes = {"embed": (cfg.vocab, cfg.d_model), "ln_f": (cfg.d_model,)}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (cfg.d_model, cfg.vocab)
    if cfg.d_media and cfg.d_media != cfg.d_model:
        shapes["media_proj"] = (cfg.d_media, cfg.d_model)
    if _is_patterned(cfg):
        P, n_full, rest = _split_blocks(cfg)
        shapes["blocks"] = [common.stack_shapes(_layer_shapes(
            cfg, _pos_plan(cfg, p)["kind"]), n_full)
            for p in range(P)] if n_full else []
        shapes["rest"] = [_layer_shapes(cfg, _pos_plan(cfg, i)["kind"])
                          for i in range(rest)]
    else:
        shapes["layers"] = common.stack_shapes(_layer_shapes(cfg),
                                               cfg.n_layers)
    return shapes


def init(gen: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    """Random weights (the reference's distributions, not its bits): fan-in
    scaled normals per layer, 0.02-scaled embedding, zero norm gains and
    cross-attention gates."""
    return common.init_tree(gen, param_shapes(cfg), device)


def _apply_layer(lp, cfg: ModelConfig, h, plan, positions, media=None):
    """One layer in train mode: self attention (window from ``plan``), or
    for a cross layer gated attention over ``media`` (``[B, M, d]``);
    then the SwiGLU MLP."""
    hd = cfg.resolved_head_dim
    hn = common.rms_norm(h, lp["ln1"], cfg.norm_eps)
    if plan["kind"] == "cross":
        a = attention.cross_attention(
            lp["attn"], hn, attention.cross_kv(lp["attn"], media,
                                               cfg.n_kv_heads, hd),
            n_heads=cfg.n_heads, head_dim=hd)
    else:
        a = attention.self_attention(
            lp["attn"], hn, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            head_dim=hd, positions=positions, theta=cfg.rope_theta,
            window=plan["window"], qk_norm=cfg.qk_norm,
            norm_eps=cfg.norm_eps)
    h = h + a
    mlp = lp["mlp"]
    return h + common.swiglu(common.rms_norm(h, lp["ln2"], cfg.norm_eps),
                             mlp["w_gate"], mlp["w_up"], mlp["w_down"])


def _run_patterned(params, cfg: ModelConfig, h, positions, media=None):
    """The whole periods in order (each position's layer from its stack),
    then the remainder's layers."""
    P, n_full, _ = _split_blocks(cfg)
    plans = [_pos_plan(cfg, p) for p in range(P)]
    blocks = [common.unstack(b, n_full) for b in params["blocks"]]
    for i in range(n_full):
        for p in range(P):
            h = _apply_layer(blocks[p][i], cfg, h, plans[p], positions,
                             media)
    for i, lp in enumerate(params["rest"]):
        h = _apply_layer(lp, cfg, h, plans[i % P], positions, media)
    return h


def _media_embed(params, media):
    if "media_proj" in params:
        media = media @ params["media_proj"]
    return media


def _logits(params, cfg: ModelConfig, h):
    h = common.rms_norm(h, params["ln_f"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ w


def forward(params, cfg: ModelConfig, tokens: torch.Tensor,
            media: torch.Tensor | None = None) -> torch.Tensor:
    """tokens ``[B, S]`` (and for the cross layers media ``[B, M,
    d_media or d]``, the stub frontend's embeddings) -> logits ``[B, S,
    V]``."""
    S = tokens.shape[1]
    h = params["embed"][tokens] * math.sqrt(float(cfg.d_model))
    positions = torch.arange(S, device=tokens.device)
    if _is_patterned(cfg):
        m = _media_embed(params, media) if media is not None else None
        h = _run_patterned(params, cfg, h, positions, m)
    else:
        plan = {"kind": "self", "window": cfg.window}
        for lp in common.unstack(params["layers"], cfg.n_layers):
            h = _apply_layer(lp, cfg, h, plan, positions)
    return _logits(params, cfg, h)
