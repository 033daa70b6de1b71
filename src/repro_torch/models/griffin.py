"""Griffin / RecurrentGemma (arXiv:2402.19427), training forward (port of
``repro.models.griffin``: ``init`` and ``forward``; prefill and decode are
not ported yet).  RG-LRU recurrent blocks mixed with local sliding-window
MQA attention in the config's block pattern (1 attn : 2 recurrent).

The RG-LRU recurrence ``h_t = a_t h_{t-1} + b_t`` runs as a log-step
(Hillis-Steele) scan over time: log2(S) steps of whole-sequence products,
where the reference runs ``jax.lax.associative_scan``.  The two add in
different orders, so they agree to rounding, not bit for bit.

Parameters: ``{"embed", "ln_f", "blocks", "rest"}``, ``blocks`` a list of
one stack per pattern position over the whole periods (``[]`` when there
is none), ``rest`` the remainder's unstacked layers.  The head is always
``embed.T``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common

_C = 8.0  # RG-LRU gate sharpness constant


def block_kinds(cfg: ModelConfig) -> list:
    pat = cfg.rglru.block_pattern
    return [pat[i % len(pat)] for i in range(cfg.n_layers)]


def _lru_width(cfg: ModelConfig) -> int:
    return cfg.rglru.lru_width or cfg.d_model


def _split_blocks(cfg: ModelConfig):
    P = len(cfg.rglru.block_pattern)
    n_full = cfg.n_layers // P
    return P, n_full, cfg.n_layers - n_full * P


def _layer_shapes(cfg: ModelConfig, kind: str) -> dict:
    d, W = cfg.d_model, _lru_width(cfg)
    p = {"ln1": (d,), "ln2": (d,)}
    if kind == "rec":
        p["lru"] = {"w_x": (d, W), "w_gate": (d, W),
                    "conv_w": (cfg.rglru.d_conv, W), "conv_b": (W,),
                    "w_a": (W, W), "b_a": (W,), "w_i": (W, W), "b_i": (W,),
                    "lam": (W,), "w_y": (W, d)}
    else:
        p["attn"] = attention.attn_shapes(d, cfg.n_heads, cfg.n_kv_heads,
                                          cfg.resolved_head_dim)
    p["mlp"] = {"w_gate": (d, cfg.d_ff), "w_up": (d, cfg.d_ff),
                "w_down": (cfg.d_ff, d)}
    return p


def param_shapes(cfg: ModelConfig) -> dict:
    """The tree of leaf shapes :func:`init` fills."""
    pat = cfg.rglru.block_pattern
    P, n_full, rest = _split_blocks(cfg)
    return {"embed": (cfg.vocab, cfg.d_model), "ln_f": (cfg.d_model,),
            "blocks": [common.stack_shapes(_layer_shapes(cfg, pat[p]),
                                           n_full)
                       for p in range(P)] if n_full else [],
            "rest": [_layer_shapes(cfg, pat[i % P]) for i in range(rest)]}


def init(gen: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    """Random weights (the reference's distributions, not its bits):
    ``lam = linspace(2, 5)``, a 0.1-scaled normal conv, zero biases and
    norm gains, fan-in scaled projections."""
    return common.init_tree(gen, param_shapes(cfg), device)


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t h_{t-1} + b_t`` from ``h_{-1} = 0`` over axis 1, by
    log-step doubling: after the step of span s each position holds the
    composition of the (up to) 2s elements ending there."""
    S = a.shape[1]
    s = 1
    while s < S:
        # (a, b)[t] <- (a[t-s] a[t], a[t] b[t-s] + b[t]); identity below s
        b = b + a * F.pad(b[:, :-s], (0, 0, s, 0))
        a = a * F.pad(a[:, :-s], (0, 0, s, 0), value=1.0)
        s *= 2
    return b


def _rec_block(p, x):
    """The RG-LRU recurrent block in train mode."""
    gate = common.gelu(x @ p["w_gate"])
    u_raw = x @ p["w_x"]
    K = p["conv_w"].shape[0]
    xp = F.pad(u_raw, (0, 0, K - 1, 0))
    u = sum(xp[:, i: i + x.shape[1]] * p["conv_w"][i] for i in range(K)) \
        + p["conv_b"]
    r = torch.sigmoid(u @ p["w_a"] + p["b_a"])
    i = torch.sigmoid(u @ p["w_i"] + p["b_i"])
    log_a = -_C * common.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9)) \
        * (i * u)
    return (gate * rglru_scan(a, b)) @ p["w_y"]


def _apply_layer(lp, cfg: ModelConfig, h, kind: str, positions):
    hn = common.rms_norm(h, lp["ln1"], cfg.norm_eps)
    if kind == "rec":
        y = _rec_block(lp["lru"], hn)
    else:
        y = attention.self_attention(
            lp["attn"], hn, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            head_dim=cfg.resolved_head_dim, positions=positions,
            theta=cfg.rope_theta, window=cfg.rglru.window,
            norm_eps=cfg.norm_eps)
    h = h + y
    mlp = lp["mlp"]
    return h + common.swiglu(common.rms_norm(h, lp["ln2"], cfg.norm_eps),
                             mlp["w_gate"], mlp["w_up"], mlp["w_down"])


def _run_stack(params, cfg: ModelConfig, h, positions):
    pat = cfg.rglru.block_pattern
    P, n_full, _ = _split_blocks(cfg)
    blocks = [common.unstack(b, n_full) for b in params["blocks"]]
    for j in range(n_full):
        for p in range(P):
            h = _apply_layer(blocks[p][j], cfg, h, pat[p], positions)
    for i, lp in enumerate(params["rest"]):
        h = _apply_layer(lp, cfg, h, pat[i % P], positions)
    return h


def forward(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """tokens ``[B, S]`` -> logits ``[B, S, V]``."""
    S = tokens.shape[1]
    h = params["embed"][tokens] * math.sqrt(float(cfg.d_model))
    h = _run_stack(params, cfg, h, torch.arange(S, device=tokens.device))
    h = common.rms_norm(h, params["ln_f"], cfg.norm_eps)
    return h @ params["embed"].T
