"""Griffin / RecurrentGemma (arXiv:2402.19427) (port of
``repro.models.griffin``: ``init``, ``forward``, and serving --
``prefill``, ``init_decode_cache``, ``decode_step``).  RG-LRU recurrent
blocks mixed with local sliding-window MQA attention in the config's
block pattern (1 attn : 2 recurrent).

The RG-LRU recurrence ``h_t = a_t h_{t-1} + b_t`` runs as a log-step
(Hillis-Steele) scan over time in train and prefill: log2(S) steps of
whole-sequence products, where the reference runs
``jax.lax.associative_scan``.  The two add in different orders, so they
agree to rounding, not bit for bit.  Decode steps the state once.

Parameters: ``{"embed", "ln_f", "blocks", "rest"}``, ``blocks`` a list of
one stack per pattern position over the whole periods (``[]`` when there
is none), ``rest`` the remainder's unstacked layers.  The head is always
``embed.T``.  The serving cache mirrors them: a recurrent layer's
``{"conv": [B, K-1, W], "state": [B, W]}``, an attention layer's ring
:class:`attention.KVCache`, stacked over the whole periods.
"""
from __future__ import annotations

import math
from typing import NamedTuple

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


def _rec_block(p, x, conv_cache=None, state=None, decode: bool = False):
    """The RG-LRU recurrent block: x ``[B, S, W]`` -> ``(y, conv window
    [B, K-1, W], state [B, W])``.  In decode (S = 1) the conv runs over
    ``conv_cache`` and this input and the state is stepped once from
    ``state``; otherwise the causal conv and the scan run over the
    sequence from zero."""
    gate = common.gelu(x @ p["w_gate"])
    u_raw = x @ p["w_x"]
    K = p["conv_w"].shape[0]
    if decode:          # the conv over the cached window and this input
        win = torch.cat([conv_cache, u_raw], dim=1)
        u = (win * p["conv_w"]).sum(1, keepdim=True) + p["conv_b"]
        new_conv = win[:, 1:]
    else:
        xp = F.pad(u_raw, (0, 0, K - 1, 0))
        u = sum(xp[:, i: i + x.shape[1]] * p["conv_w"][i]
                for i in range(K)) + p["conv_b"]
        new_conv = F.pad(u_raw, (0, 0, max(K - 1 - x.shape[1], 0), 0))[
            :, -(K - 1):]
    r = torch.sigmoid(u @ p["w_a"] + p["b_a"])
    i = torch.sigmoid(u @ p["w_i"] + p["b_i"])
    log_a = -_C * common.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9)) \
        * (i * u)
    if decode:
        new_state = a[:, 0] * state + b[:, 0]
        h = new_state[:, None]
    else:
        h = rglru_scan(a, b)
        new_state = h[:, -1]
    return (gate * h) @ p["w_y"], new_conv, new_state


def _apply_layer(lp, cfg: ModelConfig, h, kind: str, *, positions=None,
                 mode="train", cache=None, pos=None, cache_len=0):
    """One layer, ``mode`` train, prefill or decode: the recurrent block
    (its cache ``{"conv", "state"}``) or local attention over the ring of
    :func:`attention.ring_slots` slots, masked by held position in decode
    (:func:`attention.ring_decode_attention`); then the SwiGLU MLP.
    Returns ``(h, the layer's cache)`` (None in train mode)."""
    hn = common.rms_norm(h, lp["ln1"], cfg.norm_eps)
    new_cache = cache
    if kind == "rec":
        if mode == "decode":
            y, conv, state = _rec_block(lp["lru"], hn,
                                        conv_cache=cache["conv"],
                                        state=cache["state"], decode=True)
            cache["conv"].copy_(conv)
            cache["state"].copy_(state)
        else:
            y, conv, state = _rec_block(lp["lru"], hn)
            new_cache = {"conv": conv, "state": state}
    else:
        w = cfg.rglru.window
        kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                  head_dim=cfg.resolved_head_dim, theta=cfg.rope_theta,
                  norm_eps=cfg.norm_eps)
        if mode == "train":
            y = attention.self_attention(lp["attn"], hn, positions=positions,
                                         window=w, **kw)
        elif mode == "prefill":
            y, new_cache = attention.prefill_attention(
                lp["attn"], hn, positions=positions,
                cache_len=attention.ring_slots(cache_len, w, hn.shape[1]),
                window=w, **kw)
        else:
            y, new_cache = attention.ring_decode_attention(
                lp["attn"], hn, cache, pos, window=w, **kw)
    h = h + y
    mlp = lp["mlp"]
    h = h + common.swiglu(common.rms_norm(h, lp["ln2"], cfg.norm_eps),
                          mlp["w_gate"], mlp["w_up"], mlp["w_down"])
    return h, (None if mode == "train" else new_cache)


def _run_stack(params, cfg: ModelConfig, h, *, positions=None,
               mode="train", caches=None, pos=None, cache_len=0):
    """The pattern's layers in order (:func:`common.run_periods`);
    ``caches``: ``{"blocks", "rest"}`` in decode mode.  Returns ``(h,
    caches)``."""
    pat = cfg.rglru.block_pattern
    P, n_full, _ = _split_blocks(cfg)

    def apply(lp, p, h, cache):
        return _apply_layer(lp, cfg, h, pat[p], positions=positions,
                            mode=mode, cache=cache, pos=pos,
                            cache_len=cache_len)
    return common.run_periods(params, P, n_full, h, apply, mode, caches,
                              cfg)


def _embed(params, cfg: ModelConfig, tokens):
    return params["embed"][tokens] * math.sqrt(float(cfg.d_model))


def _logits(params, cfg: ModelConfig, h):
    return common.rms_norm(h, params["ln_f"], cfg.norm_eps) \
        @ params["embed"].T


def forward(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """tokens ``[B, S]`` -> logits ``[B, S, V]``."""
    S = tokens.shape[1]
    h, _ = _run_stack(params, cfg, _embed(params, cfg, tokens),
                      positions=torch.arange(S, device=tokens.device))
    return _logits(params, cfg, h)


# ---------------------------------------------------------------------------
# Serving: prefill + one-token decode
# ---------------------------------------------------------------------------

class ServeCache(NamedTuple):
    layers: object      # {"blocks": [per-position stacked caches], "rest"}


def init_decode_cache(cfg: ModelConfig, batch: int, cache_len: int,
                      media=None, params=None, device=None) -> ServeCache:
    """Zero caches on ``device``, in float32: a recurrent layer's conv
    window ``[B, K-1, W]`` and state ``[B, W]``, an attention layer's ring
    of ``min(cache_len, window + 1)`` slots; a whole period's stacked
    ``[n_full, ...]`` (``"blocks"`` is ``[]`` when there is none).
    ``media`` and ``params`` are not read."""
    W, K, hd = _lru_width(cfg), cfg.rglru.d_conv, cfg.resolved_head_dim
    cap = attention.ring_slots(cache_len, cfg.rglru.window)
    pat = cfg.rglru.block_pattern
    P, n_full, rest = _split_blocks(cfg)

    def one(kind, lead=()):
        def zeros(*shape):
            return torch.zeros(tuple(lead) + (batch,) + shape,
                               device=device)
        if kind == "rec":
            return {"conv": zeros(K - 1, W), "state": zeros(W)}
        return attention.KVCache(zeros(cap, cfg.n_kv_heads, hd),
                                 zeros(cap, cfg.n_kv_heads, hd))

    return ServeCache({
        "blocks": [one(pat[p], (n_full,)) for p in range(P)]
        if n_full else [],
        "rest": [one(pat[i % P]) for i in range(rest)]})


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor,
            cache_len: int):
    """The prompt ``tokens`` ``[B, S]`` through the stack: the last
    position's logits ``[B, 1, V]`` and a :class:`ServeCache` (an
    attention layer's ring of ``max(min(cache_len, window + 1), S)``
    slots)."""
    S = tokens.shape[1]
    h, caches = _run_stack(params, cfg, _embed(params, cfg, tokens),
                           positions=torch.arange(S, device=tokens.device),
                           mode="prefill", cache_len=cache_len)
    return _logits(params, cfg, h[:, -1:]), ServeCache(caches)


def decode_step(params, cfg: ModelConfig, token: torch.Tensor,
                cache: ServeCache, pos: int):
    """token ``[B, 1]`` at position ``pos`` (a Python int) -> ``(logits
    [B, 1, V], cache)``.  The cache is written in place: the returned one
    holds the caller's tensors."""
    h, caches = _run_stack(params, cfg, _embed(params, cfg, token),
                           mode="decode", caches=cache.layers, pos=pos)
    return _logits(params, cfg, h), ServeCache(caches)
