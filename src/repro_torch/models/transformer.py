"""Dense decoder-only transformer (port of ``repro.models.transformer``:
``init``, ``forward``, and serving -- ``prefill``, ``init_decode_cache``,
``decode_step`` -- for homogeneous stacks and for patterned stacks --
local:global windows, or the VLM's interleaved cross-attention layers --
with optional qk-norm).

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

Serving caches mirror the parameters: a homogeneous stack's
:class:`attention.KVCache` is stacked ``[L, B, cap, KV, hd]``; a patterned
stack's is ``{"blocks": [per-position caches stacked over the whole
periods], "rest": [...]}`` (``"blocks"`` is ``[None] * P`` after a prefill
or a decode step when there is no whole period, ``[]`` from
:func:`init_decode_cache`, as in the reference).  A cross layer's cache is
its media's keys and values ``[B, M, KV, hd]``.  A sliding-window layer
keeps a ring of ``cap = max(min(cache_len, window + 1), S)`` slots.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common
from repro_torch.sharding import collectives


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


def _attn_kw(cfg: ModelConfig, attn=None) -> dict:
    """The attention's head keywords; with a train layer's ``attn``
    parameters that hold a model rank's heads (a split plan), its local
    head counts and ``split``."""
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
              head_dim=cfg.resolved_head_dim, theta=cfg.rope_theta,
              qk_norm=cfg.qk_norm, norm_eps=cfg.norm_eps)
    hd = cfg.resolved_head_dim
    if attn is not None and attn["wq"].shape[-1] != cfg.n_heads * hd:
        kw.update(n_heads=attn["wq"].shape[-1] // hd,
                  n_kv=attn["wk"].shape[-1] // hd, split=True)
    return kw


def _mlp_block(lp, cfg: ModelConfig, h):
    mlp = lp["mlp"]
    return h + common.swiglu(common.rms_norm(h, lp["ln2"], cfg.norm_eps),
                             mlp["w_gate"], mlp["w_up"], mlp["w_down"],
                             split=mlp["w_gate"].shape[-1] != cfg.d_ff)


def _apply_layer(lp, cfg: ModelConfig, h, plan, *, positions=None,
                 media=None, mode="train", cache=None, pos=None,
                 cache_len=0):
    """One layer, ``mode`` train, prefill or decode: self attention
    (window from ``plan``), or for a cross layer gated attention over
    ``media`` ``[B, M, d]`` (in decode, over its cache); then the SwiGLU
    MLP.  Returns ``(h, the layer's cache)`` (None in train mode).

    A windowed layer decodes over its ring, masked by the position each
    slot holds (:func:`attention.ring_decode_attention`, where the port
    departs from the reference)."""
    hd = cfg.resolved_head_dim
    hn = common.rms_norm(h, lp["ln1"], cfg.norm_eps)
    new_cache = cache
    if plan["kind"] == "cross":
        media_kv = cache if mode == "decode" else \
            attention.cross_kv(lp["attn"], media, cfg.n_kv_heads, hd)
        a = attention.cross_attention(lp["attn"], hn, media_kv,
                                      n_heads=cfg.n_heads, head_dim=hd)
        new_cache = media_kv
    else:
        kw = _attn_kw(cfg, lp["attn"] if mode == "train" else None)
        w = plan["window"]
        if mode == "train":
            a = attention.self_attention(lp["attn"], hn, positions=positions,
                                         window=w, **kw)
        elif mode == "prefill":
            a, new_cache = attention.prefill_attention(
                lp["attn"], hn, positions=positions,
                cache_len=attention.ring_slots(cache_len, w, hn.shape[1]),
                window=w, **kw)
        elif w:                 # decode over the ring
            a, new_cache = attention.ring_decode_attention(
                lp["attn"], hn, cache, pos, window=w, **kw)
        else:
            a, new_cache = attention.decode_attention(lp["attn"], hn, cache,
                                                      pos, **kw)
    h = _mlp_block(lp, cfg, h + a)
    return h, (None if mode == "train" else new_cache)


def _run_patterned(params, cfg: ModelConfig, h, *, positions=None,
                   media=None, mode="train", caches=None, pos=None,
                   cache_len=0):
    """The pattern's layers in order (:func:`common.run_periods`);
    ``caches``: ``{"blocks", "rest"}`` in decode mode.  Returns ``(h,
    caches)``."""
    P, n_full, _ = _split_blocks(cfg)
    plans = [_pos_plan(cfg, p) for p in range(P)]

    def apply(lp, p, h, cache):
        return _apply_layer(lp, cfg, h, plans[p], positions=positions,
                            media=media, mode=mode, cache=cache, pos=pos,
                            cache_len=cache_len)
    return common.run_periods(params, P, n_full, h, apply, mode, caches,
                              cfg)


def _media_embed(params, media):
    if "media_proj" in params:
        media = media @ params["media_proj"]
    return media


def _embed(params, cfg: ModelConfig, tokens):
    """The token embedding; where ``embed`` is this model rank's vocab
    block (a split plan), each rank looks up the tokens its rows hold,
    zeros the others, and "g" sums the blocks (one term and zeros: the
    whole table's values, exactly)."""
    table = params["embed"]
    lo = common.vocab_block(cfg.vocab, table.shape[0])
    if lo is None:
        return table[tokens] * math.sqrt(float(cfg.d_model))
    local = tokens.to(torch.int64) - lo
    inside = (local >= 0) & (local < table.shape[0])
    rows = table[local.clamp(0, table.shape[0] - 1)]
    h = torch.where(inside[..., None], rows, torch.zeros_like(rows))
    return collectives.reduce_sum(h * math.sqrt(float(cfg.d_model)))


def _logits(params, cfg: ModelConfig, h):
    """The head: ``[B, S, V]`` logits, or under a split plan this model
    rank's vocab block ``[B, S, V / M]`` (column-parallel; ``h`` enters
    through "f"), tied or untied."""
    h = common.rms_norm(h, params["ln_f"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if w.shape[-1] != cfg.vocab:
        h = collectives.copy_in(h)
    return h @ w


def forward(params, cfg: ModelConfig, tokens: torch.Tensor,
            media: torch.Tensor | None = None) -> torch.Tensor:
    """tokens ``[B, S]`` (and for the cross layers media ``[B, M,
    d_media or d]``, the stub frontend's embeddings) -> logits ``[B, S,
    V]``."""
    S = tokens.shape[1]
    h = _embed(params, cfg, tokens)
    positions = torch.arange(S, device=tokens.device)
    if _is_patterned(cfg):
        m = _media_embed(params, media) if media is not None else None
        h, _ = _run_patterned(params, cfg, h, positions=positions, media=m)
    else:
        plan = {"kind": "self", "window": cfg.window}

        def body(h, lp):
            return _apply_layer(lp, cfg, h, plan, positions=positions)[0]
        for lp in common.unstack(params["layers"], cfg.n_layers):
            h = common.remat(cfg, body, h, lp)
    return _logits(params, cfg, h)


# ---------------------------------------------------------------------------
# Serving: prefill + one-token decode
# ---------------------------------------------------------------------------

class ServeCache(NamedTuple):
    layers: object          # stacked KVCache, or the patterned dict
    media_kv: object        # unused (a cross layer's cache is in layers)


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, cache_len: int,
            media: Optional[torch.Tensor] = None):
    """The prompt ``tokens`` ``[B, S]`` (and the vlm's ``media``) through
    the stack: the last position's logits ``[B, 1, V]`` and a
    :class:`ServeCache` of ``cache_len`` slots a layer (at least S; a
    windowed layer's ring and a cross layer's media as the module
    docstring says)."""
    S = tokens.shape[1]
    h = _embed(params, cfg, tokens)
    positions = torch.arange(S, device=tokens.device)
    if _is_patterned(cfg):
        m = _media_embed(params, media) if media is not None else None
        h, caches = _run_patterned(params, cfg, h, positions=positions,
                                   media=m, mode="prefill",
                                   cache_len=cache_len)
        return _logits(params, cfg, h[:, -1:]), ServeCache(caches, None)
    kw = _attn_kw(cfg)
    kvs = []
    for lp in common.unstack(params["layers"], cfg.n_layers):
        a, kv = attention.prefill_attention(
            lp["attn"], common.rms_norm(h, lp["ln1"], cfg.norm_eps),
            positions=positions, cache_len=max(cache_len, S),
            window=cfg.window, **kw)
        h = _mlp_block(lp, cfg, h + a)
        kvs.append(kv)
    return _logits(params, cfg, h[:, -1:]), ServeCache(
        common.tree_stack(kvs), None)


def _empty_kv(cfg: ModelConfig, batch: int, clen: int, lead=(),
              device=None) -> attention.KVCache:
    """Zero caches ``[*lead, batch, clen, KV, hd]`` in ``cfg.param_dtype``
    (the giants' bf16, as in the reference)."""
    shape = tuple(lead) + (batch, clen, cfg.n_kv_heads,
                           cfg.resolved_head_dim)
    dt = common.param_dtype(cfg)
    return attention.KVCache(torch.zeros(shape, dtype=dt, device=device),
                             torch.zeros(shape, dtype=dt, device=device))


def init_decode_cache(cfg: ModelConfig, batch: int, cache_len: int,
                      media: Optional[torch.Tensor] = None, params=None,
                      device=None) -> ServeCache:
    """Empty caches for pure decode, on ``device``, in ``cfg.param_dtype``:
    ``cache_len`` slots a layer (a windowed layer's ring ``min(cache_len,
    window + 1)``); a cross layer's ``cfg.n_media_tokens or 8`` media slots
    are zeros, or with ``media`` and ``params`` its keys and values of the
    media (in their compute dtype, as in the reference)."""
    if not _is_patterned(cfg):
        return ServeCache(_empty_kv(cfg, batch, cache_len, (cfg.n_layers,),
                                    device), None)
    P, n_full, rest = _split_blocks(cfg)
    plans = [_pos_plan(cfg, p) for p in range(P)]
    hd = cfg.resolved_head_dim

    def pos_cache(plan, lead=()):
        if plan["kind"] == "cross":
            return _empty_kv(cfg, batch, cfg.n_media_tokens or 8, lead,
                             device)
        return _empty_kv(cfg, batch, attention.ring_slots(
            cache_len, plan["window"]), lead, device)

    caches = {"blocks": [pos_cache(plans[p], (n_full,)) for p in range(P)]
              if n_full else [],
              "rest": [pos_cache(plans[i % P]) for i in range(rest)]}
    if media is not None and params is not None:
        m = _media_embed(params, media)
        for p in range(P if n_full else 0):
            if plans[p]["kind"] == "cross":
                caches["blocks"][p] = common.tree_stack([
                    attention.cross_kv(lp["attn"], m, cfg.n_kv_heads, hd)
                    for lp in common.unstack(params["blocks"][p], n_full)])
        for i in range(rest):
            if plans[i % P]["kind"] == "cross":
                caches["rest"][i] = attention.cross_kv(
                    params["rest"][i]["attn"], m, cfg.n_kv_heads, hd)
    return ServeCache(caches, None)


def decode_step(params, cfg: ModelConfig, token: torch.Tensor,
                cache: ServeCache, pos: int):
    """token ``[B, 1]`` at position ``pos`` (a Python int) -> ``(logits
    [B, 1, V], cache)``.  The cache is written in place: the returned one
    holds the caller's tensors."""
    h = _embed(params, cfg, token)
    if _is_patterned(cfg):
        h, caches = _run_patterned(params, cfg, h, mode="decode",
                                   caches=cache.layers, pos=pos)
        return _logits(params, cfg, h), ServeCache(caches, None)
    kw = _attn_kw(cfg)
    for i, lp in enumerate(common.unstack(params["layers"], cfg.n_layers)):
        a, _ = attention.decode_attention(
            lp["attn"], common.rms_norm(h, lp["ln1"], cfg.norm_eps),
            common.tree_at(cache.layers, i), pos, window=cfg.window, **kw)
        h = _mlp_block(lp, cfg, h + a)
    return _logits(params, cfg, h), cache
