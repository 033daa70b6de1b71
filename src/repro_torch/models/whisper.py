"""Whisper-small backbone (arXiv:2212.04356), an encoder-decoder
transformer (port of ``repro.models.whisper``: ``init``, ``encode``, the
decoder pass, ``forward``, and serving -- ``prefill``,
``init_decode_cache``, ``decode_step``).

The mel-spectrogram and conv frontend is a stub, as in the reference:
``forward`` takes precomputed frame embeddings ``[B, n_frames, d]``.
Learned positions on both sides, pre-norm MHA, GELU MLPs with biases; the
decoder's self attention also applies RoPE on its learned positions, and
its cross attention over the encoder states is ungated (``xattn.gate`` is
a parameter no forward reads), as the reference has them.  Parameters,
per-layer leaves stacked on a leading axis::

    {"embed": [V, d] (tied), "pos_emb_dec": [max_target_len, d],
     "pos_emb_enc": [n_audio_frames, d], "ln_enc": [d], "ln_f": [d],
     "encoder": {"ln1", "attn": {"wq", "wk", "wv", "wo"}, "ln_mlp",
                 "mlp": {"w_in", "b_in", "w_out", "b_out"}},
     "decoder": {... as "encoder", "ln_x",
                 "xattn": {"wq", "wk", "wv", "wo", "gate"}}}

The serving cache, :class:`ServeCache`, holds the decoder's self-attention
keys and values (stacked over the layers) and the encoder states, not the
cross keys and values: every decode step recomputes each layer's cross
K/V from the states, as the reference does.  Positions as in the
reference: the forward wraps them (``arange(S) % max_target_len``) for
the learned table, RoPE and the causal mask alike; the prefill wraps only
the learned table's; a decode step reads the table at ``pos %
max_target_len`` and ropes and masks at ``pos``.  Past ``max_target_len``
the three differ.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common


def _block_shapes(cfg: ModelConfig, cross: bool) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    shapes = {"ln1": (d,),
              "attn": attention.attn_shapes(d, cfg.n_heads, cfg.n_kv_heads,
                                            hd),
              "ln_mlp": (d,),
              "mlp": {"w_in": (d, cfg.d_ff), "b_in": (cfg.d_ff,),
                      "w_out": (cfg.d_ff, d), "b_out": (d,)}}
    if cross:
        shapes["ln_x"] = (d,)
        shapes["xattn"] = attention.cross_attn_shapes(
            d, d, cfg.n_heads, cfg.n_kv_heads, hd)
    return shapes


def param_shapes(cfg: ModelConfig) -> dict:
    """The tree of leaf shapes :func:`init` fills."""
    d = cfg.d_model
    return {"embed": (cfg.vocab, d),
            "pos_emb_dec": (cfg.max_target_len, d),
            "pos_emb_enc": (cfg.n_audio_frames, d),
            "encoder": common.stack_shapes(_block_shapes(cfg, False),
                                           cfg.encoder_layers),
            "decoder": common.stack_shapes(_block_shapes(cfg, True),
                                           cfg.n_layers),
            "ln_enc": (d,), "ln_f": (d,)}


def init(gen: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    """Random weights (the reference's distributions, not its bits):
    0.02-scaled embedding and positions, fan-in scaled projections, zero
    biases, norm gains and gates."""
    return common.init_tree(gen, param_shapes(cfg), device)


def _mlp(p, x):
    return common.gelu_mlp(x, p["w_in"], p["b_in"], p["w_out"], p["b_out"])


def encode(params, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames ``[B, n_frames, d]`` (the stub frontend's output) -> the
    normalized encoder states ``[B, n_frames, d]``."""
    S = frames.shape[1]
    h = frames + params["pos_emb_enc"][:S]
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
              head_dim=cfg.resolved_head_dim)
    for lp in common.unstack(params["encoder"], cfg.encoder_layers):
        h = h + attention.bidir_attention(
            lp["attn"], common.rms_norm(h, lp["ln1"], cfg.norm_eps), **kw)
        h = h + _mlp(lp["mlp"], common.rms_norm(h, lp["ln_mlp"],
                                                cfg.norm_eps))
    return common.rms_norm(h, params["ln_enc"], cfg.norm_eps)


def _cross_mlp(lp, cfg: ModelConfig, h, enc):
    """A decoder layer after its self attention: ungated cross attention
    over ``enc`` (its keys and values computed here), then the MLP."""
    hd = cfg.resolved_head_dim
    xkv = attention.cross_kv(lp["xattn"], enc, cfg.n_kv_heads, hd)
    h = h + attention.cross_attention(
        lp["xattn"], common.rms_norm(h, lp["ln_x"], cfg.norm_eps), xkv,
        n_heads=cfg.n_heads, head_dim=hd, gated=False)
    return h + _mlp(lp["mlp"], common.rms_norm(h, lp["ln_mlp"],
                                               cfg.norm_eps))


def _self_kw(cfg: ModelConfig) -> dict:
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                head_dim=cfg.resolved_head_dim, theta=cfg.rope_theta,
                norm_eps=cfg.norm_eps)


def _logits(params, cfg: ModelConfig, h):
    return common.rms_norm(h, params["ln_f"], cfg.norm_eps) \
        @ params["embed"].T


def _decoder_pass(params, cfg: ModelConfig, tokens, enc, positions,
                  caches=None, pos=None):
    """The decoder stack: over the full sequence (causal; ``caches``
    None), or one decode step at ``pos`` over the stacked self caches
    (written in place).  Learned positions at ``positions``, RoPE in self
    attention, ungated cross attention over ``enc``; logits through the
    tied embedding."""
    h = params["embed"][tokens] + params["pos_emb_dec"][positions]
    kw = _self_kw(cfg)
    for i, lp in enumerate(common.unstack(params["decoder"], cfg.n_layers)):
        hn = common.rms_norm(h, lp["ln1"], cfg.norm_eps)
        if caches is None:
            a = attention.self_attention(lp["attn"], hn, positions=positions,
                                         **kw)
        else:
            a, _ = attention.decode_attention(
                lp["attn"], hn, common.tree_at(caches, i), pos, **kw)
        h = _cross_mlp(lp, cfg, h + a, enc)
    return _logits(params, cfg, h)


def forward(params, cfg: ModelConfig, tokens: torch.Tensor,
            media: torch.Tensor) -> torch.Tensor:
    """tokens ``[B, S]``, media the stub frames ``[B, n_frames, d]`` ->
    logits ``[B, S, V]``."""
    enc = encode(params, cfg, media)
    positions = torch.arange(tokens.shape[1],
                             device=tokens.device) % cfg.max_target_len
    return _decoder_pass(params, cfg, tokens, enc, positions)


# ---------------------------------------------------------------------------
# Serving: prefill + one-token decode
# ---------------------------------------------------------------------------

class ServeCache(NamedTuple):
    self_kv: attention.KVCache   # stacked [L, B, S_cap, KV, hd]
    enc: torch.Tensor            # the encoder states [B, n_frames, d]


def init_decode_cache(cfg: ModelConfig, batch: int, cache_len: int,
                      media: Optional[torch.Tensor] = None, params=None,
                      device=None) -> ServeCache:
    """Zero self caches of ``cache_len`` slots a layer on ``device``, in
    float32; the encoder states of ``media`` when given ``media`` and
    ``params``, else zeros ``[batch, n_audio_frames, d]``."""
    shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    if media is not None and params is not None:
        enc = encode(params, cfg, media)
    else:
        enc = torch.zeros((batch, cfg.n_audio_frames, cfg.d_model),
                          device=device)
    return ServeCache(attention.KVCache(torch.zeros(shape, device=device),
                                        torch.zeros(shape, device=device)),
                      enc)


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, cache_len: int,
            media: torch.Tensor = None):
    """Encode ``media`` (the stub frames ``[B, n_frames, d]``) and run the
    prompt ``tokens`` ``[B, S]`` through the decoder: the last position's
    logits ``[B, 1, V]`` and a :class:`ServeCache` of ``max(cache_len, S)``
    self slots a layer.  The learned positions wrap at
    ``max_target_len``, RoPE's and the mask's do not (the reference's
    prefill)."""
    enc = encode(params, cfg, media)
    S = tokens.shape[1]
    positions = torch.arange(S, device=tokens.device)
    h = params["embed"][tokens] \
        + params["pos_emb_dec"][positions % cfg.max_target_len]
    kvs = []
    for lp in common.unstack(params["decoder"], cfg.n_layers):
        a, kv = attention.prefill_attention(
            lp["attn"], common.rms_norm(h, lp["ln1"], cfg.norm_eps),
            positions=positions, cache_len=max(cache_len, S),
            **_self_kw(cfg))
        h = _cross_mlp(lp, cfg, h + a, enc)
        kvs.append(kv)
    return _logits(params, cfg, h[:, -1:]), ServeCache(
        common.tree_stack(kvs), enc)


def decode_step(params, cfg: ModelConfig, token: torch.Tensor,
                cache: ServeCache, pos: int):
    """token ``[B, 1]`` at position ``pos`` (a Python int) -> ``(logits
    [B, 1, V], cache)``; the self caches are written in place (the
    returned cache holds the caller's tensors), and every layer's cross
    keys and values are recomputed from ``cache.enc``."""
    positions = torch.full((1,), pos % cfg.max_target_len,
                           dtype=torch.int64, device=token.device)
    logits = _decoder_pass(params, cfg, token, cache.enc, positions,
                           caches=cache.self_kv, pos=pos)
    return logits, cache
