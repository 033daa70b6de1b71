"""Whisper-small backbone (arXiv:2212.04356), an encoder-decoder
transformer, training forward (port of the train path of
``repro.models.whisper``: ``init``, ``encode``, the decoder pass and
``forward``; the serving cache, prefill and decode are not ported yet).

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
"""
from __future__ import annotations

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


def _decoder_pass(params, cfg: ModelConfig, tokens, enc, positions):
    """The decoder stack over the full sequence (causal): learned
    positions plus RoPE in self attention, ungated cross attention over
    ``enc``; logits through the tied embedding."""
    hd = cfg.resolved_head_dim
    h = params["embed"][tokens] + params["pos_emb_dec"][positions]
    for lp in common.unstack(params["decoder"], cfg.n_layers):
        h = h + attention.self_attention(
            lp["attn"], common.rms_norm(h, lp["ln1"], cfg.norm_eps),
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=hd,
            positions=positions, theta=cfg.rope_theta, norm_eps=cfg.norm_eps)
        xkv = attention.cross_kv(lp["xattn"], enc, cfg.n_kv_heads, hd)
        h = h + attention.cross_attention(
            lp["xattn"], common.rms_norm(h, lp["ln_x"], cfg.norm_eps), xkv,
            n_heads=cfg.n_heads, head_dim=hd, gated=False)
        h = h + _mlp(lp["mlp"], common.rms_norm(h, lp["ln_mlp"],
                                                cfg.norm_eps))
    h = common.rms_norm(h, params["ln_f"], cfg.norm_eps)
    return h @ params["embed"].T


def forward(params, cfg: ModelConfig, tokens: torch.Tensor,
            media: torch.Tensor) -> torch.Tensor:
    """tokens ``[B, S]``, media the stub frames ``[B, n_frames, d]`` ->
    logits ``[B, S, V]``."""
    enc = encode(params, cfg, media)
    positions = torch.arange(tokens.shape[1],
                             device=tokens.device) % cfg.max_target_len
    return _decoder_pass(params, cfg, tokens, enc, positions)
