"""Multi-head Latent Attention (port of ``repro.models.mla``; DeepSeek
V2/V3, arXiv:2405.04434 §2.1).

KV is compressed into a latent ``c_kv`` (``kv_lora_rank``, RMS-normed)
plus one RoPE key head shared by every head; per-head keys and values are
expanded from the latent.  The queries are a full-rank projection
(``q_lora_rank == 0``, v2) or a low-rank one through an RMS-normed latent
(v3).  Written as the reference is: expanded scores, a ``1/sqrt(nope +
rope)`` scale, an additive ``-1e30`` causal bias and an f32 softmax.

Serving caches the latents alone, :class:`MLACache` (``kv_lora + rope``
entries a token, MLA's point); the one-token decode is the *absorbed*
form: the queries are projected into the latent space through ``wk_b``,
and the context read out of it through ``wv_b``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import MLAConfig
from repro_torch.models import common


class MLACache(NamedTuple):
    c_kv: torch.Tensor      # [B, S_cap, kv_lora]
    k_rope: torch.Tensor    # [B, S_cap, rope_dim]


def mla_shapes(d: int, n_heads: int, m: MLAConfig) -> dict:
    """The leaf shapes of one MLA block, named as the reference's."""
    qdim = n_heads * (m.nope_head_dim + m.rope_head_dim)
    shapes = {}
    if m.q_lora_rank:
        shapes["wq_a"] = (d, m.q_lora_rank)
        shapes["q_norm"] = (m.q_lora_rank,)
        shapes["wq_b"] = (m.q_lora_rank, qdim)
    else:
        shapes["wq"] = (d, qdim)
    shapes["wkv_a"] = (d, m.kv_lora_rank + m.rope_head_dim)
    shapes["kv_norm"] = (m.kv_lora_rank,)
    shapes["wk_b"] = (m.kv_lora_rank, n_heads * m.nope_head_dim)
    shapes["wv_b"] = (m.kv_lora_rank, n_heads * m.v_head_dim)
    shapes["wo"] = (n_heads * m.v_head_dim, d)
    return shapes


def _queries(p, x, n_heads: int, m: MLAConfig, positions, theta, eps):
    B, S, _ = x.shape
    if "wq_a" in p:
        q = common.rms_norm(x @ p["wq_a"], p["q_norm"], eps) @ p["wq_b"]
    else:
        q = x @ p["wq"]
    q = q.reshape(B, S, n_heads, m.nope_head_dim + m.rope_head_dim)
    q_nope, q_rope = q[..., : m.nope_head_dim], q[..., m.nope_head_dim:]
    return q_nope, common.apply_rope(q_rope, positions, theta)


def _latents(p, x, m: MLAConfig, positions, theta, eps):
    kv = x @ p["wkv_a"]
    c_kv = common.rms_norm(kv[..., : m.kv_lora_rank], p["kv_norm"], eps)
    k_rope = kv[..., m.kv_lora_rank:][:, :, None, :]     # one shared head
    k_rope = common.apply_rope(k_rope, positions, theta)[:, :, 0]
    return c_kv, k_rope


def _scores_expanded(p, q_nope, q_rope, c_kv, k_rope, n_heads,
                     m: MLAConfig):
    B, S = c_kv.shape[:2]
    k_nope = (c_kv @ p["wk_b"]).reshape(B, S, n_heads, m.nope_head_dim)
    scale = 1.0 / math.sqrt(float(m.nope_head_dim + m.rope_head_dim))
    s = torch.einsum("bqhn,bshn->bhqs", q_nope, k_nope)
    s = s + torch.einsum("bqhr,bsr->bhqs", q_rope, k_rope)
    return s * scale


def attention(p, x, positions, theta, n_heads: int, m: MLAConfig,
              eps: float = 1e-6):
    """Full-sequence causal MLA: x ``[B, S, d]`` -> ``[B, S, d]``."""
    B, S, _ = x.shape
    q_nope, q_rope = _queries(p, x, n_heads, m, positions, theta, eps)
    c_kv, k_rope = _latents(p, x, m, positions, theta, eps)
    scores = _scores_expanded(p, q_nope, q_rope, c_kv, k_rope, n_heads, m)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    bias = torch.where(positions[None, :] <= positions[:, None], zero, -1e30)
    probs = torch.softmax(scores.to(torch.float32) + bias, dim=-1).to(x.dtype)
    v = (c_kv @ p["wv_b"]).reshape(B, S, n_heads, m.v_head_dim)
    out = torch.einsum("bhqs,bshv->bqhv", probs, v)
    return out.reshape(B, S, -1) @ p["wo"]


def prefill(p, x, positions, theta, n_heads: int, m: MLAConfig,
            cache_len: int, eps: float = 1e-6):
    """The prompt's causal MLA (expanded, as :func:`attention`) and its
    latents zero-padded to ``cache_len >= S`` slots."""
    S = x.shape[1]
    if cache_len < S:
        raise ValueError(f"cache_len {cache_len} < the prompt's {S}")
    out = attention(p, x, positions, theta, n_heads, m, eps)
    c_kv, k_rope = _latents(p, x, m, positions, theta, eps)
    pad = (0, 0, 0, cache_len - S)
    return out, MLACache(torch.nn.functional.pad(c_kv, pad),
                         torch.nn.functional.pad(k_rope, pad))


def init_cache(batch: int, cache_len: int, m: MLAConfig, device=None,
               dtype=torch.float32) -> MLACache:
    """Zero latents ``[batch, cache_len, ...]`` in ``dtype``."""
    return MLACache(
        torch.zeros((batch, cache_len, m.kv_lora_rank), dtype=dtype,
                    device=device),
        torch.zeros((batch, cache_len, m.rope_head_dim), dtype=dtype,
                    device=device))


def decode(p, x, cache: MLACache, pos: int, theta, n_heads: int,
           m: MLAConfig, eps: float = 1e-6):
    """The absorbed one-token decode over the latent cache: x ``[B, 1,
    d]`` at position ``pos`` (a Python int); its latents are written at
    slot ``pos`` in place (the returned cache holds the caller's
    tensors, cast to the cache's dtype), and slots above ``pos`` are
    masked; the cache is read in the compute dtype."""
    B = x.shape[0]
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _queries(p, x, n_heads, m, positions, theta, eps)
    c_new, kr_new = _latents(p, x, m, positions, theta, eps)
    cache.c_kv[:, pos] = c_new[:, 0]
    cache.k_rope[:, pos] = kr_new[:, 0]
    c_kv, k_rope = (c.to(x.dtype) for c in cache)

    wk = p["wk_b"].reshape(m.kv_lora_rank, n_heads, m.nope_head_dim)
    q_c = torch.einsum("bqhn,chn->bqhc", q_nope, wk)      # absorbed query
    scale = 1.0 / math.sqrt(float(m.nope_head_dim + m.rope_head_dim))
    s = torch.einsum("bqhc,bsc->bhqs", q_c, c_kv)
    s = s + torch.einsum("bqhr,bsr->bhqs", q_rope, k_rope)
    kv_pos = torch.arange(c_kv.shape[1], device=x.device)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    bias = torch.where(kv_pos <= pos, zero, -1e30)[None, None, None]
    probs = torch.softmax(s.to(torch.float32) * scale + bias,
                          dim=-1).to(x.dtype)
    ctx = torch.einsum("bhqs,bsc->bqhc", probs, c_kv)
    wv = p["wv_b"].reshape(m.kv_lora_rank, n_heads, m.v_head_dim)
    out = torch.einsum("bqhc,chv->bqhv", ctx, wv)
    return out.reshape(B, 1, -1) @ p["wo"], cache
