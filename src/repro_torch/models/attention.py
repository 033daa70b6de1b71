"""Attention (port of ``repro.models.attention``): causal GQA
self-attention with RoPE, qk-norm and sliding windows; a preallocated KV
cache for serving (prefill, then one-token decode); cross attention over
media tokens or encoder states (gated by ``tanh(gate)`` in the VLM);
bidirectional MHA (the whisper encoder).  Written plainly, as the
reference is: grouped scores, a ``-1e30`` causal bias (a zero bias where
nothing is masked) and an f32 softmax."""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.models import common
from repro_torch.sharding import collectives


class KVCache(NamedTuple):
    k: torch.Tensor          # [B, S_cap, KV, hd]
    v: torch.Tensor          # [B, S_cap, KV, hd]


def attn_shapes(d: int, n_heads: int, n_kv: int, head_dim: int,
                qk_norm: bool = False) -> dict:
    shapes = {"wq": (d, n_heads * head_dim), "wk": (d, n_kv * head_dim),
              "wv": (d, n_kv * head_dim), "wo": (n_heads * head_dim, d)}
    if qk_norm:
        shapes["q_norm"] = (head_dim,)
        shapes["k_norm"] = (head_dim,)
    return shapes


def init_attn(gen, d: int, n_heads: int, n_kv: int, head_dim: int,
              qk_norm: bool = False, device=None) -> dict:
    return common.init_tree(
        gen, attn_shapes(d, n_heads, n_kv, head_dim, qk_norm), device)


def _project_qkv(p, x, n_heads, n_kv, head_dim, positions, theta,
                 qk_norm: bool, norm_eps: float):
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, n_heads, head_dim)
    k = (x @ p["wk"]).reshape(B, S, n_kv, head_dim)
    v = (x @ p["wv"]).reshape(B, S, n_kv, head_dim)
    if qk_norm:
        q = common.rms_norm(q, p["q_norm"], norm_eps)
        k = common.rms_norm(k, p["k_norm"], norm_eps)
    q = common.apply_rope(q, positions, theta)
    k = common.apply_rope(k, positions, theta)
    return q, k, v


def attend(q, k, v, bias):
    """q ``[B,Sq,H,hd]``; k, v ``[B,Skv,KV,hd]``; bias broadcastable to
    ``[B,KV,R,Sq,Skv]``."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    R = H // KV
    qg = q.reshape(B, Sq, KV, R, hd)
    scores = torch.einsum("bqkrh,bskh->bkrqs", qg * (1.0 / math.sqrt(hd)), k)
    scores = scores.to(torch.float32) + bias
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkrqs,bskh->bqkrh", probs, v)
    return out.reshape(B, Sq, H * hd)


def _bias(allowed):
    zero = torch.zeros((), dtype=torch.float32, device=allowed.device)
    return torch.where(allowed, zero, -1e30)


def causal_bias(q_pos, kv_pos, window: int = 0, kv_valid=None):
    """Additive bias ``[1,1,1,Sq,Skv]``: 0 allowed, -1e30 blocked;
    ``kv_valid`` (``[Skv]`` bool) blocks the slots it marks False."""
    allowed = kv_pos[None, :] <= q_pos[:, None]
    if window:
        allowed &= kv_pos[None, :] > (q_pos[:, None] - window)
    if kv_valid is not None:
        allowed &= kv_valid[None, :]
    return _bias(allowed)[None, None, None]


def self_attention(p, x, *, n_heads, n_kv, head_dim, positions, theta,
                   window: int = 0, qk_norm: bool = False,
                   norm_eps: float = 1e-6, split: bool = False):
    """Full-sequence causal attention (training / scoring); ``qk_norm``
    RMS-normalises q and k over ``head_dim`` before RoPE.

    ``split``: ``p`` holds this model rank's heads (``n_heads`` and
    ``n_kv`` its local counts, whole kv groups): q, k and v are
    column-parallel, ``x`` enters through "f", and ``wo`` is row-parallel,
    its partials summed by "g".  The qk-norm gains (``[hd]``, whole) act
    on the local heads only, so they enter through "f" too: their
    gradient sums every rank's heads."""
    if split:
        x = collectives.copy_in(x)
        if qk_norm:
            p = dict(p, q_norm=collectives.copy_in(p["q_norm"]),
                     k_norm=collectives.copy_in(p["k_norm"]))
    q, k, v = _project_qkv(p, x, n_heads, n_kv, head_dim, positions, theta,
                           qk_norm, norm_eps)
    out = attend(q, k, v, causal_bias(positions, positions, window))
    return collectives.reduce_sum(out @ p["wo"]) if split else out @ p["wo"]


def prefill_attention(p, x, *, n_heads, n_kv, head_dim, positions, theta,
                      cache_len: int, window: int = 0, qk_norm: bool = False,
                      norm_eps: float = 1e-6):
    """Causal attention over the prompt, and its KV cache zero-padded to
    ``cache_len >= S`` slots (slot i holds position i)."""
    S = x.shape[1]
    q, k, v = _project_qkv(p, x, n_heads, n_kv, head_dim, positions, theta,
                           qk_norm, norm_eps)
    out = attend(q, k, v, causal_bias(positions, positions, window)) \
        @ p["wo"]
    pad = (0, 0, 0, 0, 0, cache_len - S)
    return out, KVCache(torch.nn.functional.pad(k, pad),
                        torch.nn.functional.pad(v, pad))


def decode_attention(p, x, cache: KVCache, pos: int, *, n_heads, n_kv,
                     head_dim, theta, window: int = 0, qk_norm: bool = False,
                     norm_eps: float = 1e-6, write_pos=None, kv_valid=None,
                     rope_pos=None):
    """One-token decode: write k, v at slot ``write_pos`` (default
    ``pos``), then attend over the cache.  ``kv_valid`` (``[S_cap]`` bool)
    replaces the default slot mask ``slot <= pos`` (ring buffers of
    sliding-window layers pass theirs); RoPE uses the true position
    ``rope_pos`` (default ``pos``); ``window`` also blocks slots at or
    below ``pos - window``.

    The write is in place: the returned cache holds the caller's tensors,
    which this call consumes (the reference's functional update, whose
    input XLA donates), and casts to the cache's dtype.  The cache is read
    in the compute dtype (a bf16 cache under float32 weights: bf16 storage,
    float32 arithmetic).  ``pos``, ``write_pos`` and ``rope_pos`` are
    Python ints."""
    rp = pos if rope_pos is None else rope_pos
    positions = torch.full((1,), rp, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, x, n_heads, n_kv, head_dim, positions, theta,
                           qk_norm, norm_eps)
    wp = pos if write_pos is None else write_pos
    cache.k[:, wp] = k[:, 0]
    cache.v[:, wp] = v[:, 0]
    kv_pos = torch.arange(cache.k.shape[1], device=x.device)
    allowed = kv_pos <= pos if kv_valid is None else kv_valid
    if window:
        allowed = allowed & (kv_pos > pos - window)
    out = attend(q, cache.k.to(q.dtype), cache.v.to(q.dtype),
                 _bias(allowed)[None, None, None, None])
    return out @ p["wo"], cache


def ring_slots(cache_len: int, window: int, S: int = 0) -> int:
    """The slots of a layer's cache: ``cache_len``, or for a
    sliding-window layer a ring of ``min(cache_len, window + 1)``; at
    least the prompt's ``S`` (the reference's two sizes: a prefill's, and
    :func:`init_decode_cache`'s with ``S = 0``)."""
    return max(min(cache_len, window + 1) if window else cache_len, S)


def ring_decode_attention(p, x, cache: KVCache, pos: int, *, window: int,
                          **kw):
    """One-token decode of a sliding-window layer over its ring of ``cap``
    slots: write slot ``pos % cap``; slot ``s`` holds position ``pos -
    ((pos - s) mod cap)`` (negative: not written yet), and the layer
    attends the positions in ``(pos - window, pos]``, those the forward's
    :func:`causal_bias` allows.  Here the port departs from the reference,
    whose ring attends every written slot (``window + 1`` positions, or
    the whole prompt when it is longer than ``window + 1``); before ``pos
    = window``, with a prompt of at most ``window + 1``, the two masks are
    the same.  ``kw``: :func:`decode_attention`'s head keywords."""
    cap = cache.k.shape[1]
    slot = torch.arange(cap, device=x.device)
    held = pos - torch.remainder(pos - slot, cap)
    return decode_attention(p, x, cache, pos, write_pos=pos % cap,
                            kv_valid=(held >= 0) & (held > pos - window),
                            rope_pos=pos, **kw)


# ---------------------------------------------------------------------------
# Cross attention (VLM media tokens / whisper encoder states)
# ---------------------------------------------------------------------------

def cross_attn_shapes(d: int, d_kv_in: int, n_heads: int, n_kv: int,
                      head_dim: int) -> dict:
    """q from the d-wide stream, k and v from the ``d_kv_in``-wide media;
    ``gate`` is a scalar (0 at init)."""
    return {"wq": (d, n_heads * head_dim), "wk": (d_kv_in, n_kv * head_dim),
            "wv": (d_kv_in, n_kv * head_dim), "wo": (n_heads * head_dim, d),
            "gate": ()}


def init_cross_attn(gen, d: int, d_kv_in: int, n_heads: int, n_kv: int,
                    head_dim: int, device=None) -> dict:
    return common.init_tree(
        gen, cross_attn_shapes(d, d_kv_in, n_heads, n_kv, head_dim), device)


def cross_kv(p, media, n_kv, head_dim) -> KVCache:
    """The cross layer's keys and values of ``media`` ``[B, M, d]``: its
    serving cache, filled once (``[B, M, KV, hd]``)."""
    B, M, _ = media.shape
    k = (media @ p["wk"]).reshape(B, M, n_kv, head_dim)
    v = (media @ p["wv"]).reshape(B, M, n_kv, head_dim)
    return KVCache(k, v)


def _no_mask(q, kv_len: int):
    return torch.zeros((1, 1, 1, 1, kv_len), dtype=torch.float32,
                       device=q.device)


def cross_attention(p, x, kv: KVCache, *, n_heads, head_dim,
                    gated: bool = True):
    """Every query attends to every media position (``kv`` read in the
    compute dtype, as a decode cache is); ``gated`` scales the output by
    ``tanh(gate)``."""
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, n_heads, head_dim)
    out = attend(q, kv.k.to(q.dtype), kv.v.to(q.dtype),
                 _no_mask(q, kv.k.shape[1])) @ p["wo"]
    if gated:
        out = torch.tanh(p["gate"]) * out
    return out


def bidir_attention(p, x, *, n_heads, n_kv, head_dim):
    """Bidirectional MHA without positions (the whisper encoder's)."""
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, n_heads, head_dim)
    k = (x @ p["wk"]).reshape(B, S, n_kv, head_dim)
    v = (x @ p["wv"]).reshape(B, S, n_kv, head_dim)
    return attend(q, k, v, _no_mask(q, S)) @ p["wo"]
