"""Flash-decode attention (port of ``repro.models.flash_decode``): one
query per sequence against a KV cache, as partial softmax statistics (max,
sum, weighted V) merged into the output.

With a mesh whose ``axis`` has size k (the given one, or the active one,
``sharding.partition.current_mesh``), the cache length is split into k
shards, each shard's statistics are computed on its own, and they are
merged as the reference's ``shard_map`` merges them across devices (a
max, then corrected sums: its ``pmax`` / ``psum``).  The shards are slices
of the tensors one process holds.  Without a mesh, or without ``axis`` in
it, one partial covers the whole cache (the reference's dense fallback).
Plain PyTorch, as the reference's is plain ``jnp``."""
from __future__ import annotations

import math

import torch

from repro_torch.sharding import partition


def _partial_attend(q, k, v, valid):
    """One shard's contribution.  q ``[B,KV,R,hd]``; k, v
    ``[B,S,KV,hd]``; valid ``[S]`` bool.  Returns ``(m, l, o)``: the
    row max (-inf where no slot is valid), the sum of exponentials and
    the exponential-weighted V, in float32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bkrh,bskh->bkrs", q.to(torch.float32) * scale,
                     k.to(torch.float32))
    s = torch.where(valid[None, None, None, :], s, -math.inf)
    m = s.amax(dim=-1)                                          # [B,KV,R]
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(valid[None, None, None, :], p, 0.0)
    l = p.sum(dim=-1)                                           # [B,KV,R]
    o = torch.einsum("bkrs,bskh->bkrh", p, v.to(torch.float32))
    return m, l, o


def flash_decode_attend(q, k_cache, v_cache, kv_valid, mesh=None,
                        axis: str = "model"):
    """q ``[B,1,H,hd]``; caches ``[B,S,KV,hd]``, length-sharded over
    ``axis`` when a mesh has it; kv_valid ``[S]`` bool.  Returns the
    ``[B,1,H*hd]`` attention output; a row with no valid slot gives 0
    (``max(l, 1e-30)``), not NaN."""
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    qg = q[:, 0].reshape(B, KV, H // KV, hd)
    mesh = partition.current_mesh() if mesh is None else mesh
    if mesh is None or axis not in mesh.axis_names:
        m, l, o = _partial_attend(qg, k_cache, v_cache, kv_valid)
        out = o / torch.clamp(l, min=1e-30)[..., None]
        return out.reshape(B, 1, H * hd).to(q.dtype)
    k = dict(zip(mesh.axis_names, mesh.devices.shape))[axis]
    S = k_cache.shape[1]
    if S % k:
        raise ValueError(f"cache length {S} does not split into {k} "
                         f"shards over {axis!r}")
    parts = [_partial_attend(qg, ks, vs, val) for ks, vs, val in zip(
        k_cache.chunk(k, 1), v_cache.chunk(k, 1), kv_valid.chunk(k))]
    # the stable logsumexp merge across shards
    m_glob = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    m_safe = torch.where(torch.isfinite(m_glob), m_glob, 0.0)
    l_glob, o_glob = 0.0, 0.0
    for m, l, o in parts:
        corr = torch.exp(torch.where(torch.isfinite(m), m, -math.inf)
                         - m_safe)
        l_glob = l_glob + l * corr
        o_glob = o_glob + o * corr[..., None]
    out = o_glob / torch.clamp(l_glob, min=1e-30)[..., None]
    return out.reshape(B, 1, H * hd).to(q.dtype)
