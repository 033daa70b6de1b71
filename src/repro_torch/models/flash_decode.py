"""Flash-decode attention (port of ``repro.models.flash_decode``): one
query per sequence against a KV cache, as partial softmax statistics (max,
sum, weighted V) merged into the output.

The reference merges the statistics of a length-sharded cache across a
mesh with one collective; the port runs on one card and has no mesh
(``sharding/partition.activate_mesh`` takes only None), so it takes the
reference's dense path: one partial over the whole cache.  Plain PyTorch,
as the reference's is plain ``jnp``."""
from __future__ import annotations

import math

import torch


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
    """q ``[B,1,H,hd]``; caches ``[B,S,KV,hd]``; kv_valid ``[S]`` bool.
    Returns the ``[B,1,H*hd]`` attention output; a row with no valid slot
    gives 0 (``max(l, 1e-30)``), not NaN.  ``mesh`` must be None (one
    card: there is no length-sharded cache to merge across)."""
    if mesh is not None:
        raise NotImplementedError(
            "flash_decode_attend over a device mesh is not ported yet (it "
            "comes with launch/mesh.py); on one card pass mesh=None")
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    qg = q[:, 0].reshape(B, KV, H // KV, hd)
    m, l, o = _partial_attend(qg, k_cache, v_cache, kv_valid)
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, 1, H * hd).to(q.dtype)
