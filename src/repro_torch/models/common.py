"""Shared model building blocks (port of ``repro.models.common``)."""
from __future__ import annotations

import math

import torch


def dense_init(gen: torch.Generator, shape, in_axis: int = 0,
               device=None) -> torch.Tensor:
    """Fan-in scaled normal init; ``in_axis`` indexes ``shape``."""
    fan_in = shape[in_axis]
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return x / math.sqrt(max(fan_in, 1))


def embed_init(gen: torch.Generator, vocab: int, d: int,
               device=None) -> torch.Tensor:
    return torch.randn((vocab, d), generator=gen, device=device,
                       dtype=torch.float32) * 0.02


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + gamma)).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: ``[..., S, H, hd]``; positions broadcastable to ``[..., S]``."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # [hd/2]
    angles = positions[..., None].to(torch.float32) * freqs  # [..., S, hd/2]
    angles = angles[..., None, :]                           # [..., S, 1, hd/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    h = torch.nn.functional.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token CE; logits ``[B, S, V]``, targets ``[B, S]``."""
    lf = logits.to(torch.float32)
    logz = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, targets[..., None].to(torch.int64))[..., 0]
    nll = logz - ll
    if mask is None:
        return nll.mean()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
