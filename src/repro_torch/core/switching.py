"""Switching rules (Section 3): hard indicator and soft trimmed hinge (port
of ``repro.core.switching``)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import SwitchConfig


def sigma_beta(violation: torch.Tensor, beta: float) -> torch.Tensor:
    """Trimmed hinge ``Proj_[0,1](1 + beta * x)`` of ``x = G_hat - eps``."""
    return torch.clamp(1.0 + beta * violation, 0.0, 1.0)


def switch_weight(g_hat: torch.Tensor, cfg: SwitchConfig) -> torch.Tensor:
    """sigma_t in [0, 1]: the weight on the constraint gradient."""
    if cfg.mode == "hard":
        return (g_hat > cfg.eps).to(torch.float32)
    if cfg.mode == "soft":
        return sigma_beta(g_hat - cfg.eps, cfg.beta)
    raise ValueError(f"unknown switching mode: {cfg.mode}")


def averaged_iterate_weight(g_val: torch.Tensor,
                            cfg: SwitchConfig) -> torch.Tensor:
    """Per-round weight alpha_t of w_t in the averaged iterate: hard
    ``1{G_hat <= eps}`` (Theorem 1), soft ``[1 - sigma_beta] * 1{g < eps}``
    (Theorem 2)."""
    if cfg.mode == "hard":
        return (g_val <= cfg.eps).to(torch.float32)
    w = 1.0 - sigma_beta(g_val - cfg.eps, cfg.beta)
    return w * (g_val < cfg.eps).to(torch.float32)
