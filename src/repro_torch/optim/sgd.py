"""Flat-buffer arithmetic the engine needs (port of the part of
``repro.optim.sgd`` the round uses)."""
from __future__ import annotations

import torch


def axpy(s, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """y + s * x (the reference's ``tree_axpy`` on flat buffers)."""
    return y + s * x
