"""Independent oracles for the kernels (port of ``repro.kernels.ref``)."""
from __future__ import annotations

import torch


def block_topk_ref(x: torch.Tensor, k: int):
    """x ``[nblocks, block]`` -> (values, int32 indices), through
    ``torch.topk`` (ties may order differently from the kernel's)."""
    idx = torch.topk(x.abs(), k, dim=-1).indices
    return torch.gather(x, -1, idx), idx.to(torch.int32)


def quantize_ef_ref(e: torch.Tensor, delta: torch.Tensor, bits: int):
    """EF14 step with per-block max-abs b-bit quantization: (v, e_new)."""
    buf = e + delta
    scale = buf.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: PyTorch's CUDA divide by a Python scalar multiplies
    # by its reciprocal, and the kernel divides (IEEE)
    levels = torch.tensor(float(2 ** (bits - 1) - 1), device=buf.device)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    v = torch.round(buf / safe * levels) / levels * safe
    v = torch.where(scale > 0, v, torch.zeros_like(v))
    return v, buf - v
