"""Soft-switch gradient blend: the CUDA kernel ``csrc/switch_blend.cu`` and
its plain PyTorch version (port of ``repro.kernels.switch_blend``).

    nu = (1 - sigma) * g_f + sigma * g_g

sigma is the round-constant switching weight, a one-element tensor on the
buffers' device (the kernel reads it there, so the host never waits for it).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_LL = ctypes.c_longlong


def switch_blend_plain(gf: torch.Tensor, gg: torch.Tensor,
                       sigma: torch.Tensor) -> torch.Tensor:
    """The blend as separate PyTorch operations, each rounded on its own."""
    s = sigma.reshape(())
    return (1.0 - s) * gf + s * gg


def switch_blend(gf: torch.Tensor, gg: torch.Tensor,
                 sigma: torch.Tensor) -> torch.Tensor:
    """``gf, gg [d]`` float32 + one-element float32 ``sigma`` -> the blend
    ``[d]``, freshly allocated.

    CPU tensors take :func:`switch_blend_plain`; CUDA tensors launch the
    kernel (counted in ``switch_blend.launches``); meta tensors (the dry
    run) get an empty output of the plain version's shape."""
    if gf.dim() != 1 or gf.shape != gg.shape or sigma.numel() != 1:
        raise ValueError(f"switch_blend: expected [d] buffers and one sigma, "
                         f"got {tuple(gf.shape)}, {tuple(gg.shape)} and "
                         f"{tuple(sigma.shape)}")
    if not gf.dtype == gg.dtype == sigma.dtype == torch.float32:
        raise TypeError("switch_blend: expected float32 inputs")
    if not gf.device == gg.device == sigma.device:
        raise ValueError("switch_blend: inputs on different devices")
    if gf.device.type == "cpu":
        return switch_blend_plain(gf, gg, sigma)
    if gf.device.type == "meta":        # the dry run: shapes only
        return torch.empty_like(gf)
    if gf.device.type != "cuda":
        raise ValueError(f"switch_blend: unsupported device {gf.device}")
    gf, gg, sigma = gf.contiguous(), gg.contiguous(), sigma.contiguous()
    out = torch.empty_like(gf)
    build.launch("switch_blend", "switch_blend_launch",
                 [_P, _P, _P, _LL, _P],
                 [gf.data_ptr(), gg.data_ptr(), sigma.data_ptr(),
                  gf.shape[0], out.data_ptr()], gf.device)
    switch_blend.launches += 1
    return out


switch_blend.launches = 0
