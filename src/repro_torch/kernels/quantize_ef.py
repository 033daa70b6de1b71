"""Fused EF14 quantization step with a dense output: the CUDA kernel
``csrc/quantize_ef.cu`` and its plain PyTorch version
(:func:`repro_torch.kernels.ref.quantize_ef_ref`; port of
``repro.kernels.quantize_ef``).

    buf = e + delta
    v   = Q_b(buf)          (per-row max-abs scaled b-bit rounding)
    e'  = buf - v
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import quantize_ef_ref

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
MAX_BLOCK = 8192        # buf in shared memory: 32 KB


def quantize_ef(e: torch.Tensor, delta: torch.Tensor, bits: int):
    """``e, delta [nblocks, block]`` float32 -> ``(v, e_new)``, both
    ``[nblocks, block]`` and freshly allocated.

    CPU tensors take :func:`quantize_ef_ref`; CUDA tensors launch the kernel
    (counted in ``quantize_ef.launches``); meta tensors (the dry run) get
    empty outputs of the plain version's shapes."""
    if not 2 <= bits <= 16:
        raise ValueError(f"quantize_ef: bits={bits} outside [2, 16]")
    if e.dim() != 2 or e.shape != delta.shape:
        raise ValueError(f"quantize_ef: expected equal [nblocks, block] "
                         f"shapes, got {tuple(e.shape)} and "
                         f"{tuple(delta.shape)}")
    if e.dtype != torch.float32 or delta.dtype != torch.float32:
        raise TypeError("quantize_ef: expected float32 inputs")
    if e.device != delta.device:
        raise ValueError("quantize_ef: inputs on different devices")
    if e.device.type == "cpu":
        return quantize_ef_ref(e, delta, bits)
    if e.device.type == "meta":         # the dry run: shapes only
        return torch.empty_like(e), torch.empty_like(e)
    if e.device.type != "cuda":
        raise ValueError(f"quantize_ef: unsupported device {e.device}")
    rows, block = e.shape
    if block > MAX_BLOCK:
        raise ValueError(f"quantize_ef: block {block} > {MAX_BLOCK}")
    e, delta = e.contiguous(), delta.contiguous()
    v = torch.empty_like(e)
    e_new = torch.empty_like(e)
    build.launch("quantize_ef", "quantize_ef_launch",
                 [_P, _P, _LL, _I, _I, _P, _P],
                 [e.data_ptr(), delta.data_ptr(), rows, block, bits,
                  v.data_ptr(), e_new.data_ptr()], e.device)
    quantize_ef.launches += 1
    return v, e_new


quantize_ef.launches = 0
