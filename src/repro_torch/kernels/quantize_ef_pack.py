"""Fused EF14 quantize-and-pack: the CUDA kernel ``csrc/quantize_ef_pack.cu``
and its plain PyTorch version (port of ``repro.kernels.quantize_ef_pack``).

    buf   = e + delta
    scale = max|buf|                      (per row)
    codes = round(buf / scale * L)        (L = 2^(b-1) - 1, half to even)
    words = pack_b(codes + L)             (32 // b biased lanes per uint32)
    e'    = buf - codes / L * scale
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.comm import payloads
from repro_torch.kernels import build

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
MAX_BLOCK = 4096


def quantize_ef_pack_plain(e: torch.Tensor, delta: torch.Tensor, bits: int):
    """``e, delta [..., block]`` -> (words uint32 ``[..., W]``, scale
    ``[..., 1]``, e_new ``[..., block]``).  Pad lanes of the last word are
    zero bits, not the biased zero code."""
    buf = e + delta
    codes, scale = payloads.quant_blocks(buf, bits)
    # a tensor divisor: PyTorch's CUDA divide by a Python scalar multiplies
    # by its reciprocal, and the kernel divides (IEEE)
    levels = torch.tensor(float(2 ** (bits - 1) - 1), device=buf.device)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    v = torch.where(scale > 0, codes / levels * safe, torch.zeros_like(buf))
    # scale == 0 means buf == 0, whose codes are already 0
    return payloads.pack_codes(codes, bits), scale, buf - v


def quantize_ef_pack(e: torch.Tensor, delta: torch.Tensor, bits: int):
    """``e, delta``: ``[nb, block]`` or ``[n, nb, block]`` float32 with
    contiguous inner ``[nb, block]`` (the leading strides are free) ->
    (words uint32 ``[..., W]``, scale ``[..., 1]``, e_new ``[..., block]``),
    all freshly allocated.

    CPU tensors take :func:`quantize_ef_pack_plain`; CUDA tensors launch
    the kernel (counted in ``quantize_ef_pack.launches``); meta tensors
    (the dry run) get empty outputs of the plain version's shapes."""
    if bits not in payloads.PACK_BITS:
        raise ValueError(f"bits={bits} not packable; expected "
                         f"{payloads.PACK_BITS}")
    if e.shape != delta.shape:
        raise ValueError(f"quantize_ef_pack: shapes differ, {tuple(e.shape)} "
                         f"vs {tuple(delta.shape)}")
    if e.dtype != torch.float32 or delta.dtype != torch.float32:
        raise TypeError("quantize_ef_pack: expected float32 inputs")
    if e.device != delta.device:
        raise ValueError("quantize_ef_pack: inputs on different devices")
    if e.device.type == "cpu":
        return quantize_ef_pack_plain(e, delta, bits)
    if e.device.type == "meta":         # the dry run: shapes only
        lead = e.shape[:-1]
        W = payloads.words_per_block(e.shape[-1], bits)
        return (torch.empty(lead + (W,), dtype=torch.uint32, device="meta"),
                torch.empty(lead + (1,), dtype=torch.float32, device="meta"),
                torch.empty(e.shape, dtype=torch.float32, device="meta"))
    if e.device.type != "cuda":
        raise ValueError(f"quantize_ef_pack: unsupported device {e.device}")
    block = e.shape[-1]
    if block > MAX_BLOCK:
        raise ValueError(f"quantize_ef_pack: block {block} > {MAX_BLOCK}")
    e3 = build.rows3(e, "quantize_ef_pack")
    d3 = build.rows3(delta, "quantize_ef_pack")
    n, nb, _ = e3.shape
    W = payloads.words_per_block(block, bits)
    lead = e.shape[:-1]
    words = torch.empty(lead + (W,), dtype=torch.int32,
                        device=e.device).view(torch.uint32)
    scale = torch.empty(lead + (1,), dtype=torch.float32, device=e.device)
    e_new = torch.empty(e.shape, dtype=torch.float32, device=e.device)
    build.launch("quantize_ef_pack", "quantize_ef_pack_launch",
                 [_P, _LL, _P, _LL, _LL, _I, _I, _I, _I, _P, _P, _P],
                 [e3.data_ptr(), e3.stride(0), d3.data_ptr(), d3.stride(0),
                  n * nb, nb, block, bits, W, words.data_ptr(),
                  scale.data_ptr(), e_new.data_ptr()], e.device)
    quantize_ef_pack.launches += 1
    return words, scale, e_new


quantize_ef_pack.launches = 0
