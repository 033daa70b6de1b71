"""Fused unpack-multiply-add aggregation: the CUDA kernel
``csrc/unpack_mma.cu`` and its plain PyTorch version (port of
``repro.kernels.unpack_mma``).

    acc[b] = sum_j  weight_j * scale_{j,b} / L * (unpack(words_{j,b}) - L)

summed over clients in order.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.comm import payloads
from repro_torch.kernels import build

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int


def unpack_mma_plain(words: torch.Tensor, scale: torch.Tensor,
                     weight: torch.Tensor, bits: int, block: int):
    """words ``[n, nb, W]`` uint32, scale ``[n, nb]``, weight ``[n]`` ->
    ``[nb, block]`` float32, accumulated client by client from zero."""
    # a tensor divisor: PyTorch's CUDA divide by a Python scalar multiplies
    # by its reciprocal, and the kernel divides (IEEE)
    levels = torch.tensor(float(2 ** (bits - 1) - 1), device=words.device)
    codes = payloads.unpack_codes(words, bits, block)      # [n, nb, block]
    acc = torch.zeros(words.shape[1:-1] + (block,), dtype=torch.float32,
                      device=words.device)
    for j in range(words.shape[0]):
        vals = codes[j].to(torch.float32)   # == float(lane) - L exactly
        w = weight[j] * scale[j] / levels                  # [nb]
        acc = acc + w[:, None] * vals
    return acc


def unpack_mma(words: torch.Tensor, scale: torch.Tensor, weight: torch.Tensor,
               bits: int, block: int):
    """words ``[n, nb, W]`` uint32, scale ``[n, nb]`` float32, weight ``[n]``
    float32 -> the weighted payload-domain sum ``[nb, block]`` float32.
    ``words``/``scale`` need contiguous inner dims; their leading strides
    are free (run views of the stacked payload go in without a copy).

    CPU tensors take :func:`unpack_mma_plain`; CUDA tensors launch the
    kernel (counted in ``unpack_mma.launches``); meta tensors (the dry
    run) get an empty output of the plain version's shape."""
    if bits not in payloads.PACK_BITS:
        raise ValueError(f"bits={bits} not packable; expected "
                         f"{payloads.PACK_BITS}")
    if words.dim() != 3 or scale.shape != words.shape[:2] or \
            weight.shape != words.shape[:1]:
        raise ValueError(f"unpack_mma: shapes words {tuple(words.shape)}, "
                         f"scale {tuple(scale.shape)}, weight "
                         f"{tuple(weight.shape)} do not agree")
    W = words.shape[-1]
    if W != payloads.words_per_block(block, bits):
        raise ValueError(f"unpack_mma: {W} words cannot hold a {block}-code "
                         f"block at {bits} bits")
    if words.dtype != torch.uint32 or scale.dtype != torch.float32 or \
            weight.dtype != torch.float32:
        raise TypeError("unpack_mma: expected uint32 words and float32 "
                        "scale/weight")
    if not words.device == scale.device == weight.device:
        raise ValueError("unpack_mma: inputs on different devices")
    if words.device.type == "cpu":
        return unpack_mma_plain(words, scale, weight, bits, block)
    if words.device.type == "meta":     # the dry run: shapes only
        return torch.empty((words.shape[1], block), dtype=torch.float32,
                           device="meta")
    if words.device.type != "cuda":
        raise ValueError(f"unpack_mma: unsupported device {words.device}")
    n, nb, _ = build.rows3(words, "unpack_mma").shape
    if nb > 1 and scale.stride(1) != 1:
        raise ValueError("unpack_mma: scale rows must be contiguous")
    weight = weight.contiguous()
    out = torch.empty((nb, block), dtype=torch.float32, device=words.device)
    build.launch("unpack_mma", "unpack_mma_launch",
                 [_P, _LL, _P, _LL, _P, _I, _I, _I, _I, _I, _P],
                 [words.data_ptr(), words.stride(0), scale.data_ptr(),
                  scale.stride(0), weight.data_ptr(), n, nb, W, block, bits,
                  out.data_ptr()], words.device)
    unpack_mma.launches += 1
    return out


unpack_mma.launches = 0
