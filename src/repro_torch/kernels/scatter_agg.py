"""Bucketed select-payload aggregation: the CUDA kernel
``csrc/scatter_agg.cu`` and its plain PyTorch version (port of
``repro.kernels.scatter_agg.scatter_agg``).

    acc[b, o] = sum_j sum_t  weight_j * vals[j, b, t] * 1[idx[j, b, t] == o]

Duplicate offsets add; offsets outside ``[0, block)`` drop.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.comm import payloads
from repro_torch.kernels import build

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
MAX_BLOCK = 8192


def scatter_agg_plain(vals: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor, block: int) -> torch.Tensor:
    """vals ``[n, nb, k]`` + uint16 offsets ``[n, nb, k]`` + weight ``[n]``
    -> ``[nb, block]`` float32, added client by client."""
    n, nb, k = vals.shape
    offs = payloads.u16_to_i64(idx)
    keep = offs < block
    pos = torch.arange(nb, device=vals.device)[:, None] * block + offs
    acc = torch.zeros(nb * block, dtype=torch.float32, device=vals.device)
    for j in range(n):
        wv = vals[j].to(torch.float32) * weight[j]
        acc.index_add_(0, pos[j][keep[j]], wv[keep[j]])
    return acc.reshape(nb, block)


def scatter_agg(vals: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor,
                block: int) -> torch.Tensor:
    """vals ``[n, nb, k]`` float32 + within-block offsets ``[n, nb, k]``
    uint16 + weight ``[n]`` float32 -> weighted bucket sums ``[nb, block]``
    float32.  ``vals``/``idx`` need contiguous inner ``[nb, k]``; their
    leading strides are free.

    CPU tensors take :func:`scatter_agg_plain`; CUDA tensors launch the
    kernel (counted in ``scatter_agg.launches``)."""
    if vals.dim() != 3 or idx.shape != vals.shape or \
            weight.shape != vals.shape[:1]:
        raise ValueError(f"scatter_agg: shapes vals {tuple(vals.shape)}, idx "
                         f"{tuple(idx.shape)}, weight {tuple(weight.shape)} "
                         "do not agree")
    if vals.dtype != torch.float32 or idx.dtype != torch.uint16 or \
            weight.dtype != torch.float32:
        raise TypeError("scatter_agg: expected float32 vals/weight and uint16 "
                        "offsets")
    if not vals.device == idx.device == weight.device:
        raise ValueError("scatter_agg: inputs on different devices")
    if vals.device.type == "cpu":
        return scatter_agg_plain(vals, idx, weight, block)
    if vals.device.type != "cuda":
        raise ValueError(f"scatter_agg: unsupported device {vals.device}")
    if block > MAX_BLOCK:
        raise ValueError(f"scatter_agg: block {block} > {MAX_BLOCK}")
    n, nb, k = build.rows3(vals, "scatter_agg").shape
    build.rows3(idx, "scatter_agg")
    weight = weight.contiguous()
    out = torch.empty((nb, block), dtype=torch.float32, device=vals.device)
    build.launch("scatter_agg", "scatter_agg_launch",
                 [_P, _LL, _P, _LL, _P, _I, _I, _I, _I, _P],
                 [vals.data_ptr(), vals.stride(0), idx.data_ptr(),
                  idx.stride(0), weight.data_ptr(), n, nb, k, block,
                  out.data_ptr()], vals.device)
    scatter_agg.launches += 1
    return out


scatter_agg.launches = 0
