"""The two aggregation kernels of ``repro.kernels.scatter_agg``, each a CUDA
kernel beside its plain PyTorch version.

* :func:`scatter_agg` (``csrc/scatter_agg.cu``), bucketed select-payload
  aggregation::

    acc[b, o] = sum_j sum_t  weight_j * vals[j, b, t] * 1[idx[j, b, t] == o]

  Duplicate offsets add; offsets outside ``[0, block)`` drop.
* :func:`segment_rows` (``csrc/segment_rows.cu``), participant rows into the
  population layout::

    out[i] = sum_{j : seg[j] == i} rows[j]

  Duplicate ids add; ids outside ``[0, n)`` drop.
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
    kernel (counted in ``scatter_agg.launches``); meta tensors (the dry
    run) get an empty output of the plain version's shape."""
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
    if vals.device.type == "meta":      # the dry run: shapes only
        return torch.empty((vals.shape[1], block), dtype=torch.float32,
                           device="meta")
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


MAX_IDS = 4096          # the kernel keeps the ids in shared memory
MAX_OUT_ROWS = 65535    # one grid row per output row


def segment_rows_plain(rows: torch.Tensor, seg: torch.Tensor,
                       n: int) -> torch.Tensor:
    """rows ``[m, D]`` + integer ids ``[m]`` -> ``[n, D]`` float32: the rows
    added one by one, in order, into zeros (``index_add_`` of one row at a
    time, so duplicates add in row order).  Ids outside ``[0, n)`` land in a
    spare row that is cut off, so the ids never leave the device."""
    m, D = rows.shape
    ids = seg.to(torch.int64)
    ids = torch.where((ids >= 0) & (ids < n), ids, torch.full_like(ids, n))
    out = torch.zeros((n + 1, D), dtype=torch.float32, device=rows.device)
    for j in range(m):
        out.index_add_(0, ids[j:j + 1], rows[j:j + 1].to(torch.float32))
    return out[:n]


def segment_rows(rows: torch.Tensor, seg: torch.Tensor,
                 n: int) -> torch.Tensor:
    """rows ``[m, D]`` float32 (contiguous rows, free leading stride) +
    integer ids ``[m]`` -> the segment sums ``[n, D]`` float32, freshly
    allocated.

    CPU tensors take :func:`segment_rows_plain`; CUDA tensors launch the
    kernel (counted in ``segment_rows.launches``); meta tensors (the dry
    run) get an empty output of the plain version's shape."""
    if rows.dim() != 2 or seg.shape != rows.shape[:1]:
        raise ValueError(f"segment_rows: shapes rows {tuple(rows.shape)}, "
                         f"seg {tuple(seg.shape)} do not agree")
    if rows.dtype != torch.float32 or seg.dtype.is_floating_point:
        raise TypeError("segment_rows: expected float32 rows and integer "
                        "ids")
    if rows.device != seg.device:
        raise ValueError("segment_rows: inputs on different devices")
    if rows.device.type == "cpu":
        return segment_rows_plain(rows, seg, n)
    if rows.device.type == "meta":      # the dry run: shapes only
        return torch.empty((n, rows.shape[1]), dtype=torch.float32,
                           device="meta")
    if rows.device.type != "cuda":
        raise ValueError(f"segment_rows: unsupported device {rows.device}")
    m, D = rows.shape
    if m > MAX_IDS or n > MAX_OUT_ROWS:
        raise ValueError(f"segment_rows: m = {m} > {MAX_IDS} or n = {n} > "
                         f"{MAX_OUT_ROWS}")
    if D > 1 and rows.stride(1) != 1:
        raise ValueError("segment_rows: rows must be contiguous")
    seg = seg.to(torch.int32).contiguous()
    out = torch.empty((n, D), dtype=torch.float32, device=rows.device)
    build.launch("segment_rows", "segment_rows_launch",
                 [_P, _LL, _P, _I, _LL, _I, _P],
                 [rows.data_ptr(), rows.stride(0), seg.data_ptr(), m, D, n,
                  out.data_ptr()], rows.device)
    segment_rows.launches += 1
    return out


segment_rows.launches = 0
