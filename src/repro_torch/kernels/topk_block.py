"""Block-wise magnitude top-k: the CUDA kernel ``csrc/topk_block.cu`` and its
plain PyTorch version (port of ``repro.kernels.topk_block``).

Per row: the k entries of largest |x|, in descending |x| order with ties to
the lowest index -- the order the TPU kernel's k rounds of masked argmax
emit -- as (values from x, int32 within-row indices).  Every NaN counts as
one magnitude above +inf, so NaNs tie and fall to index order.

The kernel has two variants, chosen by shape alone (:func:`variant`): a
warp-per-row radix select for the main path's shapes (block <= 1024,
k <= 128; 16-byte loads when the rows are 16-byte aligned) and a whole-row
bitonic sort for the rest.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
MAX_BLOCK = 2048
VARIANTS = ("bitonic", "radix-scalar", "radix-vec4")


def block_topk_plain(x: torch.Tensor, k: int):
    """``x [..., block]`` -> (values ``[..., k]``, int32 indices ``[..., k]``).

    A stable descending sort of |x| keeps equal magnitudes (``-0.0`` ties
    ``+0.0``, NaNs tie each other above ``inf``) in ascending index
    order."""
    order = torch.sort(x.abs(), dim=-1, descending=True, stable=True).indices
    idx = order[..., :k]
    return torch.gather(x, -1, idx), idx.to(torch.int32)


def block_topk(x: torch.Tensor, k: int):
    """``x [nb, block]`` or ``[n, nb, block]`` float32 -> (values, int32
    indices), each ``x.shape[:-1] + (k,)``.  The inner ``[nb, block]`` rows
    must be contiguous; the leading stride is free, so a run view of a
    ``[n, d]`` buffer goes in without a copy.

    CPU tensors take :func:`block_topk_plain`; CUDA tensors launch the
    kernel (counted in ``block_topk.launches``); meta tensors (the dry run)
    get empty outputs of the plain version's shapes."""
    if x.dtype != torch.float32:
        raise TypeError(f"block_topk: expected float32, got {x.dtype}")
    block = x.shape[-1]
    if not 1 <= k <= block:
        raise ValueError(f"block_topk: need 1 <= k <= block, got k={k}, "
                         f"block={block}")
    if x.device.type == "cpu":
        return block_topk_plain(x, k)
    if x.device.type == "meta":         # the dry run: shapes only
        out = x.shape[:-1] + (k,)
        return (torch.empty(out, dtype=torch.float32, device="meta"),
                torch.empty(out, dtype=torch.int32, device="meta"))
    if x.device.type != "cuda":
        raise ValueError(f"block_topk: unsupported device {x.device}")
    if block > MAX_BLOCK:
        raise ValueError(f"block_topk: block {block} > {MAX_BLOCK}")
    x3 = build.rows3(x, "block_topk")
    n, nb, _ = x3.shape
    vals = torch.empty(x.shape[:-1] + (k,), dtype=torch.float32,
                       device=x.device)
    idx = torch.empty(x.shape[:-1] + (k,), dtype=torch.int32, device=x.device)
    build.launch("topk_block", "block_topk_launch",
                 [_P, _LL, _LL, _I, _I, _I, _P, _P],
                 [x3.data_ptr(), x3.stride(0), n * nb, nb, block, k,
                  vals.data_ptr(), idx.data_ptr()], x.device)
    block_topk.launches += 1
    return vals, idx


block_topk.launches = 0


def variant(x: torch.Tensor, k: int) -> str:
    """The kernel variant :func:`block_topk` launches for the CUDA tensor
    ``x`` and ``k`` (one of :data:`VARIANTS`), as ``block_topk_launch``
    chooses it."""
    x3 = build.rows3(x, "block_topk")
    fn = build.load("topk_block").block_topk_variant
    fn.argtypes = [_P, _LL, _I, _I]
    fn.restype = _I
    return VARIANTS[fn(x3.data_ptr(), x3.stride(0), x3.shape[-1], k)]
