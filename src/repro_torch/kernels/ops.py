"""Shape-generic entry points around the kernels (port of
``repro.kernels.ops``).  The reference picks an implementation per shape
through its tuner (``repro.kernels.tune``, not ported); the port has one
implementation per kernel -- the CUDA kernel of the reference's seeded TPU
plan (``tune.py:81-97``) on CUDA tensors, its plain version on CPU tensors
-- so these wrappers only reshape, pad and cast.  Each wraps its launch in
the reference's ``kernel.*`` span (:func:`repro_torch.obs.trace.stage`), so
a profile attributes the device time to each kernel by name."""
from __future__ import annotations

import torch

from repro_torch.kernels import quantize_ef_pack as _qep
from repro_torch.kernels import scatter_agg as _scatter_agg
from repro_torch.kernels import topk_block as _topk
from repro_torch.kernels.quantize_ef import quantize_ef
from repro_torch.kernels.switch_blend import switch_blend
from repro_torch.kernels.unpack_mma import unpack_mma
from repro_torch.obs.trace import stage


def block_topk(x: torch.Tensor, k: int):
    """:func:`repro_torch.kernels.topk_block.block_topk` in its span."""
    with stage("kernel.block_topk"):
        return _topk.block_topk(x, k)


def quantize_ef_pack(e: torch.Tensor, delta: torch.Tensor, bits: int):
    """:func:`repro_torch.kernels.quantize_ef_pack.quantize_ef_pack` in its
    span."""
    with stage("kernel.quantize_ef_pack"):
        return _qep.quantize_ef_pack(e, delta, bits)


def scatter_agg(vals: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor,
                block: int) -> torch.Tensor:
    """Weighted bucket aggregation of stacked select payloads: vals ``[n,
    nblocks, k]`` + uint16 within-block offsets ``[n, nblocks, k]`` + weight
    ``[n]`` -> ``[nblocks, block]`` float32, duplicate offsets adding.  A
    block of 1 is a weighted sum over the clients; every other block goes
    through the ``scatter_agg`` kernel."""
    weight = weight.to(torch.float32)
    if block == 1:
        return torch.tensordot(weight, vals.to(torch.float32),
                               dims=([0], [0]))
    with stage("kernel.scatter_agg"):
        return _scatter_agg.scatter_agg(vals, idx, weight, block)


def quant_agg(words: torch.Tensor, scale: torch.Tensor, weight: torch.Tensor,
              bits: int, block: int) -> torch.Tensor:
    """Weighted aggregation of stacked quant payloads: words ``[n, nblocks,
    W]`` uint32 + scale ``[n, nblocks]`` + weight ``[n]`` -> ``[nblocks,
    block]`` float32, through the ``unpack_mma`` kernel."""
    with stage("kernel.quant_agg"):
        return unpack_mma(words, scale, weight.to(torch.float32), bits,
                          block)


def _to_blocks(x: torch.Tensor, block: int):
    """Flatten ``x`` and zero-pad it to ``[-1, min(block, numel)]``."""
    flat = x.reshape(-1)
    d = flat.shape[0]
    b = min(block, d)
    pad = (-d) % b
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, b), d


def quantize_ef_apply(e: torch.Tensor, delta: torch.Tensor, bits: int,
                      block: int = 1024):
    """Fused EF14 quantization (:func:`quantize_ef`) for arbitrary-shape
    float32 arrays, blocked along the flattened array: ``(v, e_new)`` shaped
    like ``e``."""
    eb, d = _to_blocks(e, block)
    db, _ = _to_blocks(delta, block)
    with stage("kernel.quantize_ef"):
        v, e_new = quantize_ef(eb, db, bits)

    def unblock(t):
        return t.reshape(-1)[:d].reshape(e.shape)
    return unblock(v), unblock(e_new)


def segment_rows(rows: torch.Tensor, seg: torch.Tensor,
                 n: int) -> torch.Tensor:
    """Segment-sum of ``[m, ...]`` rows into the ``[n, ...]`` population
    layout: ``out[i] = sum_{seg[j] == i} rows[j]`` (duplicate ids add, ids
    outside ``[0, n)`` drop), summed in float32 and cast back to
    ``rows.dtype``."""
    m = rows.shape[0]
    with stage("kernel.segment_rows"):
        out = _scatter_agg.segment_rows(
            rows.reshape(m, -1).to(torch.float32), seg, n)
    return out.reshape((n,) + tuple(rows.shape[1:])).to(rows.dtype)


def switch_blend_tree(gf_tree, gg_tree, sigma: torch.Tensor):
    """:func:`switch_blend` over a nested dict / list of gradient tensors
    (each leaf blended flat, then given back its shape)."""
    if isinstance(gf_tree, dict):
        return {k: switch_blend_tree(gf_tree[k], gg_tree[k], sigma)
                for k in gf_tree}
    if isinstance(gf_tree, list):
        return [switch_blend_tree(f, g, sigma)
                for f, g in zip(gf_tree, gg_tree)]
    return switch_blend(gf_tree.reshape(-1), gg_tree.reshape(-1),
                        sigma).reshape(gf_tree.shape)
