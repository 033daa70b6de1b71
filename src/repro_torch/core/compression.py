"""Contractive compressors as per-leaf operators (port of
``repro.core.compression``): the dense wire's compressor math.

* ``topk``    -- magnitude top-k of the whole leaf (k = round(d * ratio));
  leaves above 2^22 elements take the block-wise threshold variant
  (``payloads.block_topk_dense``),
* ``randk``   -- k uniformly random coordinates, no rescale,
* ``quant``   -- per-block max-abs symmetric b-bit rounding,
* ``natural`` -- stochastic rounding of |x| to a power of two,
* ``none``    -- identity.

Every operator takes ``batch`` leading axes that are not part of the leaf
(the client axis of a stacked ``[n, ...]`` tree): the deterministic kinds
run all rows at once, the random kinds draw from one ``torch.Generator``
per call (a client's stream), so callers give each client its own call.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.comm.payloads import (_SORT_FREE_MIN, block_topk_dense,
                                       choose_block, sort_free_keep,
                                       tree_leaves, tree_map)


def _rows(x: torch.Tensor, batch: int) -> torch.Tensor:
    """``x`` as ``[*batch dims, leaf size]``."""
    return x.reshape(tuple(x.shape[:batch]) + (-1,))


def _leaf_topk(x: torch.Tensor, ratio: float, batch: int = 0):
    """The k = round(d * ratio) entries of largest |x| of each leaf row, the
    rest zeros.  The reference keeps the LAST k of a stable ascending
    argsort of |x|: ties at the boundary go to the higher index, NaNs
    (sorted last) are kept first."""
    flat = _rows(x, batch)
    d = flat.shape[-1]
    k = max(1, int(round(d * ratio)))
    if k >= d:
        return x
    idx = torch.argsort(flat.abs(), dim=-1, stable=True)[..., d - k:]
    out = torch.zeros_like(flat).scatter_(-1, idx, flat.gather(-1, idx))
    return out.reshape(x.shape)


def _leaf_randk(x: torch.Tensor, ratio: float, gen: torch.Generator):
    """k distinct uniformly random coordinates of the leaf (a random
    permutation's first k from ``gen``), the rest zeros."""
    flat = x.reshape(-1)
    d = flat.shape[0]
    k = max(1, int(round(d * ratio)))
    if k >= d:
        return x
    idx = torch.randperm(d, generator=gen, device=x.device)[:k]
    out = torch.zeros_like(flat)
    out[idx] = flat[idx]
    return out.reshape(x.shape)


def _leaf_quant(x: torch.Tensor, bits: int, block: int, shards: int = 1,
                batch: int = 0):
    """Per-block symmetric quantization to 2^(bits-1) - 1 magnitude levels,
    blocks along the last axis.  Scalar leaves pass unchanged.  The divide
    by the levels is an IEEE divide by a tensor (XLA multiplies by the
    reciprocal there, so values may differ from the reference's by an ulp
    or two of the block scale)."""
    if x.dim() == batch:
        return x
    D = x.shape[-1]
    b = choose_block(D, block, shards)
    blocks = x.reshape(tuple(x.shape[:-1]) + (D // b, b))
    return _quant_blocks(blocks, bits).reshape(x.shape)


def _quant_blocks(blocks: torch.Tensor, bits: int) -> torch.Tensor:
    """:func:`_leaf_quant`'s rounding of ``[..., block]`` blocks."""
    scale = blocks.abs().amax(dim=-1, keepdim=True)
    levels = torch.tensor(float(2 ** (bits - 1) - 1), device=blocks.device)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.round(blocks / safe * levels) / levels * safe
    return torch.where(scale > 0, q, torch.zeros_like(q))


def _leaf_natural(x: torch.Tensor, gen: Optional[torch.Generator]):
    """Natural compression (Horvath et al. 2022): |x| rounded to one of its
    two neighbouring powers of two, up with probability ``(|x| - lo) / lo``
    (draws from ``gen``); ``gen=None`` rounds to the nearer one.  ``lo`` is
    ``2**floor(log2|x|)``, the reference's formula (not ``frexp``)."""
    mag = x.abs()
    safe = torch.where(mag > 0, mag, torch.ones_like(mag))
    lo = torch.exp2(torch.floor(torch.log2(safe)))
    p_up = (safe - lo) / lo
    if gen is None:
        rounded = torch.where(p_up > 0.5, 2 * lo, lo)
    else:
        u = torch.rand(x.shape, generator=gen, device=x.device)
        rounded = torch.where(u < p_up, 2 * lo, lo)
    return torch.where(mag > 0, torch.sign(x) * rounded, torch.zeros_like(x))


def compress_leaf(x: torch.Tensor, cfg, gen: Optional[torch.Generator] = None,
                  batch: int = 0) -> torch.Tensor:
    """The operator C of ``cfg.kind`` on one leaf with ``batch`` leading
    axes (the random kinds take none: one call per client stream)."""
    if cfg.kind == "none":
        return x
    if cfg.kind in ("randk", "natural") and batch:
        raise ValueError(f"{cfg.kind}: one call per client stream "
                         f"(batch=0), got batch={batch}")
    if cfg.kind == "natural":
        return _leaf_natural(x, gen)
    if cfg.kind == "topk":
        size = x[(0,) * batch].numel() if batch else x.numel()
        if size > _SORT_FREE_MIN:
            return block_topk_dense(x, cfg)
        return _leaf_topk(x, cfg.ratio, batch)
    if cfg.kind == "randk":
        if gen is None:
            raise ValueError("randk needs a generator")
        return _leaf_randk(x, cfg.ratio, gen)
    if cfg.kind == "quant":
        return _leaf_quant(x, cfg.bits, cfg.block, cfg.shards, batch)
    raise ValueError(f"unknown compressor kind: {cfg.kind}")


def compress_blocks(blocks: torch.Tensor, cfg, k: int,
                    giant: bool) -> torch.Tensor:
    """The operator C of a deterministic blockwise kind on ``[...,
    nblocks, block]`` blocks of a leaf (the leaf's own block size and top-k
    slots ``k``: ``payloads.block_geometry``; the lead axes batch axes):
    what :func:`compress_leaf` gives those blocks of the whole leaf.
    ``quant`` rounds every leaf by blocks, ``topk`` only a leaf above
    ``_SORT_FREE_MIN`` elements (``giant``): a column block of the flat
    buffer holding part of such a leaf compresses on its own
    (``comm.flat`` under a model axis)."""
    if cfg.kind == "quant":
        return _quant_blocks(blocks, cfg.bits)
    if cfg.kind != "topk" or not giant:
        raise ValueError(f"{cfg.kind} (giant={giant}) does not compress by "
                         "blocks")
    return sort_free_keep(blocks, k)


def compress(tree, cfg, gen: Optional[torch.Generator] = None,
             batch: int = 0):
    """The compressor leaf by leaf over a nested dict (the random kinds draw
    the leaves in the reference's leaf order from one generator)."""
    if cfg.kind == "none":
        return tree
    return tree_map(lambda leaf: compress_leaf(leaf, cfg, gen, batch), tree)


def message_bytes(tree, cfg) -> int:
    """Analytic wire bytes of one message (values fp32 + int32 indices)."""
    sizes = [leaf.numel() for leaf in tree_leaves(tree)]
    d = int(sum(sizes))
    if cfg.kind == "none":
        return 4 * d
    if cfg.kind in ("topk", "randk"):
        k = sum(max(1, int(round(s * cfg.ratio))) for s in sizes)
        return int(8 * k)
    if cfg.kind == "quant":
        nblocks = sum(-(-s // cfg.block) for s in sizes)
        return int(d * cfg.bits / 8 + 4 * nblocks)
    if cfg.kind == "natural":
        return int(d * 9 / 8)
    raise ValueError(cfg.kind)


def contraction_gap(x: torch.Tensor, cx: torch.Tensor) -> Tuple[float, float]:
    """(||C(x) - x||^2, ||x||^2) for property tests."""
    return float(((cx - x) ** 2).sum()), float((x ** 2).sum())
