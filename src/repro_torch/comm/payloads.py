"""Wire payload formats (port of ``repro.comm.payloads``).

* :class:`PackedLeaf` -- (values, uint16 within-block offsets) of one leaf's
  block-wise top-k / rand-k (the tree transports' packed wire),
* :class:`QuantPayload` -- (integer codes, per-block scale) of one leaf's
  per-block max-abs b-bit rounding,
* :class:`FlatPacked` -- values + uint16 within-block offsets of block-wise
  top-k over a flat buffer,
* :class:`FlatQuant` -- b-bit biased codes bit-packed ``32 // b`` to a
  uint32 word, plus one float32 max-abs scale per block.

Blocking runs along the LAST tensor axis with a divisor-sized block (no
padding).  PyTorch's uint16/uint32 dtypes support few operations, so all
shift and mask work runs in int64 and the wire dtypes are produced and read
through same-width signed views (:func:`to_u32` / :func:`u32_to_i64`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

INDEX_DTYPE = torch.uint16   # FlatPacked within-block offsets
PACK_BITS = (2, 4, 8)
_SORT_FREE_MIN = 1 << 22     # leaves above this use threshold selection


class PackedLeaf(NamedTuple):
    values: torch.Tensor     # [..., nblocks, k]
    indices: torch.Tensor    # [..., nblocks, k] uint16 within-block offsets


class QuantPayload(NamedTuple):
    codes: torch.Tensor      # [..., nblocks, block] int8 (int32 above 8 bits)
    scale: torch.Tensor      # [..., nblocks, 1] float32 per-block max-abs


class FlatPacked(NamedTuple):
    """Block-select payload of flat ``[..., d]`` buffers: every block's
    values and within-block offsets, concatenated in leaf order."""
    values: torch.Tensor     # [..., K_total] buffer dtype
    indices: torch.Tensor    # [..., K_total] uint16


class FlatQuant(NamedTuple):
    """Bit-packed quantization payload: uint32 words + per-block scales."""
    words: torch.Tensor      # [..., W_total] uint32
    scale: torch.Tensor      # [..., NB_total] float32


def choose_block(D: int, pref: int, shards: int = 1) -> int:
    """Largest divisor of D (and, when possible, of the per-shard chunk
    D/shards) that is <= pref -- exact blocking, no padding."""
    base = D // shards if shards > 1 and D % shards == 0 else D
    b = max(1, min(pref, base))
    while base % b:
        b -= 1
    return b


def block_geometry(D: int, cfg) -> tuple[int, int]:
    """(block, k) for block-wise top-k along a last axis of size D."""
    b = choose_block(D, cfg.block, cfg.shards)
    k = max(1, min(b, int(round(b * cfg.ratio))))
    return b, k


def words_per_block(block: int, bits: int) -> int:
    """uint32 words needed for one ``block``-code payload at ``bits`` wide."""
    per_word = 32 // bits
    return -(-block // per_word)


# -- unsigned wire dtypes through signed views ------------------------------

def to_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> uint32 (bit-exact)."""
    signed = x - ((x >> 31) & 1) * (1 << 32)
    return signed.to(torch.int32).view(torch.uint32)


def u32_to_i64(w: torch.Tensor) -> torch.Tensor:
    """uint32 -> int64 values in [0, 2^32)."""
    return w.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def to_u16(x: torch.Tensor) -> torch.Tensor:
    """Integer values in [0, 2^16) -> uint16 (bit-exact)."""
    x = x.to(torch.int64)
    signed = x - ((x >> 15) & 1) * (1 << 16)
    return signed.to(torch.int16).view(torch.uint16)


def u16_to_i64(i: torch.Tensor) -> torch.Tensor:
    """uint16 -> int64 values in [0, 2^16)."""
    return i.view(torch.int16).to(torch.int64) & 0xFFFF


# -- block top-k ------------------------------------------------------------

def _block_threshold(absx: torch.Tensor, k: int, iters: int = 25):
    """The k-th largest |x| per block by bisection, without a sort: 25
    halvings of ``[0, max]`` in float32, each counting the entries above the
    midpoint.  Returns thr with count(|x| > thr) in [~k, k + ties]."""
    hi = absx.amax(dim=-1, keepdim=True)
    lo = torch.zeros_like(hi)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        too_many = (absx > mid).sum(dim=-1, keepdim=True) > k
        lo, hi = torch.where(too_many, mid, lo), torch.where(too_many, hi, mid)
    return lo


def select_topk_blocks(blocks: torch.Tensor, k: int, sort_free: bool):
    """Per-block magnitude top-k of a ``[..., nblocks, block]`` view;
    returns (values, uint16 offsets).  ``k >= block`` keeps every entry.

    The exact regime is the reference's ``lax.top_k``: descending |x|, ties
    (and NaNs, which sort above inf) in index order -- a stable descending
    sort cut to k.  The sort-free regime (giant leaves) keeps the entries
    above :func:`_block_threshold` in index order, slot by slot: overflow
    past k drops, slots past the kept count hold zeros."""
    b = blocks.shape[-1]
    if k >= b:
        idx = torch.arange(b, device=blocks.device).expand(blocks.shape)
        return blocks, to_u16(idx)
    absx = blocks.abs()
    if not sort_free:
        idx = torch.sort(absx, dim=-1, descending=True,
                         stable=True).indices[..., :k]
        return torch.gather(blocks, -1, idx), to_u16(idx)
    keep = absx > _block_threshold(absx, k)
    del absx
    pos = torch.cumsum(keep, dim=-1) - 1
    slot = torch.where(keep & (pos < k), pos, k)        # overflow -> slot k
    del pos
    lead = blocks.shape[:-1]
    vals = blocks.new_zeros(lead + (k + 1,)).scatter_(-1, slot, blocks)
    iota = torch.arange(b, device=blocks.device).expand(blocks.shape)
    idx = torch.zeros(lead + (k + 1,), dtype=torch.int64,
                      device=blocks.device).scatter_(-1, slot, iota)
    return vals[..., :k], to_u16(idx[..., :k])


def _leaf_blocks(x: torch.Tensor, cfg):
    """``x`` (a scalar as ``[1]``) as ``[..., D // b, b]`` blocks along its
    last axis, with the (block, k) geometry."""
    if x.dim() == 0:
        x = x.reshape(1)
    D = x.shape[-1]
    b, k = block_geometry(D, cfg)
    return x.reshape(x.shape[:-1] + (D // b, b)), b, k


def block_topk_pack(x: torch.Tensor, cfg) -> PackedLeaf:
    """Block-wise magnitude top-k along the last axis (exact below
    ``_SORT_FREE_MIN`` elements, sort-free above)."""
    blocks, _, k = _leaf_blocks(x, cfg)
    return PackedLeaf(*select_topk_blocks(blocks, k,
                                          x.numel() > _SORT_FREE_MIN))


def block_randk_pack(x: torch.Tensor, cfg, gen: torch.Generator) -> PackedLeaf:
    """Block-wise rand-k: k distinct uniformly random offsets per block (the
    first k of an argsort of uniforms from ``gen``), values kept as they
    are."""
    blocks, b, k = _leaf_blocks(x, cfg)
    if k >= b:
        idx = torch.arange(b, device=blocks.device).expand(blocks.shape)
        return PackedLeaf(blocks, to_u16(idx))
    u = torch.rand(blocks.shape, generator=gen, device=blocks.device)
    idx = torch.argsort(u, dim=-1)[..., :k]
    return PackedLeaf(torch.gather(blocks, -1, idx), to_u16(idx))


def block_topk_unpack(p: PackedLeaf, shape, dtype=torch.float32,
                      block: int | None = None) -> torch.Tensor:
    """Inverse of :func:`block_topk_pack`: dense ``shape``, zeros
    off-support."""
    if len(shape) == 0:
        return block_topk_unpack(p, (1,), dtype, block).reshape(())
    nb = p.values.shape[-2]
    b = shape[-1] // nb if block is None else block
    dense = p.values.new_zeros(tuple(shape[:-1]) + (nb, b))
    dense.scatter_(-1, u16_to_i64(p.indices), p.values)
    return dense.reshape(tuple(shape)).to(dtype)


def sort_free_keep(blocks: torch.Tensor, k: int) -> torch.Tensor:
    """The sort-free block top-k of a ``[..., nblocks, block]`` view, dense:
    what lies above :func:`_block_threshold` kept, +0.0 elsewhere (the
    reference's ``blocks * keep`` is a select: NaNs, -0.0 and negatives
    below it all become +0.0); ``k >= block`` keeps every entry."""
    if k >= blocks.shape[-1]:
        return blocks
    absx = blocks.abs()
    return torch.where(absx > _block_threshold(absx, k), blocks, 0.0)


def block_topk_dense(x: torch.Tensor, cfg) -> torch.Tensor:
    """Dense result of block-wise top-k (pack then unpack); giant leaves
    through :func:`sort_free_keep` instead."""
    if x.dim() == 0:
        return x
    blocks, b, k = _leaf_blocks(x, cfg)
    if x.numel() > _SORT_FREE_MIN and b > 1:
        return sort_free_keep(blocks, k).reshape(x.shape)
    return block_topk_unpack(block_topk_pack(x, cfg), x.shape, x.dtype,
                             block=b)


# -- per-block max-abs quantization and bit-packing ---------------------------

def quant_blocks(blocks: torch.Tensor, bits: int):
    """Per-block max-abs symmetric b-bit rounding of a ``[..., nblocks,
    block]`` view: (float codes in [-L, L], scale with keepdim).  IEEE
    division then multiply, rounding half to even (``torch.round``)."""
    scale = blocks.abs().amax(dim=-1, keepdim=True)
    levels = float(2 ** (bits - 1) - 1)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    return torch.round(blocks / safe * levels), scale


def quant_code_dtype(bits: int) -> torch.dtype:
    return torch.int8 if bits <= 8 else torch.int32


def quant_pack(x: torch.Tensor, cfg) -> QuantPayload:
    """Integer codes + per-block scale of one leaf (blocks along the last
    axis, a scalar as ``[1]``)."""
    if x.dim() == 0:
        x = x.reshape(1)
    D = x.shape[-1]
    b = choose_block(D, cfg.block, cfg.shards)
    codes, scale = quant_blocks(x.reshape(x.shape[:-1] + (D // b, b)),
                                cfg.bits)
    return QuantPayload(codes.to(quant_code_dtype(cfg.bits)),
                        scale.to(torch.float32))


def quant_unpack(p: QuantPayload, shape, dtype, cfg) -> torch.Tensor:
    """Dense values of a :class:`QuantPayload` (IEEE divide by the levels,
    then multiply by the scale; zero scale gives zeros)."""
    if len(shape) == 0:
        return quant_unpack(p, (1,), dtype, cfg).reshape(())
    levels = torch.tensor(float(2 ** (cfg.bits - 1) - 1),
                          device=p.scale.device)
    vals = p.codes.to(torch.float32) / levels * p.scale
    vals = torch.where(p.scale > 0, vals, torch.zeros_like(vals))
    return vals.reshape(tuple(shape)).to(dtype)


def pack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """``[..., block]`` integer codes in [-L, L] -> ``[..., W]`` uint32
    words: biased lanes ``code + L``, lane i at bits [bits*i, bits*(i+1)),
    pad lanes of the last word zero bits."""
    if bits not in PACK_BITS:
        raise ValueError(f"bits={bits} not packable; expected {PACK_BITS}")
    per_word = 32 // bits
    block = codes.shape[-1]
    W = words_per_block(block, bits)
    biased = codes.to(torch.int64) + (2 ** (bits - 1) - 1)
    pad = W * per_word - block
    if pad:
        biased = torch.nn.functional.pad(biased, (0, pad))
    lanes = biased.reshape(biased.shape[:-1] + (W, per_word))
    shifts = torch.arange(per_word, device=codes.device) * bits
    # lanes fill disjoint bit ranges, so the sum is the OR
    return to_u32((lanes << shifts).sum(dim=-1))


def unpack_codes(words: torch.Tensor, bits: int, block: int) -> torch.Tensor:
    """``[..., W]`` uint32 words -> ``[..., block]`` int64 codes in [-L, L]
    (exact inverse of :func:`pack_codes`)."""
    per_word = 32 // bits
    w = u32_to_i64(words)
    shifts = torch.arange(per_word, device=words.device) * bits
    lanes = (w[..., None] >> shifts) & ((1 << bits) - 1)
    flat = lanes.reshape(words.shape[:-1] + (-1,))
    return flat[..., :block] - (2 ** (bits - 1) - 1)


# -- tree-level helpers and byte accounting -----------------------------------

def is_payload(x) -> bool:
    return isinstance(x, (PackedLeaf, QuantPayload, FlatPacked, FlatQuant))


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a nested dict / list (tensors, payloads
    and tuples are leaves), zipped with the leaves of ``rest``, trees of
    the same structure.  Leaves are visited in ``jax.tree_util``'s order
    (dict keys sorted, list entries by index), so a ``fn`` that draws
    random numbers draws them in the reference's leaf order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves of a nested dict / list in ``jax.tree_util``'s order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def pack_tree(tree, cfg):
    return tree_map(lambda leaf: block_topk_pack(leaf, cfg), tree)


def unpack_tree(packed, like_tree, cfg=None):
    """Dense tree of a :class:`PackedLeaf` tree shaped like ``like_tree``."""
    def one(p, ref):
        block = (choose_block(ref.shape[-1] if ref.dim() else 1, cfg.block,
                              cfg.shards) if cfg is not None else None)
        return block_topk_unpack(p, tuple(ref.shape), ref.dtype, block=block)
    return tree_map(one, packed, like_tree)


def payload_wire_bytes(payload, bits: int | None = None) -> int:
    """Wire bytes of a payload tree: every array's bytes, except quantizer
    codes, which count at ``bits`` each (the wire packs sub-byte codes)."""
    total = 0.0
    for node in tree_leaves(payload):
        if isinstance(node, QuantPayload):
            width = bits or 8 * node.codes.element_size()
            total += node.codes.numel() * width / 8 + node.scale.numel() * 4
        else:
            fields = node if is_payload(node) else (node,)
            total += sum(f.numel() * f.element_size() for f in fields)
    return int(total)
