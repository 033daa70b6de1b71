"""Wire payload formats of the flat hot path (port of ``repro.comm.payloads``).

* :class:`FlatPacked` -- values + uint16 within-block offsets of block-wise
  top-k,
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

def select_topk_blocks(blocks: torch.Tensor, k: int, sort_free: bool):
    """Per-block magnitude top-k of a ``[..., nblocks, block]`` view;
    returns (values, uint16 offsets).  ``k >= block`` keeps every entry;
    the exact regime orders by descending |x| with ties to the lowest index
    (``lax.top_k``'s order).  The sort-free threshold regime of the
    reference (mesh-scale leaves off the kernel path) is not ported yet."""
    b = blocks.shape[-1]
    if k >= b:
        idx = torch.arange(b, device=blocks.device).expand(blocks.shape)
        return blocks, to_u16(idx)
    if sort_free:
        raise NotImplementedError(
            "select_topk_blocks: the sort-free threshold regime is not "
            "ported yet")
    from repro_torch.kernels.topk_block import block_topk_plain
    vals, idx = block_topk_plain(blocks, k)
    return vals, to_u16(idx)


# -- per-block max-abs quantization and bit-packing ---------------------------

def quant_blocks(blocks: torch.Tensor, bits: int):
    """Per-block max-abs symmetric b-bit rounding of a ``[..., nblocks,
    block]`` view: (float codes in [-L, L], scale with keepdim).  IEEE
    division then multiply, rounding half to even (``torch.round``)."""
    scale = blocks.abs().amax(dim=-1, keepdim=True)
    levels = float(2 ** (bits - 1) - 1)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    return torch.round(blocks / safe * levels), scale


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
