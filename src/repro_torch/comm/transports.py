"""Pluggable transports, one registry entry per compressor kind (port of
``repro.comm.transports``).

A :class:`Transport` owns one direction's compressor math on a parameter
tree (``compress`` / ``decompress`` / the EF14 ``ef_step``), its wire
representation (``wire``: dense tensors or a packed payload) and the exact
``wire_bytes`` of one message, for each of three backends
(``FedConfig.comm`` -> :func:`backend_for`):

* ``ref``    -- ``comm="dense"``: the paper-faithful dense simulation
  (per-leaf global top-k / rand-k of :mod:`repro_torch.core.compression`),
* ``packed`` -- block-wise payloads (values + offsets, codes + scales),
* ``pallas`` -- the packed payloads through the kernels (``block_topk``;
  quant's EF14 step fused in ``quantize_ef``, a dense wire there).

The engine's wire path is :class:`repro_torch.comm.flat.FlatTransport`
over flat buffers, which takes its flags, its dense-wire accounting and
its kind from here.  The tree-level round call sites (``encode`` /
``transmit`` on stacked trees) are not ported.  Stochastic kinds take a
``torch.Generator`` as their key.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.comm import payloads
from repro_torch.comm.payloads import (PackedLeaf, block_geometry,
                                       choose_block, tree_leaves, tree_map)
from repro_torch.configs.base import CompressorConfig
from repro_torch.kernels import ops

BACKENDS = ("ref", "packed", "pallas")
_COMM_TO_BACKEND = {"dense": "ref", "packed": "packed", "pallas": "pallas"}


def backend_for(comm: str) -> str:
    """Map a ``FedConfig.comm`` mode to a transport backend name."""
    try:
        return _COMM_TO_BACKEND[comm]
    except KeyError:
        raise ValueError(f"unknown comm mode {comm!r}; expected one of "
                         f"{sorted(_COMM_TO_BACKEND)}") from None


def masked_mean(x: torch.Tensor, mask: torch.Tensor, m) -> torch.Tensor:
    """Weighted mean over the leading client axis of ``[n, ...]``:
    ``sum_j mask_j * x_j / m``."""
    return torch.tensordot(mask.to(x.dtype), x, dims=([0], [0])) / m


# unsigned wire dtypes -> the same-width signed views that CUDA's copy, cat,
# index and select kernels take
SIGNED_VIEWS = {torch.uint16: torch.int16, torch.uint32: torch.int32}


def mask_where(mask: torch.Tensor, new, old, out=None):
    """Per-client row select on ``[n, ...]`` tensors or payload NamedTuples
    (leaf by leaf): rows with ``mask > 0`` take ``new``, the rest keep
    ``old``.  ``out`` (``old`` itself, for an in-place select) receives the
    result.  Unsigned leaves select through their signed views."""
    if not isinstance(new, torch.Tensor):
        outs = out if out is not None else (None,) * len(new)
        return type(new)(*(mask_where(mask, a, b, o)
                           for a, b, o in zip(new, old, outs)))
    m = mask.reshape((mask.shape[0],) + (1,) * (new.dim() - 1))
    signed = SIGNED_VIEWS.get(new.dtype)
    if signed is None:
        return torch.where(m > 0, new, old, out=out)
    got = torch.where(m > 0, new.view(signed), old.view(signed),
                      out=None if out is None else out.view(signed))
    return got.view(new.dtype) if out is None else out


def scatter_rows(tree, idx: torch.Tensor, n: int, unique: bool = True):
    """``[m, ...]`` participant rows -> the full ``[n, ...]`` layout, zeros
    elsewhere.  ``tree`` is a tensor or a payload NamedTuple (every field
    carries the leading client axis).

    Float fields of a cohort with unique ids go through the segment-sum
    kernel (:func:`repro_torch.kernels.ops.segment_rows`), as the
    reference's TPU plan does.  Integer fields (uint16 offsets, uint32
    words) are copied bit for bit by ``index_copy_``, the reference's
    ``.at[idx].set``; so are float fields when ``unique`` is False (a short
    cohort whose padded ids repeat a row: any write wins, where a segment
    sum would double it)."""
    if not isinstance(tree, torch.Tensor):
        return type(tree)(*(scatter_rows(x, idx, n, unique) for x in tree))
    if tree.dtype.is_floating_point and unique:
        return ops.segment_rows(tree, idx, n)
    signed = SIGNED_VIEWS.get(tree.dtype)
    rows = tree if signed is None else tree.view(signed)
    out = rows.new_zeros((n,) + tuple(rows.shape[1:]))
    out.index_copy_(0, idx, rows)
    return out if signed is None else out.view(tree.dtype)


_REGISTRY: dict = {}
_WIRE_BYTES_CACHE: dict = {}


def register(cls):
    """Class decorator: register a Transport under its ``kind``."""
    _REGISTRY[cls.kind] = cls
    return cls


def get_transport(cfg: CompressorConfig, backend: str = "ref") -> "Transport":
    """The transport for ``cfg.kind`` on ``backend``."""
    try:
        cls = _REGISTRY[cfg.kind]
    except KeyError:
        raise ValueError(f"unknown compressor kind {cfg.kind!r}; registered: "
                         f"{sorted(_REGISTRY)}") from None
    return cls(cfg, backend)


def _leaf_D(shape) -> int:
    return shape[-1] if len(shape) else 1


def _mix64(*words: int) -> int:
    """A 63-bit seed from integers (splitmix64 finalizer over each)."""
    h = 0x9E3779B97F4A7C15
    for w in words:
        h = (h ^ (w & 0xFFFFFFFFFFFFFFFF)) * 0xBF58476D1CE4E5B9
        h &= 0xFFFFFFFFFFFFFFFF
        h ^= h >> 31
        h = (h * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        h ^= h >> 29
    return h & 0x7FFFFFFFFFFFFFFF


class WireKey(NamedTuple):
    """The compression randomness of one round and direction (the
    reference's ``k_up`` / ``k_down``).  Client j's stream is a
    ``torch.Generator`` on the round's device seeded from (seed, round,
    direction, j), so a client draws the same numbers in mask and gather
    mode; the downlink's one message draws as client 0.  The slot store's
    eviction flush draws from a third direction, ``FLUSH``, row i as
    client i (the reference's ``fold_in(key, FLUSH_TAG)`` stream)."""
    seed: int
    round: int
    direction: int              # UPLINK, DOWNLINK or FLUSH

    def generator(self, client: int, device) -> torch.Generator:
        return torch.Generator(device=device).manual_seed(
            _mix64(self.seed, self.round, self.direction, client))


UPLINK, DOWNLINK, FLUSH = 0, 1, 2


class Transport:
    """One direction's compressor kind on one backend.

    Usage::

        >>> t = get_transport(CompressorConfig(kind="topk"), "packed")
        >>> msg = t.compress(delta_tree)
        >>> dense = t.decompress(msg, like=delta_tree)
    """

    kind: str = "?"
    needs_key: bool = False         # stochastic kind (randk / natural)

    def __init__(self, cfg: CompressorConfig, backend: str = "ref"):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; expected "
                             f"{BACKENDS}")
        self.cfg = cfg
        self.backend = backend

    @property
    def is_identity(self) -> bool:
        return False

    @property
    def needs_residual(self) -> bool:
        """Uplink EF14 residual state exists only under real compression."""
        return not self.is_identity

    @property
    def tracks_center(self) -> bool:
        """Downlink EF21 stores the server center x separately from w."""
        return not self.is_identity

    @property
    def wire(self) -> str:
        """``packed`` when a payload (not dense tensors) is the message."""
        return "dense"

    def compress(self, tree, key=None):
        """Wire message of a parameter tree (the operator C); ``key`` is the
        ``torch.Generator`` of the stochastic kinds."""
        raise NotImplementedError

    def decompress(self, message, like):
        """Dense tree of a wire message (the message itself on a dense
        wire)."""
        return message

    def ef_step(self, e, delta, key=None):
        """EF14 step ``v = C(e + delta)``, ``e' = e + delta - v``: returns
        ``(message of v, e')``."""
        buf = tree_map(torch.add, e, delta)
        msg = self.compress(buf, key)
        return msg, tree_map(torch.sub, buf, self.decompress(msg, buf))

    def wire_bytes(self, like) -> int:
        """Exact wire bytes of one message for a ``like``-shaped tree (any
        device, ``meta`` included), cached per (config, backend, shapes)."""
        sig = (self.cfg, self.backend, tuple(
            (tuple(leaf.shape), leaf.dtype) for leaf in tree_leaves(like)))
        hit = _WIRE_BYTES_CACHE.get(sig)
        if hit is None:
            if len(_WIRE_BYTES_CACHE) > 512:
                _WIRE_BYTES_CACHE.clear()
            hit = _WIRE_BYTES_CACHE[sig] = int(self._wire_bytes(like))
        return hit

    def _wire_bytes(self, like) -> int:
        raise NotImplementedError


@register
class IdentityTransport(Transport):
    """kind='none': dense wire, no residual, no center."""

    kind = "none"

    @property
    def is_identity(self) -> bool:
        return True

    def compress(self, tree, key=None):
        return tree

    def ef_step(self, e, delta, key=None):
        if e is None:
            return delta, None
        buf = tree_map(torch.add, e, delta)
        return buf, tree_map(torch.zeros_like, buf)

    def _wire_bytes(self, like) -> int:
        return int(sum(leaf.numel() * leaf.element_size()
                       for leaf in tree_leaves(like)))


class _BlockSelectTransport(Transport):
    """The (values, offsets) payload kinds."""

    @property
    def wire(self) -> str:
        return "dense" if self.backend == "ref" else "packed"

    def decompress(self, message, like):
        if self.wire == "dense":
            return message
        return payloads.unpack_tree(message, like, self.cfg)

    def _wire_bytes(self, like) -> int:
        total = 0
        for leaf in tree_leaves(like):
            D = _leaf_D(leaf.shape)
            b, kb = block_geometry(D, self.cfg)
            blockwise = (leaf.numel() // D) * (D // b) * kb
            if self.wire != "dense":
                # the payload: values + uint16 offsets, k per block
                total += blockwise * (leaf.element_size() + 2)
                continue
            # ref: a global per-leaf selection, one value + an int32 index
            # per entry; giant leaves select block-wise
            # (core.compression.compress_leaf)
            k = blockwise if leaf.numel() > payloads._SORT_FREE_MIN else \
                max(1, int(round(leaf.numel() * self.cfg.ratio)))
            total += k * (leaf.element_size() + 4)
        return int(total)


@register
class TopKTransport(_BlockSelectTransport):
    """kind='topk': magnitude top-k.  ref: per-leaf global selection;
    packed: block-wise payload (a stable sort per block); pallas: the same
    payload from the ``block_topk`` kernel."""

    kind = "topk"

    def compress(self, tree, key=None):
        if self.backend == "ref":
            from repro_torch.core import compression
            return compression.compress(tree, self.cfg)
        if self.backend == "packed":
            return payloads.pack_tree(tree, self.cfg)
        return tree_map(self._pack_leaf_kernel, tree)

    def _pack_leaf_kernel(self, x: torch.Tensor) -> PackedLeaf:
        blocks, b, k = payloads._leaf_blocks(x, self.cfg)
        if k >= b:
            idx = torch.arange(b, device=x.device).expand(blocks.shape)
            return PackedLeaf(blocks, payloads.to_u16(idx))
        vals, idx = ops.block_topk(blocks.reshape(-1, b).contiguous(), k)
        lead = tuple(blocks.shape[:-1])
        return PackedLeaf(vals.reshape(lead + (k,)),
                          payloads.to_u16(idx.reshape(lead + (k,))))


@register
class RandKTransport(_BlockSelectTransport):
    """kind='randk': k uniformly random coordinates (no rescale).  ref:
    per-leaf global sampling; packed and pallas: block-wise payload (no
    kernel: pallas runs the packed math)."""

    kind = "randk"
    needs_key = True

    def compress(self, tree, key=None):
        if key is None:
            raise ValueError("randk needs a generator")
        if self.backend == "ref":
            from repro_torch.core import compression
            return compression.compress(tree, self.cfg, key)
        return tree_map(
            lambda leaf: payloads.block_randk_pack(leaf, self.cfg, key), tree)


@register
class QuantTransport(Transport):
    """kind='quant': per-block max-abs symmetric b-bit rounding.  ref:
    dense quantizer; packed: (int8 codes, float32 scales) payload; pallas:
    the EF14 step fused in the ``quantize_ef`` kernel, a dense wire."""

    kind = "quant"

    @property
    def wire(self) -> str:
        return "packed" if self.backend == "packed" else "dense"

    def compress(self, tree, key=None):
        if self.backend == "ref":
            from repro_torch.core import compression
            return compression.compress(tree, self.cfg)
        if self.backend == "packed":
            return tree_map(lambda leaf: payloads.quant_pack(leaf, self.cfg),
                            tree)
        v, _ = self._fused_ef(tree_map(torch.zeros_like, tree), tree)
        return v

    def decompress(self, message, like):
        if self.wire == "dense":
            return message
        return tree_map(lambda p, ref: payloads.quant_unpack(
            p, tuple(ref.shape), ref.dtype, self.cfg), message, like)

    def ef_step(self, e, delta, key=None):
        if self.backend == "pallas":
            return self._fused_ef(e, delta)
        return super().ef_step(e, delta, key)

    def _fused_ef(self, e, delta):
        """Every leaf through the fused ``quantize_ef`` kernel, blocked
        along its last axis (scalars pass unquantized)."""
        from repro_torch.kernels.quantize_ef import quantize_ef

        def one(ej, dj):
            if ej.dim() == 0:
                buf = ej + dj
                return buf, torch.zeros_like(buf)
            b = choose_block(ej.shape[-1], self.cfg.block, self.cfg.shards)
            v, en = quantize_ef(ej.reshape(-1, b).contiguous(),
                                dj.reshape(-1, b).contiguous(),
                                self.cfg.bits)
            return v.reshape(ej.shape), en.reshape(ej.shape)

        out = tree_map(one, e, delta)
        return tree_map(lambda o: o[0], out), tree_map(lambda o: o[1], out)

    def _wire_bytes(self, like) -> int:
        # format-based on every backend: bits per code plus one float32
        # scale per block
        total = 0.0
        for leaf in tree_leaves(like):
            D = _leaf_D(leaf.shape)
            b = choose_block(D, self.cfg.block, self.cfg.shards)
            lead = leaf.numel() // D if D else 1
            total += leaf.numel() * self.cfg.bits / 8 + 4 * lead * (D // b)
        return int(total)


@register
class NaturalTransport(Transport):
    """kind='natural': stochastic power-of-two rounding (Horvath et al.),
    a dense wire on every backend (sign + 8-bit exponent per entry)."""

    kind = "natural"
    needs_key = True

    def compress(self, tree, key=None):
        from repro_torch.core import compression
        return compression.compress(tree, self.cfg, key)

    def _wire_bytes(self, like) -> int:
        d = sum(leaf.numel() for leaf in tree_leaves(like))
        return int(d * 9 / 8)
