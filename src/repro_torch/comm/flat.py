"""The flat hot path: contiguous parameter buffers + flat wire codecs (port
of ``repro.comm.flat``: ``FlatTransport`` on the ``pallas`` backend, in
mask and gather mode, for the uplink and the primal-EF21 downlink).

* :class:`FlatSpec` / :func:`flatten` / :func:`unflatten` -- the nested
  parameter dict <-> ``[d]`` buffer isomorphism.  Leaves go in the
  reference's order (``jax.tree_util`` sorts dict keys), so offsets, runs,
  payloads and weights line up with the JAX package's.
* :func:`tree_norm` / :func:`project_ball` -- norms reduced per leaf slice,
  partials added in leaf order.
* :class:`WireLayout` -- static per-leaf block geometry with consecutive
  same-geometry leaves merged into *runs*: one kernel launch per run, the
  client axis folded into the run's rows.
* :class:`FlatTransport` -- EF14 encode + payload-domain reduce over
  ``[n, d]`` stacks (or the m gathered rows, scattered back into ``[n,
  ...]`` through ``segment_rows``): :class:`FlatPacked` (``block_topk``
  encode, ``scatter_agg`` reduce) for top-k and :class:`FlatQuant` (fused
  ``quantize_ef_pack`` encode, ``unpack_mma`` reduce) for quant; the
  downlink packs one ``[d]`` buffer with the same encode kernels.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.comm import payloads, transports
from repro_torch.comm.payloads import (FlatPacked, FlatQuant, PACK_BITS,
                                       choose_block, to_u16, u16_to_i64,
                                       unpack_codes, words_per_block,
                                       _SORT_FREE_MIN)
from repro_torch.kernels.quantize_ef_pack import quantize_ef_pack
from repro_torch.kernels.scatter_agg import scatter_agg
from repro_torch.kernels.topk_block import block_topk
from repro_torch.kernels.unpack_mma import unpack_mma


# ---------------------------------------------------------------------------
# FlatSpec: the parameter dict <-> [d] isomorphism
# ---------------------------------------------------------------------------

class LeafSpec(NamedTuple):
    shape: tuple            # leaf shape (possibly ())
    dtype: torch.dtype
    offset: int             # start in the flat buffer
    size: int               # number of elements


class FlatSpec(NamedTuple):
    """Static metadata of one flattening (hashable)."""
    paths: tuple            # key path of each leaf, in flattening order
    leaves: tuple           # tuple[LeafSpec]
    d: int
    dtype: torch.dtype      # buffer dtype: the leaves' common promotion


def _leaves(tree, path=()):
    """(path, leaf) pairs with dict keys sorted, as ``jax.tree_util``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def spec_of(tree) -> FlatSpec:
    """The :class:`FlatSpec` of a nested dict of tensors (any device,
    ``meta`` included)."""
    paths, specs, off = [], [], 0
    dtype = None
    for path, leaf in _leaves(tree):
        size = 1
        for s in leaf.shape:
            size *= int(s)
        paths.append(path)
        specs.append(LeafSpec(tuple(leaf.shape), leaf.dtype, off, size))
        dtype = leaf.dtype if dtype is None else \
            torch.promote_types(dtype, leaf.dtype)
        off += size
    return FlatSpec(tuple(paths), tuple(specs), off, dtype or torch.float32)


def flatten(spec: FlatSpec, tree) -> torch.Tensor:
    """Nested dict -> contiguous buffer.  Leading axes shared by every leaf
    (a stacked ``[n, ...]`` tree) are kept: the output is ``[*lead, d]``."""
    leaves = [leaf for _, leaf in _leaves(tree)]
    if len(leaves) != len(spec.leaves):
        raise ValueError(f"flatten: tree has {len(leaves)} leaves but the "
                         f"FlatSpec records {len(spec.leaves)}")
    out = []
    for leaf, ls in zip(leaves, spec.leaves):
        lead = tuple(leaf.shape[:leaf.dim() - len(ls.shape)])
        out.append(leaf.to(spec.dtype).reshape(lead + (ls.size,)))
    return torch.cat(out, dim=-1) if len(out) > 1 else out[0]


def unflatten(spec: FlatSpec, flat: torch.Tensor) -> dict:
    """Buffer ``[*lead, d]`` -> nested dict with leaf shapes
    ``[*lead, *leaf_shape]``.  On a 1-D buffer every leaf is a view (a
    ``split``, so the backward of a gradient through all leaves is one
    concatenation into ``[d]``)."""
    lead = tuple(flat.shape[:-1])
    parts = flat.split([ls.size for ls in spec.leaves], dim=-1)
    tree: dict = {}
    for path, ls, part in zip(spec.paths, spec.leaves, parts):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = part.reshape(lead + ls.shape).to(ls.dtype)
    return tree


def tree_norm(spec: FlatSpec, flat: torch.Tensor) -> torch.Tensor:
    """sqrt(sum ||leaf||^2): each leaf slice reduces on its own and the
    partials add in leaf order."""
    parts = [flat[ls.offset:ls.offset + ls.size].to(torch.float32)
             .square().sum() for ls in spec.leaves]
    return torch.sqrt(sum(parts))


def project_ball(spec: FlatSpec, flat: torch.Tensor, radius: float):
    """Euclidean projection of the flat buffer onto ``||w|| <= radius``."""
    if not radius:
        return flat
    nrm = tree_norm(spec, flat)
    scale = torch.clamp(radius / torch.clamp(nrm, min=1e-12), max=1.0)
    return flat * scale


# ---------------------------------------------------------------------------
# WireLayout: static block geometry over the flat buffer
# ---------------------------------------------------------------------------

class LeafWire(NamedTuple):
    offset: int             # flat offset of the leaf
    lead: int               # product of leading dims (blocks run last-axis)
    D: int                  # last-axis size
    block: int              # chosen block size
    nblocks: int            # lead * (D // block)
    k: int                  # top-k slots per block
    sort_free: bool         # giant leaf: threshold selection regime


class RunSpec(NamedTuple):
    """A maximal run of consecutive leaves sharing (block, k, regime): one
    contiguous flat span processed as a single ``[nblocks, block]`` view."""
    offset: int
    span: int
    block: int
    nblocks: int
    k: int
    sort_free: bool
    koff: int               # cumulative slot offset in the payload
    boff: int               # cumulative block offset (quant scales)
    woff: int               # cumulative word offset (quant words)
    W: int                  # words per block


class WireLayout(NamedTuple):
    leaves: tuple           # tuple[LeafWire]
    runs: tuple             # tuple[RunSpec]
    K_total: int
    NB_total: int
    W_total: int


_LAYOUT_CACHE: dict = {}


def wire_layout(spec: FlatSpec, cfg) -> WireLayout:
    sig = (spec, cfg)
    hit = _LAYOUT_CACHE.get(sig)
    if hit is not None:
        return hit
    if len(_LAYOUT_CACHE) > 64:
        _LAYOUT_CACHE.clear()
    bits = cfg.bits if cfg.kind == "quant" else 8
    pw_bits = bits if bits in PACK_BITS else 8
    lws = []
    for ls in spec.leaves:
        D = ls.shape[-1] if len(ls.shape) else 1
        lead = ls.size // D
        b = choose_block(D, cfg.block, cfg.shards)
        k = max(1, min(b, int(round(b * cfg.ratio))))
        lws.append(LeafWire(ls.offset, lead, D, b, lead * (D // b), k,
                            ls.size > _SORT_FREE_MIN))
    runs, koff, boff, woff = [], 0, 0, 0
    for lw in lws:
        W = words_per_block(lw.block, pw_bits)
        if runs and runs[-1].block == lw.block and runs[-1].k == lw.k \
                and runs[-1].sort_free == lw.sort_free:
            r = runs[-1]
            runs[-1] = r._replace(span=r.span + lw.lead * lw.D,
                                  nblocks=r.nblocks + lw.nblocks)
        else:
            runs.append(RunSpec(lw.offset, lw.lead * lw.D, lw.block,
                                lw.nblocks, lw.k, lw.sort_free,
                                koff, boff, woff, W))
        koff += lw.nblocks * lw.k
        boff += lw.nblocks
        woff += lw.nblocks * W
    out = _LAYOUT_CACHE[sig] = WireLayout(tuple(lws), tuple(runs), koff,
                                          boff, woff)
    return out


def run_view(flat: torch.Tensor, r: RunSpec) -> torch.Tensor:
    """``[*lead, span]`` slice as ``[*lead, nblocks, block]`` (a view)."""
    lead = tuple(flat.shape[:-1])
    return flat[..., r.offset:r.offset + r.span].reshape(
        lead + (r.nblocks, r.block))


def _cat(xs):
    """Concatenate along the last axis (unsigned wire dtypes through their
    signed views: CUDA ``cat`` does not take every unsigned dtype)."""
    if len(xs) == 1:
        return xs[0]
    signed = transports.SIGNED_VIEWS.get(xs[0].dtype)
    if signed is None:
        return torch.cat(xs, dim=-1)
    return torch.cat([x.view(signed) for x in xs], dim=-1).view(xs[0].dtype)


# ---------------------------------------------------------------------------
# Flat wire codecs (one per packed payload format)
# ---------------------------------------------------------------------------

class _SelectCodec:
    """FlatPacked (values + uint16 offsets) for block top-k."""

    fused_ef = False

    def __init__(self, cfg, spec: FlatSpec, layout: WireLayout):
        self.cfg, self.spec, self.layout = cfg, spec, layout

    def pack(self, buf: torch.Tensor) -> FlatPacked:
        """``[*lead, d]`` -> FlatPacked ``[*lead, K_total]``: one
        ``block_topk`` launch per run, the client axis folded into the
        run's rows."""
        lead = tuple(buf.shape[:-1])
        vs, js = [], []
        for r in self.layout.runs:
            blocks = run_view(buf, r)
            if r.k < r.block:
                vals, idx = block_topk(blocks, r.k)
                idx = to_u16(idx)
            else:
                vals, idx = payloads.select_topk_blocks(blocks, r.k,
                                                        r.sort_free)
            vs.append(vals.reshape(lead + (r.nblocks * r.k,)))
            js.append(idx.reshape(lead + (r.nblocks * r.k,)))
        return FlatPacked(_cat(vs), _cat(js))

    def decode(self, p: FlatPacked) -> torch.Tensor:
        """FlatPacked -> dense ``[*lead, d]`` (zeros off-support)."""
        lead = tuple(p.values.shape[:-1])
        outs = []
        for r in self.layout.runs:
            sl = slice(r.koff, r.koff + r.nblocks * r.k)
            vals = p.values[..., sl].reshape(lead + (r.nblocks, r.k))
            idx = u16_to_i64(p.indices[..., sl]).reshape(
                lead + (r.nblocks, r.k))
            dense = torch.zeros(lead + (r.nblocks, r.block),
                                dtype=p.values.dtype, device=p.values.device)
            dense.scatter_(-1, idx, vals)
            outs.append(dense.reshape(lead + (r.span,)))
        return _cat(outs)

    def reduce(self, p: FlatPacked, weights: torch.Tensor, m) -> torch.Tensor:
        """Payload-domain aggregation: per run, the stacked (value, offset)
        streams reduce into dense destination blocks (``scatter_agg``)."""
        n = p.values.shape[0]
        weights = weights.to(torch.float32)
        outs = []
        for r in self.layout.runs:
            sl = slice(r.koff, r.koff + r.nblocks * r.k)
            vals = p.values[:, sl].reshape(n, r.nblocks, r.k)
            idx = p.indices[:, sl].reshape(n, r.nblocks, r.k)
            acc = scatter_agg(vals, idx, weights, r.block)
            outs.append(acc.reshape(r.span))
        return _cat(outs).to(self.spec.dtype) / m

    def wire_bytes(self) -> int:
        itemsize = torch.empty((), dtype=self.spec.dtype).element_size()
        return int(self.layout.K_total * (itemsize + 2))


class _QuantCodec:
    """FlatQuant (bit-packed uint32 words + per-block scales); reduce is the
    fused unpack-multiply-add over the client axis (``unpack_mma``)."""

    fused_ef = False

    def __init__(self, cfg, spec: FlatSpec, layout: WireLayout):
        self.cfg, self.spec, self.layout = cfg, spec, layout
        self.levels = float(2 ** (cfg.bits - 1) - 1)

    def decode(self, q: FlatQuant) -> torch.Tensor:
        lead = tuple(q.words.shape[:-1])
        outs = []
        for r in self.layout.runs:
            words = q.words[..., r.woff:r.woff + r.nblocks * r.W].reshape(
                lead + (r.nblocks, r.W))
            scale = q.scale[..., r.boff:r.boff + r.nblocks][..., None]
            codes = unpack_codes(words, self.cfg.bits, r.block)
            levels = torch.tensor(self.levels, device=scale.device)
            vals = codes.to(self.spec.dtype) / levels * scale
            vals = torch.where(scale > 0, vals, torch.zeros_like(vals))
            outs.append(vals.reshape(lead + (r.span,)))
        return _cat(outs)

    def reduce(self, q: FlatQuant, weights: torch.Tensor, m) -> torch.Tensor:
        n = q.words.shape[0]
        weights = weights.to(torch.float32)
        outs = []
        for r in self.layout.runs:
            words = q.words[:, r.woff:r.woff + r.nblocks * r.W].reshape(
                n, r.nblocks, r.W)
            scale = q.scale[:, r.boff:r.boff + r.nblocks]
            acc = unpack_mma(words, scale, weights, self.cfg.bits, r.block)
            outs.append(acc.reshape(r.span))
        return _cat(outs).to(self.spec.dtype) / m

    def wire_bytes(self) -> int:
        return int(4 * (self.layout.W_total + self.layout.NB_total))


class _QuantPallasCodec(_QuantCodec):
    """Quant on the kernel backend: the EF14 step runs fused in the
    ``quantize_ef_pack`` kernel -- quantizer, residual update and wire-word
    packing in one pass (one launch per run, the client axis folded into
    the run's rows)."""

    fused_ef = True

    def ef(self, e: torch.Tensor, deltas: torch.Tensor):
        """(e, deltas) ``[*lead, d]`` -> (FlatQuant msgs, e_new)."""
        lead = tuple(deltas.shape[:-1])
        ws, ss, es = [], [], []
        for r in self.layout.runs:
            words, scale, e_new = quantize_ef_pack(
                run_view(e, r), run_view(deltas, r), self.cfg.bits)
            ws.append(words.reshape(lead + (r.nblocks * r.W,)))
            ss.append(scale.reshape(lead + (r.nblocks,)))
            es.append(e_new.reshape(lead + (r.span,)))
        return FlatQuant(_cat(ws), _cat(ss)), _cat(es)

    def pack(self, buf: torch.Tensor) -> FlatQuant:
        msg, _ = self.ef(torch.zeros_like(buf), buf)
        return msg


def _make_codec(t: transports.Transport, spec: FlatSpec):
    """The flat wire codec for a transport, or None for the identity."""
    if t.kind == "none":
        return None
    if t.backend != "pallas":
        raise NotImplementedError(
            f"the {t.backend!r} backend ({t.kind} on comm="
            f"{'dense' if t.backend == 'ref' else t.backend}) is not ported "
            "yet: only comm='pallas'")
    layout = wire_layout(spec, t.cfg)
    if t.kind == "topk":
        return _SelectCodec(t.cfg, spec, layout)
    if t.cfg.bits not in PACK_BITS:
        raise NotImplementedError(
            f"quant at bits={t.cfg.bits} (the dense-wire fallback) is not "
            f"ported yet; packable widths: {PACK_BITS}")
    return _QuantPallasCodec(t.cfg, spec, layout)


# ---------------------------------------------------------------------------
# FlatTransport: the engine-facing wire path over flat buffers
# ---------------------------------------------------------------------------

class FlatTransport:
    """One direction of the wire path over flat ``[d]`` buffers:
    ``e``/``deltas`` are ``[n, d]`` stacks (mask mode) or the m
    participants' ``[m, d]`` rows (gather mode), messages are flat payloads.

    Usage::

        >>> up = FlatTransport(get_transport(cfg, "pallas"), spec_of(params))
        >>> v_bar, e_new = up.transmit(e, deltas, mask, m)
    """

    def __init__(self, t: transports.Transport, spec: FlatSpec):
        self.t = t
        self.cfg = t.cfg
        self.kind = t.kind
        self.backend = t.backend
        self.spec = spec
        self.codec = _make_codec(t, spec)

    @property
    def is_identity(self) -> bool:
        return self.t.is_identity

    @property
    def tracks_center(self) -> bool:
        return self.t.tracks_center

    @property
    def wire(self) -> str:
        return "dense" if self.codec is None else "packed"

    def wire_bytes(self) -> int:
        """True wire bytes of one message: packed formats count their
        arrays (uint32 words, uint16 offsets), the identity the dense
        buffer."""
        if self.codec is None:
            itemsize = torch.empty((), dtype=self.spec.dtype).element_size()
            return int(self.spec.d * itemsize)
        return self.codec.wire_bytes()

    # -- wire primitives ----------------------------------------------------

    def compress(self, buf: torch.Tensor):
        """Flat message for one ``[d]`` buffer (the operator C)."""
        if self.codec is None:
            return buf
        return self.codec.pack(buf)

    def decompress(self, message) -> torch.Tensor:
        if self.codec is None:
            return message
        return self.codec.decode(message)

    # -- round-level call sites ---------------------------------------------

    def _ef_clients(self, e, deltas):
        if self.codec.fused_ef:
            return self.codec.ef(e, deltas)
        buf = e + deltas
        msgs = self.codec.pack(buf)
        return msgs, buf.sub_(self.codec.decode(msgs))   # buf is ours

    def encode(self, e, deltas, mask):
        """Per-client EF14 encode over the ``[n, d]`` stacks: ``(msgs,
        e_new)``; rows with ``mask == 0`` keep their residual.  The residual
        ``e`` is updated in place (the ``[n, d]`` buffer is the largest
        state of a round) and returned."""
        if self.is_identity:
            return deltas, e
        msgs, e_stack = self._ef_clients(e, deltas)
        return msgs, transports.mask_where(mask, e_stack, e, out=e)

    def encode_gathered(self, e, deltas, idx, mask, unique: bool = True):
        """Compute-sparse encode: ``deltas`` holds the m participants' rows
        (``idx``, sorted); per-client results match :meth:`encode`'s.  The
        participants' residual rows are written back into ``e`` in place
        (``index_copy_``: any write wins, so the repeated ids of a short
        cohort write the same row) and the messages are scattered into the
        ``[n, ...]`` layout (``unique=False`` for a short cohort: see
        :func:`transports.scatter_rows`)."""
        n = mask.shape[0]
        if self.is_identity:
            return transports.scatter_rows(deltas, idx, n, unique), e
        msgs, e_stack = self._ef_clients(e.index_select(0, idx), deltas)
        e.index_copy_(0, idx, e_stack)
        return transports.scatter_rows(msgs, idx, n, unique), e

    def reduce(self, msgs, weights, m) -> torch.Tensor:
        """Weighted aggregation of stacked messages into ``[d]``:
        ``sum_j weights_j * decode(msgs_j) / m``, in the payload domain."""
        if self.wire == "dense":
            return transports.masked_mean(msgs, weights, m)
        return self.codec.reduce(msgs, weights, m)

    def transmit(self, e, deltas, mask, m):
        if self.is_identity:
            return self.reduce(deltas, mask, m), e
        msgs, e_out = self.encode(e, deltas, mask)
        return self.reduce(msgs, mask, m), e_out

    def transmit_gathered(self, e, deltas, idx, mask, m,
                          unique: bool = True):
        msgs, e_out = self.encode_gathered(e, deltas, idx, mask, unique)
        return self.reduce(msgs, mask, m), e_out

    def broadcast(self, w: torch.Tensor, x_new: torch.Tensor) -> torch.Tensor:
        """Primal-EF21 downlink on flat buffers: ``w' = w + C(x_new - w)``
        (the identity returns ``x_new``)."""
        if self.is_identity:
            return x_new
        return w + self.decompress(self.compress(x_new - w))


def flat_transports_for(cfg, spec: FlatSpec):
    """(uplink, downlink) :class:`FlatTransport` pair for a FedConfig."""
    backend = transports.backend_for(cfg.comm)
    return (FlatTransport(transports.get_transport(cfg.uplink, backend), spec),
            FlatTransport(transports.get_transport(cfg.downlink, backend),
                          spec))
