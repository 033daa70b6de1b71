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
* :class:`FlatTransport` -- EF14 encode + reduce over ``[n, d]`` stacks
  (or the m gathered rows, scattered back into ``[n, ...]`` through
  ``segment_rows``), for the uplink and the primal-EF21 downlink:

  - dense wires (``comm="dense"``, ``natural``, quant at bit widths that
    do not pack) run the per-leaf operators of
    :mod:`repro_torch.core.compression` on the unflattened buffer (all
    clients at once, or one client stream at a time for the random kinds)
    and reduce with one weighted contraction over the client axis;
  - packed wires reduce in the payload domain: :class:`FlatPacked`
    (values + uint16 offsets, ``scatter_agg``) for top-k and rand-k and
    :class:`FlatQuant` (bit-packed words, ``unpack_mma``) for quant.  On
    ``comm="packed"`` top-k selects by a stable sort per block (sort-free
    on giant leaves) and quant packs unfused; on ``comm="pallas"`` the
    ``block_topk`` and fused ``quantize_ef_pack`` kernels encode;
  - ``cohorts=k`` makes :meth:`FlatTransport.reduce` two-tier: k edge
    reducers over contiguous cohorts of the stacked rows, their partials
    summed left to right (``ScaleConfig.cohorts``, the uplink only).

Under a rank mesh (``sharding.partition``) each rank encodes its block of
the round's rows (:meth:`FlatTransport.transmit` and
:meth:`FlatTransport.transmit_gathered`; the slot store through
:meth:`FlatTransport.encode_rows`), ``sharding.partition.all_rows``
all-gathers the messages in row order in the payload domain (values and
offsets, codes and scales, or the dense rows), and every rank reduces all
of them as one process does: the same kernels on the same stacked rows,
so ``v_bar`` is bit-equal to one process's.

Under a rank mesh with a model axis the flat state is split by columns
(:func:`columns_for`: a :class:`Columns` block of a
``sharding.partition.ColumnSplit``).  The cuts never divide a compression
unit of either direction's wire -- a block of a blockwise operator (every
packed codec; the dense wire's quant, and its top-k above
``_SORT_FREE_MIN`` elements), a whole leaf where the operator decides per
leaf (the dense wire's top-k below that size, rand-k) -- and balance the
element count as nearly as those units allow.  A :class:`FlatTransport`
built on a rank's columns works on them alone: the codecs run on
:func:`local_layout`'s runs (the same blocks, so the same kernels on the
same values), the payloads hold that rank's contiguous slot range of the
one-process payload, the dense wire compresses leaf by leaf or block by
block, and the random kinds draw the whole buffer from the one-process
generator and keep their columns.  :func:`tree_norm` adds the per-leaf
partials of every rank.

Under a plan that splits the model's leaves (``partition.tensor_plan``)
the model computes on each rank's tensor-local buffer instead
(:class:`TensorLayout`): the leaves in the reference's order at their
local shapes (:func:`local_spec`).  The wire keeps the column layout,
whose blocks are the reference's ravel order.  Once a round the new
``w``'s columns go into every rank's tensor-local buffer
(:meth:`TensorLayout.to_tensor`: one ``all_to_all_single`` for the split
leaves, one all-gather of the whole leaves' columns), and each delta row
comes back to the columns as soon as it is computed
(:meth:`TensorLayout.to_columns`: one ``all_to_all_single`` a row; a
whole leaf's row is the same on every rank, so each column owner keeps
its own part).  The maps are index arithmetic on the leaf shapes: a split
leaf of shape ``[A, n, B]`` (split on the middle dim into M blocks) is a
list of ``A * M`` rows of ``n / M * B`` elements, row ``a * M + t`` held
by rank t, so a column range meets each rank in at most a partial row, a
run of rows M apart and another partial row, and lands in that rank's
buffer as one contiguous range.
"""
from __future__ import annotations

import bisect
import math
from typing import NamedTuple

import torch

from repro_torch.comm import payloads, transports
from repro_torch.comm.payloads import (FlatPacked, FlatQuant, PACK_BITS,
                                       block_geometry, pack_codes, to_u16,
                                       u16_to_i64, unpack_codes,
                                       words_per_block, _SORT_FREE_MIN)
from repro_torch.core import compression
from repro_torch.kernels import ops
from repro_torch.obs.trace import stage
from repro_torch.sharding import partition


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
                            # (dict keys, and list indices as ints)
    leaves: tuple           # tuple[LeafSpec]
    d: int
    dtype: torch.dtype      # buffer dtype: the leaves' common promotion
    empties: tuple = ()     # paths of the tree's empty lists and dicts
                            # (no leaf; :func:`unflatten` gives them back)


def _leaves(tree, path=(), empties=None):
    """(path, leaf) pairs in ``jax.tree_util``'s order: dict keys sorted,
    list entries by index; an empty list or dict gives no leaf (its path
    goes into ``empties`` when given).  Anything else, tuples included,
    is a leaf."""
    if isinstance(tree, (dict, list)):
        keys = sorted(tree) if isinstance(tree, dict) else range(len(tree))
        if not keys and empties is not None:
            empties.append((path, type(tree)))
        for k in keys:
            yield from _leaves(tree[k], path + (k,), empties)
    else:
        yield path, tree


def spec_of(tree) -> FlatSpec:
    """The :class:`FlatSpec` of a nested dict / list of tensors (any
    device, ``meta`` included)."""
    paths, specs, off = [], [], 0
    dtype = None
    empties: list = []
    for path, leaf in _leaves(tree, empties=empties):
        size = 1
        for s in leaf.shape:
            size *= int(s)
        paths.append(path)
        specs.append(LeafSpec(tuple(leaf.shape), leaf.dtype, off, size))
        dtype = leaf.dtype if dtype is None else \
            torch.promote_types(dtype, leaf.dtype)
        off += size
    return FlatSpec(tuple(paths), tuple(specs), off, dtype or torch.float32,
                    tuple(empties))


def flatten(spec: FlatSpec, tree) -> torch.Tensor:
    """Nested dict / list -> contiguous buffer.  Leading axes shared by
    every leaf (a stacked ``[n, ...]`` tree) are kept: the output is
    ``[*lead, d]``."""
    leaves = [leaf for _, leaf in _leaves(tree)]
    if len(leaves) != len(spec.leaves):
        raise ValueError(f"flatten: tree has {len(leaves)} leaves but the "
                         f"FlatSpec records {len(spec.leaves)}")
    out = []
    for leaf, ls in zip(leaves, spec.leaves):
        lead = tuple(leaf.shape[:leaf.dim() - len(ls.shape)])
        out.append(leaf.to(spec.dtype).reshape(lead + (ls.size,)))
    return torch.cat(out, dim=-1) if len(out) > 1 else out[0]


def _rebuild(node):
    """Nested dicts keyed by path entries -> the tree: a node keyed by
    list indices becomes a list, dict keys come back sorted."""
    if not isinstance(node, dict) or not node:
        return node
    if all(isinstance(k, int) for k in node):
        return [_rebuild(node[i]) for i in range(len(node))]
    return {k: _rebuild(node[k]) for k in sorted(node)}


def unflatten(spec: FlatSpec, flat: torch.Tensor):
    """Buffer ``[*lead, d]`` -> the nested dict / list with leaf shapes
    ``[*lead, *leaf_shape]``.  On a 1-D buffer every leaf is a view (a
    ``split``, so the backward of a gradient through all leaves is one
    concatenation into ``[d]``)."""
    lead = tuple(flat.shape[:-1])
    parts = flat.split([ls.size for ls in spec.leaves], dim=-1)
    root: dict = {}

    def put(path, value):
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value
    for path, kind in spec.empties:
        put(path, kind())
    for path, ls, part in zip(spec.paths, spec.leaves, parts):
        put(path, part.reshape(lead + ls.shape).to(ls.dtype))
    return _rebuild(root)


def tree_norm(spec: FlatSpec, flat: torch.Tensor,
              cols: "Columns | None" = None) -> torch.Tensor:
    """sqrt(sum ||leaf||^2): each leaf slice reduces on its own and the
    partials add in leaf order.

    Under a model axis ``flat`` holds the columns ``cols``: each rank
    reduces its part of every leaf, the ``[leaves]`` partials are
    all-gathered over the model axis, a leaf's partials add in rank order
    and the leaves in leaf order.  A leaf that lies on one rank gives one
    process's partial bit for bit; a leaf that straddles a cut adds two
    partial sums in another order than one process's single reduction
    (allclose: within a few ulps of float32, rtol 1e-6 in the tests)."""
    if cols is None:
        parts = [flat[ls.offset:ls.offset + ls.size].to(torch.float32)
                 .square().sum() for ls in spec.leaves]
        return torch.sqrt(sum(parts))
    from repro_torch.sharding import collectives
    parts = torch.zeros(len(spec.leaves), dtype=torch.float32,
                        device=flat.device)
    for i, a, b in pieces(spec, cols.lo, cols.hi):
        parts[i] = flat[a - cols.lo:b - cols.lo].to(torch.float32) \
            .square().sum()
    size = len(cols.split.cuts) - 1
    every = collectives.all_gather_rows(parts[None], [1] * size,
                                        axis="model")
    total = []
    for i, ls in enumerate(spec.leaves):
        owners = [r for r in range(size)
                  if _overlap(cols.split.block(r), ls)] or [0]
        p = every[owners[0], i]
        for r in owners[1:]:
            p = p + every[r, i]
        total.append(p)
    return torch.sqrt(sum(total))


def _overlap(block: tuple, ls: LeafSpec) -> bool:
    return max(block[0], ls.offset) < min(block[1], ls.offset + ls.size)


def struct_tree(spec: FlatSpec) -> dict:
    """The parameter tree's shapes and dtypes as ``meta`` tensors (for the
    tree transports' wire accounting)."""
    return unflatten(spec, torch.empty(spec.d, dtype=spec.dtype,
                                       device="meta"))


def project_ball(spec: FlatSpec, flat: torch.Tensor, radius: float,
                 cols: "Columns | None" = None):
    """Euclidean projection of the flat buffer onto ``||w|| <= radius``
    (``flat`` the columns ``cols`` under a model axis: the norm is
    :func:`tree_norm`'s over every rank)."""
    if not radius:
        return flat
    nrm = tree_norm(spec, flat, cols)
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
        b, k = block_geometry(D, cfg)
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
# Column blocks under a model axis
# ---------------------------------------------------------------------------

class Columns(NamedTuple):
    """This model rank's columns ``lo:hi`` of the flat buffer, one block of
    ``split``."""
    split: partition.ColumnSplit
    lo: int
    hi: int

    @property
    def width(self) -> int:
        return self.hi - self.lo

    def cut(self, flat: torch.Tensor) -> torch.Tensor:
        """The columns of a whole ``[*lead, d]`` buffer (a view)."""
        return flat[..., self.lo:self.hi]


class PayloadCut(NamedTuple):
    """A column block's contiguous ranges of the one-process payload:
    top-k / rand-k slots, quant scales (blocks) and quant words."""
    slots: tuple
    blocks: tuple
    words: tuple


def pieces(spec: FlatSpec, lo: int, hi: int) -> list:
    """``(leaf index, a, b)``: the flat columns ``a:b`` of each leaf that
    meets the columns ``lo:hi``, in leaf order."""
    out = []
    for i, ls in enumerate(spec.leaves):
        a, b = max(lo, ls.offset), min(hi, ls.offset + ls.size)
        if a < b:
            out.append((i, a, b))
    return out


def local_layout(layout: WireLayout, lo: int, hi: int) -> tuple:
    """``(WireLayout, PayloadCut)`` of the columns ``lo:hi``: each run cut
    to the blocks it holds there, offsets counted from ``lo`` and from the
    block's first slot, scale and word.  A cut that divides a block raises
    ``ValueError``."""
    runs, koff, boff, woff, start = [], 0, 0, 0, None
    for r in layout.runs:
        a, b = max(lo, r.offset), min(hi, r.offset + r.span)
        if a >= b:
            continue
        if (a - r.offset) % r.block or (b - r.offset) % r.block:
            raise ValueError(f"columns {lo}:{hi} divide a block of "
                             f"{r.block} in the run at {r.offset}")
        first, nb = (a - r.offset) // r.block, (b - a) // r.block
        if start is None:
            start = (r.koff + first * r.k, r.boff + first,
                     r.woff + first * r.W)
        runs.append(RunSpec(a - lo, b - a, r.block, nb, r.k, r.sort_free,
                            koff, boff, woff, r.W))
        koff, boff, woff = koff + nb * r.k, boff + nb, woff + nb * r.W
    k0, b0, w0 = start or (0, 0, 0)
    return (WireLayout((), tuple(runs), koff, boff, woff),
            PayloadCut((k0, k0 + koff), (b0, b0 + boff), (w0, w0 + woff)))


def _leaf_units(ft: "FlatTransport") -> list:
    """Per leaf, the columns of one compression unit of a whole-width
    transport: its block where the operator works block by block, the
    whole leaf where it decides per leaf, 1 where it works per entry."""
    spec = ft.spec
    if ft.is_identity:
        return [1] * len(spec.leaves)
    lws = wire_layout(spec, ft.cfg).leaves
    out = []
    for ls, lw in zip(spec.leaves, lws):
        if ft.codec is not None:
            unit = lw.block
        elif ft.kind == "quant":
            unit = lw.block if ls.shape else 1
        elif ft.kind == "topk":
            unit = lw.block if ls.size > _SORT_FREE_MIN else ls.size
        elif ft.kind == "natural":
            unit = 1
        else:                   # rand-k: one permutation per leaf
            unit = ls.size
        out.append(max(1, unit))
    return out


def column_split(spec: FlatSpec, transports, size: int
                 ) -> partition.ColumnSplit:
    """``size`` column blocks of ``spec``'s flat buffer whose cuts divide
    no compression unit of any of ``transports`` (whole-width
    :class:`FlatTransport`): cut r lies at the unit boundary nearest to
    ``r * d / size`` (the lower one on a tie), so the blocks balance the
    element count as nearly as the units allow."""
    units = [1] * len(spec.leaves)
    for ft in transports:
        units = [math.lcm(a, b) for a, b in zip(units, _leaf_units(ft))]
    ends = [ls.offset + ls.size for ls in spec.leaves]
    cuts = [0]
    for r in range(1, size):
        target = (r * spec.d + size // 2) // size
        i = min(bisect.bisect_right(ends, target), len(ends) - 1)
        ls, u = spec.leaves[i], units[i]
        below = ls.offset + (target - ls.offset) // u * u
        above = min(below + u, ls.offset + ls.size)
        cut = below if target - below <= above - target else above
        cuts.append(max(cut, cuts[-1]))
    cuts.append(spec.d)
    return partition.ColumnSplit(tuple(cuts))


def columns_for(cfg, spec: FlatSpec) -> "Columns | None":
    """This rank's :class:`Columns` of a round of FedConfig ``cfg`` under a
    rank mesh with a model axis (:func:`column_split` of the uplink and
    the downlink); None without one."""
    ma = partition.model_axis()
    if ma is None:
        return None
    split = column_split(spec, flat_transports_for(cfg, spec), ma.size)
    lo, hi = split.block(ma.rank)
    return Columns(split, lo, hi)


# ---------------------------------------------------------------------------
# The tensor layout under a split plan
# ---------------------------------------------------------------------------

def local_spec(spec: FlatSpec, plan) -> FlatSpec:
    """``spec`` with each leaf at its local shape under ``plan`` (a
    ``partition.TensorPlan``), in the same order, offsets recounted."""
    leaves, off = [], 0
    for i, ls in enumerate(spec.leaves):
        shape = plan.local_shape(i, ls.shape)
        size = math.prod(shape)
        leaves.append(LeafSpec(shape, ls.dtype, off, size))
        off += size
    return spec._replace(leaves=tuple(leaves), d=off)


def _row_geometry(shape: tuple, dim: int, M: int) -> int:
    """The row length of a leaf split on ``dim`` into M blocks: its
    elements as rows of ``shape[dim] / M * prod(shape[dim + 1:])``."""
    return shape[dim] // M * math.prod(shape[dim + 1:])


def _segments(u: int, v: int, L: int, M: int, t: int) -> list:
    """The elements of a split leaf's range ``u:v`` (leaf-relative) that
    rank ``t`` holds, as ``(start, rows, width)``: ``rows`` runs of
    ``width`` elements from ``start``, ``M * L`` apart (rows of length
    ``L``, row ``r`` held by rank ``r % M``), in order."""
    out = []
    if u >= v:
        return out
    r = u // L
    if u % L:                                   # a partial first row
        end = min(v, (r + 1) * L)
        if r % M == t:
            out.append((u, 1, end - u))
        u, r = end, r + 1
        if u >= v:
            return out
    r1 = v // L                                 # whole rows r .. r1 - 1
    first = r + (t - r) % M
    if first < r1:
        out.append((first * L, (r1 - 1 - first) // M + 1, L))
    if v % L and r1 % M == t:                   # a partial last row
        out.append((r1 * L, 1, v - r1 * L))
    return out


def _local_at(g: int, L: int, M: int) -> int:
    """The position in its rank's shard of a split leaf's element ``g``."""
    return (g // L // M) * L + g % L


def _rows(x: torch.Tensor, start: int, n: int, width: int,
          stride: int) -> torch.Tensor:
    """``[n, width]`` view of the 1-D contiguous ``x``: rows from
    ``start``, ``stride`` apart."""
    if n == 1:
        return x[start:start + width].view(1, width)
    return x.as_strided((n, width), (stride, 1), x.storage_offset() + start)


def _merge(ops: list) -> list:
    """Copies ``(src, dst, n)`` with each one that continues the last in
    both buffers folded into it."""
    out = []
    for a, b, n in ops:
        if out and out[-1][0] + out[-1][2] == a and \
                out[-1][1] + out[-1][2] == b:
            out[-1] = (out[-1][0], out[-1][1], out[-1][2] + n)
        elif n:
            out.append((a, b, n))
    return out


class TensorLayout:
    """One model rank's maps between its column block ``cols`` of the flat
    buffer and its tensor-local buffer under ``plan`` (module docstring):

    * ``spec`` -- the tensor-local :class:`FlatSpec` (:func:`local_spec`);
    * :meth:`to_tensor` -- every rank's columns -> this rank's local
      buffer (the round's ``w``);
    * :meth:`to_columns` -- every rank's local buffer -> this rank's
      columns (a delta row).

    Under a plan with no split leaf the local buffer is the whole ``[d]``
    buffer: :meth:`to_tensor` is one all-gather of the columns, and
    :meth:`to_columns` a copy of this rank's columns."""

    def __init__(self, spec: FlatSpec, cols: Columns, plan, rank: int):
        self.whole_spec, self.cols, self.plan, self.rank = \
            spec, cols, plan, rank
        self.spec = local_spec(spec, plan)
        M = plan.size
        blocks = [cols.split.block(q) for q in range(M)]
        geo = {}
        for i, (ls, dim) in enumerate(zip(spec.leaves, plan.dims)):
            if dim is not None:
                geo[i] = _row_geometry(ls.shape, dim, M)

        def parts(q):
            lo, hi = blocks[q]
            return pieces(spec, lo, hi)

        # to_tensor, split leaves: what this rank sends each rank t (reads
        # from its columns), and where what each rank q sends lands here
        lo = cols.lo
        self._send_t, self._send_t_counts = [], []
        for t in range(M):
            ops, n = [], 0
            for i, a, b in parts(rank):
                if i not in geo:
                    continue
                off = spec.leaves[i].offset
                for g, rows, width in _segments(a - off, b - off, geo[i], M,
                                                t):
                    ops.append((off + g - lo, rows, width, M * geo[i], n))
                    n += rows * width
            self._send_t.append(ops)
            self._send_t_counts.append(n)
        self._recv_t, self._recv_t_counts, pos = [], [], 0
        for q in range(M):
            n = 0
            for i, a, b in parts(q):
                if i not in geo:
                    continue
                off, L = spec.leaves[i].offset, geo[i]
                segs = _segments(a - off, b - off, L, M, rank)
                size = sum(r * w for _, r, w in segs)
                if size:
                    dst = self.spec.leaves[i].offset + _local_at(segs[0][0],
                                                                 L, M)
                    self._recv_t.append((pos + n, dst, size))
                n += size
            self._recv_t_counts.append(n)
            pos += n
        self._recv_t = _merge(self._recv_t)
        # whole leaves: every rank's columns of them, all-gathered, and
        # placed; this rank's own part of a delta row
        self._whole_counts, self._whole_place, pos = [], [], 0
        self._whole_mine, self._own = [], []
        for q in range(M):
            n = 0
            for i, a, b in parts(q):
                if i in geo:
                    continue
                off = spec.leaves[i].offset
                dst = self.spec.leaves[i].offset + a - off
                self._whole_place.append((pos + n, dst, b - a))
                if q == rank:
                    self._whole_mine.append((a - lo, n, b - a))
                    self._own.append((dst, a - lo, b - a))
                n += b - a
            self._whole_counts.append(n)
            pos += n
        self._whole_place = _merge(self._whole_place)
        self._whole_mine = _merge(self._whole_mine)
        self._own = _merge(self._own)
        # to_columns, split leaves: this rank's local ranges for each
        # column owner q, and the strided writes of what each rank t sends
        self._send_c, self._send_c_counts = [], []
        for q in range(M):
            ops, n = [], 0
            for i, a, b in parts(q):
                if i not in geo:
                    continue
                off, L = spec.leaves[i].offset, geo[i]
                segs = _segments(a - off, b - off, L, M, rank)
                size = sum(r * w for _, r, w in segs)
                if size:
                    ops.append((self.spec.leaves[i].offset
                                + _local_at(segs[0][0], L, M), n, size))
                n += size
            self._send_c.append(_merge(ops))
            self._send_c_counts.append(n)
        self._recv_c, self._recv_c_counts, pos = [], [], 0
        for t in range(M):
            n = 0
            for i, a, b in parts(rank):
                if i not in geo:
                    continue
                off = spec.leaves[i].offset
                for g, rows, width in _segments(a - off, b - off, geo[i], M,
                                                t):
                    self._recv_c.append((pos + n, off + g - lo, rows, width,
                                         M * geo[i]))
                    n += rows * width
            self._recv_c_counts.append(n)
            pos += n
        self.any_split = plan.split
        self.any_whole = any(self._whole_counts)

    def exchange_bytes(self) -> dict:
        """Bytes this rank sends to other ranks and receives from them in
        a :meth:`to_tensor` and a :meth:`to_columns` (the all-gather's
        padding left out)."""
        item = torch.empty((), dtype=self.whole_spec.dtype).element_size()
        me, M = self.rank, self.plan.size
        whole = self._whole_counts
        return {
            "to_tensor_out": item * (sum(self._send_t_counts)
                                     - self._send_t_counts[me]
                                     + whole[me] * (M - 1)),
            "to_tensor_in": item * (sum(self._recv_t_counts)
                                    - self._recv_t_counts[me]
                                    + sum(whole) - whole[me]),
            "to_columns_out": item * (sum(self._send_c_counts)
                                      - self._send_c_counts[me]),
            "to_columns_in": item * (sum(self._recv_c_counts)
                                     - self._recv_c_counts[me])}

    # -- the two directions, each: pack, the collectives, unpack ----------

    def pack_tensor(self, x: torch.Tensor) -> tuple:
        """:meth:`to_tensor`'s sends: ``(split, whole)``, the split leaves'
        elements grouped by destination rank (``_send_t_counts``) and this
        rank's columns of the whole leaves."""
        split = x.new_empty(sum(self._send_t_counts))
        base = 0
        for t, ops in enumerate(self._send_t):
            for src, rows, width, stride, at in ops:
                split[base + at:base + at + rows * width].view(
                    rows, width).copy_(_rows(x, src, rows, width, stride))
            base += self._send_t_counts[t]
        if len(self._whole_mine) == 1 and \
                self._whole_mine[0][2] == x.shape[0]:
            return split, x
        whole = x.new_empty(self._whole_counts[self.rank])
        for a, b, n in self._whole_mine:
            whole[b:b + n] = x[a:a + n]
        return split, whole

    def unpack_tensor(self, recv: torch.Tensor, full: torch.Tensor
                      ) -> torch.Tensor:
        """:meth:`to_tensor`'s result from what arrived: ``recv`` the split
        leaves' elements grouped by source rank, ``full`` every rank's
        whole-leaf columns in rank order."""
        if not self.any_split and self._whole_place == [(0, 0,
                                                        self.spec.d)]:
            return full
        out = full.new_empty(self.spec.d)
        for a, b, n in self._whole_place:
            out[b:b + n] = full[a:a + n]
        for a, b, n in self._recv_t:
            out[b:b + n] = recv[a:a + n]
        return out

    def to_tensor(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's columns ``[cols.width]`` of a flat buffer (every
        rank calling with its own) -> this rank's tensor-local buffer
        ``[spec.d]``: one ``all_to_all_single`` of the split leaves, one
        all-gather of the whole leaves' columns."""
        from repro_torch.sharding import collectives
        split, whole = self.pack_tensor(x.contiguous())
        recv = collectives.exchange_rows(
            split, self._send_t_counts, self._recv_t_counts,
            axis="model") if self.any_split else split
        full = collectives.all_gather_rows(
            whole, self._whole_counts, axis="model") if self.any_whole \
            else whole
        return self.unpack_tensor(recv, full)

    def pack_columns(self, x: torch.Tensor) -> torch.Tensor:
        """:meth:`to_columns`'s send: the split leaves' local elements
        grouped by column owner (``_send_c_counts``)."""
        send = x.new_empty(sum(self._send_c_counts))
        base = 0
        for q, ops in enumerate(self._send_c):
            for a, b, n in ops:
                send[base + b:base + b + n] = x[a:a + n]
            base += self._send_c_counts[q]
        return send

    def unpack_columns(self, x: torch.Tensor, recv: torch.Tensor,
                       out: torch.Tensor) -> torch.Tensor:
        """:meth:`to_columns`'s result into ``out``: this rank's own part
        of the whole leaves from ``x``, the split leaves' columns from
        ``recv`` (grouped by source rank)."""
        for a, b, n in self._own:
            out[b:b + n] = x[a:a + n]
        for src, dst, rows, width, stride in self._recv_c:
            _rows(out, dst, rows, width, stride).copy_(
                recv[src:src + rows * width].view(rows, width))
        return out

    def to_columns(self, x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        """This rank's tensor-local buffer ``[spec.d]`` (every rank calling
        with its own) -> ``out``, this rank's columns ``[cols.width]``: one
        ``all_to_all_single`` of the split leaves."""
        from repro_torch.sharding import collectives
        recv = None
        if self.any_split:
            recv = collectives.exchange_rows(
                self.pack_columns(x), self._send_c_counts,
                self._recv_c_counts, axis="model")
        return self.unpack_columns(x, recv, out)


def tensor_layout(spec: FlatSpec, cols: Columns, plan) -> TensorLayout:
    """This model rank's :class:`TensorLayout` of ``spec`` between the
    columns ``cols`` and the tensor layout of ``plan`` (None: no leaf
    split), computed on each call (index arithmetic on the leaves' shapes:
    well under a millisecond at qwen3-4b's widths)."""
    from repro_torch.sharding import partition
    ma = partition.model_axis()
    if plan is None:
        plan = partition.TensorPlan((None,) * len(spec.leaves), ma.size)
    return TensorLayout(spec, cols, plan, ma.rank)


# ---------------------------------------------------------------------------
# Flat wire codecs (one per packed payload format)
# ---------------------------------------------------------------------------

class _SelectCodec:
    """FlatPacked (values + uint16 offsets) for block top-k."""

    per_client_keys = False
    fused_ef = False

    def __init__(self, cfg, spec: FlatSpec, layout: WireLayout,
                 pallas: bool = False):
        self.cfg, self.spec, self.layout, self.pallas = \
            cfg, spec, layout, pallas

    def pack(self, buf: torch.Tensor, gen=None) -> FlatPacked:
        """``[*lead, d]`` -> FlatPacked ``[*lead, K_total]``: one selection
        per run (one ``block_topk`` launch on the pallas backend), the
        client axis folded into the run's rows."""
        lead = tuple(buf.shape[:-1])
        vs, js = [], []
        for r in self.layout.runs:
            blocks = run_view(buf, r)
            if self.pallas and r.k < r.block:
                vals, idx = ops.block_topk(blocks, r.k)
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
        streams reduce into dense destination blocks (``ops.scatter_agg``:
        the ``scatter_agg`` kernel on the card)."""
        n = p.values.shape[0]
        outs = []
        for r in self.layout.runs:
            sl = slice(r.koff, r.koff + r.nblocks * r.k)
            vals = p.values[:, sl].reshape(n, r.nblocks, r.k)
            idx = p.indices[:, sl].reshape(n, r.nblocks, r.k)
            acc = ops.scatter_agg(vals, idx, weights, r.block)
            outs.append(acc.reshape(r.span))
        return _cat(outs).to(self.spec.dtype) / m

    def wire_bytes(self) -> int:
        itemsize = torch.empty((), dtype=self.spec.dtype).element_size()
        return int(self.layout.K_total * (itemsize + 2))


class _RandkCodec(_SelectCodec):
    """Rand-k in the FlatPacked format (decode and reduce shared); packing
    draws each leaf's uniforms from one client's generator, leaf by leaf as
    the tree packer does, so it runs one client row at a time."""

    per_client_keys = True

    def pack(self, buf: torch.Tensor, gen=None) -> FlatPacked:
        if gen is None:
            raise ValueError("randk needs a generator")
        vs, js = [], []
        for ls in self.spec.leaves:
            leaf = buf[ls.offset:ls.offset + ls.size].reshape(
                ls.shape if ls.shape else (1,))
            p = payloads.block_randk_pack(leaf, self.cfg, gen)
            vs.append(p.values.reshape(-1))
            js.append(p.indices.reshape(-1))
        return FlatPacked(_cat(vs), _cat(js))


class _QuantCodec:
    """FlatQuant (bit-packed uint32 words + per-block scales); reduce is the
    unpack-multiply-add over the client axis (``ops.quant_agg``: the
    ``unpack_mma`` kernel on the card)."""

    per_client_keys = False
    fused_ef = False

    def __init__(self, cfg, spec: FlatSpec, layout: WireLayout,
                 pallas: bool = False):
        self.cfg, self.spec, self.layout, self.pallas = \
            cfg, spec, layout, pallas
        self.levels = float(2 ** (cfg.bits - 1) - 1)

    def pack(self, buf: torch.Tensor, gen=None) -> FlatQuant:
        """Unfused: quantize each run's blocks, then pack the codes."""
        lead = tuple(buf.shape[:-1])
        ws, ss = [], []
        for r in self.layout.runs:
            codes, scale = payloads.quant_blocks(run_view(buf, r),
                                                 self.cfg.bits)
            words = pack_codes(codes, self.cfg.bits)
            ws.append(words.reshape(lead + (r.nblocks * r.W,)))
            ss.append(scale.to(torch.float32).reshape(lead + (r.nblocks,)))
        return FlatQuant(_cat(ws), _cat(ss))

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
        outs = []
        for r in self.layout.runs:
            words = q.words[:, r.woff:r.woff + r.nblocks * r.W].reshape(
                n, r.nblocks, r.W)
            scale = q.scale[:, r.boff:r.boff + r.nblocks]
            acc = ops.quant_agg(words, scale, weights, self.cfg.bits,
                                r.block)
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
            words, scale, e_new = ops.quantize_ef_pack(
                run_view(e, r), run_view(deltas, r), self.cfg.bits)
            ws.append(words.reshape(lead + (r.nblocks * r.W,)))
            ss.append(scale.reshape(lead + (r.nblocks,)))
            es.append(e_new.reshape(lead + (r.span,)))
        return FlatQuant(_cat(ws), _cat(ss)), _cat(es)

    def pack(self, buf: torch.Tensor, gen=None) -> FlatQuant:
        msg, _ = self.ef(torch.zeros_like(buf), buf)
        return msg


def _make_codec(t: transports.Transport, spec: FlatSpec, layout=None):
    """The flat wire codec for a transport, or None for a dense wire (the
    ref backend, ``none``, ``natural``, quant at a bit width that does not
    pack).  ``layout``: a column block's (default: the whole buffer's)."""
    if t.backend == "ref" or t.kind in ("none", "natural"):
        return None
    layout = layout or wire_layout(spec, t.cfg)
    pallas = t.backend == "pallas"
    if t.kind == "topk":
        return _SelectCodec(t.cfg, spec, layout, pallas)
    if t.kind == "randk":
        return _RandkCodec(t.cfg, spec, layout)
    if t.kind == "quant":
        if t.cfg.bits not in PACK_BITS:
            return None
        if pallas:
            return _QuantPallasCodec(t.cfg, spec, layout, pallas=True)
        return _QuantCodec(t.cfg, spec, layout)
    return None


# ---------------------------------------------------------------------------
# FlatTransport: the engine-facing wire path over flat buffers
# ---------------------------------------------------------------------------

class FlatTransport:
    """One direction of the wire path over flat ``[d]`` buffers:
    ``e``/``deltas`` are ``[n, d]`` stacks (mask mode) or the m
    participants' ``[m, d]`` rows (gather mode), messages are dense
    ``[*, d]`` buffers or flat payloads.  ``key`` is the round's
    :class:`repro_torch.comm.transports.WireKey` (used by the random kinds
    only).

    Usage::

        >>> up = FlatTransport(get_transport(cfg, "packed"), spec_of(params))
        >>> v_bar, e_new = up.transmit(e, deltas, mask, m, key=key)

    ``cohorts=k > 1`` makes :meth:`reduce` the two-tier aggregation: the
    stacked rows split into k contiguous cohorts, each reduces on its own
    (:meth:`reduce_single`, the kernels getting leading-axis views of the
    payload) and the k partials add left to right.  ``cohorts=1`` is the
    single-tier reduce itself; select partials re-associate the same
    weighted sums, quant's are a reordered sum (allclose).

    ``cols`` (a :class:`Columns` block, under a model axis) makes every
    buffer, stack and message the block's columns (see the module
    docstring); :meth:`wire_bytes` still counts a whole message.
    """

    def __init__(self, t: transports.Transport, spec: FlatSpec,
                 cohorts: int = 1, cols: "Columns | None" = None):
        self.cfg = t.cfg
        self.kind = t.kind
        self.backend = t.backend
        self.spec = spec
        self.cohorts = max(1, int(cohorts))
        self.cols = cols
        self.whole = self.cut = None
        self.codec = _make_codec(t, spec)
        if cols is not None:
            self.whole = FlatTransport(t, spec, cohorts)
            if self.codec is not None:
                layout, self.cut = local_layout(self.codec.layout, cols.lo,
                                                cols.hi)
                self.codec = _make_codec(t, spec, layout)
        if self.codec is None and t.kind == "quant" and t.backend != "ref":
            # quant at a bit width that does not pack, on the packed or
            # pallas backend: the dense wire of the ref transport (the same
            # values as the dense quantizer, bit for bit)
            t = transports.get_transport(t.cfg, "ref")
        self.t = t

    @property
    def width(self) -> int:
        """Columns of the buffers this transport works on."""
        return self.spec.d if self.cols is None else self.cols.width

    @property
    def is_identity(self) -> bool:
        return self.t.is_identity

    @property
    def needs_residual(self) -> bool:
        return self.t.needs_residual

    @property
    def tracks_center(self) -> bool:
        return self.t.tracks_center

    @property
    def needs_key(self) -> bool:
        return self.t.needs_key

    @property
    def wire(self) -> str:
        return "dense" if self.codec is None else "packed"

    def wire_bytes(self) -> int:
        """True wire bytes of one message: packed formats count their
        arrays (uint32 words, uint16 offsets); dense wires take the tree
        transport's accounting."""
        if self.whole is not None:
            return self.whole.wire_bytes()
        if self.codec is None:
            return self.t.wire_bytes(struct_tree(self.spec))
        return self.codec.wire_bytes()

    # -- wire primitives ----------------------------------------------------

    def compress(self, buf: torch.Tensor, gen=None):
        """Flat message of one ``[d]`` buffer (the operator C); ``gen`` is
        the random kinds' generator."""
        if self.is_identity:
            return buf
        if self.cols is not None and self.needs_key:
            return self._drawn_whole(buf, gen)
        if self.codec is None:
            return self._dense(buf, gen)
        return self.codec.pack(buf, gen)

    def decompress(self, message) -> torch.Tensor:
        if self.codec is None:
            return message
        return self.codec.decode(message)

    def _dense(self, buf: torch.Tensor, gen=None) -> torch.Tensor:
        """A dense wire's message of ``[*lead, d]``: every dense wire's
        operator is :func:`repro_torch.core.compression.compress`, run on
        the unflattened buffer with the lead axes as batch axes."""
        batch = buf.dim() - 1
        if self.cols is not None:
            return self._dense_columns(buf, batch)
        return flatten(self.spec, compression.compress(
            unflatten(self.spec, buf), self.cfg, gen, batch))

    def _dense_columns(self, buf: torch.Tensor, batch: int) -> torch.Tensor:
        """:meth:`_dense` of a deterministic kind on the columns ``cols``:
        a whole leaf through ``compress_leaf``, part of one (blockwise
        operators only: the cuts follow their blocks) through
        ``compress_blocks`` with the leaf's block and k; the dtype round
        trip of ``unflatten`` / ``flatten``."""
        lead, lo = tuple(buf.shape[:-1]), self.cols.lo
        lws = wire_layout(self.spec, self.cfg).leaves
        outs = []
        for i, a, b in pieces(self.spec, lo, self.cols.hi):
            ls, x = self.spec.leaves[i], buf[..., a - lo:b - lo]
            if b - a == ls.size:
                y = compression.compress_leaf(
                    x.reshape(lead + ls.shape).to(ls.dtype), self.cfg, None,
                    batch)
            else:
                lw = lws[i]
                y = compression.compress_blocks(
                    x.reshape(lead + (-1, lw.block)).to(ls.dtype),
                    self.cfg, lw.k, lw.sort_free)
            outs.append(y.to(self.spec.dtype).reshape(lead + (b - a,)))
        # a new tensor even for one piece: an operator that keeps its
        # whole leaf gives the leaf back, and the EF step updates ``buf``
        # in place
        return torch.cat(outs, dim=-1)

    def _drawn_whole(self, row: torch.Tensor, gen) -> torch.Tensor:
        """A random kind's message of one row of the columns ``cols``: the
        row placed in a whole ``[d]`` row of zeros, compressed with the
        one-process draws from ``gen``, the message cut to the columns
        (its slot range on a packed wire)."""
        lo, hi = self.cols.lo, self.cols.hi
        full = row.new_zeros((self.spec.d,))
        full[lo:hi] = row
        msg = self.whole.compress(full, gen)
        if self.codec is None:
            return msg[lo:hi].clone()
        k0, k1 = self.cut.slots
        return FlatPacked(msg.values[k0:k1].clone(),
                          msg.indices[k0:k1].clone())

    # -- round-level call sites ---------------------------------------------

    def _ef_clients(self, e, deltas, key, ids):
        """EF14 over the rows of the client ids ``ids``: ``(msgs,
        e_new)``."""
        with stage("comm.ef_encode"):
            return self._ef_clients_inner(e, deltas, key, ids)

    def _ef_clients_inner(self, e, deltas, key, ids):
        if self.codec is not None and self.codec.fused_ef:
            return self.codec.ef(e, deltas)
        buf = e + deltas
        msgs = self._messages(buf, key, ids)
        return msgs, buf.sub_(self.decompress(msgs))      # buf is ours

    def _messages(self, buf, key, ids):
        """The messages of the rows of ``buf``; the random kinds draw row
        i from stream ``ids[i]`` of ``key``."""
        if self.needs_key:
            if key is None:
                raise ValueError(f"{self.kind} needs the round's WireKey")
            rows = [self.compress(buf[i], key.generator(j, buf.device))
                    for i, j in enumerate(ids)]
            return torch.stack(rows) if self.codec is None else \
                type(rows[0])(*(torch.stack(f) for f in zip(*rows)))
        if self.codec is None:
            return self._dense(buf)
        return self.codec.pack(buf)

    def flush_messages(self, rows, key=None, ids=None):
        """The messages of residual rows encoded at a zero residual, the
        reference's ``_ef_clients(zeros_like(rows), rows)`` without its
        residual: ``rows`` (ours, overwritten) become ``0 + rows`` in place,
        which turns their -0.0 into +0.0 as that encode does.  The random
        kinds draw row i from stream ``ids[i]`` of ``key`` (the slot store's
        flush stream; default: stream i)."""
        if not rows.shape[0]:
            return self.empty_messages(rows.device)
        ids = range(rows.shape[0]) if ids is None else ids
        with stage("comm.ef_encode"):
            return self._messages(rows.add_(0.0), key, ids)

    def encode(self, e, deltas, mask, key=None, ids=None):
        """Per-client EF14 encode over the ``[n, d]`` stacks: ``(msgs,
        e_new)``; rows with ``mask == 0`` keep their residual.  The residual
        ``e`` is updated in place (the ``[n, d]`` buffer is the largest
        state of a round) and returned.  ``ids`` are the rows' client ids
        (the random kinds' streams; default: row i is client i)."""
        if self.is_identity:
            return deltas, e
        ids = range(deltas.shape[0]) if ids is None else ids
        msgs, e_stack = self.encode_rows(e, deltas, key, ids)
        return msgs, transports.mask_where(mask, e_stack, e, out=e)

    def encode_rows(self, e, deltas, key=None, ids=None):
        """EF14 over rows whose residuals ``e`` were read out of the state
        (gathered rows; ``ids`` their client ids, for the random kinds):
        ``(msgs, e_new)``, the caller writing ``e_new`` back.  No rows (a
        rank with none to encode) give an empty message stack."""
        if self.is_identity:
            return deltas, e
        if not deltas.shape[0]:
            return self.empty_messages(deltas.device), e
        return self._ef_clients(e, deltas, key, ids)

    def empty_messages(self, device):
        """A message stack of no rows (a rank with no rows to encode)."""
        def rows(width, dtype):
            return torch.empty((0, width), dtype=dtype, device=device)
        if self.is_identity or self.codec is None:
            return rows(self.width, self.spec.dtype)
        layout = self.codec.layout
        if isinstance(self.codec, _QuantCodec):
            return FlatQuant(rows(layout.W_total, torch.uint32),
                             rows(layout.NB_total, torch.float32))
        return FlatPacked(rows(layout.K_total, self.spec.dtype),
                          rows(layout.K_total, torch.uint16))

    def encode_gathered(self, e, deltas, idx, mask, unique: bool = True,
                        key=None, ids=None):
        """Compute-sparse encode: ``deltas`` holds the m participants' rows
        (``idx``, sorted; ``ids`` the same on the host, read from ``idx``
        where needed when None); per-client results, random streams
        included, match :meth:`encode`'s.  The participants' residual rows
        are read out of ``e`` and written back in place
        (``scale.shard.take`` / ``put``: any write wins, so the repeated ids
        of a short cohort write the same row) and the messages are
        scattered into the ``[n, ...]`` layout (``unique=False`` for a short
        cohort: see :func:`transports.scatter_rows`).  Under a rank mesh
        ``deltas`` are this rank's block of the m rows: their residual rows
        come from the ranks that own them and go back after the EF step,
        and the messages are all-gathered in row order first."""
        from repro_torch.scale import shard
        n, msgs = mask.shape[0], deltas
        if not self.is_identity:
            if ids is None and self.needs_key:
                ids = idx.tolist()
            lo, hi = partition.block(idx.shape[0])
            msgs, e_stack = self.encode_rows(
                shard.take(e, idx, ids), deltas, key,
                None if ids is None else ids[lo:hi])
            shard.put(e, idx, e_stack, ids)
        return transports.scatter_rows(partition.all_rows(msgs, idx.shape[0]),
                                       idx, n, unique), e

    def reduce_single(self, msgs, weights, m) -> torch.Tensor:
        """Single-tier weighted aggregation of stacked messages into
        ``[d]``: ``sum_j weights_j * decode(msgs_j) / m``, in the payload
        domain on a packed wire (one edge reducer of the two-tier form)."""
        with stage("comm.reduce"):
            if self.wire == "dense":
                return transports.masked_mean(msgs, weights, m)
            return self.codec.reduce(msgs, weights, m)

    def reduce(self, msgs, weights, m) -> torch.Tensor:
        """Weighted aggregation of stacked messages into ``[d]``; with
        ``cohorts=k > 1`` the two-tier form (k edge reductions over
        contiguous cohorts of rows, partials added left to right).  Rows
        that do not split into k equal cohorts raise ``ValueError``."""
        k = self.cohorts
        if k <= 1:
            return self.reduce_single(msgs, weights, m)
        rows = weights.shape[0]
        if rows % k:
            raise ValueError(
                f"two-tier aggregation: {rows} stacked payload rows do not "
                f"split into {k} equal cohorts -- ScaleConfig.cohorts must "
                "divide the client-row count")
        size = rows // k
        acc = None
        for c in range(k):
            sl = slice(c * size, (c + 1) * size)
            sub = msgs[sl] if isinstance(msgs, torch.Tensor) else \
                type(msgs)(*(x[sl] for x in msgs))
            part = self.reduce_single(sub, weights[sl], m)
            acc = part if acc is None else acc + part
        return acc

    def transmit(self, e, deltas, mask, m, key=None):
        """EF14 and the aggregation over the ``[n, d]`` stacks: ``(v_bar,
        e_new)``.  Under a rank mesh ``e`` and ``deltas`` are this rank's
        block of the n rows (``partition.block``): each rank encodes its
        rows, the messages are all-gathered in row order and every rank
        reduces all n, as one process does."""
        n = mask.shape[0]
        lo, hi = partition.block(n)
        msgs, e_out = self.encode(e, deltas, mask[lo:hi], key,
                                  ids=range(lo, hi))
        return self.reduce(partition.all_rows(msgs, n), mask, m), e_out

    def transmit_gathered(self, e, deltas, idx, mask, m,
                          unique: bool = True, key=None, ids=None):
        """:meth:`encode_gathered`, then the aggregation: ``(v_bar,
        e_new)``."""
        msgs, e_out = self.encode_gathered(e, deltas, idx, mask, unique, key,
                                           ids)
        return self.reduce(msgs, mask, m), e_out

    def broadcast(self, w: torch.Tensor, x_new: torch.Tensor,
                  key=None) -> torch.Tensor:
        """Primal-EF21 downlink on flat buffers: ``w' = w + C(x_new - w)``
        (the identity returns ``x_new``)."""
        if self.is_identity:
            return x_new
        with stage("comm.broadcast"):
            gen = key.generator(0, w.device) if self.needs_key else None
            return w + self.decompress(self.compress(x_new - w, gen))


def flat_transports_for(cfg, spec: FlatSpec, cols: "Columns | None" = None):
    """(uplink, downlink) :class:`FlatTransport` pair for a FedConfig, on
    the columns ``cols`` when given; ``cfg.scale.cohorts`` sets the
    uplink's two-tier aggregation (the downlink is one broadcast and never
    tiers)."""
    backend = transports.backend_for(cfg.comm)
    return (FlatTransport(transports.get_transport(cfg.uplink, backend), spec,
                          cohorts=cfg.scale.cohorts, cols=cols),
            FlatTransport(transports.get_transport(cfg.downlink, backend),
                          spec, cols=cols))
