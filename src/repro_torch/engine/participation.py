"""Client participation (port of ``repro.engine.participation``).

Two executions of the same sample S_t (m of n clients):

* ``mask``   -- the paper-faithful dense simulation: every per-client
  computation runs over all n clients and is mask-multiplied down to the m
  participants afterwards.
* ``gather`` -- compute-sparse: the sorted indices of the m sampled clients
  select their batches and uplink EF residuals, the E local steps and the
  EF step run over m rows only, residuals are written back, and the
  messages are scattered into the full ``[n, ...]`` layout, so aggregation
  is the same operation as in mask mode (the two are bit-equal).

The indices are computed on the CPU, where the samplers draw the mask, and
move to the round's device with it: the round never waits on the device
for them.

Under a rank mesh (``sharding.partition``) the round's rows -- all n in
mask mode, the m sampled in gather mode -- split into contiguous blocks of
the row list over the ranks (:func:`gather` gives a rank its block, through
``scale.shard.take`` from the ranks that own the rows).  :func:`transmit`
then runs the uplink rank by rank: each encodes its block (the dense
residual's rows brought from their owners and sent back after the EF
step), the messages are all-gathered in row order and every rank reduces
all of them as one process does.  :func:`aggregate_norm` gives every rank
one process's ``delta_norm``.  Under a model axis every row is this
rank's columns of it: the same calls run on the columns, and the norm
adds every model rank's partials (``comm.flat.tree_norm``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.comm import transports
from repro_torch.fleet.partitions import leaves_of, rebuild
from repro_torch.sharding import collectives, partition
from repro_torch.sharding.partition import ClientShard

MODES = ("mask", "gather")


class Participation(NamedTuple):
    """One round's sample S_t.  ``idx`` is None in mask mode; in gather mode
    it holds the sorted indices of the m participants (``[m]`` int64 on the
    round's device).  ``short`` says (from the host) that the mask has fewer
    than m ones, so ``idx`` repeats an index."""
    mask: torch.Tensor                      # [n] 0/1, m ones (or fewer)
    idx: Optional[torch.Tensor]             # [m] sorted, or None
    n: int
    m: int
    weights: Optional[torch.Tensor] = None  # [n], zero off-support
    short: bool = False
    host_idx: Optional[torch.Tensor] = None  # ``idx`` on the CPU (gather)


def mask_indices(mask: torch.Tensor, m: int) -> torch.Tensor:
    """Sorted indices of the m participants of a CPU mask (int64 ``[m]``).

    A mask with FEWER than m ones (a realized cohort, e.g. replayed by the
    ``fixed`` sampler) pads with the FIRST sampled index rather than 0: the
    padded rows duplicate a sampled client whose per-row compute is
    identical across duplicates, so an any-write-wins scatter-back writes
    the same value however the duplicates race, and client 0's residual is
    never clobbered when client 0 is not sampled.  Consumers scatter such a
    cohort with any-write-wins semantics (``transports.scatter_rows``
    with ``unique=False``); a segment sum would double the row."""
    nz = torch.nonzero(mask > 0).flatten()[:m]
    first = nz[0] if len(nz) else torch.zeros((), dtype=torch.int64)
    pad = first.expand(m - len(nz))
    return torch.cat([nz, pad]).to(torch.int64)


def finalize(mask: torch.Tensor, weights: Optional[torch.Tensor], cfg,
             device=None) -> Participation:
    """Wrap a sampler's CPU (mask, weights) draw into a Participation on
    ``device`` (the CPU when None), with the sorted participant indices
    computed on the CPU in gather mode.  The uniform law's ``weights IS
    mask`` survives the move."""
    if cfg.participation not in MODES:
        raise NotImplementedError(
            f"participation mode {cfg.participation!r} is not ported yet; "
            f"ported: {MODES}")
    idx, short = None, False
    if cfg.participation == "gather":
        idx = mask_indices(mask, cfg.m)
        short = int((mask > 0).sum()) < cfg.m
    mask_d = mask.to(device)
    weights_d = mask_d if weights is mask else \
        (None if weights is None else weights.to(device))
    return Participation(mask_d, None if idx is None else idx.to(device),
                         cfg.n_clients, cfg.m, weights_d, short, idx)


def gather(part: Participation, batches):
    """Participants' rows of a stacked ``[n, ...]`` batch (a NamedTuple, a
    plain tuple or a single tensor; ``[m, ...]`` in sorted-index order);
    identity in mask mode.  Under a rank mesh, this rank's block of those
    rows (:func:`own_rows` in mask mode)."""
    if part.idx is None:
        return own_rows(batches)
    from repro_torch.scale import shard
    return rebuild(batches, shard.take(leaves_of(batches), part.idx,
                                       part.host_idx))


def own_rows(batches):
    """Under a rank mesh, this rank's block of the clients of a stacked
    ``[n, ...]`` batch (a :class:`ClientShard` leaf's own rows, a whole
    leaf's slice); the batch itself in one process."""
    if partition.rank_axis() is None:
        return batches

    def one(x):
        if isinstance(x, ClientShard):
            return x.local
        lo, hi = partition.block(x.shape[0])
        return x[lo:hi]
    return rebuild(batches, [one(x) for x in leaves_of(batches)])


def scatter_rows(part: Participation, rows):
    """``[m, ...]`` participant rows -> the full ``[n, ...]`` layout, zeros
    elsewhere."""
    return transports.scatter_rows(rows, part.idx, part.n,
                                   unique=not part.short)


def agg_weights(part: Participation) -> torch.Tensor:
    """The [n] aggregation weights: the sampler's, else the mask."""
    return part.mask if part.weights is None else part.weights


def aggregate(part: Participation, deltas: torch.Tensor) -> torch.Tensor:
    """Participating weighted mean of per-client deltas (gathered ``[m, d]``
    or full ``[n, d]``), through the same masked reduction either way."""
    w = agg_weights(part)
    if part.idx is None:
        return transports.masked_mean(deltas, w, part.m)
    return transports.masked_mean(scatter_rows(part, deltas), w, part.m)


def aggregate_norm(part: Participation, deltas: torch.Tensor, norm):
    """``norm(aggregate(part, deltas))`` (``rounds``' ``delta_norm``).
    Under a rank mesh every rank's block of the delta rows goes to rank 0
    of the client axis, which aggregates them as one process does and
    broadcasts the norm: the rows cross ranks once, ``(W - 1) / W`` of the
    ``[rows, d]`` stack, and rank 0 holds them all.  Under a model axis
    the rows are this rank's columns, and ``norm`` adds the partials of
    the client-axis rank 0 of every model rank (the ranks that share its
    data coordinate)."""
    if partition.rank_axis() is None:
        return norm(aggregate(part, deltas))
    rows = part.n if part.idx is None else part.m
    me = partition.rank_axis().rank
    sizes = partition.counts(rows)
    full = collectives.exchange_rows(
        deltas, [deltas.shape[0]] + [0] * (len(sizes) - 1),
        sizes if me == 0 else [0] * len(sizes))
    out = norm(aggregate(part, full)) if me == 0 else \
        torch.zeros((), dtype=torch.float32, device=deltas.device)
    return collectives.broadcast(out, 0)


def compose_weights(part: Participation, factor: torch.Tensor
                    ) -> Participation:
    """The participation with its aggregation weights multiplied by a
    per-client ``factor`` (``[n]``): the async engine zeroes departed rows
    this way and leaves the sample itself alone, so the reduction stays
    ``sum_j (weights_j * factor_j) x_j / m``."""
    return part._replace(weights=agg_weights(part) * factor)


def encode(transport, e, deltas, part: Participation, key=None):
    """The async engine's uplink call site: the per-client wire messages
    (``[n, ...]``) and the EF residual update, without aggregation,
    dispatched as :func:`transmit` is; the messages reduce later
    (``transport.reduce``), so departed clients' payloads can park.
    Returns ``(msgs, e_new)``."""
    if part.idx is None:
        return transport.encode(e, deltas, part.mask, key=key)
    return transport.encode_gathered(e, deltas, part.idx, part.mask,
                                     unique=not part.short, key=key)


def encode_flush(transport, e, deltas, part: Participation, *, t,
                 key=None):
    """:func:`encode` with the slot store: when ``e`` is a
    :class:`repro_torch.scale.slots.SlotStore` the encode runs through
    ``slots.encode`` (pool lookup, LRU allocation, eviction flush).
    Returns ``(msgs, e_new, v_flush, slot_stats)``: the flush partial to add
    to the round's fresh reduce (None for a dense residual and for a store
    with ``cap >= n``) and the store's
    :class:`repro_torch.scale.slots.SlotStats` (None for a dense residual).
    ``t`` is the round (the store's LRU stamp)."""
    from repro_torch.scale import slots
    if isinstance(e, slots.SlotStore):
        return slots.encode(transport, e, deltas, part, t, key=key)
    msgs, e_out = encode(transport, e, deltas, part, key=key)
    return msgs, e_out, None, None


def transmit(transport, e, deltas, part: Participation, key=None, *, t):
    """The engine's single uplink call site: EF14 + aggregation, dispatched
    to the transport's dense-mask or gathered execution, or to the slot
    store's (``slots.transmit``, ``t`` its LRU stamp) when ``e`` is a
    :class:`repro_torch.scale.slots.SlotStore`; ``key`` is the round's
    uplink :class:`repro_torch.comm.transports.WireKey`.  Returns ``(v_bar,
    e_new, slot_stats)``, the last None for a dense residual."""
    from repro_torch.scale import slots
    if isinstance(e, slots.SlotStore):
        return slots.transmit(transport, e, deltas, part, t, key=key)
    w = agg_weights(part)
    # both paths update the residual in place (under a rank mesh, the
    # ClientShard's rows), so ``e`` is the new residual
    if part.idx is None:
        v_bar, _ = transport.transmit(partition.local(e), deltas, w, part.m,
                                      key=key)
    else:
        v_bar, _ = transport.transmit_gathered(
            e, deltas, part.idx, w, part.m, unique=not part.short, key=key,
            ids=part.host_idx.tolist())
    return v_bar, e, None
