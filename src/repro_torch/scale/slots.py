"""The O(m*d) uplink EF slot store (port of ``repro.scale.slots``).

The dense uplink residual ``FedState.e_up`` is ``[n, d]``: its memory grows
with the population although a round touches m rows.  :class:`SlotStore`
replaces it with a ``[cap, d]`` pool keyed by client id, slots assigned
least-recently-used within the round:

* **lookup** -- a re-sampled client reads its residual row back from its
  slot; a client without one starts from the zero residual (the dense
  initialisation, so a first contact is the dense path bit for bit),
* **allocation** -- misses claim slots by a stable priority sort: free slots
  first, then the occupied slot stamped longest ago; slots of this round's
  sampled clients are never reallocated (``cap >= m`` leaves enough),
* **eviction** -- an evicted client's orphaned residual is encoded through
  the uplink compressor at a zero residual and added to this round's
  aggregate with the Horvitz-Thompson weight stored when its row was
  written, so EF mass is conserved up to the flush's own compression error.

A short cohort (fewer than m sampled, its first id repeated as padding:
``participation.mask_indices``) claims one slot per distinct id and
evicts at most once per id.  The reference lets each copy of a padded id
without a slot claim (and evict) a slot of its own, which leaves the
client owning one slot per copy; the port departs from it there (ROADMAP
Queue 3).

Parity law: with ``cap >= n_clients`` a client without a slot always finds a
free one, nothing is evicted, every pool row equals its owner's dense
``e_up`` row, and the round is the dense gather round bit for bit (the m
messages are scattered back into the ``[n]`` layout and reduced by the same
operation).

The store lives on the round's device, its counters too (no host read in
the round).  The pool is updated in place, as the dense ``e_up`` is: the m
residual rows are copied out of it (:func:`lookup`) and the orphans read
before the new rows are written.  The small index leaves are rebuilt every
round.

Usage::

    >>> cfg = FedConfig(participation="gather",
    ...                 scale=ScaleConfig(ef_slots=128))
    >>> state = rounds.init_state(params, cfg)   # e_up is a SlotStore
    >>> state, mets = rounds.round_step(state, batches, loss_pair, cfg)
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.comm import transports
from repro_torch.engine import participation
from repro_torch.sharding import partition

INT32_MAX = 2 ** 31 - 1


class SlotStats(NamedTuple):
    """One round's slot-store counters (0-d float32 on the round's device),
    by-products of :func:`encode` carried into the telemetry
    (``Telemetry.slot_*``).  ``occupancy`` counts owned slots after the
    update, ``evictions`` the slots taken from a previous owner this round,
    ``flush_weight`` the HT mass their orphans re-entered the aggregate
    with (0 when ``cap >= n``)."""
    occupancy: torch.Tensor
    evictions: torch.Tensor
    flush_weight: torch.Tensor


class SlotStore(NamedTuple):
    """The capacity-bounded uplink residual pool (one row per slot).

    Invariant: ``owner[s] == j  <=>  client_slot[j] == s``; ``owner[s] < 0``
    marks a free slot and a client without a slot has ``client_slot[j] ==
    -1``.  ``stamp`` is the round a slot was last written (the LRU key),
    ``weight`` the sampler's HT aggregation weight at that write."""
    pool: torch.Tensor          # [cap, d] residual rows
    owner: torch.Tensor         # [cap] int32 client id, -1 free
    stamp: torch.Tensor         # [cap] int32 round of the last write
    weight: torch.Tensor        # [cap] float32 HT weight at the last write
    client_slot: torch.Tensor   # [n_clients] int32 slot of client j, -1 none


def validate(cfg) -> None:
    """The store's config checks (raised by ``rounds.init_state``)."""
    cap = cfg.scale.ef_slots
    if cfg.participation != "gather":
        raise ValueError(
            "ScaleConfig.ef_slots requires participation='gather': the mask "
            "path computes dense [n, d] per-client rows, so an O(m*d) "
            "residual store cannot exist under it")
    if cap < cfg.m:
        raise ValueError(
            f"ScaleConfig.ef_slots={cap} < m={cfg.m}: every sampled client "
            "needs a slot within the round, so the pool capacity must be "
            ">= m")


def init(n_clients: int, cap: int, d: int, dtype, device,
         split=None) -> SlotStore:
    """An empty store on ``device``: every slot free, no client assigned
    (under a rank mesh the pool holds this rank's block of slots; under a
    model axis, as a ``partition.FlatShard``, only its columns of
    ``split``)."""
    def full(shape, v, dt):
        return torch.full(shape, v, dtype=dt, device=device)
    return SlotStore(
        pool=partition.flat_zeros((cap, d), dtype, device, split),
        owner=full((cap,), -1, torch.int32),
        stamp=full((cap,), -1, torch.int32),
        weight=torch.zeros((cap,), dtype=torch.float32, device=device),
        client_slot=full((n_clients,), -1, torch.int32))


def resident_bytes(store: SlotStore) -> int:
    """Bytes the store holds (the ``[n]`` ``client_slot`` index is its only
    population term: 4 bytes per client, not 4*d); under a rank mesh, this
    rank's share."""
    return sum(x.numel() * x.element_size()
               for x in map(partition.local, store))


def lookup(store: SlotStore, idx: torch.Tensor):
    """The residual rows of the sampled ids ``idx`` (``[m, d]``, a copy out
    of the pool; zeros for the ids without a slot) and their current slots
    (``[m]`` int32, -1 for a miss)."""
    cur = store.client_slot.index_select(0, idx)
    rows = store.pool.index_select(0, torch.clamp(cur, min=0).long())
    return rows.masked_fill_((cur < 0)[:, None], 0.0), cur


def allocate(store: SlotStore, cur: torch.Tensor, t,
             first: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The ``[m]`` int32 slots of this round's sample (hits keep ``cur``).

    Priority per slot: kept (owned by a sampled client) INT32_MAX, free -1,
    occupied its ``stamp``.  A stable sort ranks the slots (ties keep slot
    order), and the r-th miss in sorted client order claims the r-th slot.
    ``t`` is the round (the store's stamps are written by :func:`encode`).
    ``first`` (a short cohort's, from :func:`first_copies`) makes only the
    first copy of a repeated id claim a slot; its copies take the same
    one."""
    cap = store.pool.shape[0]
    dev = cur.device
    # misses write the spare entry ``cap``, which is cut off
    kept = torch.zeros((cap + 1,), dtype=torch.bool, device=dev)
    kept[torch.where(cur >= 0, cur, cap).long()] = True
    prio = torch.where(kept[:cap], INT32_MAX,
                       torch.where(store.owner < 0, -1, store.stamp))
    order = torch.argsort(prio.to(torch.int64), stable=True)
    miss = cur < 0
    if first is not None:
        miss = miss & _leads(first)
    rank = torch.cumsum(miss.to(torch.int32), 0) - 1
    cand = order.index_select(0, torch.clamp(rank, min=0).long())
    slots = torch.where(miss, cand.to(torch.int32), cur)
    return slots if first is None else slots.index_select(0, first)


def first_copies(idx: torch.Tensor) -> torch.Tensor:
    """``[m]`` int64: the position of the first occurrence of each id of
    ``idx`` (a short cohort repeats its first sampled id as padding)."""
    same = idx[:, None] == idx[None, :]
    return torch.argmax(same.to(torch.int32), dim=1)


def _leads(first: torch.Tensor) -> torch.Tensor:
    return first == torch.arange(first.shape[0], device=first.device)


def _flush(uplink, pool, slots, evict, w_orph, m: int, key):
    """The evicted clients' orphaned residuals (``pool`` rows ``slots``
    where ``evict``) through the compressor at a zero residual, reduced
    with ``w_orph``, the HT weights stored at their writes (single tier).
    Reads the pool before :func:`encode` writes it."""
    orphan = pool.index_select(0, slots)
    orphan.masked_fill_(~evict[:, None], 0.0)
    fkey = None if key is None else key._replace(
        direction=transports.FLUSH)
    msgs = uplink.flush_messages(orphan, fkey)
    return uplink.reduce_single(msgs, w_orph, m)


def encode(uplink, store: SlotStore, deltas: torch.Tensor,
           part: participation.Participation, t, key=None):
    """The slot-store EF encode: EF14 over the m sampled rows with their
    residuals from the pool, LRU allocation, the store update and the
    eviction flush.  Returns ``(msgs_full, store, v_flush, stats)``:
    ``msgs_full`` the wire messages scattered back into the ``[n]`` client
    layout (the gather path's layout, so any ``uplink.reduce`` applies
    unchanged), ``v_flush`` the flush partial to add to this round's fresh
    aggregate (None when ``cap >= n``: eviction cannot happen, so the
    flush is statically absent), ``stats`` the :class:`SlotStats`.

    ``deltas`` are the gather path's ``[m, d]`` rows (sorted ids), ``t``
    the round (the LRU stamp), ``key`` the round's uplink
    :class:`repro_torch.comm.transports.WireKey` (the flush draws from its
    ``FLUSH`` stream).  The pool is updated in place; the returned store
    holds it."""
    if partition.rank_axis() is not None:
        return _encode_ranked(uplink, store, deltas, part, t, key)
    idx, n, m = part.idx, part.n, part.m
    cap = store.pool.shape[0]
    w_m = participation.agg_weights(part).index_select(0, idx)

    # -- EF over the m rows, residuals copied out of the pool -------------
    e_part, cur = lookup(store, idx)
    ids = None
    if uplink.needs_key:
        ids = (part.host_idx if part.host_idx is not None
               else idx.cpu()).tolist()
    msgs, e_new = uplink._ef_clients(e_part, deltas, key, ids)

    # -- slot allocation, eviction and the flush (reads the old pool) -----
    c = _claim(store, cur, part, t)
    v_flush = None
    if cap < n:     # static: at cap >= n a free slot always ranks first
        v_flush = _flush(uplink, store.pool, c.sl, c.evict, c.w_orph, m, key)

    # -- the m messages into the full [n] layout ---------------------------
    full = transports.scatter_rows(msgs, idx, n, unique=not part.short)

    # -- store update: hits rewrite their slot, misses claim theirs; the
    #    evicted owners lose their slot before the sampled ids take theirs;
    #    a short cohort's copies write the same values to the same entries -
    store.pool.index_copy_(0, c.sl, e_new.to(store.pool.dtype))
    new_store, stats = _update_index(store, idx, c, w_m, t, n, m)
    return full, new_store, v_flush, stats


class _Claim(NamedTuple):
    """A round's slot allocation: the ``[m]`` slots (int32 and int64), the
    owners they had, which of them this round evicts and the HT weights of
    the evicted orphans."""
    slots: torch.Tensor
    sl: torch.Tensor
    old_owner: torch.Tensor
    evict: torch.Tensor
    w_orph: torch.Tensor


def _claim(store: SlotStore, cur: torch.Tensor, part, t) -> _Claim:
    """Allocation and eviction for the sample of ``part`` (``cur``: its
    current slots, from :func:`lookup`)."""
    first = first_copies(part.idx) if part.short else None
    slots = allocate(store, cur, t, first)
    sl = slots.long()
    old_owner = store.owner.index_select(0, sl)
    evict = (cur < 0) & (old_owner >= 0)
    if first is not None:
        evict = evict & _leads(first)
    w_orph = torch.where(evict, store.weight.index_select(0, sl), 0.0)
    return _Claim(slots, sl, old_owner, evict, w_orph)


def _update_index(store, idx, c: _Claim, w_m, t, n: int, m: int):
    """The index vectors after a round's writes (the pool already written)
    and the round's :class:`SlotStats`: ``(store, stats)``."""
    slots, sl, old_owner, evict, w_orph = c
    owner = store.owner.index_copy(0, sl, idx.to(torch.int32))
    stamp = store.stamp.index_copy(
        0, sl, torch.full((m,), t, dtype=torch.int32, device=idx.device))
    weight = store.weight.index_copy(0, sl, w_m.to(torch.float32))
    # the rows not evicted write the spare entry ``n``, which is cut off
    cleared = torch.cat([store.client_slot, store.client_slot.new_full(
        (1,), -1)]).index_fill_(
            0, torch.where(evict, old_owner, n).long(), -1)[:n]
    client_slot = cleared.index_copy(0, idx, slots)
    new_store = SlotStore(pool=store.pool, owner=owner, stamp=stamp,
                          weight=weight, client_slot=client_slot)
    stats = SlotStats(
        occupancy=torch.sum((owner >= 0).to(torch.float32)),
        evictions=torch.sum(evict.to(torch.float32)),
        flush_weight=torch.sum(w_orph))
    return new_store, stats


def _encode_ranked(uplink, store: SlotStore, deltas: torch.Tensor,
                   part: participation.Participation, t, key=None):
    """:func:`encode` under a rank mesh: ``deltas`` are this rank's block
    of the m sampled rows, ``store.pool`` a ``partition.ClientShard``.  The
    slot indices are read on the host (every rank holds them) to route the
    rows; allocation, eviction and the index update run replicated."""
    from repro_torch.scale import shard
    idx, n, m = part.idx, part.n, part.m
    cap = store.pool.shape[0]
    w_m = participation.agg_weights(part).index_select(0, idx)
    ids = part.host_idx.tolist()
    lo, hi = partition.block(m)

    cur = store.client_slot.index_select(0, idx)
    cur_h = cur.tolist()
    e_part = shard.take(store.pool, cur, cur_h,
                        valid=[c >= 0 for c in cur_h])
    msgs, e_new = uplink.encode_rows(e_part, deltas, key, ids[lo:hi])

    c = _claim(store, cur, part, t)
    sl_h = c.sl.tolist()
    v_flush = None
    if cap < n:
        orphan = shard.take(store.pool, c.sl, sl_h,
                            valid=c.evict.tolist())
        fkey = None if key is None else key._replace(
            direction=transports.FLUSH)
        fmsgs = uplink.flush_messages(orphan, fkey, ids=range(lo, hi))
        v_flush = uplink.reduce_single(partition.all_rows(fmsgs, m),
                                       c.w_orph, m)

    full = transports.scatter_rows(partition.all_rows(msgs, m), idx, n,
                                   unique=not part.short)
    shard.put(store.pool, c.sl, e_new.to(store.pool.dtype), sl_h)
    new_store, stats = _update_index(store, idx, c, w_m, t, n, m)
    return full, new_store, v_flush, stats


def transmit(uplink, store: SlotStore, deltas: torch.Tensor,
             part: participation.Participation, t, key=None):
    """The synchronous slot-store uplink call site (what
    ``participation.transmit`` dispatches to when the residual is a
    :class:`SlotStore`): :func:`encode`, then the gather path's
    aggregation, plus the flush partial.  Returns ``(v_bar, store,
    stats)``."""
    full, new_store, v_flush, stats = encode(uplink, store, deltas, part,
                                             t, key)
    v_bar = uplink.reduce(full, participation.agg_weights(part), part.m)
    if v_flush is not None:
        v_bar = v_bar + v_flush
    return v_bar, new_store, stats
