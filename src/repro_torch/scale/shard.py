"""Client-axis sharding of population-sized state (port of
``repro.scale.shard``).

The reference pins the leading client axis of the fleet's shards and of the
slot store to the mesh's client axis, and gathers a round's m rows from the
sharded source so the population is never all-gathered.  In one process
(no mesh, a mesh of devices or placeholders, or one rank) the constraints
are identities and :func:`sharded_take` is a plain gather of the rows along
the leading axis.

Under a rank mesh (``sharding.partition``) the population is split into
contiguous blocks of clients over the ranks (:class:`ClientShard` leaves),
and a round's rows are split into contiguous blocks of the row list (rank
r works on positions ``partition.block(len(ids), r)``).  :func:`take`
brings each rank the rows of its positions from the ranks that own them
(one all-to-all per leaf, only the rows that rank needs), :func:`put` sends
rows back to their owners, which write them in place.  Which row goes where
follows from host lists of row ids that every rank holds the same, so no
rank asks another what to send.  In one process :func:`take` and
:func:`put` are ``index_select`` and ``index_copy_``.

Under a model axis as well, each rank's rows are its columns of them
(``partition.FlatShard`` state): the rows move over the client axis's
group only, each rank moving its columns; a fleet (token data, no flat
axis) is split by rows alone.
"""
from __future__ import annotations

from bisect import bisect_right
from typing import Callable, Optional, Sequence

import torch

from repro_torch.sharding import collectives, partition
from repro_torch.sharding.partition import ClientShard


def constrain_fleet(fleet):
    """The fleet with its leading (client) axis on the client mesh axis:
    the fleet itself in one process; under a rank mesh its shards and
    device counts as :class:`ClientShard` blocks (``host_count``, which
    the samplers read, stays whole on every rank)."""
    return fleet._replace(
        data=partition.constrain_leading(fleet.data, "client"),
        count=partition.constrain_leading(fleet.count, "client"))


def constrain_store(store):
    """The slot store with its pool rows on the client mesh axis: the store
    itself in one process; under a rank mesh the ``[cap, d]`` pool as a
    :class:`ClientShard`, its small index vectors (``owner``, ``stamp``,
    ``weight``, ``client_slot``) the same on every rank."""
    return store._replace(
        pool=partition.constrain_leading(store.pool, "client"))


def sharded_take(tree, idx: torch.Tensor):
    """The rows ``idx`` of every leaf of a client-stacked tree (a tensor, a
    NamedTuple / tuple / list of them, or a dict), gathered along the
    leading axis (``index_select``).  Under a rank mesh, this rank's block
    of those rows (:func:`take`): :class:`ClientShard` leaves move rows
    from their owners, whole leaves are indexed here."""
    return take(tree, idx)


def _host(ids) -> list:
    return ids.tolist() if isinstance(ids, torch.Tensor) else list(ids)


def _plan(ids: Sequence[int], valid, n: int) -> list:
    """``plan[q][r]``: the positions of worker q's block of ``ids`` whose
    row (valid) lives in owner r's block of ``n`` rows, in order."""
    W = partition.rank_axis().size
    ends = []
    for c in partition.counts(n):
        ends.append((ends[-1] if ends else 0) + c)
    plan = [[[] for _ in range(W)] for _ in range(W)]
    for q in range(W):
        lo, hi = partition.block(len(ids), q)
        for p in range(lo, hi):
            if valid is None or valid[p]:
                plan[q][bisect_right(ends, int(ids[p]))].append(p)
    return plan


def _index(device, rows) -> torch.Tensor:
    return torch.tensor(rows, dtype=torch.int64).to(device)


def take(tree, idx: torch.Tensor, ids=None,
         valid: Optional[Sequence[bool]] = None,
         fetch: Optional[Callable] = None):
    """The rows ``idx`` (an index tensor) of each leaf of a client-stacked
    tree.  In one process each leaf's rows are read with ``index_select``
    (``valid`` and ``fetch`` are for the rank path).

    Under a rank mesh, this rank's block of them: ``[hi - lo, ...]`` for
    positions ``partition.block(len(idx))``.  The rows are routed from
    ``ids``, the same row ids on the host (a list or a CPU tensor, the
    same on every rank; read from ``idx`` when None).  A
    :class:`ClientShard` leaf's rows are read on their owner and moved here
    (:func:`collectives.exchange_rows`); a whole leaf is read here.
    Positions with ``valid`` False read nothing and hold zeros.
    ``fetch(source, local_rows, ids)`` reads rows on their owner (default:
    ``source.index_select(0, local_rows)``; the fleet draws a client's
    minibatch there) and must give ``[0, ...]`` for no rows."""
    ra = partition.rank_axis()
    if ra is None:
        return partition.map_tensors(
            lambda x: x.index_select(0, idx.to(device=x.device,
                                               dtype=torch.int64)), tree)
    ids = _host(idx if ids is None else ids)
    me = ra.rank
    lo, hi = partition.block(len(ids))
    fetch = fetch or (lambda src, rows, _ids: src.index_select(0, rows))

    def zeros_at(got, pos):
        # rows arrive grouped by owner; put them at their positions
        if pos == list(range(hi - lo)):
            return got
        out = got.new_zeros((hi - lo,) + tuple(got.shape[1:]))
        return out.index_copy_(0, _index(got.device, pos), got)

    def one(leaf):
        if not isinstance(leaf, ClientShard):
            mine = [p for p in range(lo, hi) if valid is None or valid[p]]
            got = fetch(leaf, _index(leaf.device, [ids[p] for p in mine]),
                        [ids[p] for p in mine])
            return zeros_at(got, [p - lo for p in mine])
        plan = _plan(ids, valid, leaf.n)
        base = partition.block(leaf.n)[0]
        sends = [plan[q][me] for q in range(ra.size)]
        flat = [ids[p] for s in sends for p in s]
        rows = fetch(leaf.local, _index(leaf.device,
                                        [j - base for j in flat]), flat)
        got = collectives.exchange_rows(
            rows, [len(s) for s in sends], [len(s) for s in plan[me]])
        return zeros_at(got, [p - lo for s in plan[me] for p in s])
    return partition.map_tensors(one, tree)


def put(dest, idx: torch.Tensor, rows: torch.Tensor, ids=None):
    """Write ``rows`` at the rows ``idx`` of ``dest`` in place and return
    ``dest``: ``index_copy_`` in one process (any write wins, so a short
    cohort's repeated ids, which carry the same row, write it once).

    Under a rank mesh ``dest`` is a :class:`ClientShard` and ``rows`` this
    rank's block (positions ``partition.block(len(idx))``); ``ids`` as in
    :func:`take`.  Each row goes to the owner of its id, which copies it
    in."""
    ra = partition.rank_axis()
    if ra is None:
        return dest.index_copy_(0, idx, rows)
    if not isinstance(dest, ClientShard):
        raise ValueError("under a rank mesh the rows go to a ClientShard: "
                         "build the state with rounds.init_state under the "
                         "same mesh")
    ids = _host(idx if ids is None else ids)
    me = ra.rank
    lo = partition.block(len(ids))[0]
    plan = _plan(ids, None, dest.n)
    out_pos = [p - lo for s in plan[me] for p in s]
    send = rows if out_pos == list(range(rows.shape[0])) else \
        rows.index_select(0, _index(rows.device, out_pos))
    got = collectives.exchange_rows(
        send, [len(s) for s in plan[me]],
        [len(plan[q][me]) for q in range(ra.size)])
    base = partition.block(dest.n)[0]
    local = [ids[p] - base for q in range(ra.size) for p in plan[q][me]]
    if local:
        dest.local.index_copy_(0, _index(dest.device, local), got)
    return dest
