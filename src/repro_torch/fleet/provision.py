"""Fleet construction and per-round minibatch provisioning (port of
``repro.fleet.provision``).

A :class:`Fleet` is the client population: the partitioned per-client data
shards (every leaf ``[n_clients, cap, ...]``, on the round's device) and
the per-client valid-row ``count``, kept on the device and, as
``host_count``, on the CPU: the samplers (on the CPU) and the row draws
read the host copy, so neither waits on the device.

:func:`minibatch` is the per-round provider.  Client j's rows come from a
CPU generator keyed by (seed, round, :data:`PROVISION_TAG`, j) -- a
:class:`ProvisionKey` -- and are drawn uniformly with replacement from
``[0, count_j)``: padded rows are never touched.  Keying by client id
makes gather provisioning of the m sampled clients draw exactly the rows
that provisioning all n draws for them, so the gather round equals the
mask round bit for bit.  The drawn ``[m, b]`` row indices move to the
device and the minibatch is one index gather per leaf.

``FleetConfig.batch_size <= 0`` returns the full shards; ``redraw``
selects whether the key advances with the round (fresh draws) or stays
pinned to the run seed (one fixed subsample, drawn the same every round).

Under a rank mesh (``sharding.partition``; the fleet split over the ranks
by ``scale.shard.constrain_fleet``) :func:`minibatch` gives each rank the
rows it works on: its own clients' minibatches, or its block of the m
sampled clients', each drawn on the rank that owns the client's shard (the
same CPU stream as in one process) and moved to this rank
(``scale.shard.take``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.comm.transports import _mix64
from repro_torch.fleet import partitions
from repro_torch.fleet.partitions import leaves_of, rebuild, sum_f32
from repro_torch.sharding import partition

# seed word separating the provisioning streams from the wire's ("prov")
PROVISION_TAG = 0x70726F76


class Fleet(NamedTuple):
    """The client population: partitioned shards + per-client row counts.

    Usage::

        >>> fleet = build_fleet(gen, (x, y), cfg, labels=y)   # partitioned
        >>> fleet = from_stacked((x_stacked, y_stacked))      # pre-sharded
        >>> state, hist = rounds.drive(state, fleet, loss_pair, cfg, T=100)
    """
    data: object              # batch tuple, every leaf [n_clients, cap, ...]
    count: torch.Tensor       # [n_clients] int64 valid rows, data's device
    host_count: torch.Tensor  # the same counts on the CPU


class ProvisionKey(NamedTuple):
    """The provisioning randomness of one round: client j's generator is
    seeded from (seed, round, PROVISION_TAG, j), or from (seed,
    PROVISION_TAG, j) when ``round`` is None (pinned draws)."""
    seed: int
    round: Optional[int]

    def generator(self, client: int) -> torch.Generator:
        words = (self.seed,) + (() if self.round is None else (self.round,))
        return torch.Generator().manual_seed(
            _mix64(*words, PROVISION_TAG, client))


def round_key(cfg, t: int) -> ProvisionKey:
    """Round t's provisioning key: advancing with the round under
    ``redraw``, else pinned to the run seed."""
    return ProvisionKey(cfg.seed, t if cfg.fleet.redraw else None)


def n_clients(fleet: Fleet) -> int:
    return fleet.host_count.shape[0]


def capacity(fleet: Fleet) -> int:
    return leaves_of(fleet.data)[0].shape[1]


def data_weights(fleet: Fleet) -> torch.Tensor:
    """q_j = count_j / sum(count) (float32, CPU): the data-weighted
    population weights the weighted sampler's aggregation is unbiased
    for."""
    q = fleet.host_count.to(torch.float32)
    return q / torch.clamp(sum_f32(q), min=1e-12)


def from_stacked(data, count=None) -> Fleet:
    """Fleet over pre-stacked ``[n_clients, cap, ...]`` per-client data: the
    shards ARE the caller's tensors (every row valid unless ``count``
    says otherwise)."""
    leaf = leaves_of(data)[0]
    J, cap = leaf.shape[0], leaf.shape[1]
    host = torch.full((J,), cap, dtype=torch.int64) if count is None else \
        torch.as_tensor(count).to("cpu", torch.int64)
    return Fleet(data, host.to(leaf.device), host)


def build_fleet(gen: torch.Generator, data, cfg,
                labels: Optional[torch.Tensor] = None) -> Fleet:
    """Partition a dataset (a batch tuple of ``[n_samples, ...]`` leaves, on
    any device) into a Fleet per ``cfg.fleet``: the partition from
    ``gen`` (a CPU generator), then the partitioner's value transform
    (covariate drift) from the same generator.  The shards stay on the
    data's device.  ``labels`` feeds the label-skew partitioners."""
    fl = cfg.fleet
    part = partitions.get_partitioner(fl.partitioner)
    leaves = leaves_of(data)
    n = leaves[0].shape[0]
    if part.ragged and not fl.balance and fl.batch_size <= 0:
        raise ValueError(
            f"partitioner {fl.partitioner!r} produces ragged shards; set "
            "FleetConfig.batch_size > 0 (masked minibatch provisioning) or "
            "balance=True (equal-size re-slice)")
    cp = part.partition(gen, n, cfg.n_clients, fl, labels=labels)
    shards = rebuild(data, [
        a.index_select(0, cp.idx.reshape(-1).to(a.device))
        .reshape(cp.idx.shape + a.shape[1:]) for a in leaves])
    shards = part.transform(gen, shards, fl)
    return Fleet(shards, cp.count.to(leaves[0].device), cp.count)


def draw_rows(key: ProvisionKey, host_count: torch.Tensor, ids, b: int
              ) -> torch.Tensor:
    """``[len(ids), b]`` int64 row indices on the CPU: client j's b rows,
    uniform with replacement below ``max(count_j, 1)``, from its own
    generator."""
    counts = host_count.tolist()
    return torch.stack([
        torch.randint(0, max(counts[j], 1), (b,), generator=key.generator(j))
        for j in ids])


def minibatch(fleet: Fleet, key: ProvisionKey, cfg,
              idx: Optional[torch.Tensor] = None):
    """This round's per-client minibatches.

    ``idx=None`` provisions all n clients (``[n, b, ...]``); ``idx`` (the
    sorted participant indices of gather mode, on the CPU) provisions only
    those m (``[m, b, ...]``), drawing for each the rows provisioning all
    n would draw.  ``cfg.fleet.batch_size <= 0`` returns the full shards
    (those of ``idx`` when given).  Under a rank mesh, see
    :func:`_minibatch_ranked`."""
    if partition.rank_axis() is not None:
        return _minibatch_ranked(fleet, key, cfg, idx)
    b = cfg.fleet.batch_size
    leaves = leaves_of(fleet.data)
    dev = leaves[0].device
    if b <= 0:
        if idx is None:
            return fleet.data
        ids = idx.to(dev)
        return rebuild(fleet.data, [a.index_select(0, ids) for a in leaves])
    ids = list(range(n_clients(fleet))) if idx is None else idx.tolist()
    rows = draw_rows(key, fleet.host_count, ids, b).to(dev)
    cids = torch.tensor(ids, dtype=torch.int64).to(dev)[:, None]
    return rebuild(fleet.data, [a[cids, rows] for a in leaves])


def _minibatch_ranked(fleet: Fleet, key: ProvisionKey, cfg,
                      idx: Optional[torch.Tensor] = None):
    """:func:`minibatch` under a rank mesh.  ``idx=None``: this rank's own
    block of clients (``partition.block(n)``), as ``partition.ClientShard``
    leaves of ``[n, b, ...]``; ``idx``: this rank's block of the sampled
    rows (``[hi - lo, b, ...]``), each client's rows drawn and read on the
    rank that owns its shard and moved here."""
    from repro_torch.scale import shard
    b = cfg.fleet.batch_size
    n = n_clients(fleet)

    def fetch(src, rows, ids):
        if b <= 0:
            return src.index_select(0, rows)
        if not ids:
            return src[:0, :1].expand((0, b) + tuple(src.shape[2:]))
        drawn = draw_rows(key, fleet.host_count, ids, b).to(src.device)
        return src[rows[:, None], drawn]
    if idx is not None:
        return rebuild(fleet.data, shard.take(leaves_of(fleet.data), idx,
                                              fetch=fetch))
    lo, hi = partition.block(n)
    own = list(range(lo, hi))

    def one(a):
        src = a.local if isinstance(a, partition.ClientShard) else a[lo:hi]
        rows = torch.arange(hi - lo, device=src.device)
        return partition.ClientShard(fetch(src, rows, own), n)
    return rebuild(fleet.data, [one(a) for a in leaves_of(fleet.data)])
