"""Client-axis sharding of population-sized state (port of
``repro.scale.shard``).

The reference pins the leading client axis of the fleet's shards and of the
slot store to the mesh's client axis, and gathers a round's m rows from the
sharded source so the population is never all-gathered.  On one card there
is no mesh: the constraints are identities and :func:`sharded_take` is a
plain gather of the rows along the leading axis.
"""
from __future__ import annotations

import torch

from repro_torch.sharding import partition


def constrain_fleet(fleet):
    """The fleet with its leading (client) axis on the client mesh axis:
    the fleet itself on one card."""
    return fleet._replace(
        data=partition.constrain_leading(fleet.data, "client"),
        count=partition.constrain_leading(fleet.count, "client"))


def constrain_store(store):
    """The slot store with its pool rows and per-client index on the client
    mesh axis: the store itself on one card."""
    return store._replace(
        pool=partition.constrain_leading(store.pool, "client"),
        owner=partition.constrain_leading(store.owner, "client"),
        stamp=partition.constrain_leading(store.stamp, "client"),
        weight=partition.constrain_leading(store.weight, "client"),
        client_slot=partition.constrain_leading(store.client_slot,
                                                "client"))


def sharded_take(tree, idx: torch.Tensor):
    """The rows ``idx`` of every leaf of a client-stacked tree (a tensor, a
    NamedTuple / tuple / list of them, or a dict), gathered along the
    leading axis (``index_select``)."""
    src = partition.constrain_leading(tree, "client")
    return partition.gather_leading(_take(src, idx))


def _take(tree, idx):
    if isinstance(tree, torch.Tensor):
        return tree.index_select(0, idx.to(device=tree.device,
                                           dtype=torch.int64))
    if isinstance(tree, dict):
        return {k: _take(v, idx) for k, v in tree.items()}
    if tree is None:
        return None
    vals = [_take(v, idx) for v in tree]
    return type(tree)(*vals) if hasattr(tree, "_fields") else type(tree)(vals)
