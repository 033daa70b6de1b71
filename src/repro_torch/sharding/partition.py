"""Logical-axis sharding (port of ``repro.sharding.partition``): path rules
-> spec trees, and the activation constraints.

A spec is a tuple with one entry per tensor dim: a mesh-axis name, a tuple
of names, or None (replicated) -- PyTorch has no ``PartitionSpec``.  An
empty tuple replicates every dim, as the reference's ``P()``.

:func:`activate_mesh` installs a mesh (``launch.mesh.Mesh``: ``axis_names``
and a numpy array of devices) and the logical-axis table, remapped as the
reference remaps it.  The spec builders (:func:`make_specs`,
:func:`check_divisible`, :func:`named_shardings`) read the mesh's axis
sizes, so the dry run (``launch/dryrun.py``) sizes each device's share of
a case from them.

Two kinds of mesh:

* a mesh of devices or placeholders (the dry run's): the activation
  helpers (:func:`shard_act`, :func:`gather_leading`,
  :func:`constrain_leading`, :func:`constrain_flat`) stay the identity on
  values -- one process holds whole tensors;
* a rank mesh (``launch.mesh.make_rank_mesh``: its entries are the ranks
  of the default ``torch.distributed`` group): the mesh's client axis
  ("client" -> "data", or ``client_axis``) runs over the ranks, and
  :func:`rank_axis` gives this process its coordinate.  A tensor whose
  leading axis is constrained to the client axis becomes a
  :class:`ClientShard`, this rank's contiguous block of rows
  (:func:`block`), and :func:`gather_leading` all-gathers the blocks back
  in row order (``sharding.collectives``).  Only the client axis is
  ported: a rank mesh with another axis larger than 1 (the ``model``
  axis: tensor parallelism, ``shard_act`` in the models,
  ``constrain_flat``) raises ``NotImplementedError``, as does one whose
  size is not the world's.  A one-rank mesh is one process: nothing calls
  ``torch.distributed``.
"""
from __future__ import annotations

import re
from typing import NamedTuple, Optional

DEFAULT_LOGICAL = {
    # logical name -> mesh axis (or tuple) -- None means replicate
    "batch": "data",
    "client": "data",
    "heads": "model",
    "kv_heads": "model",
    "ffn": "model",
    "vocab": "model",
    "experts": "data",
    "cap": "model",
    "kv_len": "model",
    "blocks": "model",      # packed-payload block dim
    "flat": "model",        # trailing axis of comm.flat [d] / [n, d] buffers
    "embed": None,
    "seq": None,
    "fsdp": "data",
    "pod": "pod",
}

_ACTIVE_MESH = None
_LOGICAL: dict = {}
_RANKS = None


class RankAxis(NamedTuple):
    """This process's place on an active rank mesh's client axis."""
    rank: int               # coordinate on the client axis (= its rank)
    size: int               # ranks on the axis (= the world)
    device: str             # this rank's device


class NamedSharding(NamedTuple):
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""
    mesh: object
    spec: tuple


def activate_mesh(mesh, logical: Optional[dict] = None,
                  client_axis: Optional[str] = None):
    """Install the mesh and the logical-axis table (``logical`` overrides
    the defaults).  With a mesh, ``client_axis`` (when given) becomes the
    "client" axis, and logical axes that point at axes the mesh lacks are
    dropped (replicated)."""
    global _ACTIVE_MESH, _LOGICAL, _RANKS
    table = dict(DEFAULT_LOGICAL)
    if logical:
        table.update(logical)
    if mesh is not None:
        names = set(mesh.axis_names)
        if client_axis:
            table["client"] = client_axis
        for k, v in list(table.items()):
            axes = v if isinstance(v, tuple) else (v,)
            if any(a is not None and a not in names for a in axes):
                table[k] = None
    ranks = _rank_axis(mesh, table["client"])
    _ACTIVE_MESH, _LOGICAL, _RANKS = mesh, table, ranks


def _rank_axis(mesh, client) -> Optional[RankAxis]:
    """The checks of a rank mesh and this rank's :class:`RankAxis` (None
    for no mesh, a mesh of devices or placeholders, or one rank)."""
    from repro_torch.launch.mesh import is_rank_mesh
    if not is_rank_mesh(mesh):
        return None
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("a rank mesh needs the default process group: "
                           "call torch.distributed.init_process_group first")
    world, me = dist.get_world_size(), dist.get_rank()
    if mesh.size != world:
        raise NotImplementedError(
            f"a rank mesh of {mesh.size} ranks in a world of {world}: the "
            "port runs one rank per mesh entry over the whole default group")
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    others = {a: s for a, s in sizes.items() if a != client and s > 1}
    if client is None or others:
        raise NotImplementedError(
            f"rank mesh axes {sizes} with client axis {client!r}: only the "
            "client axis runs over ranks; the 'model' axis (tensor "
            "parallelism, shard_act in the models, constrain_flat, the fsdp "
            "rules) is not ported yet")
    entries = list(mesh.devices.flat)
    if [e.rank for e in entries] != list(range(world)):
        raise ValueError("a rank mesh's entries must be the ranks in order")
    if world == 1:
        return None
    return RankAxis(me, world, entries[me].device)


def rank_axis() -> Optional[RankAxis]:
    """This process's :class:`RankAxis` under an active rank mesh of two
    or more ranks; None otherwise (one process runs the round)."""
    return _RANKS


def refuse_ranks(what: str) -> None:
    """Raise ``NotImplementedError`` for ``what`` under a rank mesh (the
    parts of the engine that do not run across ranks yet)."""
    if _RANKS is not None:
        raise NotImplementedError(
            f"{what} under a rank mesh is not ported yet: run it in one "
            "process (no mesh, or a one-rank mesh)")


def counts(n: int, size: Optional[int] = None) -> list:
    """Rows of each rank's block of an ``n``-row list split over ``size``
    ranks (default: the rank axis's): contiguous, in rank order, the first
    ``n % size`` blocks one row longer."""
    size = (_RANKS.size if _RANKS is not None else 1) if size is None \
        else size
    q, r = divmod(int(n), size)
    return [q + (i < r) for i in range(size)]


def block(n: int, rank: Optional[int] = None) -> tuple:
    """``(lo, hi)``: the rows of ``rank``'s block (default: this rank's;
    the whole list without a rank axis) of an ``n``-row list."""
    if _RANKS is None:
        return 0, int(n)
    rank = _RANKS.rank if rank is None else rank
    c = counts(n)
    lo = sum(c[:rank])
    return lo, lo + c[rank]


class ClientShard:
    """This rank's contiguous block (:func:`block`) of a tensor whose
    leading (client) axis of ``n`` rows is split over the rank axis:
    population-sized state under a rank mesh (the dense uplink residual,
    the slot store's pool, a fleet's shards).  ``shape`` is the whole
    tensor's."""

    __slots__ = ("local", "n")

    def __init__(self, local, n: int):
        self.local, self.n = local, int(n)

    @property
    def shape(self) -> tuple:
        return (self.n,) + tuple(self.local.shape[1:])

    @property
    def dtype(self):
        return self.local.dtype

    @property
    def device(self):
        return self.local.device

    def __repr__(self) -> str:
        lo, hi = block(self.n)
        return (f"ClientShard(rows {lo}:{hi} of {self.n}, "
                f"{tuple(self.local.shape)} {self.local.dtype})")


def local(x):
    """A :class:`ClientShard`'s own rows; any other value as it is."""
    return x.local if isinstance(x, ClientShard) else x


def client_zeros(shape, dtype, device):
    """Zeros of ``shape`` whose leading axis is the client axis: a tensor
    in one process, under a rank mesh a :class:`ClientShard` holding only
    this rank's block."""
    import torch
    if _RANKS is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    lo, hi = block(shape[0])
    return ClientShard(torch.zeros((hi - lo,) + tuple(shape[1:]),
                                   dtype=dtype, device=device), shape[0])


def _on_client_axis(logical_name: str) -> bool:
    return _RANKS is not None and logical_name is not None and \
        _LOGICAL.get(logical_name) == _LOGICAL.get("client")


def current_mesh():
    """The active mesh, or None."""
    return _ACTIVE_MESH


def resolve(*logical_names) -> tuple:
    """Logical dim names (or None) -> a spec, through the installed
    table."""
    return tuple(None if nm is None else _LOGICAL.get(nm)
                 for nm in logical_names)


def shard_act(x, *logical_names):
    """Sharding constraint by logical names: the identity on values."""
    return x


def sharding_for(*logical_names) -> Optional[NamedSharding]:
    """The logical names' spec on the active mesh; None without one."""
    if _ACTIVE_MESH is None:
        return None
    return NamedSharding(_ACTIVE_MESH, resolve(*logical_names))


def map_tensors(fn, tree):
    """``fn`` over the tensor and :class:`ClientShard` leaves of a tensor,
    a NamedTuple / tuple / list of them, or a dict (None kept), as the
    same structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        vals = [map_tensors(fn, v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else \
            type(tree)(vals)
    return fn(tree)


def gather_leading(tree):
    """Replicate every leaf's leading axis: the identity on values; under a
    rank mesh each :class:`ClientShard` leaf is all-gathered into the whole
    tensor (in row order, on every rank)."""
    if _RANKS is None:
        return tree
    from repro_torch.sharding import collectives

    def one(x):
        if not isinstance(x, ClientShard):
            return x
        return collectives.all_gather_rows(x.local, counts(x.n))
    return map_tensors(one, tree)


def all_rows(tree, total: int):
    """Under a rank mesh, every rank's block of a ``total``-row list (each
    tensor leaf of ``tree`` this rank's ``[rows, ...]`` block; a payload's
    fields each on its own), all-gathered in row order; ``tree`` itself in
    one process."""
    if _RANKS is None:
        return tree
    return gather_leading(map_tensors(lambda x: ClientShard(x, total), tree))


def constrain_leading(tree, logical_name: str):
    """Pin every leaf's leading axis to a mesh axis: the identity on
    values; under a rank mesh, with ``logical_name`` on the client axis,
    each whole tensor leaf becomes a :class:`ClientShard` holding a copy of
    this rank's block (leaves already split, and 0-d leaves, stay)."""
    if not _on_client_axis(logical_name):
        return tree

    def one(x):
        if isinstance(x, ClientShard) or x.dim() == 0:
            return x
        lo, hi = block(x.shape[0])
        return ClientShard(x[lo:hi].clone(), x.shape[0])
    return map_tensors(one, tree)


def constrain_flat(tree, logical_name: str = "flat"):
    """Pin every leaf's trailing axis to a mesh axis: the identity on
    values."""
    return tree


# ---------------------------------------------------------------------------
# Parameter spec assignment by path rules
# ---------------------------------------------------------------------------

def _axis_size(axis) -> int:
    if _ACTIVE_MESH is None:
        return 1
    sizes = dict(zip(_ACTIVE_MESH.axis_names, _ACTIVE_MESH.devices.shape))
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= sizes.get(a, 1)
        return n
    return sizes.get(axis, 1)


def check_divisible(spec: tuple, shape) -> tuple:
    """Drop spec entries whose mesh-axis size does not divide the dim."""
    out = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            out.append(entry)
            continue
        out.append(entry if shape[i] % _axis_size(entry) == 0 else None)
    return tuple(out)


def _leaf_shape(leaf) -> tuple:
    """A tree leaf's shape: a tensor's, or the leaf itself when it is a
    shape (``param_shapes`` trees)."""
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def map_leaves(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over a tree of dicts and lists (NamedTuples,
    tuples of containers) whose leaves are tensors or shape tuples;
    ``path`` joins dict keys and list indices with ``/``."""
    def sub(key):
        return f"{path}/{key}" if path else str(key)
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, sub(k)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_leaves(fn, v, sub(i)) for i, v in enumerate(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_leaves(fn, v, sub(i))
                            for i, v in enumerate(tree)))
    if tree is None:
        return None
    return fn(path, tree)


def make_specs(params, rules, default=()):
    """A spec tree for ``params`` (tensors or leaf shapes).

    ``rules`` is a list of (regex_on_path, spec_of_logical_names) tried in
    order; paths are ``/``-joined dict keys and list indices.  Logical
    names are resolved through the active table at call time (so call after
    :func:`activate_mesh`).  Entries whose mesh-axis size does not divide
    the tensor dim fall back to replication (e.g. vocab 50280 on a 16-way
    model axis)."""
    def one(name, leaf):
        shape = _leaf_shape(leaf)
        for pat, logical in rules:
            if re.search(pat, name):
                ndim = len(shape)
                logical = logical[-ndim:] if len(logical) > ndim else \
                    (None,) * (ndim - len(logical)) + tuple(logical)
                return check_divisible(resolve(*logical), shape)
        return default
    return map_leaves(one, params)


def named_shardings(spec_tree, mesh):
    """Every spec of ``spec_tree`` on ``mesh``."""
    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        if tree is None:
            return None
        return NamedSharding(mesh, tree)
    return walk(spec_tree)
