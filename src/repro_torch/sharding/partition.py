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
  of the default ``torch.distributed`` group, rank r at the row-major
  coordinate of r).  Two of its axes run over the ranks:

  - the client axis ("client" -> "data", or ``client_axis``):
    :func:`rank_axis` gives this process its coordinate.  A tensor whose
    leading axis is constrained to the client axis becomes a
    :class:`ClientShard`, this rank's contiguous block of rows
    (:func:`block`), and :func:`gather_leading` all-gathers the blocks
    back in row order;
  - the model axis ("flat" -> "model"): :func:`model_axis` gives this
    process its coordinate.  :func:`constrain_flat` cuts the trailing axis
    of the round's flat ``[d]`` / ``[n, d]`` buffers into contiguous
    column blocks (a :class:`ColumnSplit`; ``comm.flat.columns_for``
    chooses one whose cuts never divide a compression unit) and gives this
    rank its block as a :class:`FlatShard`; :func:`whole` all-gathers both
    kinds of shard back.

  Client-axis traffic runs over the ranks that share a model coordinate,
  model-axis traffic over the ranks that share a client coordinate: one
  ``torch.distributed`` group each, built by :func:`activate_mesh` (the
  default group itself where an axis holds every rank, so a ``(W, 1)``
  mesh makes the calls of a client axis alone).  A ``pod`` axis (or any
  other) larger than 1 raises ``NotImplementedError``, as does a mesh
  whose size is not the world's.  A one-rank mesh is one process: nothing
  calls ``torch.distributed``.

Tensor parallelism inside the models.  The reference's activation
constraints (``shard_act`` on q by ``"heads"``, k by ``"kv_heads"``, the
MLP's output, the embedding, the logits by ``"vocab"``) are GSPMD's cue to
run the layers tensor-parallel; the port runs them so explicitly.
:func:`tensor_plan` turns a model config and its ``FlatSpec`` into a
:class:`TensorPlan`: the dim of each leaf split over the model axis, read
from the family's rules (``models.rules``) through the active logical
table.  For the dense transformer family (``family == "dense"``) it
splits ``ffn`` and ``vocab`` where the dim divides by the model axis's
size M, and the attention leaves (``heads``, ``kv_heads``) only where
``n_kv_heads % M == 0``, so that every rank keeps whole heads with their
kv group (smollm-360m's 5 kv heads keep its attention whole at M = 2 and
4, although its 960-wide ``wq`` divides; the dry run's spec trees,
:func:`make_specs`, stay the reference's).  Every other family, and a
logical table that maps those axes to None, gives a plan with no split
leaf.  The layers then run on each rank's local shapes
(``models.transformer``, ``models.common``) with the model axis's "f"
and "g" collectives (``sharding.collectives``), and ``comm.flat``'s
:class:`~repro_torch.comm.flat.TensorLayout` moves the round's state
between the column layout and the tensor layout.  ``shard_act`` itself
stays the identity on values.
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
_MODEL = None
_GROUPS: dict = {"client": None, "model": None}


class RankAxis(NamedTuple):
    """This process's place on one axis of an active rank mesh."""
    rank: int               # coordinate on the axis (its rank in the
                            # axis's group)
    size: int               # ranks on the axis
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
    dropped (replicated).  A rank mesh is checked first (nothing changes
    when it is refused), then its axes' groups are built."""
    global _ACTIVE_MESH, _LOGICAL, _RANKS, _MODEL, _GROUPS
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
    ranks, model, groups = _rank_axes(mesh, table["client"], table["flat"])
    _ACTIVE_MESH, _LOGICAL, _RANKS, _MODEL, _GROUPS = (mesh, table, ranks,
                                                        model, groups)


def _rank_axes(mesh, client, model) -> tuple:
    """The checks of a rank mesh; this rank's client and model
    :class:`RankAxis` (None for an axis of one rank, and for no mesh or a
    mesh of devices or placeholders) and each axis's group (None: the
    default group)."""
    from repro_torch.launch.mesh import is_rank_mesh
    none = (None, None, {"client": None, "model": None})
    if not is_rank_mesh(mesh):
        return none
    import numpy as np
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
    others = {a: s for a, s in sizes.items()
              if a not in (client, model) and s > 1}
    if others:
        raise NotImplementedError(
            f"rank mesh axes {sizes} with client axis {client!r} and model "
            f"axis {model!r}: only those two run over ranks; a 'pod' axis "
            "(the multi-pod mesh) is not ported yet")
    entries = list(mesh.devices.flat)
    if [e.rank for e in entries] != list(range(world)):
        raise ValueError("a rank mesh's entries must be the ranks in order")
    if world == 1:
        return none
    names = list(mesh.axis_names)
    grid = np.arange(world).reshape(mesh.devices.shape)
    lead = [names.index(a) for a in (client, model) if a in names]
    grid = np.moveaxis(grid, lead, list(range(len(lead))))
    D = sizes.get(client, 1) if client else 1
    M = sizes.get(model, 1) if model else 1
    grid = grid.reshape(D, M)
    i, j = (int(v[0]) for v in np.nonzero(grid == me))
    groups = {"client": None, "model": None}
    if D > 1 and M > 1:
        # every rank builds every group, in the same order
        for axis, lines in (("client", grid.T), ("model", grid)):
            for line in lines:
                g = dist.new_group([int(r) for r in line])
                if me in line:
                    groups[axis] = g
    dev = entries[me].device
    return (RankAxis(i, D, dev) if D > 1 else None,
            RankAxis(j, M, dev) if M > 1 else None, groups)


def rank_axis() -> Optional[RankAxis]:
    """This process's place on the client axis of an active rank mesh
    whose client axis holds two or more ranks; None otherwise (this
    process runs every row of the round)."""
    return _RANKS


def model_axis() -> Optional[RankAxis]:
    """This process's place on the model axis of an active rank mesh whose
    model axis holds two or more ranks; None otherwise (this process holds
    every column of the flat state)."""
    return _MODEL


def axis_group(axis: str):
    """The ``torch.distributed`` group of the ranks that share this rank's
    coordinates on every axis but ``axis`` (``"client"`` or ``"model"``):
    None for the default group (an axis that holds every rank)."""
    return _GROUPS[axis]


def refuse_ranks(what: str) -> None:
    """Raise ``NotImplementedError`` for ``what`` under a rank mesh (the
    parts of the engine that do not run across ranks yet)."""
    if _RANKS is not None or _MODEL is not None:
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
    """The tensor a shard holds here (a :class:`FlatShard`'s columns of a
    :class:`ClientShard`'s own rows); any other value as it is."""
    if isinstance(x, FlatShard):
        x = x.local
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
    """Sharding constraint by logical names: the identity on values (under
    a rank mesh the dense family's layers split their own work: see the
    module docstring and :func:`tensor_plan`)."""
    return x


# the logical axes a model splits over the model axis of a rank mesh, and
# the families whose layers run split (``models.transformer``'s dense
# stack: the vlm's cross layers, and every other family, are not split yet)
TENSOR_AXES = ("heads", "kv_heads", "ffn", "vocab")
TENSOR_FAMILIES = ("dense",)


class TensorPlan(NamedTuple):
    """Per leaf of a ``FlatSpec``, the dim split over the model axis into
    ``size`` equal blocks (rank r holds block r), or None: the leaf is
    whole on every model rank."""
    dims: tuple
    size: int

    @property
    def split(self) -> bool:
        """Whether any leaf is split."""
        return any(d is not None for d in self.dims)

    def local_shape(self, i: int, shape) -> tuple:
        """Leaf ``i``'s shape on one model rank."""
        shape, d = tuple(shape), self.dims[i]
        if d is None:
            return shape
        return shape[:d] + (shape[d] // self.size,) + shape[d + 1:]


def tensor_plan(cfg, spec, size: Optional[int] = None) -> TensorPlan:
    """The :class:`TensorPlan` of model config ``cfg`` over a model axis of
    ``size`` ranks (default: the active rank mesh's, 1 without one) for
    the leaves of ``spec`` (a ``comm.flat.FlatSpec``): a leaf's first
    logical axis of :data:`TENSOR_AXES` that the active logical table (the
    defaults without a mesh) maps to the model axis is split where it
    divides -- attention (``heads`` and ``kv_heads`` both on the model
    axis) only where ``cfg.n_kv_heads % size == 0``.  Families outside
    :data:`TENSOR_FAMILIES` and a model axis of one rank split nothing."""
    from repro_torch.models import rules as model_rules
    M = int(size) if size is not None else (_MODEL.size if _MODEL else 1)
    dims = [None] * len(spec.leaves)
    if M <= 1 or cfg.family not in TENSOR_FAMILIES:
        return TensorPlan(tuple(dims), M)
    table = _LOGICAL or DEFAULT_LOGICAL
    axis = table.get("flat") or "model"
    on = {name: table.get(name) == axis for name in TENSOR_AXES}
    heads = on["heads"] and on["kv_heads"] and cfg.n_kv_heads % M == 0
    rules = model_rules.dense_rules(cfg)
    for i, (path, ls) in enumerate(zip(spec.paths, spec.leaves)):
        name = "/".join(str(k) for k in path)
        ndim = len(ls.shape)
        for pat, logical in rules:
            if not re.search(pat, name):
                continue
            logical = tuple(logical)[-ndim:] if len(logical) > ndim else \
                (None,) * (ndim - len(logical)) + tuple(logical)
            for dim, lg in enumerate(logical):
                if lg not in TENSOR_AXES or not on[lg]:
                    continue
                ok = heads if lg in ("heads", "kv_heads") else \
                    ls.shape[dim] % M == 0
                if ok:
                    dims[i] = dim
                break
            break
    return TensorPlan(tuple(dims), M)


def plan_record(spec, plan: TensorPlan) -> dict:
    """A plan's account: split and whole leaves, their counts and bytes
    (at the spec's dtype), and the path of every whole leaf."""
    import torch
    item = torch.empty((), dtype=spec.dtype).element_size()
    rec = {"model_ranks": plan.size, "split_leaves": 0, "whole_leaves": 0,
           "split_bytes": 0, "whole_bytes": 0, "whole": []}
    for path, ls, dim in zip(spec.paths, spec.leaves, plan.dims):
        kind = "whole" if dim is None else "split"
        rec[f"{kind}_leaves"] += 1
        rec[f"{kind}_bytes"] += ls.size * item
        if dim is None:
            rec["whole"].append("/".join(str(k) for k in path))
    return rec


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


class ColumnSplit(NamedTuple):
    """Contiguous column blocks of a flat ``[d]`` axis over the model axis:
    model rank r holds columns ``cuts[r]:cuts[r + 1]``."""
    cuts: tuple

    @property
    def d(self) -> int:
        return self.cuts[-1]

    def widths(self) -> list:
        return [b - a for a, b in zip(self.cuts, self.cuts[1:])]

    def block(self, rank: Optional[int] = None) -> tuple:
        """``(lo, hi)``: the columns of ``rank`` (default: this rank's
        model coordinate; every column without a model axis)."""
        if rank is None:
            if _MODEL is None:
                return 0, self.d
            rank = _MODEL.rank
        return self.cuts[rank], self.cuts[rank + 1]


class FlatShard:
    """This model rank's contiguous column block (``split.block()``) of a
    tensor whose trailing (flat) axis of ``split.d`` columns is split over
    the model axis: the round's flat state under a rank mesh with a model
    axis (the server center, the averaged-iterate sum, the uplink residual
    or the slot store's pool).  ``local`` is a contiguous tensor of its
    own, or a :class:`ClientShard` of such columns where the leading axis
    is split over the client axis too."""

    __slots__ = ("local", "split")

    def __init__(self, local, split: ColumnSplit):
        self.local, self.split = local, split

    def __repr__(self) -> str:
        lo, hi = self.split.block()
        return (f"FlatShard(columns {lo}:{hi} of {self.split.d}, "
                f"{self.local!r})")


def constrain_flat(tree, split: Optional[ColumnSplit] = None,
                   logical_name: str = "flat"):
    """Pin every leaf's trailing axis to a mesh axis: the identity on
    values; under a rank mesh with a model axis (``logical_name`` on it),
    each leaf becomes a :class:`FlatShard` holding a copy of this rank's
    columns of ``split`` (the round's: ``comm.flat.columns_for``;
    ``ClientShard`` leaves keep their rows; leaves already split, and 0-d
    leaves, stay)."""
    if _MODEL is None or _LOGICAL.get(logical_name) is None:
        return tree
    lo, hi = _model_block(split)

    def cut(x):
        # a copy, not a view: clone() lays a column slice out densely
        return x[..., lo:hi].clone()

    def one(x):
        if isinstance(x, FlatShard) or (
                not isinstance(x, ClientShard) and x.dim() == 0):
            return x
        if isinstance(x, ClientShard):
            return FlatShard(ClientShard(cut(x.local), x.n), split)
        return FlatShard(cut(x), split)
    return map_tensors(one, tree)


def _model_block(split: Optional[ColumnSplit]) -> tuple:
    if split is None:
        raise ValueError("under a model axis the flat state needs the "
                         "round's ColumnSplit (comm.flat.columns_for)")
    return split.block()


def flat_zeros(shape, dtype, device, split: Optional[ColumnSplit] = None):
    """Zeros of ``shape`` whose trailing axis is the flat axis and whose
    leading axis, for two or more dims, the client axis
    (:func:`client_zeros`): under a model axis a :class:`FlatShard` of
    this rank's columns of ``split``."""
    import torch
    shape = tuple(shape)
    if _MODEL is None:
        if len(shape) == 1:
            return torch.zeros(shape, dtype=dtype, device=device)
        return client_zeros(shape, dtype, device)
    lo, hi = _model_block(split)
    sub = shape[:-1] + (hi - lo,)
    inner = torch.zeros(sub, dtype=dtype, device=device) \
        if len(shape) == 1 else client_zeros(sub, dtype, device)
    return FlatShard(inner, split)


def flat_local(x):
    """A :class:`FlatShard`'s columns (a tensor or a ``ClientShard``); any
    other value as it is."""
    return x.local if isinstance(x, FlatShard) else x


def whole(tree):
    """Every leaf whole on every rank: :class:`FlatShard` leaves
    all-gathered in column order over the model axis, :class:`ClientShard`
    leaves in row order over the client axis; other leaves as they are."""
    from repro_torch.sharding import collectives

    def one(x):
        if isinstance(x, FlatShard):
            return collectives.all_gather_cols(one(x.local),
                                               x.split.widths())
        if isinstance(x, ClientShard):
            return collectives.all_gather_rows(x.local, counts(x.n))
        return x
    return map_tensors(one, tree)


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
