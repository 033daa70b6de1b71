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
a case from them.  The activation helpers (:func:`shard_act`,
:func:`gather_leading`, :func:`constrain_leading`,
:func:`constrain_flat`) stay the identity on values with or without a
mesh: one process holds whole tensors, and there is no partitioner for
them to guide.
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
    global _ACTIVE_MESH, _LOGICAL
    _ACTIVE_MESH = mesh
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
    _LOGICAL = table


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


def gather_leading(tree):
    """Replicate every leaf's leading axis: the identity on values."""
    return tree


def constrain_leading(tree, logical_name: str):
    """Pin every leaf's leading axis to a mesh axis: the identity on
    values."""
    return tree


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
