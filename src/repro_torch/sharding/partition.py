"""Logical-axis sharding shims (port of ``repro.sharding.partition``).

The reference pins activations and client-axis stacks to mesh axes by
logical names; without an active mesh every helper is the identity.  The
port runs on one card and has no mesh (``launch/mesh.py`` is not ported),
so :func:`activate_mesh` takes only ``None`` and every helper is the
identity.  :func:`resolve` translates logical names through the same table
as the reference into a plain tuple of mesh-axis names (PyTorch has no
``PartitionSpec``).  The path-rule spec builders (``make_specs``,
``named_shardings``) come with the model-family rules (``models/rules.py``).
"""
from __future__ import annotations

from typing import Optional

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


def activate_mesh(mesh, logical: Optional[dict] = None):
    """Install the logical-axis table (``logical`` overrides the defaults).
    ``mesh`` must be None: a device mesh needs the mesh launcher, which the
    port does not have yet (the reference's ``client_axis`` remapping
    applies to a mesh only, so it comes with it)."""
    global _LOGICAL
    if mesh is not None:
        raise NotImplementedError(
            "activate_mesh with a device mesh is not ported yet (it comes "
            "with launch/mesh.py); on one card pass mesh=None")
    table = dict(DEFAULT_LOGICAL)
    if logical:
        table.update(logical)
    _LOGICAL = table


def current_mesh():
    """The active mesh: always None on one card."""
    return _ACTIVE_MESH


def resolve(*logical_names) -> tuple:
    """Logical dim names (or None) -> a tuple of mesh-axis names (None:
    replicated), through the installed table."""
    return tuple(None if nm is None else _LOGICAL.get(nm)
                 for nm in logical_names)


def shard_act(x, *logical_names):
    """Sharding constraint by logical names: the identity without a mesh."""
    return x


def gather_leading(tree):
    """Replicate every leaf's leading axis: the identity without a mesh."""
    return tree


def constrain_leading(tree, logical_name: str):
    """Pin every leaf's leading axis to a mesh axis: the identity without a
    mesh."""
    return tree


def constrain_flat(tree, logical_name: str = "flat"):
    """Pin every leaf's trailing axis to a mesh axis: the identity without
    a mesh."""
    return tree
