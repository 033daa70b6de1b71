"""Checkpointing (port of ``repro.checkpoint``): ``FedState`` and any tree
of tensors saved to ``<path>.npz`` with a ``<path>.json`` sidecar, written
atomically (a temporary file, then ``os.replace``).

Keys are the ``/``-joined path down to each leaf, spelt as the reference
spells ``jax.tree_util`` paths: a NamedTuple field as ``.name``, a dict key
and a tuple index as themselves.  So where a field exists in both packages
the key is the same (``.wbar_weight``, ``.e_up/.pool``, ``.e_up/.owner``,
``.sampler``, ...; the port's ``.w`` is the flat ``[d]`` buffer itself, the
reference's ``.w/<leaf>`` the parameter tree).  The leaves:

* tensors move to the CPU to be written and restore onto the like-tree's
  device (a ``meta`` like-leaf restores onto the ``device`` given to
  :func:`restore`, which it then needs), shape checked (a mismatch raises
  ``ValueError``) and cast to the like-leaf's dtype; ``uint16`` / ``uint32``
  wire payloads go through their signed views, bit for bit;
* a ``torch.Generator`` (``FedState.gen``) is written as its
  ``get_state()`` bytes and restored into a new generator;
* Python ints and floats (``FedState.t``, a replayed cohort's position)
  are written as 0-d arrays;
* ``None`` leaves and the static :class:`repro_torch.comm.flat.FlatSpec`
  (``FedState.spec``) are not written: the like-tree supplies them, as it
  decides the sampler state's structure.

:func:`save` / :func:`restore` round-trip the whole engine state -- the
uplink residual (dense or a slot store), the server center, the averaged
iterate, the round, the participation generator and the sampler state --
so a restored run continues on the uninterrupted one's trajectory.
:func:`save_round` / :func:`restore_round` keep round checkpoints with the
fleet, staleness-buffer and compressed-residual sidecars beside them.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Optional

import numpy as np
import torch

from repro_torch.comm import flat
from repro_torch.comm.payloads import FlatPacked, FlatQuant
from repro_torch.sharding import partition

# unsigned wire dtypes -> (signed torch view, its numpy dtype, the numpy
# dtype written)
_UNSIGNED = {torch.uint16: (torch.int16, np.int16, np.uint16),
             torch.uint32: (torch.int32, np.int32, np.uint32)}


def _join(prefix: str, name) -> str:
    return f"{prefix}/{name}" if prefix else str(name)


def _items(tree, prefix: str = ""):
    """``(key, leaf)`` for every written leaf of ``tree``, in order."""
    if tree is None or isinstance(tree, flat.FlatSpec):
        return
    if isinstance(tree, (torch.Tensor, torch.Generator, bool, int, float)):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], _join(prefix, k))
    elif hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _items(getattr(tree, f), _join(prefix, "." + f))
    elif isinstance(tree, (tuple, list)):
        for i, x in enumerate(tree):
            yield from _items(x, _join(prefix, i))
    else:
        raise TypeError(f"checkpoint: cannot write a {type(tree).__name__} "
                        f"at {prefix!r}")


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy()
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    x = leaf.detach()
    signed = _UNSIGNED.get(x.dtype)
    if signed is not None:
        return x.view(signed[0]).cpu().numpy().view(signed[2])
    return x.cpu().numpy()


def _flatten(tree) -> dict:
    return {key: _to_numpy(leaf) for key, leaf in _items(tree)}


def _from_numpy(arr: np.ndarray, ref: torch.Tensor, device, key: str):
    dev = ref.device
    if dev.type == "meta":
        if device is None:
            raise ValueError(f"checkpoint: {key} has a meta like-leaf; "
                             "restore needs the device to put it on")
        dev = torch.device(device)
    signed = _UNSIGNED.get(ref.dtype)
    if signed is not None:
        host = np.ascontiguousarray(arr, dtype=signed[2]).view(signed[1])
        return torch.from_numpy(host).to(dev).view(ref.dtype)
    return torch.from_numpy(np.array(arr)).to(device=dev, dtype=ref.dtype)


def _rebuild(like, prefix: str, data, device):
    if like is None or isinstance(like, flat.FlatSpec):
        return like
    if isinstance(like, torch.Tensor):
        arr = data[prefix]
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint mismatch at {prefix}: "
                             f"{tuple(arr.shape)} vs {tuple(like.shape)}")
        return _from_numpy(arr, like, device, prefix)
    if isinstance(like, torch.Generator):
        gen = torch.Generator(device=like.device)
        gen.set_state(torch.from_numpy(np.array(data[prefix], np.uint8)))
        return gen
    if isinstance(like, bool):
        return bool(data[prefix])
    if isinstance(like, int):
        return int(data[prefix])
    if isinstance(like, float):
        return float(data[prefix])
    if isinstance(like, dict):
        return {k: _rebuild(like[k], _join(prefix, k), data, device)
                for k in like}
    if hasattr(like, "_fields"):
        return type(like)(*(_rebuild(getattr(like, f), _join(prefix, "." + f),
                                     data, device) for f in like._fields))
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(x, _join(prefix, i), data, device)
                          for i, x in enumerate(like))
    raise TypeError(f"checkpoint: cannot restore a {type(like).__name__} "
                    f"at {prefix!r}")


def save(path: str, tree, metadata: Optional[dict] = None):
    """Atomic checkpoint write: ``<path>.npz`` + ``<path>.json`` (the
    metadata and the sorted keys).  Refused under a rank mesh."""
    partition.refuse_ranks("checkpoints")
    folder = os.path.dirname(path) or "."
    os.makedirs(folder, exist_ok=True)
    arrays = _flatten(tree)
    # np.savez appends ".npz" to a name without it: keep the suffix
    fd, tmp = tempfile.mkstemp(dir=folder, suffix=".tmp.npz")
    os.close(fd)
    np.savez(tmp, **arrays)
    os.replace(tmp, path + ".npz")
    fd, tmp = tempfile.mkstemp(dir=folder, suffix=".tmp.json")
    with os.fdopen(fd, "w") as f:
        json.dump({"metadata": metadata or {}, "keys": sorted(arrays)}, f)
    os.replace(tmp, path + ".json")


def restore(path: str, like_tree, device=None):
    """Restore ``<path>.npz`` into the structure of ``like_tree`` (shapes
    checked, dtypes and devices taken from it; ``meta`` leaves restore onto
    ``device``).  Refused under a rank mesh."""
    partition.refuse_ranks("checkpoints")
    with np.load(path + ".npz") as data:
        return _rebuild(like_tree, "", data, device)


def read_metadata(path: str) -> dict:
    """The ``metadata`` dict of a checkpoint's json sidecar (``{}`` when
    the sidecar is absent or unreadable)."""
    try:
        with open(path + ".json") as f:
            return json.load(f).get("metadata", {}) or {}
    except (OSError, ValueError):
        return {}


def _round_numbers(ckpt_dir: str) -> list:
    """Round numbers of the ``round_<t>.npz`` checkpoints in a directory
    (sidecars such as ``round_<t>_fleet.npz`` are skipped)."""
    rounds = []
    for f in os.listdir(ckpt_dir):
        if f.startswith("round_") and f.endswith(".npz"):
            try:
                rounds.append(int(f[len("round_"):-len(".npz")]))
            except ValueError:
                pass
    return sorted(rounds)


def latest_round(ckpt_dir: str) -> Optional[int]:
    """The newest ``round_<t>`` checkpoint in a directory, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    rounds = _round_numbers(ckpt_dir)
    return max(rounds) if rounds else None


def fleet_metadata(fleet, cfg=None) -> dict:
    """The fleet sidecar's metadata: per-client shard counts plus the
    FleetConfig fields that produced them."""
    meta = {"count": [int(c) for c in fleet.host_count.tolist()]}
    if cfg is not None:
        meta.update(dataclasses.asdict(cfg.fleet))
    return meta


# ---------------------------------------------------------------------------
# The uplink EF residual through the wire format (opt-in checkpoint shrink)
# ---------------------------------------------------------------------------

def _uplink(params, cfg):
    spec = params if isinstance(params, flat.FlatSpec) else \
        flat.spec_of(params)
    return spec, flat.flat_transports_for(cfg, spec)[0]


def _packable(uplink) -> bool:
    return uplink.codec is not None and not uplink.codec.per_client_keys


def residual_to_wire(e_up, params, cfg):
    """The uplink EF residual re-encoded through the uplink's wire format:
    the dense ``[n, d]`` rows, or a slot store's ``[cap, d]`` pool, as
    FlatPacked values + uint16 offsets or FlatQuant words + scales.
    ``params`` is the parameter tree (any device, ``meta`` included) or
    its :class:`repro_torch.comm.flat.FlatSpec`.

    Returns None where no deterministic packed wire exists (dense wires,
    ``none`` / ``natural``, rand-k's per-client streams, quant widths that
    do not pack, or no residual): the caller then keeps the residual dense.
    The restore yields ``decode(pack(e))`` row by row: each block's top-k
    entries exactly (the rest zero), or every entry quantized."""
    if e_up is None:
        return None
    from repro_torch.scale import slots
    _, uplink = _uplink(params, cfg)
    if not _packable(uplink):
        return None
    if isinstance(e_up, slots.SlotStore):
        return e_up._replace(pool=uplink.codec.pack(e_up.pool))
    return uplink.codec.pack(e_up)


def residual_wire_struct(e_like, params, cfg):
    """The structure of :func:`residual_to_wire`'s result for a residual
    shaped like ``e_like``, as ``meta`` tensors (read from the wire layout;
    no kernel runs), or None where it returns None."""
    if e_like is None:
        return None
    from repro_torch.scale import slots
    spec, uplink = _uplink(params, cfg)
    if not _packable(uplink):
        return None
    store = isinstance(e_like, slots.SlotStore)
    rows = (e_like.pool if store else e_like).shape[0]
    layout = uplink.codec.layout

    def meta(width, dtype):
        return torch.empty((rows, width), dtype=dtype, device="meta")
    if uplink.kind == "quant":
        wire = FlatQuant(meta(layout.W_total, torch.uint32),
                         meta(layout.NB_total, torch.float32))
    else:
        wire = FlatPacked(meta(layout.K_total, spec.dtype),
                          meta(layout.K_total, torch.uint16))
    if store:
        return e_like._replace(pool=wire)
    return wire


def residual_from_wire(wire, params, cfg, like=None):
    """A :func:`residual_to_wire` sidecar decoded back into the engine's
    residual (dense rows, or a slot store with a decoded pool), in
    ``like``'s dtype (the model spec's by default)."""
    from repro_torch.scale import slots
    spec, uplink = _uplink(params, cfg)
    if isinstance(wire, slots.SlotStore):
        dt = like.pool.dtype if like is not None else spec.dtype
        return wire._replace(pool=uplink.codec.decode(wire.pool).to(dt))
    dt = like.dtype if like is not None else spec.dtype
    return uplink.codec.decode(wire).to(dt)


def save_round(ckpt_dir: str, t: int, state, keep: int = 3,
               metadata: Optional[dict] = None, fleet=None, cfg=None,
               compress_residual: bool = False, params=None):
    """Save a round checkpoint (plus the fleet sidecar when ``fleet`` is
    given) and delete all but the newest ``keep`` rounds, sidecars
    included.

    ``compress_residual=True`` (needs ``params`` and ``cfg``) re-encodes the
    uplink residual through the wire format into a ``round_<t>_eup``
    sidecar and drops it from the main npz (see :func:`residual_to_wire`);
    uplinks without a deterministic packed wire keep it dense."""
    metadata = dict(metadata or {})
    if fleet is not None:
        metadata["fleet"] = fleet_metadata(fleet, cfg)
        save(os.path.join(ckpt_dir, f"round_{t}_fleet"), fleet,
             metadata["fleet"])
    if compress_residual:
        if params is None or cfg is None:
            raise ValueError("compress_residual=True needs params and cfg "
                             "(the uplink wire format re-encodes e_up)")
        wire = residual_to_wire(getattr(state, "e_up", None), params, cfg)
        if wire is not None:
            save(os.path.join(ckpt_dir, f"round_{t}_eup"), wire,
                 {"compressed": True, "kind": cfg.uplink.kind})
            state = state._replace(e_up=None)
    save(os.path.join(ckpt_dir, f"round_{t}"), state, metadata)
    for old in _round_numbers(ckpt_dir)[:-keep]:
        for stem in (f"round_{old}", f"round_{old}_fleet",
                     f"round_{old}_buffer", f"round_{old}_eup"):
            for ext in (".npz", ".json"):
                try:
                    os.remove(os.path.join(ckpt_dir, stem + ext))
                except OSError:
                    pass


def save_buffer(ckpt_dir: str, t: int, wire_buf,
                metadata: Optional[dict] = None):
    """Save the async staleness buffer beside a round checkpoint, in its
    sidecar form (``engine.async_rounds.buffer_wire``: the parked payloads
    as they crossed the wire).  Nothing when the buffer is disabled
    (``wire_buf is None``)."""
    if wire_buf is None:
        return
    save(os.path.join(ckpt_dir, f"round_{t}_buffer"), wire_buf, metadata)


def restore_buffer(ckpt_dir: str, t: Optional[int], like_wire,
                   device=None):
    """Restore a round's buffer sidecar into the structure of ``like_wire``
    (``engine.async_rounds.buffer_wire_struct``; its ``meta`` leaves land
    on ``device``); None when the sidecar is absent or the buffer is
    disabled (``like_wire is None``)."""
    if t is None or like_wire is None:
        return None
    path = os.path.join(ckpt_dir, f"round_{t}_buffer")
    if not os.path.exists(path + ".npz"):
        return None
    return restore(path, like_wire, device=device)


def restore_round(ckpt_dir: str, like_state, t: Optional[int] = None,
                  like_fleet=None, params=None, cfg=None):
    """Restore the newest (or round-``t``) checkpoint into the structure of
    ``like_state``; ``(None, None)`` when there is none.  With
    ``like_fleet`` the fleet sidecar is restored too and ``(state, fleet),
    t`` returns.

    A ``round_<t>_eup`` sidecar (``save_round(...,
    compress_residual=True)``) is detected: the residual is decoded through
    the uplink wire format (``params`` and ``cfg`` are then required) and
    put back into the restored state."""
    t = t if t is not None else latest_round(ckpt_dir)
    if t is None:
        return None, None
    dev = like_state.w.device
    eup_path = os.path.join(ckpt_dir, f"round_{t}_eup")
    if os.path.exists(eup_path + ".npz"):
        if params is None or cfg is None:
            raise ValueError("checkpoint has a compressed-residual sidecar; "
                             "restore_round needs params and cfg to decode "
                             "it through the uplink wire format")
        like_wire = residual_wire_struct(like_state.e_up, params, cfg)
        wire = restore(eup_path, like_wire, device=dev)
        state = restore(os.path.join(ckpt_dir, f"round_{t}"),
                        like_state._replace(e_up=None))
        state = state._replace(e_up=residual_from_wire(
            wire, params, cfg, like=like_state.e_up))
    else:
        state = restore(os.path.join(ckpt_dir, f"round_{t}"), like_state)
    if like_fleet is None:
        return state, t
    fleet = restore(os.path.join(ckpt_dir, f"round_{t}_fleet"), like_fleet)
    return (state, fleet), t
