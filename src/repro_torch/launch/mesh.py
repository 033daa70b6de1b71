"""Production mesh construction (port of ``repro.launch.mesh``).  Functions,
not module-level constants: importing this module touches no device.

A :class:`Mesh` is the axis names and a numpy array of devices, which is
all that ``sharding.partition`` reads.  :func:`make_production_mesh`
builds the reference's ``(16, 16)`` or ``(2, 16, 16)`` mesh over the CUDA
devices present and raises the reference's ``RuntimeError`` when there are
fewer.  The dry run builds the same shapes over :func:`placeholder_devices`
(the port's counterpart of the reference's forced host devices): they
lower nothing and run nothing, they only size each device's share.

:func:`make_rank_mesh` lays the ranks of the default ``torch.distributed``
group (started by the caller) out as a mesh: each entry is a
:class:`RankDevice`, a rank and the device it computes on, rank r at the
row-major coordinate of r (on a ``(D, M)`` ``("data", "model")`` mesh,
``(r // M, r % M)``).  Under ``sharding.partition.activate_mesh`` such a
mesh runs the engine's rounds across the ranks: the client axis over the
rows of the round, the model axis over the columns of its flat state.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Mesh(NamedTuple):
    axis_names: tuple
    devices: np.ndarray     # device handles, shaped like the mesh

    @property
    def size(self) -> int:
        return int(self.devices.size)


class RankDevice(NamedTuple):
    """One entry of a rank mesh: a process of the default group and its
    device (``cuda:<local rank>``, or ``cpu``)."""
    rank: int
    device: str


def is_rank_mesh(mesh) -> bool:
    """Whether ``mesh``'s entries are ranks (:func:`make_rank_mesh`)."""
    return mesh is not None and mesh.devices.size > 0 and all(
        isinstance(e, RankDevice) for e in mesh.devices.flat)


def rank_device(device: str, rank: int) -> str:
    """The device of ``rank`` under ``device`` (``cuda`` or ``cpu``): its
    local rank's card, ranks past the card count sharing cards round robin
    (two ranks on one card under gloo), or the CPU."""
    import torch
    kind = torch.device(device).type
    if kind == "cpu":
        return "cpu"
    if kind != "cuda":
        raise ValueError(f"a rank mesh runs on cuda or cpu, not {device!r}")
    count = torch.cuda.device_count()
    if not count:
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "for a mesh of CPU ranks")
    return f"cuda:{rank % count}"


def make_rank_mesh(device: str = "cuda", shape=None,
                   axes=("data",)) -> Mesh:
    """The world's ranks as a mesh of :class:`RankDevice` entries in rank
    order (default: one axis, ``data``, the reference's client axis,
    holding every rank).  Needs an initialised default group; on one host
    a rank's local rank is its rank."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_rank_mesh needs the default process group: "
                           "call torch.distributed.init_process_group first")
    world = dist.get_world_size()
    shape = (world,) if shape is None else tuple(shape)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} against axes {axes}")
    n = int(np.prod(shape))
    return _mesh([RankDevice(r, rank_device(device, r)) for r in range(n)],
                 shape, axes)


def placeholder_devices(n: int) -> list:
    """``n`` stand-in devices for the dry run (names, not devices)."""
    return [f"placeholder:{i}" for i in range(n)]


def _mesh(devices, shape, axes) -> Mesh:
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(tuple(axes), arr.reshape(shape))


def make_production_mesh(*, multi_pod: bool = False,
                         devices=None) -> Mesh:
    """The production mesh over ``devices`` (default: every CUDA device
    present; the dry run passes :func:`placeholder_devices`)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    if devices is None:
        import torch
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    if len(devices) < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} devices but only {len(devices)} present; "
            "the dry run (launch/dryrun.py) builds it over placeholder "
            "devices")
    return _mesh(list(devices)[:n], shape, axes)


def make_debug_mesh(shape=(2, 2), axes=("data", "model"),
                    devices=None) -> Mesh:
    """A small mesh for sharding tests (default: placeholder devices)."""
    n = int(np.prod(shape))
    devices = placeholder_devices(n) if devices is None else devices
    return _mesh(list(devices)[:n], shape, axes)
