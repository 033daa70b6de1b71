"""Production mesh construction (port of ``repro.launch.mesh``).  Functions,
not module-level constants: importing this module touches no device.

A :class:`Mesh` is the axis names and a numpy array of devices, which is
all that ``sharding.partition`` reads.  :func:`make_production_mesh`
builds the reference's ``(16, 16)`` or ``(2, 16, 16)`` mesh over the CUDA
devices present and raises the reference's ``RuntimeError`` when there are
fewer.  The dry run builds the same shapes over :func:`placeholder_devices`
(the port's counterpart of the reference's forced host devices): they
lower nothing and run nothing, they only size each device's share.
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
