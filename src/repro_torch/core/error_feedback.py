"""Deprecated shim (port of ``repro.core.error_feedback``): error feedback
lives in the transport layer (:mod:`repro_torch.comm.transports`,
``Transport.ef_step``; the engine's downlink is
``comm.flat.FlatTransport.broadcast``).  The old free functions, on
parameter trees:

Uplink (EF14, per client j)::

    v_j  = C_j(e_j + Delta_j)
    e_j' = e_j + Delta_j - v_j

Downlink (primal EF21): the server compresses the difference between
successive broadcast models, ``w_{t+1} = w_t + C_0(x_{t+1} - w_t)``.
"""
from __future__ import annotations

import torch

from repro_torch.comm.payloads import tree_map
from repro_torch.comm.transports import get_transport
from repro_torch.configs.base import CompressorConfig


def _backend(blockwise: bool) -> str:
    return "packed" if blockwise else "ref"


def uplink_step(e, delta, cfg: CompressorConfig, key=None,
                blockwise: bool = False):
    """One EF14 uplink step: ``(dense message v, new residual e')``."""
    t = get_transport(cfg, _backend(blockwise))
    msg, e_new = t.ef_step(e, delta, key)
    return t.decompress(msg, delta), e_new


def downlink_step(w, x_new, cfg: CompressorConfig, key=None,
                  blockwise: bool = False):
    """One primal-EF21 downlink step: the broadcast model ``w_{t+1}``."""
    t = get_transport(cfg, _backend(blockwise))
    if t.is_identity:
        return x_new
    diff = tree_map(torch.sub, x_new, w)
    return tree_map(torch.add, w, t.decompress(t.compress(diff, key), w))
