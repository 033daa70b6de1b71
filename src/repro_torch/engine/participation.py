"""Client participation (port of ``repro.engine.participation``, mask mode).

``mask`` is the paper-faithful dense simulation: every per-client
computation runs over all n clients and is mask-multiplied down to the m
participants afterwards.  (``gather``, the compute-sparse mode, is not
ported yet.)
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.comm import transports

MODES = ("mask",)


class Participation(NamedTuple):
    """One round's sample S_t."""
    mask: torch.Tensor                      # [n] 0/1, exactly m ones
    n: int
    m: int
    weights: Optional[torch.Tensor] = None  # [n], zero off-support


def finalize(mask: torch.Tensor, weights: Optional[torch.Tensor],
             cfg) -> Participation:
    if cfg.participation not in MODES:
        raise NotImplementedError(
            f"participation mode {cfg.participation!r} is not ported yet; "
            f"ported: {MODES}")
    return Participation(mask, cfg.n_clients, cfg.m, weights)


def agg_weights(part: Participation) -> torch.Tensor:
    """The [n] aggregation weights: the sampler's, else the mask."""
    return part.mask if part.weights is None else part.weights


def aggregate(part: Participation, deltas: torch.Tensor) -> torch.Tensor:
    """Participating weighted mean of per-client ``[n, d]`` deltas."""
    return transports.masked_mean(deltas, agg_weights(part), part.m)


def transmit(transport, e, deltas, part: Participation):
    """The engine's single uplink call site: EF14 + aggregation over the
    ``[n, d]`` stacks.  Returns ``(v_bar, e_new)``."""
    return transport.transmit(e, deltas, agg_weights(part), part.m)
