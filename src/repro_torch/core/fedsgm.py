"""FedSGM (Algorithm 1) -- the compatibility facade over
:mod:`repro_torch.engine` (port of ``repro.core.fedsgm``): the round loop
lives in ``engine.rounds``; these re-exports keep the reference's API."""
from __future__ import annotations

from repro_torch.engine.rounds import (FedState, RoundMetrics,  # noqa: F401
                                       averaged_iterate, drive, init_state,
                                       round_bytes, round_step, run_rounds,
                                       transports_for)
from repro_torch.fleet.samplers import participation_mask  # noqa: F401

__all__ = [
    "FedState", "RoundMetrics", "averaged_iterate", "drive", "init_state",
    "participation_mask", "round_bytes", "round_step", "run_rounds",
    "transports_for",
]
