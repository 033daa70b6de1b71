"""Baselines the paper compares against (port of ``repro.core.baselines``).

* Penalty-based FedAvg (Fig. 6/7): clients descend on f + rho * [g - eps]_+
  with a fixed penalty weight rho -- showing the tuning instability the paper
  criticizes (small rho => infeasible, large rho => slow).
* Centralized SGM (n=1 special case of FedSGM; ``strategy="centralized-sgm"``
  or FedConfig(n_clients=1, m=1)).

:func:`penalty_round` is a thin wrapper over one engine round with
``strategy="penalty-fedavg"``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.comm import flat
from repro_torch.configs.base import CompressorConfig, FedConfig, SwitchConfig
from repro_torch.engine import rounds


class PenaltyState(NamedTuple):
    w: dict                  # the parameter tree
    t: int
    gen: torch.Generator     # participation draws (CPU)


def penalty_init(params, seed: int = 0) -> PenaltyState:
    return PenaltyState(params, 0, torch.Generator().manual_seed(seed))


def penalty_config(rho: float, eps: float, lr: float, local_steps: int,
                   n_clients: int, m: int, proj_radius: float = 0.0,
                   participation: str = "mask",
                   client_chunk: int = 0) -> FedConfig:
    """The engine config equivalent of the penalty-FedAvg arguments
    (``client_chunk`` passes through; the port's clients run one after
    another whatever its value)."""
    return FedConfig(
        n_clients=n_clients, m=m, local_steps=local_steps, lr=lr,
        switch=SwitchConfig(mode="hard", eps=eps),
        uplink=CompressorConfig(kind="none"),
        downlink=CompressorConfig(kind="none"),
        proj_radius=proj_radius, track_wbar=False,
        strategy="penalty-fedavg", rho=rho, participation=participation,
        client_chunk=client_chunk)


def penalty_round(state: PenaltyState, batches, loss_pair: Callable,
                  rho: float, eps: float, lr: float, local_steps: int,
                  n_clients: int, m: int, proj_radius: float = 0.0,
                  participation: str = "mask", client_chunk: int = 0,
                  device="cuda"):
    """One penalty-FedAvg round on ``device`` (``cuda`` unless the caller
    asks for the CPU; the parameters must live there): E local steps on
    f + rho [g - eps]_+.  Returns ``(state, {"f", "g"})``, the all-client
    means at the pre-update iterate."""
    cfg = penalty_config(rho, eps, lr, local_steps, n_clients, m,
                         proj_radius, participation, client_chunk)
    spec = flat.spec_of(state.w)
    w = flat.flatten(spec, state.w)
    fstate = rounds.FedState(
        w=w, x=None, e_up=None, wbar_sum=None,
        wbar_weight=torch.zeros((), device=w.device), t=state.t,
        gen=state.gen, spec=spec)
    new, mets = rounds.round_step(fstate, batches, loss_pair, cfg,
                                  device=device)
    metrics = {"f": mets.f_full, "g": mets.g_full}
    return PenaltyState(flat.unflatten(spec, new.w), new.t, new.gen), metrics
