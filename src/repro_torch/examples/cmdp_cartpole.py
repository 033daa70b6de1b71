"""Federated CMDP: safety-constrained Cartpole with per-client budgets
(paper Section 4, Figure 3/4; port of ``examples/cmdp_cartpole.py``).
n=10 clients with budgets d_i in [25, 35], soft switching, Top-K K/d=0.5
compression, 70% participation.

The client population is a fleet (``repro_torch.fleet``): each client's
shard is a pool of rollout draws + its budget, provisioned one row per
round (``batch_size=1``, ``redraw``), and participation follows the Markov
availability sampler: clients drop out and return in time-correlated
streaks.

    PYTHONPATH=src python -m repro_torch.examples.cmdp_cartpole \\
        [--rounds 300] [--horizon 200] [--device cpu]

Runs on ``cuda`` unless given ``--device cpu``; without a card it raises.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.comm import flat
from repro_torch.configs.base import (CompressorConfig, FedConfig,
                                      FleetConfig, SwitchConfig)
from repro_torch.core import fedsgm
from repro_torch.tasks import cmdp

N_EPISODES = 5


def fed_config(n: int = 10, participation: float = 0.7) -> FedConfig:
    return FedConfig(
        n_clients=n, m=max(1, int(participation * n)), local_steps=1,
        lr=3e-4, switch=SwitchConfig(mode="soft", eps=0.0, beta=1.0),
        uplink=CompressorConfig(kind="topk", ratio=0.5),
        downlink=CompressorConfig(kind="none"),
        fleet=FleetConfig(sampler="markov", avail_stay=0.85,
                          avail_return=0.6, batch_size=1, redraw=True))


def main(rounds: int = 300, n: int = 10, participation: float = 0.7,
         horizon: int = 200, chunk: int = 50, pool: int = 256,
         device="cuda") -> list:
    """``rounds`` FedSGM rounds in chunks of ``chunk``, each chunk followed
    by ``eval_policy`` on 10 fresh episodes.  Returns one record per
    chunk."""
    dev = resolve_device(device)
    params = cmdp.init_params(torch.Generator().manual_seed(0), device=dev)
    loss_pair = cmdp.fleet_loss_pair(n_episodes=N_EPISODES, horizon=horizon)
    cfg = fed_config(n, participation)
    fleet = cmdp.make_fleet(torch.Generator().manual_seed(1), cfg, pool=pool,
                            n_episodes=N_EPISODES, horizon=horizon,
                            device=dev)
    state = fedsgm.init_state(params, cfg, device=dev)
    out = []
    for c in range(max(rounds // chunk, 1)):
        t0 = time.perf_counter()
        state, hist = fedsgm.drive(state, fleet, loss_pair, cfg,
                                   T=min(chunk, rounds), device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        spr = (time.perf_counter() - t0) / min(chunk, rounds)
        ev = cmdp.eval_policy(flat.unflatten(state.spec, state.w),
                              torch.Generator().manual_seed(c + 1), 10,
                              horizon)
        rec = {"round": state.t, "reward": ev["reward"], "cost": ev["cost"],
               "sigma": float(hist.sigma[-1]), "s_per_round": spr}
        print(f"round {rec['round']:4d}: episodic reward={ev['reward']:6.1f} "
              f"cost={ev['cost']:5.1f} (budget 30) "
              f"sigma={rec['sigma']:.2f} s/round={spr:.3f}", flush=True)
        out.append(rec)
    return out


def cli(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=300)
    ap.add_argument("--horizon", type=int, default=200)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    return main(args.rounds, horizon=args.horizon, device=args.device)


if __name__ == "__main__":
    cli()
