"""Fair classification with demographic parity (paper Appendix F.3; port of
``examples/fair_classification.py``): FedSGM vs penalty-based FedAvg on
adult-like data, with the client population built as a non-IID fleet: the
Dirichlet partitioner skews clients over the *protected attribute* (low
alpha packs protected-group members onto few clients) and the
shard-size-weighted sampler keeps the aggregate unbiased under the
resulting ragged shards.

    PYTHONPATH=src python -m repro_torch.examples.fair_classification \\
        [--rounds 300] [--device cpu]

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
from repro_torch.core import baselines, fedsgm
from repro_torch.tasks import fair


def fed_config(alpha: float, n: int = 10, m: int = 5,
               eps: float = 0.05) -> FedConfig:
    fl = FleetConfig(partitioner="dirichlet", alpha=alpha, batch_size=32,
                     redraw=True, sampler="weighted")
    return FedConfig(n_clients=n, m=m, local_steps=2, lr=0.05,
                     switch=SwitchConfig(mode="soft", eps=eps, beta=2 / eps),
                     uplink=CompressorConfig(kind="topk", ratio=0.25),
                     downlink=CompressorConfig(kind="none"), fleet=fl)


def main(T: int = 300, n: int = 10, m: int = 5, eps: float = 0.05,
         device="cuda") -> dict:
    """FedSGM at alpha 10 and 0.5, then the penalty baseline at rho 0.1, 1
    and 10, T rounds each.  Returns the records."""
    dev = resolve_device(device)
    loss_pair = fair.loss_pair_builder(dp_budget=0.0)
    out = {"fedsgm": [], "penalty": []}

    for alpha in (10.0, 0.5):
        cfg = fed_config(alpha, n, m, eps)
        fleet, (x, y, a) = fair.make_fleet(torch.Generator().manual_seed(0),
                                           cfg, device=dev)
        params0 = fair.init_params(torch.Generator().manual_seed(0),
                                   x.shape[-1], device=dev)
        state = fedsgm.init_state(params0, cfg, device=dev)
        t0 = time.perf_counter()
        state, hist = fedsgm.drive(state, fleet, loss_pair, cfg, T=T,
                                   device=dev)
        spr = (time.perf_counter() - t0) / T
        dp = fair.demographic_parity(flat.unflatten(state.spec, state.w),
                                     x, y, a)
        rec = {"alpha": alpha, "bce": float(hist.f[-1]), "dp": dp,
               "s_per_round": spr}
        print(f"FedSGM[alpha={alpha:4.1f}]  bce={rec['bce']:.4f} "
              f"DP violation={dp:.4f} (eps={eps}, weighted sampler) "
              f"s/round={spr:.4f}", flush=True)
        out["fedsgm"].append(rec)

    # penalty baseline (rho-tuning instability, Fig. 6/7) on the sort-based
    # heterogeneous split -- a different draw of the same adult-like
    # distribution, so compare the rho sweep's *spread* with the FedSGM
    # rows, not line-for-line values
    (xs, ys, as_), (x, y, a) = fair.make_dataset(
        torch.Generator().manual_seed(0), n, device=dev)
    params0 = fair.init_params(torch.Generator().manual_seed(0), x.shape[-1],
                               device=dev)
    for rho in (0.1, 1.0, 10.0):
        st = baselines.penalty_init(params0)
        t0 = time.perf_counter()
        for _ in range(T):
            st, mx = baselines.penalty_round(
                st, (xs, ys, as_), loss_pair, rho=rho, eps=eps, lr=0.05,
                local_steps=2, n_clients=n, m=m, device=dev)
        spr = (time.perf_counter() - t0) / T
        dp = fair.demographic_parity(st.w, x, y, a)
        rec = {"rho": rho, "bce": float(mx["f"]), "dp": dp,
               "s_per_round": spr}
        print(f"penalty-FedAvg rho={rho:5.1f}  bce={rec['bce']:.4f} "
              f"DP violation={dp:.4f} s/round={spr:.4f}", flush=True)
        out["penalty"].append(rec)
    return out


def cli(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=300)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    return main(args.rounds, device=args.device)


if __name__ == "__main__":
    cli()
