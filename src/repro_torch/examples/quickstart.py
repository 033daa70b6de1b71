"""Quickstart: Neyman-Pearson classification with FedSGM (paper Section 4;
port of ``examples/quickstart.py``).

The Figure-1 setting: n=20 clients, m=10 participating, E=5 local steps,
top-k compression K/d=0.1 with error feedback in both directions, hard and
soft switching, on a client fleet; then the Dirichlet label-skew sweep
(alpha 100, 1, 0.1) with the shard-size-weighted (unbiased) sampler and
fresh minibatches of 16 every round; then gather participation against
the dense mask simulation, bit for bit.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Runs on ``cuda`` unless given ``--device cpu``; without a card it raises.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import (CompressorConfig, FedConfig,
                                      FleetConfig, SwitchConfig)
from repro_torch.core import fedsgm, theory
from repro_torch.fleet import provision
from repro_torch.tasks import np_classification as npc


def fed_config(mode: str, eps: float, fleet: FleetConfig) -> FedConfig:
    return FedConfig(
        n_clients=20, m=10, local_steps=5, lr=0.1,
        switch=SwitchConfig(mode=mode, eps=eps, beta=theory.beta_min(eps)),
        uplink=CompressorConfig(kind="topk", ratio=0.1),
        downlink=CompressorConfig(kind="topk", ratio=0.1),
        fleet=fleet)


def _drive(fleet, cfg, T: int, dev, x_dim: int):
    """T rounds from zero weights on ``dev``; returns (state, metrics,
    seconds per round)."""
    params = npc.init_params(x_dim, device=dev)
    state = fedsgm.init_state(params, cfg, device=dev)
    t0 = time.perf_counter()
    state, hist = fedsgm.drive(state, fleet, npc.loss_pair, cfg, T=T,
                               device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return state, hist, (time.perf_counter() - t0) / T


def run(mode: str, T: int = 500, eps: float = 0.35, device="cuda") -> dict:
    """Figure-1 run on an IID fleet (uniform sampler, full shards)."""
    dev = resolve_device(device)
    cfg = fed_config(mode, eps, FleetConfig())
    fleet, (x_test, _) = npc.make_fleet(torch.Generator().manual_seed(0),
                                        cfg, device=dev)
    state, hist, spr = _drive(fleet, cfg, T, dev, x_test.shape[-1])
    wbar = fedsgm.averaged_iterate(state)
    xs, ys = fleet.data
    f_bar, g_bar = npc.loss_pair(wbar, (xs.reshape(-1, xs.shape[-1]),
                                        ys.reshape(-1)))
    res = {"mode": mode, "rounds": T, "f": float(hist.f[-1]),
           "g_hat": float(hist.g_hat[-1]), "f_wbar": float(f_bar),
           "g_wbar": float(g_bar), "mean_sigma": float(hist.sigma.mean()),
           "s_per_round": spr}
    print(f"[{mode:4s}] round {T}: f(w_t)={res['f']:.4f} "
          f"g_hat={res['g_hat']:.4f}  |  averaged iterate: "
          f"f(w_bar)={res['f_wbar']:.4f} g(w_bar)={res['g_wbar']:.4f} "
          f"(eps={eps}) mean sigma={res['mean_sigma']:.2f} "
          f"s/round={spr:.4f}", flush=True)
    info = fedsgm.round_bytes(npc.init_params(x_test.shape[-1], device=dev),
                              cfg)
    print(f"       uplink bytes/round/client: {info['uplink']} "
          f"({100 * info['savings_up']:.0f}% saved vs dense)", flush=True)
    return res


def fleet_demo(T: int = 200, eps: float = 0.35, device="cuda") -> list:
    """Dirichlet label skew at decreasing alpha with the shard-size-weighted
    sampler (Horvitz-Thompson reweighted: the aggregate stays unbiased for
    the data-weighted population objective) and 16 fresh rows per client
    and round."""
    dev = resolve_device(device)
    out = []
    for alpha in (100.0, 1.0, 0.1):
        fl = FleetConfig(partitioner="dirichlet", alpha=alpha,
                         batch_size=16, redraw=True, sampler="weighted")
        cfg = fed_config("soft", eps, fl)
        fleet, (x_test, _) = npc.make_fleet(
            torch.Generator().manual_seed(0), cfg, device=dev)
        state, hist, spr = _drive(fleet, cfg, T, dev, x_test.shape[-1])
        q = provision.data_weights(fleet)
        res = {"alpha": alpha, "rounds": T, "f": float(hist.f[-1]),
               "g_hat": float(hist.g_hat[-1]),
               "mean_sigma": float(hist.sigma.mean()),
               "shard_spread": float(q.max() / q.min()), "s_per_round": spr}
        print(f"[fleet] alpha={alpha:6.1f}: f={res['f']:.4f} "
              f"g_hat={res['g_hat']:+.4f} "
              f"mean sigma={res['mean_sigma']:.2f} "
              f"shard spread={res['shard_spread']:.1f}x "
              f"s/round={spr:.4f}", flush=True)
        out.append(res)
    return out


def engine_demo(T: int = 50, eps: float = 0.35, device="cuda") -> dict:
    """Gather participation against the dense mask simulation from the
    same fleet, seeds and minibatch streams: the final weights bit-equal,
    while the 10 clients not sampled run no local steps in gather mode."""
    dev = resolve_device(device)
    base = fed_config("soft", eps, FleetConfig(batch_size=16, redraw=True))
    fleet, (x_test, _) = npc.make_fleet(torch.Generator().manual_seed(0),
                                        base, device=dev)
    finals, spr = {}, {}
    for part in ("mask", "gather"):
        cfg = base.replace(participation=part)
        state, _, spr[part] = _drive(fleet, cfg, T, dev, x_test.shape[-1])
        finals[part] = state.w
    same = torch.equal(finals["mask"].view(torch.int32),
                       finals["gather"].view(torch.int32))
    print(f"[engine] gather == mask after {T} rounds: {same} "
          "(local steps and EF state over m=10, not n=20) "
          f"s/round mask={spr['mask']:.4f} gather={spr['gather']:.4f}",
          flush=True)
    return {"rounds": T, "gather_equals_mask": same,
            "s_per_round": spr}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    dev = resolve_device(ap.parse_args(argv).device)
    print("== FedSGM quickstart: NP classification (breast-cancer-like) ==",
          flush=True)
    out = {"figure1": [run(mode, device=dev) for mode in ("hard", "soft")],
           "sweep": fleet_demo(device=dev), "engine": engine_demo(device=dev)}
    if not out["engine"]["gather_equals_mask"]:
        raise AssertionError("gather and mask rounds differ")
    return out


if __name__ == "__main__":
    main()
