"""End-to-end example: federated constrained LM training with FedSGM (port of
``examples/train_lm_federated.py``).

Trains a transformer LM (a tiny smollm-family model by default; ``--preset
100m`` for the ~100M-parameter config) for FedSGM rounds on synthetic
heterogeneous token streams.  The functional constraint keeps the
minority-domain (rare-token) cross entropy under a budget while minimizing
the majority CE.  The wire is the packed one: top-k 0.1 up and 0.25 down
in blocks of 2048.

    PYTHONPATH=src python -m repro_torch.examples.train_lm_federated \\
        [--rounds 200] [--preset tiny|100m] [--device cpu]

Runs on ``cuda`` unless given ``--device cpu``; without a card it raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import configs, resolve_device
from repro_torch.comm import flat
from repro_torch.configs.base import CompressorConfig, FedConfig, SwitchConfig
from repro_torch.core import fedsgm
from repro_torch.data import synthetic
from repro_torch.models import build
from repro_torch.tasks import lm


def get_cfg(preset: str):
    if preset == "tiny":
        return dataclasses.replace(
            configs.get_reduced("smollm-360m"),
            n_layers=2, d_model=128, d_ff=256, vocab=512)
    if preset == "100m":
        # ~100M-parameter smollm-family config
        return dataclasses.replace(
            configs.get_config("smollm-360m"), n_layers=12, d_model=768,
            d_ff=2048, n_heads=12, n_kv_heads=4, vocab=32000)
    raise ValueError(preset)


def fed_config(n: int = 8) -> FedConfig:
    return FedConfig(
        n_clients=n, m=max(1, (3 * n) // 4), local_steps=2, lr=0.05,
        switch=SwitchConfig(mode="soft", eps=0.0, beta=2.0),
        uplink=CompressorConfig(kind="topk", ratio=0.1, block=2048),
        downlink=CompressorConfig(kind="topk", ratio=0.25, block=2048),
        comm="packed")


def main(rounds: int = 200, preset: str = "tiny", n: int = 8, seq: int = 64,
         b: int = 4, chunk: int = 25, device="cuda") -> dict:
    """``rounds`` rounds in chunks of ``chunk`` (one line per chunk).
    Returns the last chunk's metrics, the wire bytes and each chunk's
    s/round."""
    dev = resolve_device(device)
    cfg = get_cfg(preset)
    fns = build(cfg)
    params = fns.init(torch.Generator(device=dev).manual_seed(0), cfg,
                      device=dev)
    n_params = flat.spec_of(params).d
    print(f"model: {cfg.name} preset={preset} params={n_params/1e6:.2f}M",
          flush=True)
    fed = fed_config(n)
    loss_pair = lm.make_loss_pair(fns.forward, cfg, budget=5.5)
    info = fedsgm.round_bytes(params, fed)
    state = fedsgm.init_state(params, fed, device=dev)
    del params                  # the state's flat buffer is the model now

    def batch_fn(t, g):
        toks, mask = synthetic.client_token_batches(
            g, n, b, seq, cfg.vocab, hetero=1.0, device=dev)
        return lm.LMBatch(tokens=toks, minority_mask=mask)

    T = min(chunk, rounds)
    t0 = time.time()
    chunk_spr = []
    for c in range((rounds + T - 1) // T):
        t1 = time.time()
        state, hist = fedsgm.run_rounds(state, batch_fn, loss_pair, fed, T=T,
                                        device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        chunk_spr.append((time.time() - t1) / T)
        spr = (time.time() - t0) / (T * (c + 1))
        print(f"round {T * (c + 1):4d}: majority CE={float(hist.f[-1]):.3f} "
              f"minority gap g={float(hist.g_hat[-1]):+.3f} "
              f"sigma={float(hist.sigma[-1]):.2f} ({spr:.2f}s/round)",
              flush=True)
    print(f"uplink: {info['uplink']/1e3:.0f}kB/round/client "
          f"({100*info['savings_up']:.0f}% saved); "
          f"downlink {info['downlink']/1e3:.0f}kB", flush=True)
    return {"n_params": n_params, "f": hist.f.tolist(),
            "g_hat": hist.g_hat.tolist(), "sigma": hist.sigma.tolist(),
            "s_per_round": chunk_spr, "bytes": info}


def cli(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--preset", default="tiny", choices=["tiny", "100m"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    return main(args.rounds, args.preset, device=args.device)


if __name__ == "__main__":
    cli()
