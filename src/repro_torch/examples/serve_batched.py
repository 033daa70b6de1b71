"""Batched serving demo: prefill a batch of prompts, then decode tokens
greedily with any arch's reduced config (port of
``examples/serve_batched.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_batched \\
        --arch gemma3-4b --steps 16 --device cpu

Runs on ``cuda`` unless given ``--device cpu``; without a card it raises.
Weights are drawn on the device's generator, prompts and media on a CPU
generator (:func:`repro_torch.launch.serve.draw_inputs`).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs, resolve_device
from repro_torch.launch.serve import draw_inputs, greedy, synchronize
from repro_torch.models import build


def main(arch: str = "gemma3-4b", batch: int = 4, prompt_len: int = 16,
         steps: int = 16, device="cuda") -> torch.Tensor:
    """Prints the prefill's shapes, the decode's ms/step and the first
    sequence's first 12 tokens; returns the decoded tokens ``[batch,
    steps + 1]``."""
    cfg = configs.get_reduced(arch)
    fns = build(cfg)
    dev = resolve_device(device)
    params = fns.init(torch.Generator(device=dev).manual_seed(0), cfg,
                      device=dev)
    prompts, kw = draw_inputs(cfg, batch, prompt_len, dev)

    cap = prompt_len + steps
    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, cache = fns.prefill(params, cfg, prompts, cap, **kw)
        synchronize(dev)
        print(f"[{arch}] prefill {tuple(prompts.shape)} -> logits "
              f"{tuple(logits.shape)} ({time.perf_counter() - t0:.2f}s)")
        tok = greedy(logits)
        out = [tok]
        t0 = time.perf_counter()
        for i in range(steps):
            logits, cache = fns.decode_step(params, cfg, tok, cache,
                                            prompt_len + i)
            tok = greedy(logits)
            out.append(tok)
        synchronize(dev)
    dt = time.perf_counter() - t0
    gen = torch.cat(out, dim=1)
    print(f"decoded {steps} steps x batch {batch}: "
          f"{1000 * dt / max(steps, 1):.1f} ms/step ({dev.type}, reduced "
          f"config)")
    print("sample tokens:", gen[0, :12].tolist())
    return gen


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-4b",
                    choices=sorted(configs.ALIASES))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    main(args.arch, args.batch, args.prompt_len, args.steps, args.device)
