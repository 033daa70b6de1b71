"""Serving launcher: batched prefill, then greedy one-token decode over
each family's preallocated cache (KV, cross-KV, MLA latents, conv windows
and recurrent states), on one device (port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b \\
        --reduced --batch 4 --prompt-len 32 --steps 8 --device cpu
    # full published width on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \\
        --no-reduced --batch 4 --prompt-len 512 --steps 32

Serves every arch of every family.  The reference serves the reduced
config on one device; the port runs on one device, so ``--reduced`` is
the default and ``--no-reduced`` serves the full config.  Runs on
``cuda`` unless given ``--device cpu``; without a card it raises.
Weights are drawn on the device's generator (as the training launcher's
are), prompts and media (``normal * 0.1``) on a CPU generator seeded 0
and then moved.  Prints ``[name] batch=B decode X
ms/step``: the decode loop's wall time between two synchronisations of
the device, over ``--steps``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs, resolve_device
from repro_torch.models import build


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b",
                    choices=sorted(configs.ALIASES))
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="the reduced config (the default on one device, "
                         "as in the reference)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def draw_inputs(cfg, batch: int, prompt_len: int, dev: torch.device) -> tuple:
    """Prompts ``[batch, prompt_len]`` and, for the vlm and audio families,
    media ``[batch, n_media_tokens or n_audio_frames, d_media or d]``
    (``normal * 0.1``), drawn on a CPU generator seeded 0 and moved to
    ``dev``: ``(prompts, prefill keywords)``."""
    gen = torch.Generator().manual_seed(0)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen)
    kw = {}
    if cfg.family in ("vlm", "audio"):
        M = cfg.n_media_tokens or cfg.n_audio_frames
        kw["media"] = (torch.randn((batch, M, cfg.d_media or cfg.d_model),
                                   generator=gen) * 0.1).to(dev)
    return prompts.to(dev), kw


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """The next token ``[B, 1]`` of the last position's logits."""
    return logits[:, -1].argmax(dim=-1)[:, None]


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    cfg = configs.get_reduced(args.arch) if args.reduced \
        else configs.get_config(args.arch)
    fns = build(cfg)
    dev = resolve_device(args.device)
    params = fns.init(torch.Generator(device=dev).manual_seed(0), cfg,
                      device=dev)
    prompts, kw = draw_inputs(cfg, args.batch, args.prompt_len, dev)
    cap = args.prompt_len + args.steps
    with torch.inference_mode():
        logits, cache = fns.prefill(params, cfg, prompts, cap, **kw)
        tok = greedy(logits)
        synchronize(dev)
        t0 = time.perf_counter()
        for i in range(args.steps):
            logits, cache = fns.decode_step(params, cfg, tok, cache,
                                            args.prompt_len + i)
            tok = greedy(logits)
        synchronize(dev)
    ms = (time.perf_counter() - t0) / max(args.steps, 1) * 1e3
    print(f"[{cfg.name}] batch={args.batch} decode {ms:.1f} ms/step")
    return {"arch": cfg.name, "batch": args.batch, "decode_ms": ms,
            "device": str(dev)}


if __name__ == "__main__":
    main()
