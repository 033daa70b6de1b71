"""Language-model task for FedSGM (port of ``repro.tasks.lm``, dense path).

The objective f is next-token CE on ordinary tokens; the constraint g is CE
on the minority slice (rare-token domain) minus a budget.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import common


class LMBatch(NamedTuple):
    tokens: torch.Tensor          # [B, S] (or [n, B, S] stacked) integer
    minority_mask: torch.Tensor   # same shape, float32 (1 = constraint slice)


def make_fleet(gen: torch.Generator, fed_cfg, pool: int, seq_len: int,
               vocab: int, hetero: float = 0.5, device="cuda"):
    """Client population for LM training: each client holds ``pool`` token
    sequences of its own Zipf-shifted stream (``hetero`` spreads the
    exponent across clients), drawn from the CPU generator ``gen`` and kept
    on ``device``; each round provisions ``fed_cfg.fleet.batch_size`` of
    them per client."""
    from repro_torch.data import synthetic
    from repro_torch.fleet import provision
    toks, mask = synthetic.client_token_batches(
        gen, fed_cfg.n_clients, pool, seq_len, vocab, hetero=hetero,
        device=resolve_device(device))
    return provision.from_stacked(LMBatch(tokens=toks, minority_mask=mask))


def make_loss_pair(model_forward, cfg: ModelConfig, budget: float = 0.0):
    """``loss_pair(params, batch) -> (f, g)`` scalars for ``round_step``."""

    def loss_pair(params, batch: LMBatch):
        out = model_forward(params, cfg, batch.tokens)[:, :-1]
        targets = batch.tokens[:, 1:]
        mmask = batch.minority_mask[:, 1:]
        f = common.cross_entropy(out, targets, mask=1.0 - mmask)
        g = common.cross_entropy(out, targets, mask=mmask) - budget
        return f, g

    return loss_pair
