"""Language-model task for FedSGM (port of ``repro.tasks.lm``).

The objective f is next-token CE on ordinary tokens; the constraint g is CE
on the minority slice (rare-token domain) minus a budget, or for MoE
models the router's load imbalance minus the budget (``aux_constraint``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import common


class LMBatch(NamedTuple):
    tokens: torch.Tensor          # [B, S] (or [n, B, S] stacked) integer
    minority_mask: torch.Tensor   # same shape, float32 (1 = constraint slice)
    media: Optional[torch.Tensor] = None  # [B, M, d_media or d] (or
                                  # [n, B, M, ...]) stub embeddings of the
                                  # vlm / audio frontends; None: tokens only


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


def make_loss_pair(model_forward, cfg: ModelConfig, budget: float = 0.0,
                   aux_constraint: bool = False, mtp_weight: float = 0.3):
    """``loss_pair(params, batch) -> (f, g)`` scalars for ``round_step``.

    A forward may return ``(logits, aux)`` or ``(logits, aux,
    mtp_logits)`` (the moe family); the MTP logits at t predict token
    t+2 and add ``mtp_weight`` times their CE to f.  ``aux_constraint``
    makes g the model's aux scalar (the MoE load imbalance) minus
    ``budget``.  A batch with ``media`` passes it to the forward."""

    def loss_pair(params, batch: LMBatch):
        kwargs = {}
        if batch.media is not None:
            kwargs["media"] = batch.media
        out = model_forward(params, cfg, batch.tokens, **kwargs)
        aux, mtp_logits = None, None
        if isinstance(out, tuple):
            if len(out) == 3:
                out, aux, mtp_logits = out
            else:
                out, aux = out
        out = out[:, :-1]
        targets = batch.tokens[:, 1:]
        mmask = batch.minority_mask[:, 1:]
        # under a split plan the logits are this model rank's vocab block
        lo = common.vocab_block(cfg.vocab, out.shape[-1])
        f = common.cross_entropy(out, targets, mask=1.0 - mmask,
                                 vocab_lo=lo)
        if mtp_logits is not None:
            f = f + mtp_weight * common.cross_entropy(mtp_logits[:, :-1],
                                                      targets[:, 1:])
        if aux_constraint and aux is not None:
            g = aux - budget
        else:
            g = common.cross_entropy(out, targets, mask=mmask,
                                     vocab_lo=lo) - budget
        return f, g

    return loss_pair
