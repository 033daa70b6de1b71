"""Synthetic LM token streams (port of the LM part of
``repro.data.synthetic``).  Draws come from a ``torch.Generator``: the same
distribution as the reference, not the same bits."""
from __future__ import annotations

import torch


def token_stream(gen: torch.Generator, batch: int, seq_len: int, vocab: int,
                 minority_frac: float = 0.125, zipf_a: float = 1.2,
                 device=None):
    """Zipf tokens + a copied induction span; the last ``minority_frac`` of
    each sequence is drawn from the rare half of the vocabulary (the
    constraint slice).  Returns (tokens int64 ``[B, S]``, minority mask
    float32 ``[B, S]``)."""
    ranks = torch.arange(1, vocab + 1, dtype=torch.float32, device=device)
    probs = ranks ** (-zipf_a)
    probs = probs / probs.sum()
    toks = torch.multinomial(probs, batch * seq_len, replacement=True,
                             generator=gen).reshape(batch, seq_len)
    span = max(1, seq_len // 8)
    toks[:, span:2 * span] = toks[:, :span]
    m = max(1, int(seq_len * minority_frac))
    toks[:, -m:] = torch.randint(vocab // 2, vocab, (batch, m), generator=gen,
                                 device=device)
    mask = torch.zeros((batch, seq_len), dtype=torch.float32, device=device)
    mask[:, -m:] = 1.0
    return toks, mask


def client_token_batches(gen: torch.Generator, n_clients: int,
                         batch_per_client: int, seq_len: int, vocab: int,
                         hetero: float = 0.0, device=None):
    """Per-client token batches ``[n, B, S]`` with a per-client Zipf shift."""
    zipfs = 1.2 + hetero * torch.linspace(-0.3, 0.3, n_clients)
    toks, masks = [], []
    for j in range(n_clients):
        t, m = token_stream(gen, batch_per_client, seq_len, vocab,
                            zipf_a=float(zipfs[j]), device=device)
        toks.append(t)
        masks.append(m)
    return torch.stack(toks), torch.stack(masks)
