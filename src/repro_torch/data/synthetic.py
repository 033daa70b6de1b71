"""Synthetic data generators (port of ``repro.data.synthetic``).  Draws
come from a ``torch.Generator``: the same distributions as the reference,
not the same bits.

* ``breast_cancer_like`` -- 2-class Gaussian tabular data of the UCI
  breast-cancer shape (569 x 30) and imbalance (~63%/37%),
* ``adult_like`` -- tabular data with a binary protected attribute,
* ``partition_*`` -- IID and Dirichlet label-skew client splits (the
  latter a shim over ``repro_torch.fleet.partitions``),
* ``token_stream`` / ``client_token_batches`` -- Zipf LM tokens with a
  rare-token minority slice.

Every generator draws on the CPU, from a CPU ``torch.Generator``, and moves
the result to ``device``: the same data on the card and on the CPU, run
after run.  ``token_stream`` refuses a generator on the card, whose token
draws do not reproduce bit for bit: on an H100, ``torch.cumsum`` over the
49,152 Zipf probabilities does not give the same bits call after call, and
the with-replacement ``multinomial`` samples from such a cumulative sum, so
a draw next to a category boundary can change its token (``chip_smoke.py``
phase 6 measures each step of that draw).
"""
from __future__ import annotations

import torch


def breast_cancer_like(gen: torch.Generator, n: int = 569, d: int = 30,
                       sep: float = 0.35, flip: float = 0.08, device=None):
    """2-class Gaussians with overlap + label noise; label 1 is the
    minority.  Returns (x float32 ``[n, d]``, y float32 ``[n]``)."""
    n1 = int(0.37 * n)
    n0 = n - n1
    mu = torch.randn(d, generator=gen) * sep
    x0 = torch.randn((n0, d), generator=gen) - mu
    x1 = torch.randn((n1, d), generator=gen) * 1.3 + mu
    x = torch.cat([x0, x1])
    y = torch.cat([torch.zeros(n0), torch.ones(n1)])
    flips = torch.rand(n, generator=gen) < flip
    y = torch.where(flips, 1.0 - y, y)
    perm = torch.randperm(n, generator=gen)
    return x[perm].to(device), y[perm].to(device)


def adult_like(gen: torch.Generator, n: int = 2000, d: int = 24,
               device=None):
    """Tabular data with a protected attribute a in {0, 1} and an
    income-like label.  Returns (x ``[n, d + 1]``, y ``[n]``, a ``[n]``)."""
    a = (torch.rand(n, generator=gen) < 0.33).to(torch.float32)
    base = torch.randn((n, d), generator=gen)
    w_true = torch.linspace(1.0, -1.0, d)
    logits = base @ w_true + 0.8 * a - 0.3
    y = (logits + 0.5 * torch.randn(n, generator=gen) > 0).to(torch.float32)
    x = torch.cat([base, a[:, None]], dim=-1)
    return x.to(device), y.to(device), a.to(device)


def partition_iid(gen: torch.Generator, x, y, n_clients: int):
    """Equal-size IID split: ``[n_clients, per, ...]`` (the remainder is
    dropped)."""
    n = x.shape[0]
    per = n // n_clients
    perm = torch.randperm(n, generator=gen)[: per * n_clients].to(x.device)
    return (x[perm].reshape(n_clients, per, -1),
            y[perm].reshape(n_clients, per))


def partition_dirichlet(gen: torch.Generator, x, y, n_clients: int,
                        alpha: float = 2.0):
    """Label-Dirichlet heterogeneous split, equal sizes (the balanced
    re-slice of ``fleet.partitions.dirichlet_core``): an exact partition,
    no row twice."""
    from repro_torch.fleet import partitions
    labels = y.cpu().to(torch.int64)
    C = partitions.infer_n_classes(labels)
    cp = partitions.dirichlet_core(
        partitions.dirichlet(gen, alpha, C, n_clients), labels, n_clients,
        C, cap=x.shape[0], balance=True)
    idx = cp.idx.to(x.device)
    return x[idx], y[idx]


def token_stream(gen: torch.Generator, batch: int, seq_len: int, vocab: int,
                 minority_frac: float = 0.125, zipf_a: float = 1.2,
                 device=None):
    """Zipf tokens + a copied induction span; the last ``minority_frac`` of
    each sequence is drawn from the rare half of the vocabulary (the
    constraint slice).  Returns (tokens int64 ``[B, S]``, minority mask
    float32 ``[B, S]``) on ``device``."""
    if gen.device.type != "cpu":
        raise ValueError("token_stream draws from a CPU generator (the "
                         "card's token draws are not reproducible)")
    ranks = torch.arange(1, vocab + 1, dtype=torch.float32)
    probs = ranks ** (-zipf_a)
    probs = probs / probs.sum()
    toks = torch.multinomial(probs, batch * seq_len, replacement=True,
                             generator=gen).reshape(batch, seq_len)
    span = max(1, seq_len // 8)
    toks[:, span:2 * span] = toks[:, :span]
    m = max(1, int(seq_len * minority_frac))
    toks[:, -m:] = torch.randint(vocab // 2, vocab, (batch, m), generator=gen)
    mask = torch.zeros((batch, seq_len), dtype=torch.float32, device=device)
    mask[:, -m:] = 1.0
    return toks.to(device), mask


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
