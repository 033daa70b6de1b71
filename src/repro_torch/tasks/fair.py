"""Fair classification with a demographic-parity constraint (paper Appendix
F.3; port of ``repro.tasks.fair``).

f_j = binary cross-entropy on client j's data;
g_j = |mean sigmoid(logit | protected) - mean sigmoid(logit | unprotected)|
      - eps_dp, as the smooth surrogate sqrt(x^2 + 1e-8).

A batch is the plain tuple ``(x, y, a)``: features, labels and the
protected attribute (0/1 floats).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.data import synthetic


def init_params(gen: torch.Generator, d: int, hidden: int = 32,
                device="cuda") -> dict:
    """A one-hidden-layer MLP, weights normal / sqrt(fan-in) from the CPU
    generator ``gen``, on ``device`` (``cuda`` unless asked for the CPU)."""
    dev = resolve_device(device)
    w1 = torch.randn((d, hidden), generator=gen) / np.sqrt(d)
    w2 = torch.randn((hidden, 1), generator=gen) / np.sqrt(hidden)
    return {"w1": w1.to(dev), "b1": torch.zeros(hidden, device=dev),
            "w2": w2.to(dev), "b2": torch.zeros((), device=dev)}


def predict(params, x):
    h = torch.tanh(x @ params["w1"] + params["b1"])
    return (h @ params["w2"])[..., 0] + params["b2"]


def _group_means(p, a):
    mp = torch.sum(p * a) / torch.clamp(torch.sum(a), min=1.0)
    mu = torch.sum(p * (1 - a)) / torch.clamp(torch.sum(1 - a), min=1.0)
    return mp, mu


def _abs(x):
    """|x| whose gradient at 0 is +1, as the reference's ``jnp.abs`` (the
    BCE's gradient at a logit of exactly 0 depends on it)."""
    return torch.where(x >= 0, x, -x)


def loss_pair_builder(dp_budget: float = 0.0):
    def loss_pair(params, batch):
        x, y, a = batch
        logits = predict(params, x)
        # maximum, not clamp: at a logit of 0 its gradient splits 1/2 : 1/2,
        # as the reference's jnp.maximum does
        bce = torch.mean(torch.maximum(logits, torch.zeros_like(logits))
                         - logits * y
                         + torch.log1p(torch.exp(-_abs(logits))))
        mp, mu = _group_means(torch.sigmoid(logits), a)
        # smooth |.|: sqrt(x^2 + delta) keeps subgradients stable at 0
        dp = torch.sqrt((mp - mu) ** 2 + 1e-8)
        return bce, dp - dp_budget
    return loss_pair


def demographic_parity(params, x, y, a) -> float:
    with torch.no_grad():
        mp, mu = _group_means(torch.sigmoid(predict(params, x)), a)
    return float(torch.abs(mp - mu))


def split_by_protected(x, y, a, n_clients: int):
    """The heterogeneous client split: rows sorted by the protected
    attribute plus numpy noise (``default_rng(0)``) and dealt out in equal
    contiguous blocks.  ``([n, per, ...] x, y, a)`` as tensors on the
    data's device."""
    xn, yn, an = (np.asarray(v.cpu()) for v in (x, y, a))
    n = xn.shape[0]
    per = n // n_clients
    rng = np.random.default_rng(0)
    order = np.argsort(an + 0.3 * rng.standard_normal(n))
    idx = np.stack([order[j * per:(j + 1) * per] for j in range(n_clients)])
    return tuple(torch.from_numpy(v[idx]).to(x.device) for v in (xn, yn, an))


def make_dataset(gen: torch.Generator, n_clients: int, device="cuda"):
    """The adult-like data from the CPU generator ``gen``, split over
    ``n_clients`` by :func:`split_by_protected`.  Returns ``((xs, ys, as_)
    stacked, (x, y, a))`` on ``device``."""
    x, y, a = synthetic.adult_like(gen, device=resolve_device(device))
    return split_by_protected(x, y, a, n_clients), (x, y, a)


def make_fleet(gen: torch.Generator, cfg, device="cuda"):
    """Client population per ``cfg.fleet`` (``repro_torch.fleet``), skewed
    over the *protected attribute*: the Dirichlet partitioner's labels are
    the group memberships a, so low alpha concentrates protected-group
    members on few clients.  Data and partition from the CPU generator
    ``gen``.  Returns ``(fleet, (x, y, a))`` on ``device``."""
    from repro_torch.fleet import provision
    x, y, a = synthetic.adult_like(gen, device=resolve_device(device))
    fleet = provision.build_fleet(gen, (x, y, a), cfg, labels=a)
    return fleet, (x, y, a)
