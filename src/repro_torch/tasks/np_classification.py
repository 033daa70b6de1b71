"""Neyman-Pearson classification (paper Section 4 / F.2; port of
``repro.tasks.np_classification``).

    min f(w) = majority-class logistic loss   s.t.   g(w) = minority loss <= eps

Each client j holds local class-0 / class-1 rows; f_j and g_j are the
per-class mean logistic losses, and ``loss_pair`` returns g_j itself (the
switching rule compares it with eps).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.data import synthetic


class NPBatch(NamedTuple):
    x: torch.Tensor     # [n_clients, per, d] (or [per, d])
    y: torch.Tensor     # [n_clients, per] (or [per]), float 0/1 labels


def init_params(d: int, device="cuda") -> dict:
    """Zero weights and bias on ``device`` (``cuda`` unless asked for the
    CPU)."""
    dev = resolve_device(device)
    return {"w": torch.zeros(d, device=dev), "b": torch.zeros((), device=dev)}


def _logistic(params, x, y):
    logits = x @ params["w"] + params["b"]
    # softplus as log(1 + e^z) everywhere: F.softplus switches to the
    # identity above its threshold, the reference's softplus does not
    return torch.logaddexp(logits, torch.zeros_like(logits)) - logits * y


def loss_pair(params, batch):
    """(f_j, g_j): mean loss on class 0 (majority) and class 1
    (minority)."""
    x, y = batch
    per_ex = _logistic(params, x, y)
    m0 = (y == 0).to(torch.float32)
    m1 = (y == 1).to(torch.float32)
    f = torch.sum(per_ex * m0) / torch.clamp(torch.sum(m0), min=1.0)
    g = torch.sum(per_ex * m1) / torch.clamp(torch.sum(m1), min=1.0)
    return f, g


def make_dataset(gen: torch.Generator, n_clients: int, hetero: bool = False,
                 device="cuda"):
    """The breast-cancer-like data split 80/20, the train part partitioned
    over ``n_clients`` (IID, or Dirichlet label skew with ``hetero``), all
    drawn from the CPU generator ``gen``.  Returns ``(NPBatch([n, per, d],
    [n, per]), (x_test, y_test))`` on ``device``."""
    dev = resolve_device(device)
    x, y = synthetic.breast_cancer_like(gen, device=dev)
    n_train = int(0.8 * x.shape[0])
    xt, yt = x[:n_train], y[:n_train]
    split = synthetic.partition_dirichlet if hetero else \
        synthetic.partition_iid
    xs, ys = split(gen, xt, yt, n_clients)
    return NPBatch(xs, ys), (x[n_train:], y[n_train:])


def make_fleet(gen: torch.Generator, cfg, test_frac: float = 0.2,
               device="cuda"):
    """Client population per ``cfg.fleet``: the breast-cancer-like train
    split partitioned by the configured law (IID / Dirichlet label skew /
    Zipf quantity skew / feature shift) into a Fleet on ``device``, all
    drawn from the CPU generator ``gen``.  Returns ``(fleet, (x_test,
    y_test))``."""
    from repro_torch.fleet import provision
    dev = resolve_device(device)
    x, y = synthetic.breast_cancer_like(gen, device=dev)
    n_train = int((1.0 - test_frac) * x.shape[0])
    xt, yt = x[:n_train], y[:n_train]
    fleet = provision.build_fleet(gen, NPBatch(xt, yt), cfg, labels=yt)
    return fleet, (x[n_train:], y[n_train:])
