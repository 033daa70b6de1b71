"""Weakly-convex FedSGM extension (paper Appendix E, Theorem 10; port of
``repro.core.weakly_convex``).

For rho-weakly-convex f (convex g), convergence is measured by the proximal
stationarity ||w_t - w_hat(w_t)|| where w_hat solves the constrained
proximal subproblem

    w_hat(w) = argmin_y  f(y) + (rho_hat/2) ||y - w||^2   s.t.  g(y) <= 0

with rho_hat > 2 rho.  The FedSGM iteration itself is unchanged; this module
provides the *evaluation*: an inner solver for w_hat (switching gradient on
the strongly-convex surrogate) and the stationarity measure.

Both run on the flat ``[d]`` buffer of the parameters (``flat.spec_of`` /
``unflatten``), the clients one after another, as the round does.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.comm import flat
from repro_torch.engine.rounds import client_batch, n_rows
from repro_torch.optim.sgd import axpy


def proximal_point(loss_pair: Callable, batches, w, *, rho_hat: float = 2.0,
                   eps: float = 1e-2, inner_steps: int = 200,
                   lr: float = 0.05, client_chunk: int = 0):
    """Approximately solve the proximal subproblem with switching gradients.

    ``loss_pair(params, batch) -> (f_j, g_j)``; ``batches`` has a leading
    client axis (the subproblem uses the global mean, full participation).
    Each step evaluates the surrogate constraint, then takes the gradient
    of the surrogate objective or of the constraint, whichever the switch
    ``g > eps`` chooses (the reference computes both and selects; the
    chosen one is the same number).  Returns the parameter tree of w_hat.
    ``client_chunk`` is the reference's chunked client vmap: the clients run
    one after another here whatever its value, and the result does not
    depend on it."""
    spec = flat.spec_of(w)
    w0 = flat.flatten(spec, w).detach()
    n = n_rows(batches)

    def mean_pair(y):
        pairs = [loss_pair(flat.unflatten(spec, y), client_batch(batches, j))
                 for j in range(n)]
        return (torch.stack([p[0] for p in pairs]).mean(),
                torch.stack([p[1] for p in pairs]).mean())

    def surrogate_f(y):
        f, _ = mean_pair(y)
        diff = y - w0
        # sum-of-squares directly, leaf by leaf: sqrt(0) has an inf gradient
        # at y == w
        sq = sum(torch.sum(torch.square(diff[ls.offset:ls.offset + ls.size]))
                 for ls in spec.leaves)
        return f + 0.5 * rho_hat * sq

    def surrogate_g(y):
        _, g = mean_pair(y)
        return g

    y = w0
    for _ in range(inner_steps):
        with torch.no_grad():
            use_g = bool(surrogate_g(y) > eps)
        leaf = y.detach().requires_grad_(True)
        (grad,) = torch.autograd.grad(
            (surrogate_g if use_g else surrogate_f)(leaf), leaf)
        y = axpy(-lr, grad, y)
    return flat.unflatten(spec, y)


def stationarity(loss_pair: Callable, batches, w, **kw) -> torch.Tensor:
    """||w - w_hat(w)|| (Theorem 10's measure; -> 0 at near-stationarity)."""
    spec = flat.spec_of(w)
    w_hat = proximal_point(loss_pair, batches, w, **kw)
    return flat.tree_norm(spec, flat.flatten(spec, w) - flat.flatten(spec,
                                                                     w_hat))
