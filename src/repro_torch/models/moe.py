"""Mixture-of-Experts FFN, training path (port of ``repro.models.moe``):
shared plus routed experts, GShard-style group-limited capacity routing by
a scatter dispatch into ``[E, C]`` expert slots.

Routing is split into a draw and a draw-free core, so that a routing flip
from rounding (a token whose k-th and (k+1)-th router probabilities lie
within the two frameworks' last bits) can be told apart from a fault:

* :func:`route` is the draw: the router's f32 softmax, the top-k with
  ties to the lowest index (``jax.lax.top_k``'s order: pad tokens, zero
  rows, have uniform probabilities and go to experts ``0..k-1``), the
  gates renormalised with ``max(sum, 1e-9)``;
* :func:`moe_core` is the rest, given ``probs``, ``gates`` and ``idx``:
  the dispatch, the experts, the combine, the shared experts and the
  load-balance aux.

Capacity priority is token-major: a choice's position within its expert
is an exclusive cumulative count over the ``[G*k]`` list (token 0's k
choices, then token 1's, ...); choices at or past ``C`` go to a dump row
``E*C`` that is dropped, and the combine reads a zero row there.

Atomics.  The forward has none: the dispatch stores each live slot's one
token with a non-accumulating ``scatter`` (the dump row receives only
zeros), and the token copies are an ``expand`` whose backward is a sum
over the k choices in a fixed order.  In the backward, the combine's
``gather`` becomes a ``scatter_add`` (atomic on CUDA) that adds one term
into each live slot and the dropped choices' into the dump row, which is
discarded, so its result does not depend on the order; the same holds for
the gates' ``gather`` from ``probs`` (k distinct experts a token).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.models import common


def moe_shapes(d: int, mcfg: MoEConfig) -> dict:
    """The leaf shapes of one MoE FFN, named as the reference's."""
    E, de = mcfg.n_experts, mcfg.d_expert
    shapes = {"router": (d, E),
              "experts": {"w_gate": (E, d, de), "w_up": (E, d, de),
                          "w_down": (E, de, d)}}
    if mcfg.n_shared:
        ds = de * mcfg.n_shared
        shapes["shared"] = {"w_gate": (d, ds), "w_up": (d, ds),
                            "w_down": (ds, d)}
    return shapes


def capacity(G: int, mcfg: MoEConfig) -> int:
    """Slots per expert and group (Python's ``round``, as the reference)."""
    return max(1, int(round(G * mcfg.top_k / mcfg.n_experts
                            * mcfg.capacity_factor)))


def groups(x: torch.Tensor, mcfg: MoEConfig) -> torch.Tensor:
    """x ``[T, d]`` -> ``[ng, G, d]``, ``G = min(router_group, T)``; the
    last group is padded with zero rows (pad tokens route too)."""
    T, d = x.shape
    G = min(mcfg.router_group, T)
    ng = -(-T // G)
    pad = ng * G - T
    if pad:
        x = torch.cat([x, x.new_zeros((pad, d))])
    return x.reshape(ng, G, d)


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` on the last axis: the k largest, ties to the
    lowest index (a stable descending sort; ``torch.topk`` leaves the
    order of ties unspecified).  Returns ``(values, indices)``."""
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    idx = idx[..., :k]
    return probs.gather(-1, idx), idx


def route(router: torch.Tensor, xg: torch.Tensor, k: int):
    """The draw: ``(probs [ng, G, E] f32, gates [ng, G, k], idx [ng, G,
    k])``."""
    probs = torch.softmax((xg @ router).to(torch.float32), dim=-1)
    gates, idx = top_k(probs, k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates.to(xg.dtype), idx


def dispatch(xg: torch.Tensor, idx: torch.Tensor, E: int, C: int):
    """Tokens ``[ng, G, d]`` into expert slots ``[ng, E, C, d]``; returns
    ``(expert_in, slot [ng, G*k], keep [ng, G*k])``."""
    ng, G, k = idx.shape
    d = xg.shape[-1]
    flat = idx.reshape(ng, G * k)                          # token-major
    onehot = torch.nn.functional.one_hot(flat, E)
    before = onehot.cumsum(1) - onehot
    pos = (onehot * before).sum(-1)                        # within expert
    keep = pos < C
    slot = torch.where(keep, flat * C + pos, E * C)        # overflow: dump
    src = xg[:, :, None].expand(ng, G, k, d).reshape(ng, G * k, d) \
        * keep[..., None].to(xg.dtype)
    buf = xg.new_zeros((ng, E * C + 1, d)).scatter(
        1, slot[..., None].expand(ng, G * k, d), src)
    return buf[:, : E * C].reshape(ng, E, C, d), slot, keep


def experts(w: dict, ei: torch.Tensor) -> torch.Tensor:
    """SwiGLU per expert: ei ``[E, N, d]`` -> ``[E, N, d]``."""
    h = torch.nn.functional.silu(torch.bmm(ei, w["w_gate"]))
    h = h * torch.bmm(ei, w["w_up"])
    return torch.bmm(h, w["w_down"])


def combine(eo: torch.Tensor, slot: torch.Tensor, gates: torch.Tensor,
            keep: torch.Tensor) -> torch.Tensor:
    """Expert outputs ``[ng, E, C, d]`` back to tokens ``[ng, G, d]``:
    each choice's slot row (a zero row for the dropped) times its gate,
    summed over the k choices."""
    ng, E, C, d = eo.shape
    G, k = gates.shape[1:]
    padded = torch.cat([eo.reshape(ng, E * C, d), eo.new_zeros((ng, 1, d))],
                       dim=1)
    y = padded.gather(1, slot[..., None].expand(ng, G * k, d)) \
        * gates.reshape(ng, G * k)[..., None] * keep[..., None].to(eo.dtype)
    return y.reshape(ng, G, k, d).sum(2)


def balance_aux(probs: torch.Tensor, idx: torch.Tensor, E: int,
                k: int) -> torch.Tensor:
    """``E * sum_e (f_e / k) p_e - 1``: 0 at uniform routing.  ``f_e``
    (the share of choices, pad tokens included) carries no gradient,
    ``p_e`` (the mean router probability) does."""
    f_e = torch.nn.functional.one_hot(idx, E).to(torch.float32).sum(2)
    f_e = f_e.reshape(-1, E).mean(0)
    p_e = probs.reshape(-1, E).mean(0)
    return E * ((f_e / k) * p_e).sum() - 1.0


def moe_core(p: dict, xg: torch.Tensor, probs: torch.Tensor,
             gates: torch.Tensor, idx: torch.Tensor, mcfg: MoEConfig,
             T: int):
    """The draw-free part of :func:`moe_ffn`, given the routing: tokens
    ``[ng, G, d]`` (the first ``T`` real) -> ``(y [T, d], aux)``."""
    ng, G, d = xg.shape
    E = mcfg.n_experts
    C = capacity(G, mcfg)
    expert_in, slot, keep = dispatch(xg, idx, E, C)
    ei = expert_in.transpose(0, 1).reshape(E, ng * C, d)
    eo = experts(p["experts"], ei).reshape(E, ng, C, d).transpose(0, 1)
    y = combine(eo, slot, gates, keep).reshape(-1, d)[:T]
    if mcfg.n_shared:
        s = p["shared"]
        y = y + common.swiglu(xg.reshape(-1, d)[:T], s["w_gate"], s["w_up"],
                              s["w_down"])
    return y, balance_aux(probs, idx, E, mcfg.top_k)


def moe_ffn(p: dict, x: torch.Tensor, mcfg: MoEConfig):
    """x ``[T, d]`` -> ``(y [T, d], aux load imbalance; 0 == uniform)``."""
    xg = groups(x, mcfg)
    probs, gates, idx = route(p["router"], xg, mcfg.top_k)
    return moe_core(p, xg, probs, gates, idx, mcfg, x.shape[0])
