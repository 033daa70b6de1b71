"""Client-sampling laws (port of ``repro.fleet.samplers``).

A :class:`ClientSampler` draws the round's participant set S_t as a 0/1
``mask`` (``[n]``, exactly m ones) plus per-client aggregation ``weights``
(``[n]``, zero off-support), and may carry per-run state
(``FedState.sampler``).  The engine aggregates every per-client quantity
as ``sum_j weights_j * x_j / m``.

Registered samplers:

* ``uniform``  -- m of n without replacement; ``weights = mask``.
* ``weighted`` -- importance sampling ∝ shard size (the fleet's counts;
  uniform probabilities without a fleet) by Madow systematic sampling,
  whose inclusion probabilities are exactly the capped pi_j = m·q_j, with
  the Horvitz-Thompson weights ``m·q_j / pi_j``: the aggregate is unbiased
  for the data-weighted mean Σ_j q_j x_j (q_j = count_j / Σ count).
* ``markov``   -- a two-state availability chain per client; m sampled
  uniformly among the available clients (unavailable ones only when fewer
  than m are up); ``weights = mask``.
* ``fixed``    -- replay of recorded ``[T, n]`` cohorts.

Draws come from a CPU ``torch.Generator`` and masks live on the CPU (n is
small): the round computes the gather indices there and moves both to its
device.  Each law is split into its draw (the uniform ``u`` of systematic
sampling; the flip and pick uniforms of the Markov step) and a
deterministic core (:func:`weighted_core` over :func:`capped_inclusion`
and :func:`systematic_pick`; :func:`markov_step`), which gives the
reference's bits for the same uniforms: its float32 sums and running sums
are taken in the reference's CPU order (``partitions.sum_f32`` /
``cumsum_f32``).  The laws give the reference's distributions, not its
draws.

For asynchronous rounds (``repro_torch.engine.async_rounds``) every
sampler also draws mid-round :class:`Events` -- departures (a sampled
client drops out before the aggregation barrier) and arrivals (a client
able to deliver a parked payload) -- from the round's generator, after
:meth:`ClientSampler.sample`.  The default law (:func:`default_events`)
draws i.i.d. departures at ``cfg.async_.depart`` and i.i.d. per-round
rejoins at ``cfg.async_.rejoin``; ``markov`` derives both from its
availability chain (:func:`markov_events`).  The synchronous engine draws
no events, so its trajectories do not move.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.comm.transports import _mix64
from repro_torch.fleet.partitions import cumsum_f32, sum_f32

_SAMPLERS: dict = {}

# seed word separating the Markov chain's initial draw from the round
# streams ("smp")
SAMPLER_TAG = 0x736D70


class Events(NamedTuple):
    """One round's arrival/departure events, ``[n]`` 0/1 float32 masks on
    the CPU: ``depart`` -- sampled clients whose uplink misses the round's
    aggregation barrier and parks in the staleness buffer; ``arrive`` --
    clients able to deliver a parked payload this round."""
    depart: torch.Tensor
    arrive: torch.Tensor


def register_sampler(cls):
    _SAMPLERS[cls.name] = cls
    return cls


def get_sampler(name: str) -> "ClientSampler":
    try:
        cls = _SAMPLERS[name]
    except KeyError:
        raise ValueError(f"unknown client sampler {name!r}; "
                         f"registered: {sorted(_SAMPLERS)}") from None
    return cls()


def sampler_names() -> tuple:
    return tuple(sorted(_SAMPLERS))


def participation_mask(gen: torch.Generator, n: int, m: int) -> torch.Tensor:
    """0/1 float32 mask with exactly m ones, uniform without replacement."""
    if m >= n:
        return torch.ones((n,), dtype=torch.float32)
    perm = torch.randperm(n, generator=gen)
    return (perm < m).to(torch.float32)


# ---------------------------------------------------------------------------
# Systematic (Madow) sampling: exactly m distinct picks with exact
# inclusion probabilities pi_j
# ---------------------------------------------------------------------------

def capped_inclusion(p: torch.Tensor, m: int, iters: int = 4) -> torch.Tensor:
    """Inclusion probabilities pi = m*p (float32, CPU), iteratively capped
    at 1 with the excess spread proportionally over the rest."""
    pi = m * p.to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32)
    for _ in range(iters):
        over = pi >= 1.0
        excess = sum_f32(torch.where(over, pi - 1.0, zero))
        free = sum_f32(torch.where(over, zero, pi))
        pi = torch.where(over, torch.ones((), dtype=torch.float32),
                         pi * (1.0 + excess / torch.clamp(free, min=1e-12)))
    return torch.clamp(pi, max=1.0)


def systematic_pick(u: torch.Tensor, pi: torch.Tensor, m: int
                    ) -> torch.Tensor:
    """Madow systematic sampling: m distinct sorted indices with inclusion
    probability exactly pi_j (pi <= 1, sum ~= m).  The points u, u+1, ...,
    u+m-1 (one uniform ``u`` in [0, 1)) fall on the running sum of pi; each
    interval of length <= 1 catches at most one of them."""
    c = cumsum_f32(pi)
    c[-1] = float(m)                        # close float drift exactly
    pts = u.to(torch.float32) + torch.arange(m, dtype=torch.float32)
    idx = torch.searchsorted(c, pts, right=True)
    return torch.clamp(idx, 0, pi.shape[0] - 1)


def weighted_core(u: torch.Tensor, q: torch.Tensor, m: int):
    """One weighted round from its uniform ``u``: the m systematic picks
    over the capped inclusion probabilities of the population weights
    ``q``, and their Horvitz-Thompson weights ``m·q_j / pi_j``.  Returns
    ``(mask, weights)``."""
    pi = capped_inclusion(q, m)
    idx = systematic_pick(u, pi, m)
    mask = torch.zeros((q.shape[0],), dtype=torch.float32)
    mask[idx] = 1.0
    return mask, mask * (m * q / torch.clamp(pi, min=1e-12))


def markov_step(avail_prev: torch.Tensor, u_flip: torch.Tensor,
                u_pick: torch.Tensor, m: int, stay: float, ret: float):
    """One Markov round from its uniforms: each chain stays up with
    probability ``stay`` or comes back with ``ret``; the m highest scores
    ``2·avail + u_pick`` take part (stable: ties to the lower index).
    Returns ``(mask, avail)``."""
    p = torch.where(avail_prev > 0, torch.tensor(stay, dtype=torch.float32),
                    torch.tensor(ret, dtype=torch.float32))
    avail = (u_flip < p).to(torch.float32)
    score = avail * 2.0 + u_pick
    order = torch.sort(-score, stable=True).indices
    mask = torch.zeros(avail.shape[0], dtype=torch.float32)
    mask[order[:m]] = 1.0
    return mask, avail


def default_events(u_dep: torch.Tensor, u_arr: torch.Tensor,
                   mask: torch.Tensor, depart: float, rejoin: float
                   ) -> Events:
    """The default events law from its uniforms: each sampled client
    departs with probability ``depart``; any client arrives with
    probability ``rejoin`` (geometric away-times)."""
    dep = mask * (u_dep < torch.tensor(depart, dtype=torch.float32)
                  ).to(torch.float32)
    arr = (u_arr < torch.tensor(rejoin, dtype=torch.float32)
           ).to(torch.float32)
    return Events(dep, arr)


def markov_events(avail: torch.Tensor, u: torch.Tensor, mask: torch.Tensor,
                  stay: float):
    """The Markov chain's mid-round step from its uniform: a sampled
    available client leaves with probability ``1 - stay``; a sampled client
    whose chain is down departs for sure.  Arrivals are the clients up
    after the step, and a departure flips the chain down, so the next
    round's sample sees the client unavailable.  Returns ``(events,
    avail)``."""
    leave = (u < torch.tensor(1.0 - stay, dtype=torch.float32)
             ).to(torch.float32)
    dep = mask * torch.maximum(leave, 1.0 - avail)
    up = avail * (1.0 - dep)
    return Events(dep, up), up


# ---------------------------------------------------------------------------
# Registry entries
# ---------------------------------------------------------------------------

class ClientSampler:
    """One client-participation law.

    Usage::

        >>> samp = get_sampler(cfg.fleet.sampler)
        >>> mask, weights, s = samp.sample(gen, cfg, state, fleet=fleet)
    """

    name: str = "?"

    def init(self, cfg):
        """The law's state at round 0 (``FedState.sampler``); None for the
        stateless laws."""
        return None

    def inclusion_probs(self, cfg, fleet=None) -> torch.Tensor:
        """Per-client inclusion probability of one round's draw."""
        n = cfg.n_clients
        return torch.full((n,), min(cfg.m, n) / n, dtype=torch.float32)

    def sample(self, gen: torch.Generator, cfg, state=None, fleet=None
               ) -> Tuple[torch.Tensor, torch.Tensor, object]:
        """Draw S_t: ``(mask [n], weights [n], next state)`` on the CPU."""
        raise NotImplementedError

    def events(self, gen: torch.Generator, cfg, mask: torch.Tensor,
               state=None) -> Tuple[Events, object]:
        """This round's events (async rounds only), drawn from ``gen``
        after :meth:`sample`: the default law (:func:`default_events`).
        ``state`` is the post-sample sampler state, returned (a law may
        update it)."""
        n = cfg.n_clients
        u_dep = torch.rand((n,), generator=gen)
        u_arr = torch.rand((n,), generator=gen)
        return default_events(u_dep, u_arr, mask, cfg.async_.depart,
                              cfg.async_.rejoin), state


@register_sampler
class UniformSampler(ClientSampler):
    """m of n uniform without replacement; the weights ARE the mask."""

    name = "uniform"

    def sample(self, gen, cfg, state=None, fleet=None):
        mask = participation_mask(gen, cfg.n_clients, cfg.m)
        return mask, mask, state


@register_sampler
class WeightedSampler(ClientSampler):
    """Importance sampling ∝ shard size with Horvitz-Thompson weights (see
    the module docstring).  Without a fleet the probabilities are uniform
    and the weights reduce to the mask."""

    name = "weighted"

    def _probs(self, cfg, fleet):
        if fleet is None:
            n = cfg.n_clients
            return torch.full((n,), 1.0 / n, dtype=torch.float32)
        from repro_torch.fleet.provision import data_weights
        return data_weights(fleet)

    def inclusion_probs(self, cfg, fleet=None):
        return capped_inclusion(self._probs(cfg, fleet),
                                min(cfg.m, cfg.n_clients))

    def sample(self, gen, cfg, state=None, fleet=None):
        mask, weights = weighted_core(torch.rand((), generator=gen),
                                      self._probs(cfg, fleet),
                                      min(cfg.m, cfg.n_clients))
        return mask, weights, state


@register_sampler
class MarkovSampler(ClientSampler):
    """Two-state availability chain per client; m drawn uniformly among
    the available set each round.  The chain starts from its stationary
    law, drawn from a generator derived from ``cfg.seed``."""

    name = "markov"

    def _stationary(self, cfg) -> float:
        fl = cfg.fleet
        return fl.avail_return / max(fl.avail_return + 1.0 - fl.avail_stay,
                                     1e-9)

    def init(self, cfg):
        gen = torch.Generator().manual_seed(_mix64(cfg.seed, SAMPLER_TAG))
        return (torch.rand((cfg.n_clients,), generator=gen)
                < self._stationary(cfg)).to(torch.float32)

    def inclusion_probs(self, cfg, fleet=None):
        # stationary approximation: m spread over the expected available set
        n = cfg.n_clients
        avail = self._stationary(cfg)
        return torch.full((n,), min(1.0, cfg.m / max(avail * n, 1e-9)),
                          dtype=torch.float32) * avail

    def sample(self, gen, cfg, state=None, fleet=None):
        n = cfg.n_clients
        if state is None:                 # a hand-built FedState
            state = torch.ones((n,), dtype=torch.float32)
        u_flip = torch.rand((n,), generator=gen)
        u_pick = torch.rand((n,), generator=gen)
        mask, avail = markov_step(state, u_flip, u_pick, cfg.m,
                                  cfg.fleet.avail_stay,
                                  cfg.fleet.avail_return)
        return mask, mask, avail

    def events(self, gen, cfg, mask, state=None):
        """The chain's mid-round step (:func:`markov_events`); the
        returned state has the departed clients' chains down."""
        n = cfg.n_clients
        avail = state if state is not None else \
            torch.ones((n,), dtype=torch.float32)
        return markov_events(avail, torch.rand((n,), generator=gen), mask,
                             cfg.fleet.avail_stay)


@register_sampler
class FixedSampler(ClientSampler):
    """Replay a recorded cohort trajectory: the state is ``(masks [T, n],
    weights [T, n], t)`` and round t returns row ``min(t, T - 1)`` verbatim,
    drawing nothing.  Masks may carry fewer than m ones (see
    ``participation.mask_indices`` for the padded gather).  Build the state
    with :func:`fixed_state` and install it with
    ``state._replace(sampler=...)``."""

    name = "fixed"

    def init(self, cfg):
        # placeholder trajectory (full participation, weight 1): real runs
        # install a recorded one through fixed_state
        n = cfg.n_clients
        return (torch.ones((1, n)), torch.ones((1, n)), 0)

    def sample(self, gen, cfg, state=None, fleet=None):
        if state is None:
            state = self.init(cfg)
        masks, weights, t = state
        i = min(t, masks.shape[0] - 1)
        return masks[i], weights[i], (masks, weights, t + 1)


def fixed_state(masks, weights):
    """FixedSampler state from recorded per-round ``[T, n]`` cohorts (numpy
    arrays or tensors; kept as float32 on the CPU)."""
    masks = torch.as_tensor(masks, dtype=torch.float32).cpu()
    weights = torch.as_tensor(weights, dtype=torch.float32).cpu()
    if masks.shape != weights.shape or masks.dim() != 2:
        raise ValueError(f"fixed_state needs matching [T, n] masks/weights, "
                         f"got {tuple(masks.shape)} and "
                         f"{tuple(weights.shape)}")
    return (masks, weights, 0)
