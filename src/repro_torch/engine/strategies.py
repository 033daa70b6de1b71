"""Strategy registry for the engine round (port of
``repro.engine.strategies``: ``fedsgm``, ``fedsgm-soft``,
``penalty-fedavg`` and ``centralized-sgm``).

A :class:`Strategy` supplies only the round's pluggable math:

* ``switch_weight(g_hat, cfg) -> sigma_t``,
* ``local_objective(loss_pair, sigma, cfg) -> (params, batch) -> scalar``,
* ``server_update(x, v_bar, cfg, spec, cols) -> x_{t+1}``,
* ``iterate_weight(g_hat, cfg) -> alpha_t``,
* ``staleness_weight(s, sigma_origin, g_hat, cfg) -> lambda`` (async
  rounds).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.comm import flat
from repro_torch.core import switching

_STRATEGIES: dict = {}


def register_strategy(cls):
    _STRATEGIES[cls.name] = cls
    return cls


def get_strategy(name: str) -> "Strategy":
    try:
        cls = _STRATEGIES[name]
    except KeyError:
        raise ValueError(f"unknown strategy {name!r}; registered: "
                         f"{sorted(_STRATEGIES)}") from None
    return cls()


class Strategy:
    name: str = "?"

    def validate(self, cfg) -> None:
        """Raise when ``cfg`` does not suit the strategy."""

    def switch_weight(self, g_hat, cfg):
        raise NotImplementedError

    def blend_values(self, f, g, sigma, cfg):
        """The local objective as a function of the (f, g) pair.  A strategy
        whose objective factors through it (the base ``local_objective``)
        gets the engine's fused eval/step-1 round, with ``d(blend)/d(f, g)``
        as the backward's seeds."""
        raise NotImplementedError

    def local_objective(self, loss_pair, sigma, cfg):
        def obj(params, batch):
            f, g = loss_pair(params, batch)
            return self.blend_values(f, g, sigma, cfg)
        return obj

    def server_update(self, x, v_bar, cfg, spec, cols=None):
        """x_{t+1} = Pi_X(x_t - eta * v_bar) on flat buffers (the columns
        ``cols`` of them under a model axis)."""
        return flat.project_ball(spec, x - cfg.lr * v_bar, cfg.proj_radius,
                                 cols)

    def iterate_weight(self, g_hat, cfg):
        raise NotImplementedError

    def staleness_weight(self, s, sigma_origin, g_hat, cfg):
        """lambda(s): the down-weight of a buffered uplink of age ``s``
        rounds at delivery (async rounds); ``sigma_origin`` is the switch
        weight it was computed under and ``g_hat`` the current constraint
        estimate.  Dispatches the ``cfg.async_.staleness`` law."""
        from repro_torch.engine.async_rounds import get_staleness_law
        return get_staleness_law(cfg.async_.staleness)(
            s, sigma_origin, g_hat, cfg)


@register_strategy
class FedSGM(Strategy):
    """Algorithm 1: blended-objective local steps with switching weight."""

    name = "fedsgm"

    def _switch_cfg(self, cfg):
        return cfg.switch

    def switch_weight(self, g_hat, cfg):
        return switching.switch_weight(g_hat, self._switch_cfg(cfg))

    def blend_values(self, f, g, sigma, cfg):
        # sigma_t is round-constant, so grad-of-blend == blend-of-grads
        return (1.0 - sigma) * f + sigma * g

    def iterate_weight(self, g_hat, cfg):
        return switching.averaged_iterate_weight(g_hat, self._switch_cfg(cfg))


@register_strategy
class FedSGMSoft(FedSGM):
    """FedSGM with the trimmed-hinge soft switch forced on."""

    name = "fedsgm-soft"

    def _switch_cfg(self, cfg):
        if cfg.switch.mode == "soft":
            return cfg.switch
        return dataclasses.replace(cfg.switch, mode="soft")


@register_strategy
class PenaltyFedAvg(FedSGM):
    """Penalty-based FedAvg: E local steps on f + rho * [g - eps]_+ with a
    fixed rho, no switching; every round weighs 1 in the averaged
    iterate."""

    name = "penalty-fedavg"

    def switch_weight(self, g_hat, cfg):
        return torch.zeros((), device=g_hat.device)

    def blend_values(self, f, g, sigma, cfg):
        # maximum, not clamp: at g == eps its gradient splits 1/2 : 1/2,
        # as the reference's jnp.maximum does
        return f + cfg.rho * torch.maximum(g - cfg.switch.eps,
                                           torch.zeros_like(g))

    def iterate_weight(self, g_hat, cfg):
        return torch.ones((), device=g_hat.device)

    def staleness_weight(self, s, sigma_origin, g_hat, cfg):
        """No switching phases, so the constraint-aware law degenerates to
        the polynomial one (``constant`` stays constant)."""
        from repro_torch.engine.async_rounds import get_staleness_law
        law = cfg.async_.staleness
        if law == "constraint":
            law = "poly"
        return get_staleness_law(law)(s, sigma_origin, g_hat, cfg)


@register_strategy
class CentralizedSGM(FedSGM):
    """The centralized switching gradient method: Algorithm 1 at
    n_clients == m == 1."""

    name = "centralized-sgm"

    def validate(self, cfg) -> None:
        if cfg.n_clients != 1 or cfg.m != 1:
            raise ValueError(
                "centralized-sgm is the n_clients == m == 1 special case; "
                f"got n_clients={cfg.n_clients}, m={cfg.m} "
                "(use strategy='fedsgm' for federated runs)")
