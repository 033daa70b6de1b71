"""Client-sampling laws (port of ``repro.fleet.samplers``: the ``uniform``
law and the ``fixed`` replay law).  Draws come from a CPU
``torch.Generator`` and masks live on the CPU (n is small): the round
computes the gather indices there and moves both to its device.  The
uniform law gives the reference's distribution, not its bits; ``fixed``
replays recorded masks, which is how tests give both packages the same
cohorts."""
from __future__ import annotations

import torch

_SAMPLERS: dict = {}


def register_sampler(cls):
    _SAMPLERS[cls.name] = cls
    return cls


def get_sampler(name: str) -> "ClientSampler":
    try:
        cls = _SAMPLERS[name]
    except KeyError:
        raise NotImplementedError(
            f"client sampler {name!r} is not ported yet; ported: "
            f"{sorted(_SAMPLERS)}") from None
    return cls()


def participation_mask(gen: torch.Generator, n: int, m: int) -> torch.Tensor:
    """0/1 float32 mask with exactly m ones, uniform without replacement."""
    if m >= n:
        return torch.ones((n,), dtype=torch.float32)
    perm = torch.randperm(n, generator=gen)
    return (perm < m).to(torch.float32)


class ClientSampler:
    name: str = "?"

    def init(self, cfg):
        """The law's state at round 0 (``FedState.sampler``); None for the
        stateless laws."""
        return None

    def sample(self, gen: torch.Generator, cfg, state=None):
        """Draw S_t: ``(mask [n], weights [n], next state)`` on the CPU."""
        raise NotImplementedError


@register_sampler
class UniformSampler(ClientSampler):
    """m of n uniform without replacement; the weights ARE the mask."""

    name = "uniform"

    def sample(self, gen, cfg, state=None):
        mask = participation_mask(gen, cfg.n_clients, cfg.m)
        return mask, mask, state


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

    def sample(self, gen, cfg, state=None):
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
