"""Client-sampling laws (port of ``repro.fleet.samplers``: the ``uniform``
law).  Draws come from a CPU ``torch.Generator`` (n is small; the mask moves
to the round's device): the reference's distribution, not its bits."""
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

    def sample(self, gen: torch.Generator, cfg):
        """Draw S_t: ``(mask [n], weights [n])`` on the CPU."""
        raise NotImplementedError


@register_sampler
class UniformSampler(ClientSampler):
    """m of n uniform without replacement; the weights ARE the mask."""

    name = "uniform"

    def sample(self, gen, cfg):
        mask = participation_mask(gen, cfg.n_clients, cfg.m)
        return mask, mask
