"""The telemetry bus (port of ``repro.obs.bus``).

:class:`Telemetry` is a record of optimizer-health counters computed inside
the round from buffers the round already holds and moved to the host with
the other round metrics (once per metric segment): the EF residual norms
and residual-to-delta ratios per direction, the constraint margin, the
trailing switching fraction, the wire bytes, the slot store's occupancy,
evictions and flushed HT mass, and the staleness buffer's occupancy,
parked HT mass and age histogram.  Each counter is a 0-d float32 tensor on
the round's device (the histogram ``[max_staleness + 1]``).

With ``ObsConfig.enabled=False`` the ``RoundMetrics.telemetry`` field is
None and the round computes nothing here.  Enabled, telemetry is
observation only: the state trajectory is bit-identical to the disabled
run.  No counter builds an ``[n, d]`` temporary (the norms are
``torch.linalg.vector_norm`` reductions).  Under a rank mesh the bus
raises ``NotImplementedError`` (not ported across ranks yet).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.sharding import partition

_TINY = 1e-30


class Telemetry(NamedTuple):
    """Per-round counters (0-d float32 unless noted).

    ``up_res_norm``/``up_ratio``: the Frobenius norm of the uplink EF
    residual stack after the round and its ratio to the local-delta stack's
    norm.  ``down_err_norm``/``down_ratio``: the downlink compression error
    ``x_{t+1} - w_{t+1}`` against the server step ``x_{t+1} - w_t`` (zero
    under an identity downlink).  ``buf_stale_hist`` is ``[max_staleness +
    1]`` occupied-slot counts by age (zeros in synchronous rounds)."""
    up_res_norm: torch.Tensor
    up_ratio: torch.Tensor
    down_err_norm: torch.Tensor
    down_ratio: torch.Tensor
    margin: torch.Tensor          # g_hat - eps (signed constraint margin)
    switch_frac: torch.Tensor     # mean sigma over the trailing obs.window
                                  # (the drive loop's ring; a bare round_step
                                  # reports this round's sigma)
    wire_up_bytes: torch.Tensor   # uplink wire bytes of the whole round
    wire_down_bytes: torch.Tensor  # downlink broadcast bytes
    slot_occupancy: torch.Tensor  # slot-store owned slots (0 dense)
    slot_evictions: torch.Tensor  # slots reallocated this round (0 dense)
    slot_flush_weight: torch.Tensor  # HT mass flushed by evictions (0 dense)
    buf_occupancy: torch.Tensor   # StaleBuffer occupied slots (0 sync)
    buf_parked_weight: torch.Tensor  # HT mass parked in the buffer (0 sync)
    buf_stale_hist: torch.Tensor  # [max_staleness + 1] occupied by age


def _zero(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=device)


def empty_telemetry(cfg, device) -> Telemetry:
    """An all-zero record with ``cfg``'s shapes on ``device``."""
    z = _zero(device)
    return Telemetry(*([z] * 13), buf_stale_hist=torch.zeros(
        (cfg.async_.max_staleness + 1,), dtype=torch.float32,
        device=device))


def _fro(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x.to(torch.float32))


def residual_norm(e_up) -> torch.Tensor:
    """Frobenius norm of the uplink EF residual: the dense ``[n, d]``
    stack, or a :class:`repro_torch.scale.slots.SlotStore`'s owned pool
    rows only (per-row norms combined, no ``[cap, d]`` temporary), or 0
    when there is none (an uncompressed uplink; on the CPU)."""
    if e_up is None:
        return torch.zeros((), dtype=torch.float32)
    from repro_torch.scale import slots
    if isinstance(e_up, slots.SlotStore):
        rows = torch.linalg.vector_norm(e_up.pool.to(torch.float32), dim=1)
        return torch.sqrt(torch.sum(torch.where(e_up.owner >= 0,
                                                rows * rows, 0.0)))
    return _fro(e_up)


def round_telemetry(cfg, deltas, e_up, x_new, wf, w_new_f, g_hat, sigma,
                    uplink, downlink, slot_stats=None) -> Telemetry:
    """One round's :class:`Telemetry` from the tail of
    ``rounds.finish_round`` (every input is already there; the counters
    are reductions, so the state is untouched).  ``slot_stats`` is the
    round's :class:`repro_torch.scale.slots.SlotStats`, None for a dense
    residual."""
    partition.refuse_ranks("the telemetry bus (ObsConfig.enabled)")
    dev = wf.device

    def const(v):
        # a fill on the device: a tensor copied from the host would wait
        # for the stream
        return torch.full((), v, dtype=torch.float32, device=dev)
    delta_n = _fro(deltas)
    res_n = residual_norm(e_up) if e_up is not None else const(0.0)
    step_n = _fro(x_new - wf)
    err_n = _fro(x_new - w_new_f)
    tel = empty_telemetry(cfg, dev)
    if slot_stats is not None:
        tel = tel._replace(slot_occupancy=slot_stats.occupancy,
                           slot_evictions=slot_stats.evictions,
                           slot_flush_weight=slot_stats.flush_weight)
    return tel._replace(
        up_res_norm=res_n,
        up_ratio=res_n / torch.maximum(delta_n, const(_TINY)),
        down_err_norm=err_n,
        down_ratio=err_n / torch.maximum(step_n, const(_TINY)),
        margin=(g_hat - const(cfg.switch.eps)).to(torch.float32),
        switch_frac=sigma.to(torch.float32),
        wire_up_bytes=const(float(uplink.wire_bytes()) * cfg.m),
        wire_down_bytes=const(float(downlink.wire_bytes())))


def staleness_hist(occupied: torch.Tensor, age: torch.Tensor,
                   cfg) -> torch.Tensor:
    """Occupied-slot counts by age: ``hist[h] = sum_j occupied_j *
    1[age_j == h]`` for h in ``[0, max_staleness]`` (a one-hot
    contraction)."""
    hs = torch.arange(cfg.async_.max_staleness + 1, dtype=torch.float32,
                      device=occupied.device)
    onehot = (age.to(torch.float32)[:, None] == hs).to(torch.float32)
    return torch.sum(occupied.to(torch.float32)[:, None] * onehot, dim=0)


# ---------------------------------------------------------------------------
# The trailing switching-fraction window (drive-loop ring)
# ---------------------------------------------------------------------------

def ring_init(cfg, device):
    """The sigma ring riding the drive-loop carry when telemetry is on: a
    ``[window]`` float32 buffer on ``device`` and the rounds seen."""
    partition.refuse_ranks("the telemetry bus (ObsConfig.enabled)")
    w = max(1, int(cfg.obs.window))
    return (torch.zeros((w,), dtype=torch.float32, device=device), 0)


def window_wrap(step: Callable, cfg, *, sigma_of: Callable,
                tel_get: Callable, tel_set: Callable) -> Callable:
    """Wrap a drive step ``step(carry, b) -> (carry, mets)`` so the
    telemetry's ``switch_frac`` is the mean sigma over the trailing
    ``cfg.obs.window`` rounds (rounds seen < window average over what
    exists).  ``sigma_of(mets)`` reads the round's sigma;
    ``tel_get``/``tel_set`` address the telemetry inside the step's metric
    type (RoundMetrics or AsyncMetrics)."""
    w = max(1, int(cfg.obs.window))

    def wrapped(carry2, b):
        carry, (ring, seen) = carry2
        carry, mets = step(carry, b)
        ring = ring.clone()
        ring[seen % w] = sigma_of(mets).to(torch.float32)
        seen += 1
        frac = torch.sum(ring) / torch.full(
            (), float(min(seen, w)), dtype=torch.float32, device=ring.device)
        mets = tel_set(mets, tel_get(mets)._replace(switch_frac=frac))
        return (carry, (ring, seen)), mets

    return wrapped
