"""Asynchronous buffered rounds: staleness-weighted aggregation on the
fleet's availability model (port of ``repro.engine.async_rounds``).

The synchronous round (engine.rounds) waits for every sampled client's
uplink before the server steps.  Here:

* a sampled client that departs mid-round (the sampler's
  :class:`repro_torch.fleet.samplers.Events`, drawn from the round's CPU
  generator after the cohort) still takes its E local steps and encodes
  its delta -- its EF residual updates like everyone's -- but its message
  misses the aggregation barrier and parks in a :class:`StaleBuffer` slot,
* the buffer holds one slot per client id: the *wire-format* message
  (FlatPacked values + uint16 offsets, FlatQuant uint32 words + scales, or
  a dense ``[d]`` row on a dense wire), the origin round, the switch weight
  sigma it was computed under, and the sampler's Horvitz-Thompson weight
  at origin,
* a parked payload delivers at the client's first arrival within
  ``max_staleness`` rounds, merged into that round's server update with
  weight ``lambda(s) * w_origin`` (:func:`staleness_law` registry:
  ``constant`` / ``poly`` / ``constraint``; s the age in rounds); older
  entries drop.

The stale merge is a second call of the uplink's ``reduce`` over the
buffer's messages with weights ``w_origin * lambda(s) * deliver`` --
fractional and zero on most rows -- so on the packed wires it runs the
``scatter_agg`` / ``unpack_mma`` kernels a second time each round.  It runs
and is added every round, delivering or not, as the reference's does.

Parked messages live in the buffer's own storage: they are written by a
masked select into it (``transports.mask_where(..., out=buf.msgs)``), never
a view of ``deltas``, the messages or the residual ``e_up``, which later
rounds overwrite in place.

``AsyncConfig.enabled=False`` is the parity point: :func:`async_round_step`
*is* ``rounds.round_step`` and :func:`init_buffer` returns None, so the
async drive loops give the synchronous trajectories bit for bit.

With a slot-store residual (``ScaleConfig.ef_slots``) the encode runs
through ``scale.slots.encode``: the eviction flush's partial joins the
fresh aggregate and the store's counters feed the telemetry.

The checkpoint sidecar is the buffer itself (:func:`buffer_wire` /
:func:`buffer_from_wire`): ``msgs`` already holds each parked uplink's wire
representation, so ``checkpoint.save_buffer`` writes exactly what crossed
the wire.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch import resolve_device
from repro_torch.comm import flat, transports
from repro_torch.comm.payloads import FlatPacked, FlatQuant
from repro_torch.engine import participation, rounds, strategies
from repro_torch.engine.rounds import FedState, RoundMetrics
from repro_torch.fleet import provision, samplers
from repro_torch.obs import bus as obs_bus
from repro_torch.obs.trace import stage
from repro_torch.sharding import partition


# ---------------------------------------------------------------------------
# Staleness-decay laws
# ---------------------------------------------------------------------------

_LAWS: dict = {}


def staleness_law(name: str):
    """Decorator: register ``fn(s, sigma_origin, g_hat, cfg) -> lambda`` as
    a staleness-decay law.  ``s`` is the payload age in rounds (float32
    ``[n]``), ``sigma_origin`` the switch weight it was computed under,
    ``g_hat`` the current constraint estimate."""
    def deco(fn):
        _LAWS[name] = fn
        return fn
    return deco


def get_staleness_law(name: str) -> Callable:
    try:
        return _LAWS[name]
    except KeyError:
        raise ValueError(f"unknown staleness law {name!r}; "
                         f"registered: {sorted(_LAWS)}") from None


def staleness_law_names() -> tuple:
    return tuple(sorted(_LAWS))


@staleness_law("constant")
def _constant(s, sigma_origin, g_hat, cfg):
    """lambda(s) = 1: delayed payloads merge with their full origin
    weight, so total HT mass is conserved."""
    return torch.ones_like(s)


@staleness_law("poly")
def _poly(s, sigma_origin, g_hat, cfg):
    """lambda(s) = (1+s)^-decay: older payloads were computed against an
    older model, so their contribution shrinks polynomially in the age."""
    return (1.0 + s) ** (-cfg.async_.decay)


@staleness_law("constraint")
def _constraint(s, sigma_origin, g_hat, cfg):
    """Constraint-aware decay: near the feasibility boundary a stale
    objective-phase payload (sigma_origin ~ 0) decays with a doubled
    exponent, a constraint-phase one (sigma_origin ~ 1) with the plain
    polynomial law::

        lambda(s) = (1+s)^-(decay * (1 + (1-sigma_origin) * near))
        near      = exp(-|g_hat - eps| / width)

    ``width`` is ``AsyncConfig.boundary_width`` (0 => max(|eps|, 1e-3))."""
    eps = cfg.switch.eps
    width = cfg.async_.boundary_width or max(abs(eps), 1e-3)
    near = torch.exp(-torch.abs(g_hat - eps) / width)
    exponent = cfg.async_.decay * (1.0 + (1.0 - sigma_origin) * near)
    return (1.0 + s) ** (-exponent)


# ---------------------------------------------------------------------------
# The staleness buffer
# ---------------------------------------------------------------------------

class StaleBuffer(NamedTuple):
    """One slot per client id, on the round's device.  ``msgs`` holds the
    uplink's flat wire messages (``[n, ...]`` on every leaf); unoccupied
    slots hold zeros or old payloads, and every read is gated by
    ``occupied``."""
    msgs: object               # wire-format payload, leading axis [n]
    origin: torch.Tensor       # [n] int32 round the payload was computed at
    sigma: torch.Tensor        # [n] f32 switch weight at origin
    weight: torch.Tensor       # [n] f32 sampler HT weight at origin
    occupied: torch.Tensor     # [n] f32 0/1


class AsyncMetrics(NamedTuple):
    """Per-round async counters around the synchronous
    :class:`RoundMetrics` (``round``); 0-d float32.  With the buffer off
    they take their nominal values (``fresh = fresh_weight = m``, the rest
    0)."""
    round: RoundMetrics
    fresh: torch.Tensor           # uplinks merged at the round barrier
    departed: torch.Tensor        # sampled clients lost mid-round (parked)
    merged: torch.Tensor          # parked payloads delivered this round
    dropped: torch.Tensor         # entries expired or overwritten
    occupancy: torch.Tensor       # occupied slots after the round
    fresh_weight: torch.Tensor    # HT mass merged fresh
    departed_weight: torch.Tensor  # HT mass entering the buffer
    stale_weight: torch.Tensor    # lambda-weighted HT mass merged stale
    dropped_weight: torch.Tensor  # HT mass lost to expiry or overwrite
    buffered_weight: torch.Tensor  # HT mass parked after the round
    max_age: torch.Tensor         # oldest occupied entry (post-round)


def wire_msg_struct(spec: flat.FlatSpec, cfg):
    """The ``[n]``-stacked uplink wire messages' shapes and dtypes under
    this config's transport for the model of ``spec`` (``FedState.spec``),
    as ``meta`` tensors: a tensor, or a FlatPacked / FlatQuant of them.
    Read from the flat wire layout: the kernels do not run on ``meta``
    tensors."""
    uplink, _ = flat.flat_transports_for(cfg, spec)
    n = cfg.n_clients

    def meta(width, dtype):
        return torch.empty((n, width), dtype=dtype, device="meta")
    if uplink.wire == "dense":
        return meta(spec.d, spec.dtype)
    layout = uplink.codec.layout
    if uplink.kind == "quant":
        return FlatQuant(meta(layout.W_total, torch.uint32),
                         meta(layout.NB_total, torch.float32))
    return FlatPacked(meta(layout.K_total, spec.dtype),
                      meta(layout.K_total, torch.uint16))


def init_buffer(state: FedState, cfg) -> Optional[StaleBuffer]:
    """An empty buffer on the state's device with the uplink's wire shapes
    for its model; None when the buffer is disabled."""
    if not cfg.async_.enabled:
        return None
    partition.refuse_ranks("asynchronous rounds (AsyncConfig.enabled)")
    n, dev = cfg.n_clients, state.w.device
    struct = wire_msg_struct(state.spec, cfg)
    if isinstance(struct, torch.Tensor):
        msgs = torch.zeros(struct.shape, dtype=struct.dtype, device=dev)
    else:
        msgs = type(struct)(*(torch.zeros(x.shape, dtype=x.dtype,
                                          device=dev) for x in struct))

    def zeros(dtype):
        return torch.zeros((n,), dtype=dtype, device=dev)
    return StaleBuffer(msgs=msgs, origin=zeros(torch.int32),
                       sigma=zeros(torch.float32),
                       weight=zeros(torch.float32),
                       occupied=zeros(torch.float32))


# ---------------------------------------------------------------------------
# Buffer checkpoint sidecar: the parked payloads in wire form
# ---------------------------------------------------------------------------

def buffer_wire(buf: Optional[StaleBuffer], state: FedState,
                cfg) -> Optional[StaleBuffer]:
    """The buffer in its checkpoint sidecar form: the buffer itself, since
    ``msgs`` already holds each parked uplink's wire representation (uint32
    words and scales, values and uint16 offsets, or dense rows), so save ->
    restore -> continue is bit-exact by construction.  ``state`` stands in
    for the reference's ``params`` (the port's buffers are built from the
    state)."""
    return buf


def buffer_from_wire(wire: Optional[StaleBuffer], state: FedState, cfg,
                     sig: Optional[str] = None) -> Optional[StaleBuffer]:
    """A :func:`buffer_wire` sidecar back as the engine's buffer (the same
    object).

    ``sig`` is the payload kind/shape signature the sidecar (or a wire
    frame header, :mod:`repro_torch.wire.frames`) recorded at save or
    encode time.  When given, it is checked against THIS process's
    transport config (``wire.frames.row_signature`` of ``state.spec``)
    before the payloads reach any ``reduce``: a buffer encoded by a
    differently configured process (another compressor kind, bit width,
    block size or comm backend) would decode as silent garbage, since the
    packed uint32 words carry no self-description.  A mismatch raises
    ``ValueError`` naming both signatures and the config knobs to check."""
    if sig is not None:
        from repro_torch.wire import frames as wire_frames
        expect = wire_frames.row_signature(state.spec, cfg)
        if sig != expect:
            raise ValueError(
                "staleness-buffer payload signature mismatch: the sidecar "
                f"(or frame) was encoded as {sig!r}, but this process's "
                f"uplink transport produces {expect!r}.  The encoding and "
                "decoding processes must agree on cfg.uplink (kind / bits "
                "/ ratio / block) and cfg.comm -- refusing to merge "
                "foreign payload words as if they were ours.")
    return wire


def buffer_wire_struct(state: FedState, cfg) -> Optional[StaleBuffer]:
    """The sidecar's structure for ``checkpoint.restore_buffer``: a
    :class:`StaleBuffer` of ``meta`` tensors with the buffer's shapes and
    dtypes (nothing is allocated; ``restore_buffer`` puts the restored
    leaves on the device it is given).  None when the buffer is disabled."""
    if not cfg.async_.enabled:
        return None
    n = cfg.n_clients

    def meta(dtype):
        return torch.empty((n,), dtype=dtype, device="meta")
    return StaleBuffer(msgs=wire_msg_struct(state.spec, cfg),
                       origin=meta(torch.int32), sigma=meta(torch.float32),
                       weight=meta(torch.float32),
                       occupied=meta(torch.float32))


def _nominal_metrics(mets: RoundMetrics, cfg) -> AsyncMetrics:
    dev = mets.f.device
    m = torch.full((), float(cfg.m), dtype=torch.float32, device=dev)
    z = torch.zeros((), dtype=torch.float32, device=dev)
    return AsyncMetrics(round=mets, fresh=m, departed=z, merged=z,
                        dropped=z, occupancy=z, fresh_weight=m,
                        departed_weight=z, stale_weight=z, dropped_weight=z,
                        buffered_weight=z, max_age=z)


# ---------------------------------------------------------------------------
# The asynchronous round
# ---------------------------------------------------------------------------

def async_round_step(state: FedState, buf: Optional[StaleBuffer], batches,
                     loss_pair: Callable, cfg, device="cuda"
                     ) -> tuple[FedState, Optional[StaleBuffer],
                                AsyncMetrics]:
    """One asynchronous round on ``device`` (``cuda`` unless the caller
    asks for the CPU; the state and buffer must live there).  See the
    module docstring.

    With ``cfg.async_.enabled == False`` this IS ``rounds.round_step`` and
    the buffer rides along untouched.  Enabled, it composes the same stages
    (``rounds.compute_round`` / ``finish_round``) with the event draw, the
    split encode / reduce wire path and the buffer merge.  The uplink
    residual and the buffer's messages are updated in place."""
    if not cfg.async_.enabled:
        new_state, mets = rounds.round_step(state, batches, loss_pair, cfg,
                                            device=device)
        return new_state, buf, _nominal_metrics(mets, cfg)
    partition.refuse_ranks("asynchronous rounds (AsyncConfig.enabled)")
    dev = resolve_device(device)
    if state.w.device != dev:
        raise ValueError(f"async_round_step on {dev}: the state lives on "
                         f"{state.w.device}")
    rounds.check_ported(cfg)
    strat = strategies.get_strategy(cfg.strategy)
    m, t, acfg = cfg.m, state.t, cfg.async_
    fleet = batches if isinstance(batches, provision.Fleet) else None

    with stage("round.sample_round"):
        samp = samplers.get_sampler(cfg.fleet.sampler)
        mask, weights, samp_state = samp.sample(state.gen, cfg,
                                                state.sampler, fleet=fleet)
        ev, samp_state = samp.events(state.gen, cfg, mask, samp_state)
        part = participation.finalize(mask, weights, cfg, dev)
        depart, arrive = ev.depart.to(dev), ev.arrive.to(dev)

    spec, wf = state.spec, state.w
    f_part, g_hat, g_full, f_full, sigma, deltas = rounds.compute_round(
        state, wf, spec, batches, part, strat, loss_pair, cfg, fleet)

    # -- uplink: everyone encodes (the residuals are client state), only
    #    the fresh fraction aggregates at the barrier ----------------------
    uplink, downlink = flat.flat_transports_for(cfg, spec)
    with stage("round.encode"):
        msgs, e_up, v_flush, slot_stats = participation.encode_flush(
            uplink, state.e_up, deltas, part, t=t,
            key=transports.WireKey(cfg.seed, t, transports.UPLINK))
    fresh = part.mask * (1.0 - depart)
    part_fresh = participation.compose_weights(part, 1.0 - depart)
    w_fresh = participation.agg_weights(part_fresh)
    with stage("round.reduce"):
        v_bar = uplink.reduce(msgs, w_fresh, m)
    if v_flush is not None:
        # the slot store's eviction flush (cap < n) joins the fresh
        # aggregate; absent at cap >= n, the dense async path bit for bit
        v_bar = v_bar + v_flush

    # -- staleness buffer: deliver, expire, park --------------------------
    age = (t - buf.origin).to(torch.float32)
    deliver = buf.occupied * arrive
    lam = strat.staleness_weight(age, buf.sigma, g_hat, cfg)
    w_stale = buf.weight * lam * deliver
    v_stale = uplink.reduce(buf.msgs, w_stale, m)
    v_bar = v_bar + v_stale

    remaining = buf.occupied * (1.0 - deliver)
    expired = remaining * (age >= acfg.max_staleness).to(torch.float32)
    remaining = remaining * (1.0 - expired)
    overwritten = remaining * depart
    dropped = expired + overwritten
    occupied = remaining * (1.0 - depart) + depart

    parks = depart > 0
    w_agg = participation.agg_weights(part)
    buf_new = StaleBuffer(
        msgs=transports.mask_where(depart, msgs, buf.msgs, out=buf.msgs),
        origin=torch.where(parks, torch.full((), t, dtype=torch.int32,
                                             device=dev), buf.origin),
        sigma=torch.where(parks, sigma, buf.sigma),
        weight=torch.where(parks, w_agg, buf.weight),
        occupied=occupied)

    # -- server update, downlink, bookkeeping: the synchronous tail on the
    #    buffer-merged direction; delta_norm reads the fresh participation
    new_state, round_metrics = rounds.finish_round(
        state, strat, cfg, spec, wf, part_fresh, deltas, v_bar, e_up,
        uplink, downlink, samp_state, f_part, g_hat, g_full, f_full, sigma,
        slot_stats=slot_stats)

    new_age = t - buf_new.origin
    if cfg.obs.enabled:
        with stage("round.telemetry"):
            round_metrics = round_metrics._replace(
                telemetry=round_metrics.telemetry._replace(
                    buf_occupancy=torch.sum(occupied),
                    buf_parked_weight=torch.sum(buf_new.weight * occupied),
                    buf_stale_hist=obs_bus.staleness_hist(occupied, new_age,
                                                          cfg)))

    metrics = AsyncMetrics(
        round=round_metrics,
        fresh=torch.sum(fresh),
        departed=torch.sum(depart),
        merged=torch.sum(deliver),
        dropped=torch.sum(dropped),
        occupancy=torch.sum(occupied),
        fresh_weight=torch.sum(w_fresh),
        departed_weight=torch.sum(w_agg * depart),
        stale_weight=torch.sum(w_stale),
        dropped_weight=torch.sum(buf.weight * dropped),
        buffered_weight=torch.sum(buf_new.weight * occupied),
        max_age=torch.max(occupied * new_age).to(torch.float32))
    return new_state, buf_new, metrics


# ---------------------------------------------------------------------------
# Drive loops
# ---------------------------------------------------------------------------

def async_run_rounds(state: FedState, batch_fn: Callable,
                     loss_pair: Callable, cfg, T: int, device="cuda", *,
                     buf: Optional[StaleBuffer] = None, block: int = 0,
                     progress: Optional[Callable] = None,
                     on_chunk: Optional[Callable] = None):
    """``rounds.run_rounds`` with the staleness buffer in the carry (the
    same keywords).  ``buf=None`` starts from a fresh :func:`init_buffer`
    (None when disabled).  Returns ``(final state, final buffer,
    metrics)`` with :class:`AsyncMetrics` on the host (``[T]`` leading
    axis); ``metrics.round`` is the synchronous record, bit for bit the
    synchronous drive loops' at the parity point."""
    dev = resolve_device(device)
    if buf is None:
        buf = init_buffer(state, cfg)

    def step(carry, b):
        s, bf = carry
        s, bf, mets = async_round_step(s, bf, b, loss_pair, cfg, device=dev)
        return (s, bf), mets
    carry = (state, buf)
    if cfg.obs.enabled:
        step = obs_bus.window_wrap(
            step, cfg, sigma_of=lambda m: m.round.sigma,
            tel_get=lambda m: m.round.telemetry,
            tel_set=lambda m, tel: m._replace(
                round=m.round._replace(telemetry=tel)))
        carry = (carry, obs_bus.ring_init(cfg, dev))
    carry, mets = rounds.drive_loop(step, carry, batch_fn, cfg, T, state.t,
                                    block=block, progress=progress,
                                    on_chunk=on_chunk)
    state, buf = carry[0] if cfg.obs.enabled else carry
    return state, buf, mets


def async_drive(state: FedState, batches, loss_pair: Callable, cfg, T: int,
                device="cuda", **kw):
    """:func:`async_run_rounds` on fixed per-client ``batches`` or on a
    :class:`repro_torch.fleet.Fleet` (the keywords are its own)."""
    return async_run_rounds(state, lambda t, gen: batches, loss_pair, cfg,
                            T, device, **kw)
