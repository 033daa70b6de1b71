"""The federation round engine (port of ``repro.engine.rounds``).

One :func:`round_step` is a full communication round, the paper's
Algorithm 1:

  1. sample S_t (``cfg.fleet.sampler``), executed dense-mask or
     compute-sparse gather (``cfg.participation``, engine.participation);
     with a :class:`repro_torch.fleet.Fleet` as ``batches``, provision this
     round's per-client minibatches (``fleet.provision.minibatch``: all n
     clients, or only the m sampled when the eval is sparse),
  2. constraint query: (f_j, g_j) at w_t for every client, aggregated over
     the participants (and over all clients for the ``*_full`` metrics),
  3. strategy switch weight sigma_t,
  4. E local steps per client (all n in mask mode, the m participants in
     gather mode) on the strategy's objective,
  5. uplink EF14 compression of Delta_j = (w_t - w_{j,E}) / eta through the
     flat transport (the wire kernels),
  6. strategy server update x_{t+1} from the server center x_t,
  7. downlink primal-EF21 broadcast w_{t+1} = w_t + C_0(x_{t+1} - w_t).

Between sampling and the next :class:`FedState` the model is ONE contiguous
``[d]`` buffer.  Unlike the reference's pytree ``FedState.w``, the port's
state holds that flat buffer itself; ``flat.unflatten(state.spec, state.w)``
gives the parameter views.  Clients run one after another; each client's
gradient comes from autograd on a flat leaf, through the views of
``unflatten``.

When the eval rows are the local-step rows -- ``full_eval=False`` (the m
sampled clients), or full participation in mask mode (all n) -- and the
strategy's objective factors through ``blend_values``, stages 2 and 4 fuse
as in the reference: each row's (f_j, g_j) forward keeps its graph, sigma
comes from their aggregate, and the first local step's gradient is the
backward of that same forward seeded with ``d(blend)/d(f_j, g_j)``.  One
forward per client fewer per round.  Elsewhere the eval is a separate
no-grad forward.

The compression randomness of the random kinds is one
:class:`repro_torch.comm.transports.WireKey` per round and direction
(seed, round, direction), from which each client's generator derives; the
fleet's rows come from a :class:`repro_torch.fleet.provision.ProvisionKey`
in the same manner.

:func:`drive` runs T rounds on fixed batches or a fleet and
:func:`run_rounds` takes per-round batches from a function; both move the
metrics to the host once per segment of ``block`` rounds (once in all by
default).  The stages run inside ``repro_torch.obs.trace.stage`` spans
(``round.sample_round``, ``round.eval_round``, ``round.local_deltas``,
``round.encode_reduce``, ``round.server_update``, ``round.downlink``,
``round.telemetry``); with ``cfg.obs.enabled`` each round's metrics carry a
:class:`repro_torch.obs.Telemetry` record.

With ``cfg.scale.ef_slots`` the uplink residual is a
:class:`repro_torch.scale.slots.SlotStore` (a ``[cap, d]`` pool, gather mode
only) instead of the dense ``[n, d]`` stack; ``cfg.scale.cohorts`` makes the
uplink's reduce two-tier (``comm.flat``).  ``cfg.client_chunk`` is the
reference's chunked client vmap, a bound on its activation memory: the port
runs the clients one after another whatever its value, and per-client
results do not depend on it (the reference's own law), so every chunk gives
the same trajectory.

Across ranks: under ``sharding.partition.activate_mesh`` with a rank mesh
(``launch.mesh.make_rank_mesh`` over the caller's default
``torch.distributed`` group), the same functions run one round on every
rank.  The population state is split into contiguous blocks of clients
(``init_state``: the dense residual, the slot store's pool; a fleet under
``scale.shard.constrain_fleet``), and the round's rows (all n in mask
mode, the m sampled in gather mode) into contiguous blocks of the row
list.  Each rank evaluates and steps its own rows; the per-row ``(f_j,
g_j)`` and the wire messages are all-gathered in row order
(``partition.all_rows``), and the
aggregates, sigma, the reduce, the server step and the downlink run
replicated.  Every rank ends each round with one process's ``w``, ``x``,
averaged-iterate sums and metrics, bit for bit.  The telemetry bus,
asynchronous rounds, checkpoints and the wire runtime refuse a rank mesh.

With a model axis on the rank mesh (``make_rank_mesh(shape=(D, M),
axes=("data", "model"))``) the flat state is split by columns as well
(``comm.flat.columns_for``; the reference's ``constrain_flat`` sites):
each model rank holds only its columns of ``w``, ``x``, the
averaged-iterate sum and the residual (the dense stack's or the slot
store's pool: ``partition.FlatShard`` state, client rows x columns on a
2-D mesh).  The uplink (EF14, the payloads, the reduce), the server step
and the downlink run on the columns.  The model computes in the tensor
layout of the state's plan (``init_state(..., plan=...)``, from
``models.build(cfg).tensor_plan``; ``comm.flat.TensorLayout``): at the
start of each round the new ``w``'s columns go into each rank's
tensor-local buffer, the model ranks share each client's forward and
backward (the dense family's heads, ffn and vocab split over them; the
other leaves, and every leaf of a plan with no split, whole on each
rank), and each delta row goes back to the columns as soon as it is
computed.  Under a plan with no split leaf the tensor layout is the whole
``w`` (one all-gather of the columns a round) and every rank ends each
round with one process's state, bit for bit; a split plan adds the
row-parallel sums in another order (allclose).  The whole-``[d]`` norms
(``delta_norm``, the projection's) add per-rank partials
(``flat.tree_norm``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.comm import flat, transports
from repro_torch.comm.flat import flat_transports_for
from repro_torch.core.compression import message_bytes
from repro_torch.engine import participation, strategies
from repro_torch.fleet import provision, samplers
from repro_torch.fleet.partitions import leaves_of, rebuild
from repro_torch.obs import bus as obs_bus
from repro_torch.obs.trace import stage
from repro_torch.optim.sgd import axpy
from repro_torch.scale import slots as slot_store
from repro_torch.sharding import partition


class FedState(NamedTuple):
    w: torch.Tensor               # broadcast model w_t, flat [d]
    x: Optional[torch.Tensor]     # server center x_t, flat [d] (None unless
                                  # the downlink compresses: then x == w)
    e_up: object                  # uplink EF residuals: [n_clients, d],
                                  # a scale.slots.SlotStore, or None
    wbar_sum: Optional[torch.Tensor]  # weighted sum of w_t, flat [d]
    # (under a model axis w, x, wbar_sum and the residual, or the
    # store's pool, are partition.FlatShard: this rank's columns)
    wbar_weight: torch.Tensor
    t: int
    gen: torch.Generator          # participation draws (CPU)
    spec: flat.FlatSpec
    sampler: object = None        # client-sampler state (None for the
                                  # stateless laws)
    plan: object = None           # partition.TensorPlan of the model's
                                  # leaves under a model axis (None: no
                                  # leaf split)


class RoundMetrics(NamedTuple):
    f: torch.Tensor           # mean client objective at w_t (participating)
    g_hat: torch.Tensor       # aggregated constraint estimate
    g_full: torch.Tensor      # constraint over all clients
    sigma: torch.Tensor       # switching weight used
    feasible: torch.Tensor    # 1{G_hat <= eps}
    delta_norm: torch.Tensor
    up_bytes: torch.Tensor    # wire bytes of one client's uplink message
    down_bytes: torch.Tensor  # wire bytes of one broadcast
    f_full: torch.Tensor      # mean objective over all clients
    telemetry: object = None  # repro_torch.obs.Telemetry when
                              # cfg.obs.enabled; None otherwise


def check_ported(cfg) -> None:
    """Raise for the parts of a FedConfig the port does not run yet (and
    for a config the strategy rejects).  Every ``client_chunk`` runs: the
    clients go one after another (see the module docstring)."""
    if cfg.participation not in participation.MODES:
        raise NotImplementedError(
            f"participation mode {cfg.participation!r} is not ported yet")
    samplers.get_sampler(cfg.fleet.sampler)
    strategies.get_strategy(cfg.strategy).validate(cfg)


def transports_for(cfg):
    """(uplink, downlink) capability transports for a federation config."""
    backend = transports.backend_for(cfg.comm)
    return (transports.get_transport(cfg.uplink, backend),
            transports.get_transport(cfg.downlink, backend))


def init_state(params, cfg, device="cuda", plan=None) -> FedState:
    """Round-0 state: the flattened ``params`` on ``device`` (``cuda``
    unless the caller asks for the CPU) and the zero uplink residual --
    the dense ``[n, d]`` stack, or with ``cfg.scale.ef_slots`` an empty
    :class:`repro_torch.scale.slots.SlotStore` of that capacity (after
    ``slots.validate``).  ``plan``: the model's
    :class:`~repro_torch.sharding.partition.TensorPlan` under a model axis
    (``models.build(model_cfg).tensor_plan(flat.spec_of(params))``), the
    leaves its layers split; None or a plan with no split leaf: the model
    whole on every rank."""
    dev = resolve_device(device)
    check_ported(cfg)
    spec = flat.spec_of(params)
    w = flat.flatten(spec, params).to(dev).contiguous()
    uplink, downlink = transports_for(cfg)
    cols = flat.columns_for(cfg, spec)
    split = None if cols is None else cols.split
    if plan is not None and plan.split and (
            cols is None or plan.size != len(split.cuts) - 1
            or len(plan.dims) != len(spec.leaves)):
        raise ValueError(f"a plan that splits {plan.size} ways needs a "
                         "model axis of that size and the params' leaves")
    w = partition.constrain_flat(w, split)
    e_up = None
    if uplink.needs_residual:
        if cfg.scale.ef_slots:
            slot_store.validate(cfg)
            e_up = slot_store.init(cfg.n_clients, cfg.scale.ef_slots,
                                   spec.d, spec.dtype, dev, split)
        else:
            e_up = partition.flat_zeros((cfg.n_clients, spec.d),
                                        spec.dtype, dev, split)
    return FedState(
        # x starts as w itself: no round updates either buffer in place
        # (under a model axis, this rank's columns of it)
        w=w, x=w if downlink.tracks_center else None, e_up=e_up,
        wbar_sum=(partition.flat_zeros((spec.d,), spec.dtype, dev, split)
                  if cfg.track_wbar else None),
        wbar_weight=torch.zeros((), dtype=torch.float32, device=dev),
        t=0, gen=torch.Generator().manual_seed(cfg.seed), spec=spec,
        sampler=samplers.get_sampler(cfg.fleet.sampler).init(cfg),
        plan=plan)


def state_device(state: FedState) -> torch.device:
    """The device the state lives on."""
    return partition.flat_local(state.w).device


def averaged_iterate(state: FedState) -> dict:
    """w_bar, the theorems' averaged iterate over the weighted rounds, as
    parameter views (w_t itself before any round carried weight); under a
    model axis gathered whole on every rank."""
    w = partition.whole(state.w)
    if state.wbar_sum is None:
        return flat.unflatten(state.spec, w)
    wgt = torch.clamp(state.wbar_weight, min=1e-12)
    return flat.unflatten(state.spec, torch.where(
        state.wbar_weight > 0, partition.whole(state.wbar_sum) / wgt, w))


def sample_round(state: FedState, cfg, fleet=None):
    """Stage 1: draw S_t with the configured sampler law (the weighted law
    reads the fleet's host counts).  Returns ``(part, sampler state)``."""
    mask, weights, samp_state = samplers.get_sampler(
        cfg.fleet.sampler).sample(state.gen, cfg, state.sampler, fleet=fleet)
    return (participation.finalize(mask, weights, cfg, state_device(state)),
            samp_state)


def client_batch(batches, j: int):
    """Client j's rows of a stacked ``[n, ...]`` batch: a NamedTuple, a
    plain tuple or a single tensor, rebuilt as the same type."""
    return rebuild(batches, [x[j] for x in leaves_of(batches)])


def n_rows(batches) -> int:
    """The leading (client) axis of a stacked batch."""
    return leaves_of(batches)[0].shape[0]


def eval_clients(params, batches, loss_pair: Callable, n: int):
    """Stage 2's per-client eval forward: ``(f_j, g_j)`` for j < n."""
    with torch.no_grad():
        pairs = [loss_pair(params, client_batch(batches, j))
                 for j in range(n)]
    if not pairs:       # a rank with no rows under a rank mesh (the
        # gather of the rows gives it rank 0's dtype)
        z = torch.empty((0,), dtype=torch.float32)
        return z, z
    return (torch.stack([p[0] for p in pairs]),
            torch.stack([p[1] for p in pairs]))


def _eval_aggregates(part, f_ev, g_ev, sparse_eval: bool, m: int):
    """Participating and all-evaluated aggregates of the per-row (f, g):
    ``sparse_eval`` when the rows are the m gathered participants."""
    w_agg = participation.agg_weights(part)
    if sparse_eval:
        w_agg = w_agg.index_select(0, part.idx)
    g_hat = torch.sum(w_agg * g_ev) / m
    f_part = torch.sum(w_agg * f_ev) / m
    return f_part, g_hat, g_ev.mean(), f_ev.mean()


def _eval_rows(pairs, total: int, device):
    """The per-row ``(f_j, g_j)`` of the eval as two ``[rows]`` stacks:
    under a rank mesh this rank's block is all-gathered into the ``total``
    rows."""
    if not pairs:       # no rows here: the gather gives rank 0's dtype
        z = torch.empty((0,), dtype=torch.float32, device=device)
        f_ev = g_ev = z
    else:
        f_ev = torch.stack([f.detach() for f, _ in pairs])
        g_ev = torch.stack([g.detach() for _, g in pairs])
    return partition.all_rows((f_ev, g_ev), total)


def local_deltas(wf, spec, strat, sigma, local_b, loss_pair: Callable, cfg,
                 n: int, first=None, cols=None) -> torch.Tensor:
    """Stage 4: E local SGD steps for each of the n rows of ``local_b`` on
    the strategy objective, ``Delta_j = (wf - w_{j,E}) / eta`` as one
    ``[n, d]`` stack.  Under a model axis ``cols`` is this rank's
    :class:`comm.flat.TensorLayout`: ``wf`` and ``spec`` are the tensor
    layout's, and each row goes to the columns (``[n, cols.cols.width]``)
    as soon as it is computed.  ``first(j)``, when given, is row j's
    first-step gradient (the fused round's backward); the other steps are
    ordinary forward + backward passes."""
    E, eta = cfg.local_steps, cfg.lr
    obj = strat.local_objective(loss_pair, sigma, cfg)
    deltas = torch.empty((n, spec.d if cols is None else cols.cols.width),
                         dtype=wf.dtype, device=wf.device)
    for j in range(n):
        batch = client_batch(local_b, j)
        w = wf
        for step in range(E):
            if step == 0 and first is not None:
                grad = first(j)
            else:
                leaf = w.detach().requires_grad_(True)
                (grad,) = torch.autograd.grad(
                    obj(flat.unflatten(spec, leaf), batch), leaf)
            w = w - eta * grad
        if cols is None:
            torch.sub(wf, w, out=deltas[j])
            deltas[j].div_(eta)
        else:
            cols.to_columns(torch.sub(wf, w).div_(eta), deltas[j])
    return deltas


def fuses(part, strat, cfg) -> bool:
    """Whether the round fuses its eval with the first local step: the eval
    rows must be the local-step rows (``full_eval`` off, or mask mode at
    full participation) and the strategy's objective must factor through
    ``blend_values`` (overriding ``local_objective`` opts out).  Partial
    participation in mask mode stays unfused, as in the reference, so that
    mask and gather mode run the same eval."""
    return ((not cfg.full_eval
             or (part.idx is None and cfg.m >= cfg.n_clients))
            and type(strat).local_objective
            is strategies.Strategy.local_objective)


def _fused_eval(wf, spec, strat, local_b, loss_pair: Callable, cfg, part,
                sparse_eval: bool):
    """The fused round's stages 2-3: row j's (f_j, g_j) forward on its own
    leaf, graph kept; the aggregates and sigma; then ``first(j)``, row j's
    step-1 gradient, the backward of that forward seeded with
    ``d(blend)/d(f_j, g_j)`` (per row: penalty-fedavg's seed depends on
    g_j).  Returns ``(aggregates, sigma, first)``."""
    leaves, pairs = [], []
    for j in range(n_rows(local_b)):
        leaf = wf.detach().requires_grad_(True)
        pairs.append(loss_pair(flat.unflatten(spec, leaf),
                               client_batch(local_b, j)))
        leaves.append(leaf)
    f_ev, g_ev = _eval_rows(pairs, cfg.m if sparse_eval else cfg.n_clients,
                            wf.device)
    aggs = _eval_aggregates(part, f_ev, g_ev, sparse_eval, cfg.m)
    sigma = strat.switch_weight(aggs[1], cfg)

    def first(j):
        fj, gj = (v.detach().requires_grad_(True) for v in pairs[j])
        seeds = torch.autograd.grad(strat.blend_values(fj, gj, sigma, cfg),
                                    (fj, gj))
        (grad,) = torch.autograd.grad(pairs[j], leaves[j], seeds)
        pairs[j] = leaves[j] = None        # row j's graph is spent
        return grad

    return aggs, sigma, first


def compute_round(state: FedState, wf, spec, batches, part, strat,
                  loss_pair: Callable, cfg, fleet=None, cols=None):
    """Stages 2-4 on the flat buffer: the fleet's minibatches (when
    ``fleet`` is given; ``batches`` is then ignored), the constraint query,
    the switch weight and the E local steps over the local rows (all n in
    mask mode, the m gathered participants in gather mode).  The eval runs
    over all n clients unless ``full_eval`` is off (then over the m
    participants, and only their minibatches are provisioned), and fuses
    with the first local step where :func:`fuses` says so.  Returns
    ``(f_part, g_hat, g_full, f_full, sigma, deltas)``; ``deltas`` is
    ``[n, d]`` or ``[m, d]`` (under a rank mesh, this rank's block of
    them; the eval's rows are gathered before the aggregates).  Under a
    model axis ``wf`` and ``spec`` are the tensor layout ``cols``'s (a
    :class:`comm.flat.TensorLayout`) and the rows of ``deltas`` its
    columns."""
    sparse_eval = part.idx is not None and not cfg.full_eval
    pre_gathered = fleet is not None and sparse_eval
    if fleet is not None:
        batches = provision.minibatch(
            fleet, provision.round_key(cfg, state.t), cfg,
            idx=part.host_idx if sparse_eval else None)
    local_b = batches if pre_gathered else participation.gather(part,
                                                                batches)
    n_local = n_rows(local_b)
    with stage("round.eval_round"):
        if fuses(part, strat, cfg):
            aggs, sigma, first = _fused_eval(wf, spec, strat, local_b,
                                             loss_pair, cfg, part,
                                             sparse_eval)
        else:
            eval_b = local_b if sparse_eval else \
                participation.own_rows(batches)
            f_ev, g_ev = eval_clients(flat.unflatten(spec, wf), eval_b,
                                      loss_pair, n_rows(eval_b))
            f_ev, g_ev = partition.all_rows(
                (f_ev.to(wf.device), g_ev.to(wf.device)),
                cfg.m if sparse_eval else cfg.n_clients)
            aggs = _eval_aggregates(part, f_ev, g_ev, sparse_eval, cfg.m)
            sigma, first = strat.switch_weight(aggs[1], cfg), None
    with stage("round.local_deltas"):
        deltas = local_deltas(wf, spec, strat, sigma, local_b, loss_pair,
                              cfg, n_local, first, cols)
    return (*aggs, sigma, deltas)


def finish_round(state: FedState, strat, cfg, spec, wf, part, deltas, v_bar,
                 e_up, uplink, downlink, samp_state, f_part, g_hat, g_full,
                 f_full, sigma, slot_stats=None, cols=None
                 ) -> tuple[FedState, RoundMetrics]:
    """Stages 6-7 + bookkeeping, shared with the asynchronous round: server
    update of the center on the aggregated direction, primal-EF21 downlink
    broadcast, averaged-iterate accounting, metrics (with the telemetry
    record when ``cfg.obs.enabled``; ``slot_stats`` is the slot store's
    :class:`repro_torch.scale.slots.SlotStats` from the uplink call site,
    None for a dense residual).  Under a model axis (``cols``) ``v_bar``,
    ``deltas`` and the transports are the columns': the new ``w``, ``x``
    and the averaged-iterate sum stay split by columns (``wf`` is then the
    tensor layout's buffer, read by the telemetry only)."""
    split = None if cols is None else cols.split
    w_cols = wf if cols is None else partition.flat_local(state.w)
    with stage("round.server_update"):
        xf = partition.flat_local(state.x) if state.x is not None \
            else w_cols
        x_new = strat.server_update(xf, v_bar, cfg, spec, cols)
    with stage("round.downlink"):
        w_new = downlink.broadcast(
            w_cols, x_new, key=transports.WireKey(cfg.seed, state.t,
                                                  transports.DOWNLINK))
        if cols is not None:
            w_new = partition.FlatShard(w_new, split)
            x_new = partition.FlatShard(x_new, split)
    alpha = strat.iterate_weight(g_hat, cfg)
    wbar_sum = None
    if state.wbar_sum is not None:
        wbar_sum = axpy(alpha, w_cols, partition.flat_local(state.wbar_sum))
        if cols is not None:
            wbar_sum = partition.FlatShard(wbar_sum, split)
    dev = wf.device
    delta_norm = torch.zeros((), device=dev) if cfg.lean_metrics else \
        participation.aggregate_norm(part, deltas,
                                     lambda v: flat.tree_norm(spec, v, cols))
    telemetry = None
    if cfg.obs.enabled:
        with stage("round.telemetry"):
            telemetry = obs_bus.round_telemetry(
                cfg, deltas, e_up, x_new, wf, w_new, g_hat, sigma, uplink,
                downlink, slot_stats)
    metrics = RoundMetrics(
        f=f_part, g_hat=g_hat, g_full=g_full, sigma=sigma,
        feasible=(g_hat <= cfg.switch.eps).to(torch.float32),
        delta_norm=delta_norm,
        up_bytes=torch.tensor(float(uplink.wire_bytes()), device=dev),
        down_bytes=torch.tensor(float(downlink.wire_bytes()), device=dev),
        f_full=f_full, telemetry=telemetry)
    new_state = FedState(
        w=w_new, x=x_new if downlink.tracks_center else None, e_up=e_up,
        wbar_sum=wbar_sum, wbar_weight=state.wbar_weight + alpha,
        t=state.t + 1, gen=state.gen, spec=spec, sampler=samp_state,
        plan=state.plan)
    return new_state, metrics


def round_step(state: FedState, batches, loss_pair: Callable, cfg,
               device="cuda") -> tuple[FedState, RoundMetrics]:
    """One engine round on ``device`` (``cuda`` unless the caller asks for
    the CPU; the state must live there).  ``batches`` is a NamedTuple, a plain
    tuple or a single tensor of ``[n_clients, ...]`` rows, or a :class:`repro_torch.fleet.Fleet`:
    then this round's per-client minibatches are provisioned from its
    shards.

    The uplink residual ``state.e_up`` is updated in place (the ``[n, d]``
    buffer, or the slot store's pool, is the largest state of a round); the
    returned state holds it.  In gather mode the local steps run over the m
    participants only."""
    dev = resolve_device(device)
    if state_device(state) != dev:
        raise ValueError(f"round_step on {dev}: the state lives on "
                         f"{state_device(state)}")
    check_ported(cfg)
    strat = strategies.get_strategy(cfg.strategy)
    fleet = batches if isinstance(batches, provision.Fleet) else None
    with stage("round.sample_round"):
        part, samp_state = sample_round(state, cfg, fleet)
    spec, wf = state.spec, state.w
    cols = flat.columns_for(cfg, spec)
    layout, mspec = None, spec
    if cols is not None:
        # the model computes in the tensor layout: the new w's columns
        # into this rank's tensor-local buffer
        layout = flat.tensor_layout(spec, cols, state.plan)
        with stage("round.to_tensor"):
            wf = layout.to_tensor(partition.flat_local(state.w))
        mspec = layout.spec
    f_part, g_hat, g_full, f_full, sigma, deltas = compute_round(
        state, wf, mspec, batches, part, strat, loss_pair, cfg, fleet,
        layout)
    uplink, downlink = flat_transports_for(cfg, spec, cols)
    with stage("round.encode_reduce"):
        v_bar, e_up, slot_stats = participation.transmit(
            uplink, partition.map_tensors(partition.flat_local, state.e_up),
            deltas, part,
            key=transports.WireKey(cfg.seed, state.t, transports.UPLINK),
            t=state.t)
    return finish_round(state, strat, cfg, spec, wf, part, deltas, v_bar,
                        _columns_of(e_up, state.e_up), uplink, downlink,
                        samp_state, f_part, g_hat, g_full, f_full, sigma,
                        slot_stats=slot_stats, cols=cols)


def _columns_of(e_new, e_old):
    """The residual after the uplink with ``e_old``'s column shards: the
    residual rows, or the slot store's pool, were updated in place, so the
    old :class:`partition.FlatShard` holds them."""
    if isinstance(e_old, partition.FlatShard):
        return e_old
    if isinstance(e_old, slot_store.SlotStore) and \
            isinstance(e_old.pool, partition.FlatShard):
        return e_new._replace(pool=e_old.pool)
    return e_new


def run_rounds(state: FedState, batch_fn: Callable, loss_pair: Callable,
               cfg, T: int, device="cuda", *, block: int = 0,
               progress: Optional[Callable] = None,
               on_chunk: Optional[Callable] = None):
    """Drive T rounds; ``batch_fn(t, gen) -> batches`` supplies per-round
    data on ``device`` from a CPU ``torch.Generator`` seeded ``cfg.seed +
    1`` (CPU draws are the same on every run and device).

    * ``block``: rounds per metric segment.  Metrics stay on the device
      and move to the host once per segment, as numpy arrays (0: one
      segment of T rounds).
    * ``on_chunk``: called with each segment's host metrics as it lands
      (the metrics-sink hook).
    * ``progress``: ``progress(t, f, g_hat, sigma)`` for every round, in
      order, as each segment lands (``t`` counts rounds done).

    Returns ``(final state, metrics)`` with a leading ``[T]`` axis; with
    ``cfg.obs.enabled`` the telemetry's ``switch_frac`` is the mean sigma
    over the trailing ``cfg.obs.window`` rounds."""
    dev = resolve_device(device)

    def step(s, b):
        return round_step(s, b, loss_pair, cfg, device=dev)
    carry = state
    if cfg.obs.enabled:
        # the trailing switch-fraction ring rides the loop's carry
        step = obs_bus.window_wrap(
            step, cfg, sigma_of=lambda m: m.sigma,
            tel_get=lambda m: m.telemetry,
            tel_set=lambda m, tel: m._replace(telemetry=tel))
        carry = (state, obs_bus.ring_init(cfg, dev))
    carry, mets = drive_loop(step, carry, batch_fn, cfg, T, state.t,
                             block=block, progress=progress,
                             on_chunk=on_chunk)
    return (carry[0] if cfg.obs.enabled else carry), mets


def drive(state: FedState, batches, loss_pair: Callable, cfg, T: int,
          device="cuda", **kw):
    """``run_rounds`` on fixed per-client ``batches`` or on a
    :class:`repro_torch.fleet.Fleet` (each round provisions its own
    minibatches; ``cfg.fleet.redraw`` for fresh draws every round); the
    keywords are ``run_rounds``'s."""
    return run_rounds(state, lambda t, gen: batches, loss_pair, cfg, T,
                      device, **kw)


def drive_loop(step: Callable, carry, batch_fn: Callable, cfg, T: int,
               t0: int, *, block: int = 0,
               progress: Optional[Callable] = None,
               on_chunk: Optional[Callable] = None):
    """The loop behind :func:`run_rounds` and
    ``async_rounds.async_run_rounds``: ``carry, mets = step(carry,
    batch_fn(t, gen))`` for T rounds, the metrics moved to the host once
    per ``block`` rounds (see :func:`run_rounds`; ``t0`` is the rounds done
    before the first).  Returns ``(carry, stacked host metrics)``."""
    gen = torch.Generator().manual_seed(cfg.seed + 1)
    block = max(1, min(int(block) if block else T, T))
    chunks, history = [], []
    for t in range(T):
        carry, mets = step(carry, batch_fn(t, gen))
        history.append(mets)
        if len(history) == block or t == T - 1:
            host = _stack(history)
            history = []
            chunks.append(host)
            if on_chunk is not None:
                on_chunk(host)
            if progress is not None:
                rm = host.round if hasattr(host, "round") else host
                first = t0 + t + 2 - len(rm.f)
                for i in range(len(rm.f)):
                    progress(first + i, rm.f[i], rm.g_hat[i], rm.sigma[i])
    return carry, _concat(chunks)


def _stack(history):
    """Per-round metric records (NamedTuples of 0-d or small device
    tensors, possibly nested, None fields kept) -> one record of host
    numpy arrays with a leading round axis."""
    first = history[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.stack(history).cpu().numpy()
    return type(first)(*(_stack([getattr(h, f) for h in history])
                         for f in first._fields))


def _concat(chunks):
    """Host metric segments -> one record (concatenated round axes)."""
    first = chunks[0]
    if first is None:
        return None
    if isinstance(first, np.ndarray):
        return np.concatenate(chunks, axis=0)
    return type(first)(*(_concat([getattr(c, f) for c in chunks])
                         for f in first._fields))


def round_bytes(params, cfg) -> dict:
    """Wire bytes of one round per participating client: ``uplink`` /
    ``downlink`` are the analytic ``message_bytes``, ``measured_up`` /
    ``measured_down`` the flat wire's own accounting for ``cfg.comm``."""
    spec = flat.spec_of(params)
    uplink, downlink = flat_transports_for(cfg, spec)
    up = message_bytes(params, cfg.uplink)
    down = message_bytes(params, cfg.downlink)
    dense = message_bytes(params, type(cfg.uplink)(kind="none"))
    return {"uplink": up, "downlink": down, "dense": dense,
            "measured_up": uplink.wire_bytes(),
            "measured_down": downlink.wire_bytes(),
            "savings_up": 1.0 - up / dense, "savings_down": 1.0 - down / dense}
