"""Asynchronous buffered rounds of the port (``repro_torch.engine.
async_rounds``) against the JAX package, on the CPU, at the NP size of
``tests/test_async.py``: N = 8 clients, m = 4, E = 2, the reference's NP
shards.

The two packages' random draws cannot match, so the whole-round parity
replays the same recorded cohorts (``fixed`` sampler) on both sides and
feeds the reference's own event uniforms -- redone from its key split
(``async_rounds.py:301``, then ``samplers.py:166-170``) -- into the port's
event core through a sampler the test registers.

Tolerances and why:

* staleness laws at rtol 1e-6 (XLA's and PyTorch's ``pow`` / ``exp`` differ
  in the last place);
* event cores bit-equal (0/1 masks from the same uniforms);
* whole async rounds: the counters (``fresh``, ``departed``, ``merged``,
  ``dropped``, ``occupancy``, ``max_age``) exactly; the HT masses and the
  round metrics at rtol 1e-6; w within 1e-6 absolute; the parked buffer's
  integer leaves (origin, occupancy, uint16 offsets, uint32 words)
  bit-equal, its float leaves at rtol 1e-5 / atol 1e-6 (the reordered sums
  and the quant residual's ulps of ROADMAP Queue 3, carried through the
  rounds);
* the port's async drive loops with the buffer off against its
  synchronous ones: bit-equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import flat as jax_flat
from repro.configs.base import (AsyncConfig as JAsyncConfig,
                                CompressorConfig as JCompressorConfig,
                                FedConfig as JFedConfig,
                                FleetConfig as JFleetConfig,
                                SwitchConfig as JSwitchConfig)
from repro.engine import async_rounds as jax_async
from repro.engine import rounds as jax_rounds
from repro.engine import strategies as jax_strategies
from repro.fleet import samplers as jax_samplers
from repro.tasks import np_classification as jax_npc
from repro_torch.comm import payloads
from repro_torch.configs.base import (AsyncConfig, CompressorConfig,
                                      FedConfig, FleetConfig, SwitchConfig)
from repro_torch.engine import (async_rounds, participation, rounds,
                                strategies)
from repro_torch.fleet import provision, samplers
from repro_torch.tasks import np_classification as npc
from torch_port_util import assert_bits_equal, n, t

EPS = 0.35
N, M = 8, 4

KINDS = {
    "none": dict(kind="none"),
    "topk": dict(kind="topk", ratio=0.25, block=8),
    "randk": dict(kind="randk", ratio=0.25, block=8),
    "quant": dict(kind="quant", bits=8, block=8),
    "quant4": dict(kind="quant", bits=4, block=8),
    "natural": dict(kind="natural"),
}
STRATS = ("fedsgm", "fedsgm-soft", "penalty-fedavg")
MODES = ("mask", "gather")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def np_data():
    (xs, ys), _ = jax_npc.make_dataset(jax.random.PRNGKey(0), n_clients=N)
    return np.asarray(xs), np.asarray(ys)


def _cfgs(up="none", down="none", async_=None, fleet=None, **kw):
    """The same FedConfig in both packages (``up``/``down`` name KINDS)."""
    out = []
    for fed, cc, sw, ac, fl in (
            (JFedConfig, JCompressorConfig, JSwitchConfig, JAsyncConfig,
             JFleetConfig),
            (FedConfig, CompressorConfig, SwitchConfig, AsyncConfig,
             FleetConfig)):
        out.append(fed(n_clients=N, m=M, local_steps=2, lr=0.1,
                       switch=sw(mode="hard", eps=EPS),
                       uplink=cc(**KINDS[up]), downlink=cc(**KINDS[down]),
                       async_=ac(**(async_ or {})),
                       fleet=fl(**(fleet or {})), **kw))
    return out


def _async(**kw):
    base = dict(enabled=True, max_staleness=3, staleness="constant",
                depart=0.5)
    base.update(kw)
    return base


def _params():
    return {"w": torch.zeros(30), "b": torch.zeros(())}


def _batch(np_data):
    xs, ys = np_data
    return npc.NPBatch(t(xs), t(ys))


# ---------------------------------------------------------------------------
# Staleness laws
# ---------------------------------------------------------------------------

S = np.array([0.0, 1.0, 2.0, 3.0, 4.0, 7.0, 10.0, 1.0], np.float32)
SIGMA = np.array([0.0, 1.0, 0.5, 0.0, 1.0, 0.25, 0.9, 0.0], np.float32)
G_HATS = [EPS, EPS + 0.01, EPS - 0.2, -1.0, EPS + 100.0]


@pytest.mark.parametrize("decay", [1.0, 0.5, 2.0])
@pytest.mark.parametrize("law", ["constant", "poly", "constraint"])
def test_staleness_laws_match_reference(law, decay):
    jcfg, cfg = _cfgs(async_=_async(staleness=law, decay=decay,
                                    boundary_width=0.1 if decay == 2.0
                                    else 0.0))
    for g in G_HATS:
        want = jax_async.get_staleness_law(law)(
            jnp.asarray(S), jnp.asarray(SIGMA), jnp.float32(g), jcfg)
        got = async_rounds.get_staleness_law(law)(
            t(S), t(SIGMA), torch.tensor(g, dtype=torch.float32), cfg)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-6)


def test_staleness_law_registry():
    assert async_rounds.staleness_law_names() == \
        jax_async.staleness_law_names()
    with pytest.raises(ValueError, match="unknown staleness law"):
        async_rounds.get_staleness_law("exponential")


@pytest.mark.parametrize("law", ["constant", "poly", "constraint"])
@pytest.mark.parametrize("strategy", STRATS)
def test_strategy_staleness_weight_matches_reference(strategy, law):
    """Every strategy dispatches the configured law; penalty-fedavg turns
    ``constraint`` into ``poly``."""
    jcfg, cfg = _cfgs(strategy=strategy, async_=_async(staleness=law))
    want = jax_strategies.get_strategy(strategy).staleness_weight(
        jnp.asarray(S), jnp.asarray(SIGMA), jnp.float32(EPS), jcfg)
    got = strategies.get_strategy(strategy).staleness_weight(
        t(S), t(SIGMA), torch.tensor(EPS, dtype=torch.float32), cfg)
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-6)
    if strategy == "penalty-fedavg" and law == "constraint":
        poly = async_rounds.get_staleness_law("poly")(
            t(S), t(SIGMA), torch.tensor(EPS), cfg)
        assert_bits_equal(got, poly)


# ---------------------------------------------------------------------------
# Event cores, on the reference's own uniforms
# ---------------------------------------------------------------------------

MASK = np.array([1, 0, 1, 1, 0, 1, 0, 0], np.float32)


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("depart,rejoin", [(0.25, 0.5), (0.5, 0.5),
                                           (1.0, 1.0), (0.0, 0.0)])
def test_default_events_core_matches_reference(seed, depart, rejoin):
    jcfg, _ = _cfgs(async_=_async(depart=depart, rejoin=rejoin))
    key = jax.random.PRNGKey(seed)
    ev, st = jax_samplers.get_sampler("uniform").events(
        key, jcfg, jnp.asarray(MASK), None)
    k_dep, k_arr = jax.random.split(key)
    u_dep = np.asarray(jax.random.uniform(k_dep, (N,)))
    u_arr = np.asarray(jax.random.uniform(k_arr, (N,)))
    got = samplers.default_events(t(u_dep), t(u_arr), t(MASK), depart,
                                  rejoin)
    assert_bits_equal(got.depart, ev.depart)
    assert_bits_equal(got.arrive, ev.arrive)
    assert st is None


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("stay", [0.9, 0.6, 0.0, 1.0])
def test_markov_events_core_matches_reference(seed, stay):
    """The chain's mid-round step, the down-but-sampled departures and the
    flip-down of the departed clients' chains included."""
    jcfg, _ = _cfgs(fleet=dict(sampler="markov", avail_stay=stay,
                               avail_return=0.5), async_=_async())
    avail = np.array([1, 1, 0, 1, 0, 0, 1, 1], np.float32)
    key = jax.random.PRNGKey(seed)
    ev, st = jax_samplers.get_sampler("markov").events(
        key, jcfg, jnp.asarray(MASK), jnp.asarray(avail))
    u = np.asarray(jax.random.uniform(key, (N,)))
    got, up = samplers.markov_events(t(avail), t(u), t(MASK), stay)
    assert_bits_equal(got.depart, ev.depart)
    assert_bits_equal(got.arrive, ev.arrive)
    assert_bits_equal(up, st)
    # a departure flips the chain down; a sampled client already down
    # always departs
    dep = n(got.depart)
    assert (n(up)[dep > 0] == 0).all()
    assert (dep[(MASK > 0) & (avail == 0)] == 1).all()


@pytest.mark.parametrize("name", ["uniform", "weighted", "markov", "fixed"])
def test_sampler_events_are_a_draw_plus_the_core(name):
    """A sampler's ``events`` takes its uniforms from the round's generator
    after ``sample`` (two ``[n]`` draws for the default law, one for the
    Markov chain) and applies the core to them."""
    _, cfg = _cfgs(fleet=dict(sampler=name, avail_stay=0.7),
                   async_=_async(depart=0.4, rejoin=0.6))
    samp = samplers.get_sampler(name)
    gen = torch.Generator().manual_seed(4)
    mask, _, st = samp.sample(gen, cfg, samp.init(cfg))
    twin = torch.Generator().manual_seed(0)
    twin.set_state(gen.get_state())
    ev, st2 = samp.events(gen, cfg, mask, st)
    if name == "markov":
        want, up = samplers.markov_events(st, torch.rand(N, generator=twin),
                                          mask, 0.7)
        assert_bits_equal(st2, up)
    else:
        u_dep = torch.rand(N, generator=twin)
        want = samplers.default_events(u_dep, torch.rand(N, generator=twin),
                                       mask, 0.4, 0.6)
        assert st2 is st
    assert_bits_equal(ev.depart, want.depart)
    assert_bits_equal(ev.arrive, want.arrive)
    assert (n(ev.depart) <= n(mask)).all()


# ---------------------------------------------------------------------------
# Buffer structure
# ---------------------------------------------------------------------------

WIRE_CASES = [("dense", "none"), ("dense", "topk"), ("dense", "quant"),
              ("packed", "topk"), ("packed", "quant"), ("packed", "randk"),
              ("pallas", "topk"), ("pallas", "quant")]


def _leaves(x):
    return [x] if not isinstance(x, tuple) else list(x)


@pytest.mark.parametrize("comm,kind", WIRE_CASES)
def test_buffer_structure_matches_reference_and_encode(comm, kind):
    """``init_buffer``'s message leaves have the reference's
    ``wire_msg_struct`` shapes and dtypes, and those of what ``encode``
    returns, in mask and gather mode."""
    jcfg, cfg = _cfgs(up=kind, comm=comm, async_=_async())
    want = jax_async.wire_msg_struct(jax_npc.init_params(None, 30), jcfg)
    state = rounds.init_state(_params(), cfg, device="cpu")
    buf = async_rounds.init_buffer(state, cfg)
    got = buf.msgs
    assert _leaves(got)[0].device.type == "cpu"
    assert type(got).__name__ == type(want).__name__ or \
        isinstance(got, torch.Tensor)
    for g, w in zip(_leaves(got), jax.tree_util.tree_leaves(want)):
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).split(".")[-1] == np.dtype(w.dtype).name
        assert not g.any()
    for name, dt in (("origin", torch.int32), ("sigma", torch.float32),
                     ("weight", torch.float32), ("occupied", torch.float32)):
        assert getattr(buf, name).dtype == dt
        assert getattr(buf, name).shape == (N,)
    if comm != "dense":
        assert isinstance(got, (payloads.FlatPacked, payloads.FlatQuant))
    # what encode returns, mask and gather
    from repro_torch.comm.flat import flat_transports_for
    from repro_torch.comm.transports import UPLINK, WireKey
    spec = state.spec
    up, _ = flat_transports_for(cfg, spec)
    rng = np.random.default_rng(0)
    for mode in MODES:
        c = cfg.replace(participation=mode)
        part = participation.finalize(t(MASK), None, c)
        rows = N if mode == "mask" else M
        deltas = t(rng.standard_normal((rows, spec.d)).astype(np.float32))
        e = torch.zeros((N, spec.d)) if up.t.needs_residual else None
        msgs, _, flush, stats = participation.encode_flush(
            up, e, deltas, part, t=0, key=WireKey(0, 0, UPLINK))
        assert flush is None and stats is None
        for g, b in zip(_leaves(msgs), _leaves(got)):
            assert g.shape == b.shape and g.dtype == b.dtype


def test_disabled_has_no_buffer():
    _, cfg = _cfgs()
    state = rounds.init_state(_params(), cfg, device="cpu")
    assert async_rounds.init_buffer(state, cfg) is None


def test_compose_weights():
    cfg = FedConfig(n_clients=4, m=3)
    part = participation.finalize(torch.tensor([1.0, 0.0, 1.0, 1.0]),
                                  torch.tensor([2.0, 0.0, 1.0, 1.0]), cfg)
    out = participation.compose_weights(part, torch.tensor([1.0, 1.0, 0.0,
                                                            1.0]))
    assert out.weights.tolist() == [2.0, 0.0, 0.0, 1.0]
    assert out.mask is part.mask


# ---------------------------------------------------------------------------
# Disabled async: the synchronous drive loops, bit for bit
# ---------------------------------------------------------------------------

def _state_fields(s):
    return (s.w, s.x, s.e_up, s.wbar_sum, s.wbar_weight)


def _assert_metrics_equal(a, b):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if x is None or isinstance(x, np.ndarray):
            assert_bits_equal(x, y)
        else:
            _assert_metrics_equal(x, y)


def _parity(cfg, batches, T=2):
    state = rounds.init_state(_params(), cfg, device="cpu")
    s_sync, h_sync = rounds.drive(state, batches, npc.loss_pair, cfg, T=T,
                                  device="cpu")
    state = rounds.init_state(_params(), cfg, device="cpu")
    s_async, buf, h_async = async_rounds.async_drive(
        state, batches, npc.loss_pair, cfg, T=T, device="cpu")
    assert buf is None
    for a, b in zip(_state_fields(s_sync), _state_fields(s_async)):
        assert_bits_equal(a, b)
    _assert_metrics_equal(h_sync, h_async.round)
    assert (h_async.fresh == cfg.m).all()
    assert (h_async.occupancy == 0).all()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("strategy", STRATS)
@pytest.mark.parametrize("kind", sorted(set(KINDS) - {"quant4"}))
def test_disabled_bit_for_bit(np_data, strategy, kind, mode):
    _, cfg = _cfgs(up=kind, down=kind, strategy=strategy,
                   participation=mode)
    _parity(cfg, _batch(np_data))


@pytest.mark.parametrize("comm", ("packed", "pallas"))
def test_disabled_wire_backends(np_data, comm):
    _, cfg = _cfgs(up="topk", down="quant", comm=comm)
    _parity(cfg, _batch(np_data))


@pytest.mark.parametrize("sampler", ("weighted", "markov"))
def test_disabled_samplers(np_data, sampler):
    _, cfg = _cfgs(up="topk", fleet=dict(sampler=sampler, avail_stay=0.8,
                                         avail_return=0.5))
    _parity(cfg, _batch(np_data), T=3)


@pytest.mark.parametrize("mode", MODES)
def test_disabled_provisioned_fleet(np_data, mode):
    _, cfg = _cfgs(up="quant", participation=mode,
                   fleet=dict(batch_size=8, redraw=True))
    _parity(cfg, provision.from_stacked(_batch(np_data)))


# ---------------------------------------------------------------------------
# Whole async rounds against the reference
# ---------------------------------------------------------------------------

R = 5


class ReplayEvents(samplers.FixedSampler):
    """Recorded cohorts (the ``fixed`` law) and recorded event uniforms:
    round r's events are the default law's core on ``UNIFORMS[r]``."""

    name = "replay-events"
    UNIFORMS: list = []

    def events(self, gen, cfg, mask, state=None):
        r = state[2] - 1                  # sample has advanced the replay
        u_dep, u_arr = self.UNIFORMS[r]
        return samplers.default_events(u_dep, u_arr, mask,
                                       cfg.async_.depart,
                                       cfg.async_.rejoin), state


@pytest.fixture
def replay(monkeypatch):
    monkeypatch.setitem(samplers._SAMPLERS, ReplayEvents.name, ReplayEvents)
    monkeypatch.setattr(ReplayEvents, "UNIFORMS", [])
    return ReplayEvents


def reference_event_uniforms(seed: int, T: int):
    """The uniforms the reference's default events law draws in rounds
    0..T-1 of a run from ``PRNGKey(seed)``: its round key split, then the
    law's own split."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(T):
        key, _, _, _, k_evt = jax.random.split(key, 5)
        k_dep, k_arr = jax.random.split(k_evt)
        out.append((t(np.asarray(jax.random.uniform(k_dep, (N,)))),
                    t(np.asarray(jax.random.uniform(k_arr, (N,))))))
    return out


def cohorts(T: int, seed: int = 7):
    """T recorded cohorts of m of n, with Horvitz-Thompson-like weights
    (not 0/1) on the support."""
    rng = np.random.default_rng(seed)
    masks = np.zeros((T, N), np.float32)
    for r in range(T):
        masks[r, rng.choice(N, M, replace=False)] = 1.0
    weights = masks * rng.uniform(0.5, 2.0, (T, N)).astype(np.float32)
    return masks, weights


def run_both(np_data, replay, jcfg, cfg, T=R, obs=False):
    """The reference's ``async_drive`` (fixed sampler, its own event
    draws) and the port's (the same cohorts, the reference's uniforms)."""
    masks, weights = cohorts(T)
    jcfg = jcfg.replace(fleet=dataclasses.replace(jcfg.fleet,
                                                  sampler="fixed"))
    jstate = jax_rounds.init_state(jax_npc.init_params(None, 30), jcfg)
    jstate = jstate._replace(sampler=jax_samplers.fixed_state(
        jnp.asarray(masks), jnp.asarray(weights)))
    jstate, jbuf, jh = jax_async.async_drive(
        jstate, (jnp.asarray(np_data[0]), jnp.asarray(np_data[1])),
        jax_npc.loss_pair, jcfg, T)
    replay.UNIFORMS = reference_event_uniforms(cfg.seed, T)
    cfg = cfg.replace(fleet=dataclasses.replace(cfg.fleet,
                                                sampler=replay.name))
    state = rounds.init_state(_params(), cfg, device="cpu")
    state = state._replace(sampler=samplers.fixed_state(masks, weights))
    state, buf, h = async_rounds.async_drive(
        state, _batch(np_data), npc.loss_pair, cfg, T, device="cpu")
    return (jstate, jbuf, jh), (state, buf, h)


COUNTERS = ("fresh", "departed", "merged", "dropped", "occupancy",
            "max_age")
MASSES = ("fresh_weight", "departed_weight", "stale_weight",
          "dropped_weight", "buffered_weight")
ASYNC_CASES = {
    "dense topk mask constant": dict(comm="dense", up="topk",
                                     participation="mask",
                                     staleness="constant"),
    "pallas topk gather constraint": dict(comm="pallas", up="topk",
                                          down="topk",
                                          participation="gather",
                                          staleness="constraint"),
    "packed quant mask poly": dict(comm="packed", up="quant",
                                   participation="mask", staleness="poly"),
    "pallas quant gather poly": dict(comm="pallas", up="quant",
                                     down="quant", participation="gather",
                                     staleness="poly"),
    "dense none mask constraint": dict(comm="dense", up="none",
                                       participation="mask",
                                       staleness="constraint"),
    "dense quant gather constant": dict(comm="dense", up="quant",
                                        participation="gather",
                                        staleness="constant"),
    "penalty pallas topk mask constraint": dict(
        comm="pallas", up="topk", participation="mask",
        staleness="constraint", strategy="penalty-fedavg"),
}


def _async_cfgs(case):
    kw = dict(ASYNC_CASES[case])
    law = kw.pop("staleness")
    return _cfgs(async_=_async(staleness=law, max_staleness=2, depart=0.5,
                               rejoin=0.4), **kw)


def _assert_buffers_close(jbuf, buf):
    for name in ("origin", "occupied"):
        assert_bits_equal(getattr(buf, name), getattr(jbuf, name))
    for name in ("weight", "sigma"):
        np.testing.assert_allclose(n(getattr(buf, name)),
                                   np.asarray(getattr(jbuf, name)),
                                   rtol=1e-6)
    for g, w in zip(_leaves(buf.msgs), jax.tree_util.tree_leaves(jbuf.msgs)):
        if g.dtype.is_floating_point:
            np.testing.assert_allclose(n(g), np.asarray(w), rtol=1e-5,
                                       atol=1e-6)
        else:
            assert_bits_equal(g, w)


@pytest.mark.parametrize("case", sorted(ASYNC_CASES))
def test_async_rounds_match_reference(np_data, replay, case):
    jcfg, cfg = _async_cfgs(case)
    (js, jbuf, jh), (s, buf, h) = run_both(np_data, replay, jcfg, cfg)
    for f in COUNTERS:
        np.testing.assert_array_equal(getattr(h, f),
                                      np.asarray(getattr(jh, f)), err_msg=f)
    for f in MASSES:
        np.testing.assert_allclose(getattr(h, f), np.asarray(getattr(jh, f)),
                                   rtol=1e-6, atol=1e-7, err_msg=f)
    for f in ("f", "g_hat", "sigma", "g_full", "f_full", "delta_norm"):
        np.testing.assert_allclose(getattr(h.round, f),
                                   np.asarray(getattr(jh.round, f)),
                                   rtol=1e-6, atol=1e-7, err_msg=f)
    for f in ("feasible", "up_bytes", "down_bytes"):
        np.testing.assert_array_equal(getattr(h.round, f),
                                      np.asarray(getattr(jh.round, f)))
    spec = jax_flat.spec_of(js.w)
    np.testing.assert_allclose(n(s.w), np.asarray(jax_flat.flatten(spec,
                                                                   js.w)),
                               rtol=0, atol=1e-6)
    _assert_buffers_close(jbuf, buf)
    # the run parked, and the buffer's bookkeeping closes
    assert h.departed.sum() > 0
    np.testing.assert_allclose(
        h.departed.sum(), h.merged.sum() + h.dropped.sum()
        + float(buf.occupied.sum()))


def test_async_rounds_park_deliver_and_expire(np_data, replay):
    """The replayed runs see all three fates of a parked payload."""
    seen = {"merged": 0.0, "dropped": 0.0}
    for case in ("dense topk mask constant", "pallas quant gather poly"):
        jcfg, cfg = _async_cfgs(case)
        _, (_, _, h) = run_both(np_data, replay, jcfg, cfg, T=6)
        for k in seen:
            seen[k] += float(getattr(h, k).sum())
        assert float(h.max_age.max()) <= cfg.async_.max_staleness - 1
    assert seen["merged"] > 0 and seen["dropped"] > 0


def test_mass_conservation(np_data):
    """Under the constant law every departed payload's HT weight re-enters
    through exactly one later merge or is counted as dropped (a re-departing
    client overwriting its parked slot; no expiry at max_staleness=100)."""
    _, cfg = _cfgs(up="topk", async_=_async(max_staleness=100, depart=0.6))
    state = rounds.init_state(_params(), cfg, device="cpu")
    _, buf, h = async_rounds.async_drive(state, _batch(np_data),
                                         npc.loss_pair, cfg, 12,
                                         device="cpu")
    assert h.departed.sum() > 0 and h.merged.sum() > 0
    np.testing.assert_allclose(
        h.departed.sum(),
        h.merged.sum() + h.dropped.sum() + float(buf.occupied.sum()))
    np.testing.assert_allclose(
        h.departed_weight.sum(),
        h.stale_weight.sum() + h.dropped_weight.sum()
        + float((buf.weight * buf.occupied).sum()), rtol=1e-6)
    np.testing.assert_allclose(h.fresh_weight, h.fresh)
    assert h.max_age.max() >= 1.0


def test_markov_departures_land_within_max_staleness(np_data):
    ms = 3
    _, cfg = _cfgs(up="topk", fleet=dict(sampler="markov", avail_stay=0.6,
                                         avail_return=0.5),
                   async_=_async(max_staleness=ms))
    cfg = cfg.replace(m=5)
    state = rounds.init_state(_params(), cfg, device="cpu")
    _, buf, h = async_rounds.async_drive(state, _batch(np_data),
                                         npc.loss_pair, cfg, 24,
                                         device="cpu")
    assert h.departed.sum() > 0 and h.merged.sum() > 0
    np.testing.assert_allclose(
        h.departed.sum(),
        h.merged.sum() + h.dropped.sum() + float(buf.occupied.sum()))
    assert (h.max_age <= ms - 1).all()


def test_preloaded_slot_merges_exact_law(np_data):
    """A hand-loaded slot shifts the server step by exactly
    ``-lr * w_origin * payload / m`` (identity uplink: the dense row)."""
    _, cfg = _cfgs(async_=_async(depart=0.0, rejoin=1.0))
    state = rounds.init_state(_params(), cfg, device="cpu")
    spec = state.spec
    row = async_rounds.flat.flatten(spec, {"w": torch.full((30,), 1.0),
                                           "b": torch.tensor(2.0)})
    buf0 = async_rounds.init_buffer(state, cfg)
    loaded = async_rounds.init_buffer(state, cfg)
    loaded.msgs[2] = row
    loaded.occupied[2] = 1.0
    loaded.weight[2] = 1.0
    loaded.origin[2] = -1
    s_empty, _, _ = async_rounds.async_round_step(
        state, buf0, _batch(np_data), npc.loss_pair, cfg, device="cpu")
    state = rounds.init_state(_params(), cfg, device="cpu")
    s_load, buf1, mets = async_rounds.async_round_step(
        state, loaded, _batch(np_data), npc.loss_pair, cfg, device="cpu")
    assert float(mets.merged) == 1.0 and float(buf1.occupied.sum()) == 0.0
    np.testing.assert_allclose(n(s_load.w - s_empty.w),
                               n(-cfg.lr * row / cfg.m), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("comm,kind,mode", [
    ("dense", "none", "mask"), ("dense", "topk", "gather"),
    ("pallas", "topk", "mask"), ("pallas", "quant", "mask"),
    ("pallas", "quant", "gather"), ("packed", "topk", "gather")])
def test_parked_payload_survives_the_next_round(np_data, comm, kind, mode):
    """Aliasing: the rows parked in round t are the buffer's own storage.
    Round t+1 (no departure, no arrival) updates ``e_up`` in place and
    makes new deltas and messages; the parked rows read after it equal a
    copy taken at t, and so do the rows that never parked."""
    _, cfg = _cfgs(up=kind, comm=comm, participation=mode,
                   async_=_async(depart=1.0, rejoin=0.0, max_staleness=5))
    state = rounds.init_state(_params(), cfg, device="cpu")
    buf = async_rounds.init_buffer(state, cfg)
    state, buf, m1 = async_rounds.async_round_step(
        state, buf, _batch(np_data), npc.loss_pair, cfg, device="cpu")
    assert float(m1.departed) == M
    parked = [x.clone() for x in _leaves(buf.msgs)]
    occ = buf.occupied.clone()
    quiet = cfg.replace(async_=dataclasses.replace(cfg.async_, depart=0.0))
    state, buf, m2 = async_rounds.async_round_step(
        state, buf, _batch(np_data), npc.loss_pair, quiet, device="cpu")
    assert float(m2.departed) == 0 and float(m2.merged) == 0
    assert_bits_equal(buf.occupied, occ)
    for a, b in zip(_leaves(buf.msgs), parked):
        assert_bits_equal(a, b)
    assert any(bool(x.any()) for x in parked)
