"""Population scale-out of the port (``repro_torch.scale``, two-tier
aggregation in ``comm.flat``, ``client_chunk``, the sharding shims) against
the JAX package, on the CPU, at the NP size of ``tests/test_scale.py``:
N = 12 clients, m = 4, E = 2, the reference's NP shards.

Both packages replay the same recorded cohorts (``fixed`` sampler, weights
that are not 0/1) and, in async rounds, the reference's own event uniforms.

Tolerances and why:

* whole rounds with a slot store against the reference: w within 1e-6
  absolute, the round metrics at rtol 1e-6 (``feasible`` and the wire bytes
  exactly); the store's ``owner``, ``stamp``, ``client_slot`` and ``weight``
  bit-equal (integers, and HT weights copied from the cohort); the pool
  rows at rtol 1e-5 / atol 1e-6 (the reordered sums and the quant
  residual's ulps of ROADMAP Queue 3, carried through the rounds); the
  slot telemetry (occupancy, evictions, flushed mass) at rtol 1e-6, the
  residual norm at rtol 1e-5;
* ``allocate`` / ``lookup`` on random stores, and the flush messages on
  the same orphan rows: bit-equal;
* the port against itself: cap >= n against the dense residual, every
  ``client_chunk``, the two-tier select reduce on integer payloads:
  bit-equal; the two-tier quant and dense reduces: rtol 1e-5 / atol 1e-6
  (a reordered sum), as the reference's own tests hold them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import flat as jax_flat
from repro.comm import transports as jax_transports
from repro.configs.base import (AsyncConfig as JAsyncConfig,
                                CompressorConfig as JCompressorConfig,
                                FedConfig as JFedConfig,
                                FleetConfig as JFleetConfig,
                                ObsConfig as JObsConfig,
                                ScaleConfig as JScaleConfig,
                                SwitchConfig as JSwitchConfig)
from repro.engine import async_rounds as jax_async
from repro.engine import rounds as jax_rounds
from repro.fleet import samplers as jax_samplers
from repro.obs import bus as jax_bus
from repro.scale import slots as jax_slots
from repro.tasks import np_classification as jax_npc
from repro_torch.comm import flat, transports
from repro_torch.configs.base import (AsyncConfig, CompressorConfig,
                                      FedConfig, FleetConfig, ObsConfig,
                                      ScaleConfig, SwitchConfig)
from repro_torch.core import baselines
from repro_torch.engine import async_rounds, participation, rounds
from repro_torch.fleet import samplers
from repro_torch.launch import mesh, train
from repro_torch.obs import bus
from repro_torch.scale import shard, slots
from repro_torch.sharding import partition
from repro_torch.tasks import np_classification as npc
from torch_port_util import assert_bits_equal, n, t

EPS = 0.35
N, M, T = 12, 4, 4
KINDS = {
    "topk": dict(kind="topk", ratio=0.25, block=8),
    "quant": dict(kind="quant", bits=8, block=8),
    "randk": dict(kind="randk", ratio=0.25, block=8),
}
# four recorded cohorts: disjoint thirds (a store of 4 or 8 slots is full
# and evicts by round 2 or 3), then a mix of old and new clients
SAMPLED = [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11], [0, 5, 9, 11]]


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


def _cfgs(up="topk", comm="pallas", cap=0, cohorts=1, async_=None,
          obs=False, **kw):
    """The same FedConfig in both packages (gather mode, ``fixed``
    sampler)."""
    out = []
    for fed, cc, sw, sc, ac, fl, oc in (
            (JFedConfig, JCompressorConfig, JSwitchConfig, JScaleConfig,
             JAsyncConfig, JFleetConfig, JObsConfig),
            (FedConfig, CompressorConfig, SwitchConfig, ScaleConfig,
             AsyncConfig, FleetConfig, ObsConfig)):
        base = dict(n_clients=N, m=M, local_steps=2, lr=0.1,
                    switch=sw(mode="hard", eps=EPS), participation="gather",
                    uplink=cc(**KINDS[up]), downlink=cc(kind="none"),
                    comm=comm, scale=sc(ef_slots=cap, cohorts=cohorts),
                    async_=ac(**(async_ or {})), fleet=fl(sampler="fixed"),
                    obs=oc(enabled=obs, window=2))
        base.update(kw)
        out.append(fed(**base))
    return out


def _cohorts():
    masks = np.zeros((T, N), np.float32)
    for r, ids in enumerate(SAMPLED):
        masks[r, ids] = 1.0
    rng = np.random.default_rng(3)
    return masks, masks * rng.uniform(0.5, 2.0, (T, N)).astype(np.float32)


def _params():
    return {"w": torch.zeros(30), "b": torch.zeros(())}


def _batch(np_data):
    return npc.NPBatch(t(np_data[0]), t(np_data[1]))


def _port_state(cfg, masks=None, weights=None):
    if masks is None:
        masks, weights = _cohorts()
    state = rounds.init_state(_params(), cfg, device="cpu")
    return state._replace(sampler=samplers.fixed_state(masks, weights))


def _ref_state(jcfg):
    masks, weights = _cohorts()
    jstate = jax_rounds.init_state(jax_npc.init_params(None, 30), jcfg)
    return jstate._replace(sampler=jax_samplers.fixed_state(
        jnp.asarray(masks), jnp.asarray(weights)))


def _port_drive(cfg, np_data, rounds_=T):
    return rounds.drive(_port_state(cfg), _batch(np_data), npc.loss_pair,
                        cfg, rounds_, device="cpu")


def _ref_drive(jcfg, np_data):
    return jax_rounds.drive(_ref_state(jcfg), (jnp.asarray(np_data[0]),
                                               jnp.asarray(np_data[1])),
                            jax_npc.loss_pair, jcfg, T)


METRICS = ("f", "g_hat", "sigma", "g_full", "f_full", "delta_norm")


def _assert_rounds_close(h, jh, s, js):
    for f in METRICS:
        np.testing.assert_allclose(getattr(h, f), np.asarray(getattr(jh, f)),
                                   rtol=1e-6, atol=1e-7, err_msg=f)
    for f in ("feasible", "up_bytes", "down_bytes"):
        np.testing.assert_array_equal(getattr(h, f),
                                      np.asarray(getattr(jh, f)))
    spec = jax_flat.spec_of(js.w)
    np.testing.assert_allclose(n(s.w), np.asarray(jax_flat.flatten(spec,
                                                                   js.w)),
                               rtol=0, atol=1e-6)


def _assert_stores_close(store, jstore):
    for f in ("owner", "stamp", "client_slot", "weight"):
        assert_bits_equal(getattr(store, f), getattr(jstore, f))
    np.testing.assert_allclose(n(store.pool), np.asarray(jstore.pool),
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# The slot store against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [4, 8, 12])
@pytest.mark.parametrize("kind", ["topk", "quant"])
@pytest.mark.parametrize("comm", ["dense", "packed", "pallas"])
def test_slot_store_matches_reference(np_data, comm, kind, cap):
    """Whole rounds with a slot store of ``cap`` slots (4 and 8 evict, 12
    is cap >= n), telemetry on: the trajectory, the store and the slot
    counters against the reference's.  (cap >= n is also held bit-equal to
    the port's own dense residual below.)"""
    jcfg, cfg = _cfgs(kind, comm, cap=cap, obs=True)
    js, jh = _ref_drive(jcfg, np_data)
    s, h = _port_drive(cfg, np_data)
    assert isinstance(s.e_up, slots.SlotStore)
    _assert_rounds_close(h, jh, s, js)
    _assert_stores_close(s.e_up, js.e_up)
    tel, jtel = h.telemetry, jh.telemetry
    for f in ("slot_occupancy", "slot_evictions", "slot_flush_weight"):
        np.testing.assert_allclose(getattr(tel, f),
                                   np.asarray(getattr(jtel, f)), rtol=1e-6,
                                   atol=1e-7, err_msg=f)
    np.testing.assert_allclose(tel.up_res_norm, np.asarray(jtel.up_res_norm),
                               rtol=1e-5)
    evictions = float(tel.slot_evictions.sum())
    assert (evictions > 0) == (cap < N)
    assert (tel.slot_flush_weight.sum() > 0) == (cap < N)


@pytest.mark.parametrize("kind", ["topk", "quant", "randk"])
@pytest.mark.parametrize("comm", ["dense", "packed", "pallas"])
def test_cap_ge_n_is_the_dense_residual_bitwise(np_data, comm, kind):
    """cap >= n: no eviction, no flush, and the round is the dense gather
    round bit for bit (state, metrics), every owned pool row its owner's
    dense residual row (rand-k's per-client streams included)."""
    _, dense_cfg = _cfgs(kind, comm)
    _, slot_cfg = _cfgs(kind, comm, cap=N)
    sd, hd = _port_drive(dense_cfg, np_data)
    ss, hs = _port_drive(slot_cfg, np_data)
    for a, b in ((sd.w, ss.w), (sd.wbar_sum, ss.wbar_sum)):
        assert_bits_equal(a, b)
    for f in hd._fields:
        assert_bits_equal(getattr(hd, f), getattr(hs, f))
    owner = n(ss.e_up.owner)
    for s_, j in enumerate(owner):
        if j >= 0:
            assert_bits_equal(ss.e_up.pool[s_], sd.e_up[j])
    assert sorted(j for j in owner if j >= 0) == sorted(
        {j for ids in SAMPLED for j in ids})


@pytest.mark.parametrize("cap", [M, 6, N])
def test_store_invariant_after_rounds(np_data, cap):
    """owner[s] == j <=> client_slot[j] == s after the rounds, evicting or
    not."""
    _, cfg = _cfgs(cap=cap)
    state, _ = _port_drive(cfg, np_data)
    owner, cslot = n(state.e_up.owner), n(state.e_up.client_slot)
    for s_, j in enumerate(owner):
        if j >= 0:
            assert cslot[j] == s_
    for j, s_ in enumerate(cslot):
        if s_ >= 0:
            assert owner[s_] == j
    assert (owner >= 0).sum() == min(cap, 12)
    assert slots.resident_bytes(state.e_up) == cap * 31 * 4 + 3 * cap * 4 \
        + N * 4


def _short_cohorts(sampled):
    masks = np.zeros((len(sampled), N), np.float32)
    for r, ids in enumerate(sampled):
        masks[r, ids] = 1.0
    rng = np.random.default_rng(5)
    return masks, masks * rng.uniform(0.5, 2.0, masks.shape).astype(
        np.float32)


def _assert_store_invariant(store):
    owner, cslot = n(store.owner), n(store.client_slot)
    held = owner[owner >= 0]
    assert len(set(held.tolist())) == len(held), owner
    for s_, j in enumerate(owner):
        if j >= 0:
            assert cslot[j] == s_
    for j, s_ in enumerate(cslot):
        if s_ >= 0:
            assert owner[s_] == j


# short cohorts (fewer than m sampled; the first id pads the cohort): the
# padded id 4 of round 2 and 0 of round 3 hold no slot, so each would claim
# one per copy if the copies counted as misses
SHORT_MISS = [[0, 1, 2, 3], [4, 5], [0, 6, 7], [4, 8, 9, 10]]
# every padded id (0, then 2) already holds a slot
SHORT_HIT = [[0, 1, 2, 3], [0, 1], [2, 5, 6], [0, 7, 8, 9]]


@pytest.mark.parametrize("kind", ["topk", "quant"])
def test_short_cohort_claims_one_slot_per_client(np_data, kind):
    """A short cohort whose padded id has no slot: the id claims one slot
    and evicts at most once, and owner[s] == j <=> client_slot[j] == s
    after every round (the reference's store lets each copy claim a slot,
    so client 4 owns three after round 2: ROADMAP Queue 3)."""
    _, cfg = _cfgs(kind, cap=M, obs=True)
    masks, weights = _short_cohorts(SHORT_MISS)
    state = _port_state(cfg, masks, weights)
    batch = _batch(np_data)
    evictions = []
    for r, ids in enumerate(SHORT_MISS):
        state, met = rounds.round_step(state, batch, npc.loss_pair, cfg,
                                       device="cpu")
        _assert_store_invariant(state.e_up)
        assert set(ids) <= set(n(state.e_up.owner).tolist())
        evictions.append(float(met.telemetry.slot_evictions))
        assert np.isfinite(float(met.f))
    # round 2 evicts clients 0, 1 for 4, 5; round 3 evicts 2, 3, 4 for 0,
    # 6, 7; round 4, four misses, evicts 5, 0, 6, 7
    assert evictions == [0.0, 2.0, 3.0, 4.0]
    if kind != "topk":          # the reference's behaviour, shown once
        return
    jcfg, _ = _cfgs(kind, cap=M)
    jstate = jax_rounds.init_state(jax_npc.init_params(None, 30), jcfg)
    jstate = jstate._replace(sampler=jax_samplers.fixed_state(
        jnp.asarray(masks), jnp.asarray(weights)))
    js, _ = jax_rounds.drive(jstate, (jnp.asarray(np_data[0]),
                                      jnp.asarray(np_data[1])),
                             jax_npc.loss_pair, jcfg, 2)
    # the reference's cohort [4, 5, 4, 4]: a slot for each copy of 4
    assert list(np.asarray(js.e_up.owner)).count(4) == 3


@pytest.mark.parametrize("kind", ["topk", "quant"])
def test_short_cohort_of_slot_holders_matches_reference(np_data, kind):
    """Short cohorts whose padded ids already hold a slot: the store, the
    trajectory and the slot counters as the reference's."""
    jcfg, cfg = _cfgs(kind, cap=M, obs=True)
    masks, weights = _short_cohorts(SHORT_HIT)
    jstate = jax_rounds.init_state(jax_npc.init_params(None, 30), jcfg)
    jstate = jstate._replace(sampler=jax_samplers.fixed_state(
        jnp.asarray(masks), jnp.asarray(weights)))
    js, jh = jax_rounds.drive(jstate, (jnp.asarray(np_data[0]),
                                       jnp.asarray(np_data[1])),
                              jax_npc.loss_pair, jcfg, T)
    s, h = rounds.drive(_port_state(cfg, masks, weights), _batch(np_data),
                        npc.loss_pair, cfg, T, device="cpu")
    _assert_rounds_close(h, jh, s, js)
    _assert_stores_close(s.e_up, js.e_up)
    _assert_store_invariant(s.e_up)
    np.testing.assert_array_equal(h.telemetry.slot_evictions,
                                  np.asarray(jh.telemetry.slot_evictions))
    assert h.telemetry.slot_evictions.sum() > 0


# ---------------------------------------------------------------------------
# allocate and lookup, on random stores
# ---------------------------------------------------------------------------

def _random_store(rng, n_clients, cap, d):
    owned = rng.integers(0, cap + 1)
    owner = np.full(cap, -1, np.int32)
    cslot = np.full(n_clients, -1, np.int32)
    who = rng.choice(n_clients, owned, replace=False)
    where = rng.choice(cap, owned, replace=False)
    owner[where] = who
    cslot[who] = where
    stamp = np.where(owner >= 0, rng.integers(0, 4, cap), -1).astype(
        np.int32)
    weight = np.where(owner >= 0, rng.uniform(0.5, 2, cap), 0).astype(
        np.float32)
    pool = rng.standard_normal((cap, d)).astype(np.float32)
    pool[owner < 0] = 0.0
    return pool, owner, stamp, weight, cslot


@pytest.mark.parametrize("seed", range(6))
def test_allocate_and_lookup_match_reference(seed):
    """Random stores (free, occupied and sampled slots, tied stamps) and
    random cohorts of 4 of 10 clients in a 6-slot store."""
    rng = np.random.default_rng(seed)
    n_clients, cap, d, m = 10, 6, 6, 4
    arrays = _random_store(rng, n_clients, cap, d)
    store = slots.SlotStore(*(t(a) for a in arrays))
    jstore = jax_slots.SlotStore(*(jnp.asarray(a) for a in arrays))
    idx = np.sort(rng.choice(n_clients, m, replace=False)).astype(np.int64)
    rows, cur = slots.lookup(store, t(idx))
    jrows, jcur = jax_slots.lookup(jstore, jnp.asarray(idx, jnp.int32))
    assert_bits_equal(rows, jrows)
    assert_bits_equal(cur, jcur)
    got = slots.allocate(store, cur, 5)
    want = jax_slots.allocate(jstore, jcur, 5)
    assert got.dtype == torch.int32
    assert_bits_equal(got, want)


# ---------------------------------------------------------------------------
# The eviction flush
# ---------------------------------------------------------------------------

def _part(idx, n_clients):
    idx = torch.tensor(idx, dtype=torch.int64)
    mask = torch.zeros(n_clients).index_fill_(0, idx, 1.0)
    return participation.Participation(mask, idx, n_clients, len(idx), mask,
                                       False, idx)


def _flat_transport(kind, comm, d):
    spec = flat.spec_of({"w": torch.zeros(d)})
    cc = CompressorConfig(**KINDS[kind])
    return flat.FlatTransport(
        transports.get_transport(cc, transports.backend_for(comm)), spec)


@pytest.mark.parametrize("kind,comm", [("topk", "packed"), ("topk", "pallas"),
                                       ("quant", "packed"),
                                       ("quant", "pallas"),
                                       ("topk", "dense"),
                                       ("randk", "packed")])
def test_flush_is_the_compressed_orphan_at_its_stored_weight(kind, comm):
    """A disjoint second sample at cap = m evicts both residents: the
    aggregate is the regular HT reduce of the new messages plus the
    compressor image of each orphan (at a zero residual, from the flush
    stream) under the weight stored when its row was written; the mass the
    flush leaks is its own compression error."""
    n_clients, m, d = 6, 2, 32
    ft = _flat_transport(kind, comm, d)
    store = slots.init(n_clients, m, d, torch.float32, "cpu")
    rng = np.random.default_rng(0)
    part0 = _part([0, 1], n_clients)
    part0 = part0._replace(weights=torch.tensor([1.5, 0.5, 0, 0, 0, 0.0]))
    key0 = transports.WireKey(0, 0, transports.UPLINK)
    _, store1, st1 = slots.transmit(ft, store, t(rng.standard_normal(
        (m, d)).astype(np.float32)), part0, 0, key=key0)
    assert float(store1.pool.abs().sum()) > 0
    assert float(st1.evictions) == 0.0 and float(st1.occupancy) == 2.0
    pool1 = store1.pool.clone()
    weight1 = store1.weight.clone()

    part1 = _part([2, 3], n_clients)
    d1 = t(rng.standard_normal((m, d)).astype(np.float32))
    key1 = transports.WireKey(0, 1, transports.UPLINK)
    v1, store2, st2 = slots.transmit(ft, store1, d1, part1, 1, key=key1)

    msgs, _ = ft._ef_clients(torch.zeros_like(d1), d1.clone(), key1, [2, 3])
    full = transports.scatter_rows(msgs, part1.idx, n_clients)
    v_agg = ft.reduce(full, participation.agg_weights(part1), m)
    claimed = store2.client_slot.index_select(0, part1.idx).long()
    orphan = pool1.index_select(0, claimed)
    w_orph = weight1.index_select(0, claimed)
    omsgs = ft.flush_messages(orphan.clone(),
                              key1._replace(direction=transports.FLUSH))
    v_flush = ft.reduce_single(omsgs, w_orph, m)
    assert_bits_equal(v1, v_agg + v_flush)
    assert torch.isfinite(v1).all()
    np.testing.assert_allclose(float(st2.flush_weight),
                               float(w_orph.sum()), rtol=1e-7)
    assert float(st2.evictions) == 2.0
    leak = orphan - ft.decompress(omsgs)
    assert float(leak.abs().sum()) < float(orphan.abs().sum())
    cslot = n(store2.client_slot)
    assert cslot[0] == -1 and cslot[1] == -1
    assert sorted(n(store2.owner).tolist()) == [2, 3]
    if kind == "randk":
        # the flush stream is not the uplink's
        up = ft.flush_messages(orphan.clone(), key1)
        assert not torch.equal(up.indices.view(torch.int16),
                               omsgs.indices.view(torch.int16))


@pytest.mark.parametrize("kind,comm", [("topk", "packed"), ("topk", "pallas"),
                                       ("quant", "packed"),
                                       ("quant", "pallas"),
                                       ("topk", "dense"),
                                       ("quant", "dense")])
def test_flush_messages_match_reference(kind, comm):
    """The residual-free flush encode against the reference's
    ``_ef_clients(zeros_like(orphan), orphan)`` on the same rows (-0.0
    entries and zero rows included): the payloads bit for bit."""
    rng = np.random.default_rng(1)
    d = 32
    orphan = rng.standard_normal((3, d)).astype(np.float32)
    orphan[0, ::5] = -0.0
    orphan[1] = 0.0
    orphan[2, :8] = -0.0
    ft = _flat_transport(kind, comm, d)
    jspec = jax_flat.spec_of({"w": jnp.zeros((d,))})
    jft = jax_flat.FlatTransport(jax_transports.get_transport(
        JCompressorConfig(**KINDS[kind]), jax_transports.backend_for(comm)),
        jspec)
    want, _ = jft._ef_clients(jnp.zeros_like(jnp.asarray(orphan)),
                              jnp.asarray(orphan), None)
    got = ft.flush_messages(t(orphan))
    if isinstance(got, torch.Tensor):
        np.testing.assert_array_equal(n(got), np.asarray(want))
        return
    for g, w in zip(got, jax.tree_util.tree_leaves(want)):
        assert_bits_equal(g, w)


def test_no_eviction_at_cap_ge_n():
    n_clients, d = 6, 16
    ft = _flat_transport("topk", "packed", d)
    store = slots.init(n_clients, n_clients, d, torch.float32, "cpu")
    rng = np.random.default_rng(0)
    _, s1, _ = slots.transmit(ft, store, t(rng.standard_normal(
        (2, d)).astype(np.float32)), _part([0, 1], n_clients), 0)
    full, s2, flush, st = slots.encode(ft, s1, t(rng.standard_normal(
        (2, d)).astype(np.float32)), _part([2, 3], n_clients), 1)
    assert flush is None and float(st.evictions) == 0.0
    cslot = n(s2.client_slot)
    assert cslot[0] >= 0 and cslot[1] >= 0
    assert len({int(s_) for s_ in cslot if s_ >= 0}) == 4
    assert full.values.shape[0] == n_clients


def test_residual_norm_counts_owned_rows_only():
    rng = np.random.default_rng(2)
    arrays = list(_random_store(rng, 10, 6, 40))
    arrays[0][arrays[1] < 0] = 7.0          # stale garbage in free slots
    got = bus.residual_norm(slots.SlotStore(*(t(a) for a in arrays)))
    want = jax_bus.residual_norm(jax_slots.SlotStore(
        *(jnp.asarray(a) for a in arrays)))
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-5)


# ---------------------------------------------------------------------------
# Validation
# ---------------------------------------------------------------------------

def test_validate_errors():
    _, cfg = _cfgs(cap=N)
    with pytest.raises(ValueError, match="gather"):
        rounds.init_state(_params(), cfg.replace(participation="mask"),
                          device="cpu")
    _, cfg = _cfgs(cap=M - 1)
    with pytest.raises(ValueError, match=">= m"):
        rounds.init_state(_params(), cfg, device="cpu")
    _, cfg = _cfgs(cap=N, async_=dict(enabled=True))
    state = rounds.init_state(_params(), cfg, device="cpu")
    assert isinstance(state.e_up, slots.SlotStore)
    _, cfg = _cfgs(up="topk", cap=M)
    none = cfg.replace(uplink=CompressorConfig(kind="none"))
    assert rounds.init_state(_params(), none, device="cpu").e_up is None


# ---------------------------------------------------------------------------
# Async rounds with a slot store
# ---------------------------------------------------------------------------

class ReplayEvents(samplers.FixedSampler):
    """Recorded cohorts and recorded event uniforms (round r's events are
    the default law's core on ``UNIFORMS[r]``)."""

    name = "replay-events-scale"
    UNIFORMS: list = []

    def events(self, gen, cfg, mask, state=None):
        u_dep, u_arr = self.UNIFORMS[state[2] - 1]
        return samplers.default_events(u_dep, u_arr, mask,
                                       cfg.async_.depart,
                                       cfg.async_.rejoin), state


@pytest.fixture
def replay(monkeypatch):
    monkeypatch.setitem(samplers._SAMPLERS, ReplayEvents.name, ReplayEvents)
    monkeypatch.setattr(ReplayEvents, "UNIFORMS", [])
    return ReplayEvents


def _reference_uniforms(seed):
    """The uniforms the reference's default events law draws in rounds
    0..T-1 from ``PRNGKey(seed)`` (its round key split, then the law's)."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(T):
        key, _, _, _, k_evt = jax.random.split(key, 5)
        k_dep, k_arr = jax.random.split(k_evt)
        out.append((t(np.asarray(jax.random.uniform(k_dep, (N,)))),
                    t(np.asarray(jax.random.uniform(k_arr, (N,))))))
    return out


ASYNC = dict(enabled=True, max_staleness=2, staleness="constant",
             depart=0.5, rejoin=0.4)


@pytest.mark.parametrize("cap,kind", [(M, "topk"), (6, "quant")])
def test_async_slots_match_reference(np_data, replay, cap, kind):
    """Async rounds with an evicting store: the flush partial joins the
    fresh aggregate; counters, trajectory, store and buffer against the
    reference's."""
    jcfg, cfg = _cfgs(kind, "pallas", cap=cap, async_=ASYNC)
    js, jbuf, jh = jax_async.async_drive(
        _ref_state(jcfg), (jnp.asarray(np_data[0]), jnp.asarray(np_data[1])),
        jax_npc.loss_pair, jcfg, T)
    replay.UNIFORMS = _reference_uniforms(cfg.seed)
    cfg = cfg.replace(fleet=dataclasses.replace(cfg.fleet,
                                                sampler=replay.name))
    s, buf, h = async_rounds.async_drive(_port_state(cfg), _batch(np_data),
                                         npc.loss_pair, cfg, T, device="cpu")
    for f in ("fresh", "departed", "merged", "dropped", "occupancy"):
        np.testing.assert_array_equal(getattr(h, f),
                                      np.asarray(getattr(jh, f)), err_msg=f)
    _assert_rounds_close(h.round, jh.round, s, js)
    _assert_stores_close(s.e_up, js.e_up)
    assert_bits_equal(buf.occupied, jbuf.occupied)
    assert_bits_equal(buf.origin, jbuf.origin)
    assert h.departed.sum() > 0


def test_async_cap_ge_n_is_the_dense_async_path_bitwise(np_data, replay):
    _, dense = _cfgs("topk", "pallas", async_=ASYNC)
    _, slot = _cfgs("topk", "pallas", cap=N, async_=ASYNC)
    replay.UNIFORMS = _reference_uniforms(0)
    out = []
    for cfg in (dense, slot):
        cfg = cfg.replace(fleet=dataclasses.replace(cfg.fleet,
                                                    sampler=replay.name))
        out.append(async_rounds.async_drive(
            _port_state(cfg), _batch(np_data), npc.loss_pair, cfg, T,
            device="cpu"))
    (sd, bd, hd), (ss, bs, hs) = out
    assert_bits_equal(sd.w, ss.w)
    for a, b in zip(bd.msgs, bs.msgs):
        assert_bits_equal(a, b)
    assert_bits_equal(hd.round.f, hs.round.f)
    for s_, j in enumerate(n(ss.e_up.owner)):
        if j >= 0:
            assert_bits_equal(ss.e_up.pool[s_], sd.e_up[j])


# ---------------------------------------------------------------------------
# Two-tier aggregation
# ---------------------------------------------------------------------------

ROWS = 16
TIERS = (1, 2, 4, 8)


def _two_tier_spec():
    tree = {"W": torch.zeros(24, 24), "b": torch.zeros(24)}
    jtree = {"W": jnp.zeros((24, 24)), "b": jnp.zeros((24,))}
    return flat.spec_of(tree), jax_flat.spec_of(jtree)


def _two_tier(kind, comm, x, w, reference=(1, 4)):
    """The port's reduce at every k of ``TIERS`` of the same messages, and
    the reference's at the k of ``reference`` (each package packs its
    own)."""
    spec, jspec = _two_tier_spec()
    cc, jcc = CompressorConfig(**KINDS[kind]), JCompressorConfig(**KINDS[
        kind])
    tp = transports.get_transport(cc, transports.backend_for(comm))
    jtp = jax_transports.get_transport(jcc, jax_transports.backend_for(comm))
    msgs = flat.FlatTransport(tp, spec).codec.pack(t(x))
    got = {k: n(flat.FlatTransport(tp, spec, cohorts=k).reduce(
        msgs, t(w), float(ROWS))) for k in TIERS}
    want = {}
    if reference:
        jmsgs = jax_flat.FlatTransport(jtp, jspec).codec.pack(jnp.asarray(x))
        want = {k: np.asarray(jax_flat.FlatTransport(jtp, jspec, cohorts=k)
                              .reduce(jmsgs, jnp.asarray(w), float(ROWS)))
                for k in reference}
    return got, want


@pytest.mark.parametrize("comm", ["packed", "pallas"])
def test_two_tier_select_bit_equal_every_k(comm):
    """Integer-valued payloads with 0/1 weights make every cohort partial
    an exact sum: the two-tier select reduce is bit-equal to the single
    tier for every k, and to the reference's."""
    spec, _ = _two_tier_spec()
    rng = np.random.default_rng(0)
    x = np.round(rng.standard_normal((ROWS, spec.d)) * 100.0).astype(
        np.float32)
    w = (rng.uniform(size=ROWS) < 0.5).astype(np.float32)
    got, want = _two_tier("topk", comm, x, w)
    for k in TIERS:
        assert_bits_equal(got[k], got[1])
    for k, jw in want.items():
        np.testing.assert_array_equal(got[k], jw, err_msg=f"k={k}")


@pytest.mark.parametrize("kind", ["topk", "quant"])
def test_two_tier_bit_equal_when_later_cohorts_hold_one_row(kind):
    """A partial adds its cohort's rows in client order, and the partials
    add left to right: where every cohort after the first holds at most one
    row of nonzero weight, the two tiers add the same terms in the same
    order and the reduce is bit-equal to the single tier on real-valued
    payloads and weights (m = ROWS divides exactly)."""
    spec, _ = _two_tier_spec()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((ROWS, spec.d)).astype(np.float32)
    w = np.zeros(ROWS, np.float32)
    # rows 0-2 lie in the first cohort at every k <= 4, row 9 alone in a
    # later one
    w[[0, 1, 2, 9]] = rng.uniform(0.5, 2.0, 4)
    got, _ = _two_tier(kind, "pallas", x, w, reference=())
    for k in (2, 4):
        assert_bits_equal(got[k], got[1])


@pytest.mark.parametrize("comm", ["packed", "pallas"])
def test_two_tier_quant_allclose_every_k(comm):
    spec, _ = _two_tier_spec()
    rng = np.random.default_rng(2)
    x = rng.standard_normal((ROWS, spec.d)).astype(np.float32)
    w = (rng.uniform(size=ROWS) < 0.5).astype(np.float32) * 1.25
    got, want = _two_tier("quant", comm, x, w)
    for k in TIERS:
        np.testing.assert_allclose(got[k], got[1], rtol=1e-5, atol=1e-6,
                                   err_msg=f"k={k}")
    for k, jw in want.items():
        np.testing.assert_allclose(got[k], jw, rtol=1e-5, atol=1e-6,
                                   err_msg=f"k={k}")


def test_two_tier_dense_wire_allclose():
    spec, _ = _two_tier_spec()
    tp = transports.get_transport(CompressorConfig(kind="none"), "ref")
    x = t(np.random.default_rng(3).standard_normal((ROWS, spec.d)).astype(
        np.float32))
    w = torch.ones(ROWS)
    ref = flat.FlatTransport(tp, spec).reduce(x, w, float(ROWS))
    got = flat.FlatTransport(tp, spec, cohorts=4).reduce(x, w, float(ROWS))
    np.testing.assert_allclose(n(got), n(ref), rtol=1e-6, atol=1e-7)


def test_two_tier_rows_not_divisible_raises():
    spec, _ = _two_tier_spec()
    tp = transports.get_transport(
        CompressorConfig(**KINDS["topk"]), "packed")
    msgs = flat.FlatTransport(tp, spec).codec.pack(torch.ones(6, spec.d))
    with pytest.raises(ValueError, match="cohorts"):
        flat.FlatTransport(tp, spec, cohorts=4).reduce(msgs, torch.ones(6),
                                                       6.0)


def test_flat_transports_tier_the_uplink_only():
    _, cfg = _cfgs("quant", "pallas", cohorts=3)
    up, down = flat.flat_transports_for(cfg, flat.spec_of(_params()))
    assert up.cohorts == 3 and down.cohorts == 1


@pytest.mark.parametrize("kind", ["topk", "quant"])
def test_engine_rounds_with_cohorts(np_data, kind):
    """cohorts = 2 and 4 on the engine's uplink reduce: the rounds within
    the reordered sum of the single tier's (rtol 1e-5 / atol 1e-6), and the
    reference's two-tier rounds at the usual tolerances."""
    _, one = _cfgs(kind, "pallas")
    s1, _ = _port_drive(one, np_data)
    for k in (2, 4):
        jcfg, cfg = _cfgs(kind, "pallas", cohorts=k)
        s, h = _port_drive(cfg, np_data)
        np.testing.assert_allclose(n(s.w), n(s1.w), rtol=1e-5, atol=1e-6)
        if k == 2:
            js, jh = _ref_drive(jcfg, np_data)
            _assert_rounds_close(h, jh, s, js)


# ---------------------------------------------------------------------------
# client_chunk
# ---------------------------------------------------------------------------

def test_client_chunk_gives_one_trajectory(np_data):
    """The clients run one after another whatever the chunk: every value
    gives the same rounds, bit for bit, with and without a store."""
    for cap in (0, M):
        out = []
        for chunk in (0, 1, 3):
            _, cfg = _cfgs("topk", "pallas", cap=cap, client_chunk=chunk)
            out.append(_port_drive(cfg, np_data, rounds_=3))
        (s0, h0) = out[0]
        for s, h in out[1:]:
            assert_bits_equal(s.w, s0.w)
            for f in h0._fields:
                assert_bits_equal(getattr(h, f), getattr(h0, f))
    cfg = baselines.penalty_config(1.0, EPS, 0.1, 2, N, M, client_chunk=4)
    assert cfg.client_chunk == 4


# ---------------------------------------------------------------------------
# The one-card sharding shims
# ---------------------------------------------------------------------------

def test_sharding_shims_are_identities():
    data = {"x": torch.arange(24.0).reshape(6, 4)}
    idx = torch.tensor([1, 3])
    out = shard.sharded_take(data, idx)
    assert_bits_equal(out["x"], data["x"][idx])
    store = slots.init(6, 4, 8, torch.float32, "cpu")
    assert shard.constrain_store(store) == store
    tup = npc.NPBatch(torch.zeros(6, 2), torch.arange(6))
    got = shard.sharded_take(tup, idx)
    assert isinstance(got, npc.NPBatch) and got.y.tolist() == [1, 3]
    x = torch.ones(3)
    for fn in (partition.gather_leading, partition.shard_act):
        assert fn(x) is x
    assert partition.constrain_leading(x, "client") is x
    assert partition.constrain_flat(x) is x
    assert partition.current_mesh() is None
    partition.activate_mesh(None)
    assert partition.resolve("client", None, "flat", "embed") == (
        "data", None, "model", None)
    partition.activate_mesh(None, logical={"client": "pod"})
    assert partition.resolve("client") == ("pod",)
    partition.activate_mesh(None)
    # with a mesh the helpers stay identities on values (one process holds
    # whole tensors); the table remaps the client axis and drops the axes
    # the mesh lacks
    m = mesh.make_debug_mesh((2, 2), ("pod", "model"))
    try:
        partition.activate_mesh(m, client_axis="pod")
        assert partition.current_mesh() is m
        assert partition.resolve("client", "batch", "flat") == (
            "pod", None, "model")
        assert partition.shard_act(x, "batch") is x
        assert partition.constrain_leading(x, "client") is x
    finally:
        partition.activate_mesh(None)
    assert partition.DEFAULT_LOGICAL == __import__(
        "repro.sharding.partition",
        fromlist=["DEFAULT_LOGICAL"]).DEFAULT_LOGICAL


# ---------------------------------------------------------------------------
# The launcher's flags, on the CPU (one 10-round chunk each)
# ---------------------------------------------------------------------------

LAUNCH = ["--reduced", "--device", "cpu", "--seq", "8", "--batch", "1",
          "--rounds", "10", "--log-level", "warning"]


@pytest.mark.parametrize("flags", [
    ["--ef-slots", "4", "--clients", "8", "--participating", "4",
     "--participation", "gather", "--comm", "pallas"],
    ["--cohorts", "2", "--clients", "4", "--participating", "2",
     "--participation", "gather", "--comm", "pallas", "--uplink", "quant"],
    ["--client-chunk", "2", "--clients", "2"],
    ["--ef-slots", "4", "--clients", "8", "--participating", "4",
     "--participation", "gather", "--comm", "pallas", "--sparse-eval",
     "--lean-metrics"],
], ids=["ef-slots", "cohorts", "client-chunk", "ef-slots-lean"])
def test_launcher_scale_flags(flags):
    fed = train.setup(train.parser().parse_args(LAUNCH + flags))[3]
    assert fed.full_eval == ("--sparse-eval" not in flags)
    assert fed.lean_metrics == ("--lean-metrics" in flags)
    state = train.main(LAUNCH + flags)
    assert state.t == 10 and torch.isfinite(state.w).all()
    if "--ef-slots" in flags:
        assert isinstance(state.e_up, slots.SlotStore)
        assert state.e_up.pool.shape[0] == 4
        assert int((state.e_up.owner >= 0).sum()) == 4
