"""The client fleet (``repro_torch.fleet``) and the NP task against the JAX
package, and the fleet's own laws.

The port's random draws cannot match the reference's, so every random law
is held in two parts: its deterministic core, given the reference's own
draws (the permutation, the Dirichlet proportions, the drift normals, the
sampler uniforms), and its distribution, on the port's own draws.

Tolerances and why:

* partitioner cores (``idx``, ``count``, the drifted shards),
  ``largest_remainder`` and the sampler cores (``capped_inclusion``'s
  float32 pi, ``systematic_pick``'s picks, the weighted mask and
  Horvitz-Thompson weights, the Markov mask and availability): bit-equal.
  The port sums and runs its float32 sums in the reference's CPU order
  (left to right; running sums in blocks of 16), so pi and the picks are
  bit-equal too, not only the picks;
* statistical properties on the port's own draws: inclusion frequencies
  within 0.03 of pi over 4000 draws, the Horvitz-Thompson aggregate
  within 0.05 of its target (the reference's own bounds);
* provisioning and the fleet defaults against raw batches, gather against
  mask: bit-equal (the same computation);
* engine rounds against ``repro.engine.rounds.round_step``, as the
  trainer slice states them: per-round f, g_hat, sigma at rtol 1e-5
  (``delta_norm`` at rtol 1e-5 too); ``feasible`` and the wire bytes
  exactly; the final w: all but 0.1% of the coordinates within rtol 1e-4 /
  atol 1e-6 and every coordinate within atol 1e-3 (a top-k member may flip
  on the last-bit differences of the two frameworks' gradients);
* NP ``loss_pair``: rtol 1e-6 (the two frameworks' ``exp`` / ``log1p``
  differ in the last place);
* the theory helpers: equal (the same float64 formulas).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import (CompressorConfig as JCompressorConfig,
                                FedConfig as JFedConfig,
                                FleetConfig as JFleetConfig,
                                SwitchConfig as JSwitchConfig)
from repro.comm import flat as jax_flat
from repro.core import theory as jax_theory
from repro.engine import rounds as jax_rounds
from repro.fleet import partitions as jax_part
from repro.fleet import provision as jax_prov
from repro.fleet import samplers as jax_samp
from repro.tasks import np_classification as jax_npc
from repro_torch.configs.base import (CompressorConfig, FedConfig,
                                      FleetConfig, SwitchConfig)
from repro_torch.core import fedsgm, theory
from repro_torch.data import synthetic
from repro_torch.engine import rounds
from repro_torch.fleet import partitions, provision, samplers
from repro_torch.tasks import np_classification as npc
from torch_port_util import assert_bits_equal, n, t

EPS = 0.35
N = 10

KINDS = {
    "none": dict(kind="none"),
    "topk": dict(kind="topk", ratio=0.25, block=8),
    "randk": dict(kind="randk", ratio=0.25, block=8),
    "quant": dict(kind="quant", bits=8, block=8),
    "natural": dict(kind="natural"),
}
STRATS = ("fedsgm", "fedsgm-soft", "penalty-fedavg")
# heavy-tailed valid rows of the 45-row NP shards: at m = 5 the inclusion
# probabilities of clients 0 and 8 cap at 1, so the Horvitz-Thompson
# weights are not 0/1
HT_COUNTS = np.array([40, 3, 17, 1, 9, 30, 2, 5, 44, 11])


@pytest.fixture
def one_thread():
    # tiny shapes: one intra-op thread beats contending with the other
    # test workers for the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(cls=FedConfig, comp=CompressorConfig, switch=SwitchConfig,
         fleet=None, **kw):
    """The reference's fleet-test config (n = 10, m = 5, E = 2, hard
    switch), in either package's classes."""
    base = dict(n_clients=N, m=5, local_steps=2, lr=0.1,
                switch=switch(mode="hard", eps=EPS),
                uplink=comp(kind="none"), downlink=comp(kind="none"))
    for k in ("uplink", "downlink"):
        if isinstance(kw.get(k), dict):
            kw[k] = comp(**kw[k])
    base.update(kw)
    if fleet is not None:
        base["fleet"] = fleet
    return cls(**base)


def _jcfg(fleet=None, **kw):
    return _cfg(JFedConfig, JCompressorConfig, JSwitchConfig,
                fleet=None if fleet is None else JFleetConfig(**fleet), **kw)


def _tcfg(fleet=None, **kw):
    return _cfg(fleet=None if fleet is None else FleetConfig(**fleet), **kw)


@pytest.fixture(scope="module")
def np_data():
    """The reference's NP client split (n = 10), as numpy arrays."""
    (xs, ys), _ = jax_npc.make_dataset(jax.random.PRNGKey(0), n_clients=N)
    return np.asarray(xs), np.asarray(ys)


@pytest.fixture(scope="module")
def labelled():
    """The reference's partitioner-test dataset (201 rows, ~40% label 1),
    as numpy arrays."""
    key = jax.random.PRNGKey(7)
    x = jax.random.normal(key, (201, 6))
    y = (jax.random.uniform(jax.random.fold_in(key, 1), (201,)) < 0.4
         ).astype(jnp.float32)
    return np.asarray(x), np.asarray(y)


def _batch(xs, ys):
    return npc.NPBatch(t(xs), t(ys))


def _params(d=30):
    return {"w": torch.zeros(d), "b": torch.zeros(())}


def _traj(cfg, batches, T=3, sampler=None):
    state = rounds.init_state(_params(), cfg, device="cpu")
    if sampler is not None:
        state = state._replace(sampler=sampler)
    mets = []
    for _ in range(T):
        state, m = rounds.round_step(state, batches, npc.loss_pair, cfg,
                                     device="cpu")
        mets.append(m)
    return state, mets


def _assert_states_equal(a, b):
    for name in ("w", "x", "e_up", "wbar_sum", "wbar_weight"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert_bits_equal(x, y)


def _assert_metrics_equal(ma, mb):
    for a, b in zip(ma, mb):
        for name in rounds.RoundMetrics._fields:
            assert_bits_equal(getattr(a, name), getattr(b, name))


def _valid(cp):
    return [n(cp.idx[j, :int(cp.count[j])]) for j in range(len(cp.count))]


# ---------------------------------------------------------------------------
# Partitioner cores against the reference, given its draws
# ---------------------------------------------------------------------------

def _assert_partition_equal(got, want):
    np.testing.assert_array_equal(n(got.idx), np.asarray(want.idx))
    np.testing.assert_array_equal(n(got.count), np.asarray(want.count))


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("J", [8, 20])
def test_iid_core_matches_reference(labelled, seed, J):
    key = jax.random.PRNGKey(seed)
    want = jax_part.iid_indices(key, 201, J)
    perm = t(jax.random.permutation(key, 201))
    _assert_partition_equal(partitions.iid_core(perm, J), want)


# (alpha, clients, cap_factor, balance): the reference tests' ragged and
# balanced settings, strong and mild skew, a cap that clips
DIRICHLET_CASES = [(0.5, 8, 8.0, False), (0.5, 8, 2.0, True),
                   (0.1, 8, 2.0, False), (2.0, 5, 1.0, False),
                   (100.0, 20, 8.0, False), (0.05, 20, 8.0, True)]


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("alpha,J,cap_factor,balance", DIRICHLET_CASES)
def test_dirichlet_core_matches_reference(labelled, seed, alpha, J,
                                          cap_factor, balance):
    _, y = labelled
    fl = JFleetConfig(partitioner="dirichlet", alpha=alpha,
                      cap_factor=cap_factor, balance=balance)
    key = jax.random.PRNGKey(seed)
    part = jax_part.get_partitioner("dirichlet")
    want = part.partition(key, 201, J, fl, labels=jnp.asarray(y))
    props = jax.random.dirichlet(key, jnp.full((J,), float(alpha)),
                                 shape=(2,))
    got = partitions.dirichlet_core(t(props), t(y), J, 2,
                                    part.cap(201, J, fl), balance=balance)
    _assert_partition_equal(got, want)


def test_dirichlet_extreme_alpha_counts_match_reference(labelled):
    """alpha = 0.05 over 20 clients, cap ceil(8 * 201 / 20) = 81: the
    port's shards equal the reference's at PRNGKey(0..3), dropped rows
    included.  At PRNGKey(2) the largest shard holds 85 rows after the
    rescue of the empty clients and ``pack_shards`` clips it to the cap:
    4 rows are dropped (197 of 201), which is why the reference's own
    ``test_dirichlet_extreme_alpha_no_empty_shards`` fails."""
    _, y = labelled
    fl = JFleetConfig(partitioner="dirichlet", alpha=0.05, cap_factor=8.0)
    tfl = FleetConfig(partitioner="dirichlet", alpha=0.05, cap_factor=8.0)
    part = jax_part.get_partitioner("dirichlet")
    assert part.cap(201, 20, fl) == 81
    assert partitions.get_partitioner("dirichlet").cap(201, 20, tfl) == 81
    sums = []
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        want = part.partition(key, 201, 20, fl, labels=jnp.asarray(y))
        props = jax.random.dirichlet(key, jnp.full((20,), 0.05), shape=(2,))
        got = partitions.dirichlet_core(t(props), t(y), 20, 2, 81)
        _assert_partition_equal(got, want)
        assert int(got.count.min()) >= 1
        sums.append(int(got.count.sum()))
        allv = np.concatenate(_valid(got))
        assert len(allv) == len(set(allv.tolist()))
    assert sums == [201, 201, 197, 201]
    # the cause: the rescued assignment's largest shard is 85 > cap
    key = jax.random.PRNGKey(2)
    props = jax.random.dirichlet(key, jnp.full((20,), 0.05), shape=(2,))
    wide = partitions.dirichlet_core(t(props), t(y), 20, 2, 201)
    assert int(wide.count.max()) == 85 and int(wide.count.sum()) == 201


@pytest.mark.parametrize("a", [0.7, 1.2, 1.5, 2.0])
@pytest.mark.parametrize("J,cap_factor", [(8, 8.0), (20, 4.0), (3, 1.0)])
def test_zipf_core_matches_reference(a, J, cap_factor):
    fl = JFleetConfig(partitioner="zipf", zipf_a=a, cap_factor=cap_factor)
    key = jax.random.PRNGKey(3)
    part = jax_part.get_partitioner("zipf")
    want = part.partition(key, 201, J, fl)
    perm = t(jax.random.permutation(key, 201))
    _assert_partition_equal(
        partitions.zipf_core(perm, J, a, part.cap(201, J, fl)), want)


def test_shift_matches_reference(labelled):
    """``build_fleet`` with the feature-shift law: the IID split from the
    reference's permutation, then the drift from its normals -- the
    drifted shards bit-equal (``leaf + shift * z``, one rounding each)."""
    x, y = labelled
    key = jax.random.PRNGKey(5)
    jcfg = _jcfg(n_clients=8, fleet=dict(partitioner="shift", shift=2.0))
    want = jax_prov.build_fleet(key, (jnp.asarray(x), jnp.asarray(y)), jcfg,
                                labels=jnp.asarray(y))
    kp, kt = jax.random.split(key)
    cp = partitions.iid_core(t(jax.random.permutation(kp, 201)), 8)
    shards = npc.NPBatch(t(x)[cp.idx], t(y)[cp.idx])
    k0, k1 = jax.random.split(kt, 2)
    normals = [t(jax.random.normal(k0, (8, 1, 6), jnp.float32)), None]
    got = partitions.shift_core(shards, normals, 2.0)
    assert_bits_equal(got.x, want.data[0])
    assert_bits_equal(got.y, want.data[1])
    np.testing.assert_array_equal(n(cp.count), np.asarray(want.count))


def test_largest_remainder_matches_reference_with_ties():
    """Floors, deficits and tied remainders (ties to the lower index),
    bit-equal."""
    rng = np.random.default_rng(0)
    for trial in range(60):
        k = (1, 8, 20)[trial % 3]
        raw = rng.integers(0, 20, k).astype(np.float32)
        if trial % 3 == 0:
            raw += 0.5                              # every remainder ties
        elif trial % 3 == 1:
            raw += rng.choice([0.25, 0.5, 0.75], k).astype(np.float32)
        else:
            raw += rng.random(k).astype(np.float32)
        raw = raw.astype(np.float32)
        total = int(np.floor(raw.astype(np.float64).sum() + 0.5))
        want = jax_part.largest_remainder(jnp.asarray(raw), total)
        got = partitions.largest_remainder(t(raw), total)
        np.testing.assert_array_equal(n(got), np.asarray(want))
        assert int(got.sum()) == total


def test_float32_scans_follow_the_reference_order():
    """``sum_f32`` adds left to right and ``cumsum_f32`` runs in blocks of
    16: bit-equal to the reference's CPU ``sum`` (up to 32 entries) and
    ``cumsum`` (any length), where a plain float32 sum or ``torch.cumsum``
    differ in the last place."""
    rng = np.random.default_rng(1)
    for k in (1, 5, 16, 17, 20, 32, 33, 257, 300):
        x = (rng.random((8, k)) ** 3).astype(np.float32)
        for x in x:
            assert_bits_equal(partitions.cumsum_f32(t(x)), jnp.cumsum(x))
            if k <= 32:
                assert_bits_equal(partitions.sum_f32(t(x)), jnp.sum(x))


# ---------------------------------------------------------------------------
# The partitioners' own laws (the reference's property tests, on the port)
# ---------------------------------------------------------------------------

def _tpartition(name, labelled, J=8, seed=3, **kw):
    x, y = labelled
    return partitions.get_partitioner(name).partition(
        torch.Generator().manual_seed(seed), x.shape[0], J,
        FleetConfig(partitioner=name, **kw), labels=t(y))


@pytest.mark.parametrize("name,kw", [
    ("iid", {}),
    ("dirichlet", dict(alpha=0.5, cap_factor=8.0)),
    ("dirichlet", dict(alpha=0.5, balance=True)),
    ("zipf", dict(zipf_a=1.5, cap_factor=8.0)),
    ("shift", dict(shift=1.0)),
])
def test_partitions_assign_no_row_twice(labelled, name, kw):
    cp = _tpartition(name, labelled, **kw)
    allv = np.concatenate(_valid(cp))
    assert len(allv) == len(set(allv.tolist()))
    assert allv.min() >= 0 and allv.max() < labelled[0].shape[0]


@pytest.mark.parametrize("name,kw", [
    ("dirichlet", dict(alpha=0.5, cap_factor=8.0)),
    ("zipf", dict(zipf_a=1.5, cap_factor=8.0)),
])
def test_ragged_partitions_exact_under_ample_cap(labelled, name, kw):
    cp = _tpartition(name, labelled, **kw)
    assert int(cp.count.sum()) == 201
    assert set(np.concatenate(_valid(cp)).tolist()) == set(range(201))


def test_dirichlet_low_alpha_skews_labels(labelled):
    _, y = labelled
    cp = _tpartition("dirichlet", labelled, alpha=0.1, balance=True)
    fracs = np.asarray([y[v].mean() for v in _valid(cp)])
    assert fracs.std() > 0.05


def test_zipf_quantity_skew(labelled):
    counts = n(_tpartition("zipf", labelled, zipf_a=1.5,
                           cap_factor=8.0).count)
    assert (np.diff(counts) <= 0).all() and counts.min() >= 1
    assert counts.max() / counts.min() > 4


@pytest.mark.parametrize("alpha", [0.05, 1.0, 50.0])
def test_dirichlet_draw(alpha):
    """The port's Dirichlet draw (Marsaglia-Tsang with the boost, in log
    space): rows on the simplex, no 0/0 at alpha = 0.05, and the law's
    mean 1/J and variance (J-1) / (J^2 (J alpha + 1))."""
    J = 5
    p = partitions.dirichlet(torch.Generator().manual_seed(0), alpha, 20000,
                             J).double()
    assert torch.isfinite(p).all() and (p >= 0).all()
    np.testing.assert_allclose(p.sum(1).numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(p.mean(0).numpy(), 1.0 / J, atol=0.01)
    var = (J - 1) / (J * J * (J * alpha + 1))
    np.testing.assert_allclose(p.var(0).numpy(), var, rtol=0.1)


def test_feature_shift_moves_client_means(labelled):
    x, y = labelled

    def mk(s):
        return provision.build_fleet(
            torch.Generator().manual_seed(5), npc.NPBatch(t(x), t(y)),
            _tcfg(n_clients=8, fleet=dict(partitioner="shift", shift=s)),
            labels=t(y))
    plain, shifted = mk(0.0), mk(2.0)

    def spread(f):
        return float(f.data.x.mean(dim=(1, 2)).std())
    assert spread(shifted) > 5 * spread(plain)
    assert_bits_equal(plain.data.y, shifted.data.y)


def test_build_fleet_checks(labelled):
    x, y = labelled
    data = npc.NPBatch(t(x), t(y))
    with pytest.raises(ValueError, match="ragged"):
        provision.build_fleet(torch.Generator(), data,
                              _tcfg(fleet=dict(partitioner="dirichlet")),
                              labels=t(y))
    with pytest.raises(ValueError, match="needs labels"):
        provision.build_fleet(torch.Generator(), data, _tcfg(fleet=dict(
            partitioner="dirichlet", balance=True)))
    fleet = provision.build_fleet(
        torch.Generator().manual_seed(0), data,
        _tcfg(n_clients=8, fleet=dict(partitioner="zipf", batch_size=4)))
    assert provision.n_clients(fleet) == 8
    assert provision.capacity(fleet) == math.ceil(2.0 * 201 / 8)
    assert torch.equal(fleet.count, fleet.host_count)
    # padded rows repeat the shard's own first row
    for j in range(8):
        c = int(fleet.host_count[j])
        assert (fleet.data.x[j, c:] == fleet.data.x[j, :1]).all()


def test_registries():
    assert set(partitions.partitioner_names()) >= {"iid", "dirichlet",
                                                   "zipf", "shift"}
    assert set(samplers.sampler_names()) >= {"uniform", "weighted",
                                             "markov", "fixed"}
    with pytest.raises(ValueError, match="unknown partitioner"):
        partitions.get_partitioner("sorted")
    with pytest.raises(ValueError, match="unknown client sampler"):
        samplers.get_sampler("greedy")
    # the mid-round events came with the async engine
    cfg = _tcfg()
    ev, avail = samplers.get_sampler("markov").events(
        torch.Generator().manual_seed(0), cfg, torch.ones(cfg.n_clients))
    assert isinstance(ev, samplers.Events)
    assert avail.shape == ev.depart.shape == (cfg.n_clients,)


def test_partition_shims(labelled):
    """``partition_iid`` and ``partition_dirichlet``: equal shards, no row
    twice."""
    x, y = labelled
    xs, ys = synthetic.partition_dirichlet(torch.Generator().manual_seed(2),
                                           t(x), t(y), 5, alpha=0.3)
    assert xs.shape == (5, 40, 6) and ys.shape == (5, 40)
    flat = n(xs).reshape(-1, 6)
    assert np.unique(flat, axis=0).shape[0] == flat.shape[0]
    xs, ys = synthetic.partition_iid(torch.Generator().manual_seed(2), t(x),
                                     t(y), 8)
    assert xs.shape == (8, 25, 6)
    assert np.unique(n(xs).reshape(-1, 6), axis=0).shape[0] == 200


def test_tabular_generators():
    x, y = synthetic.breast_cancer_like(torch.Generator().manual_seed(0))
    assert x.shape == (569, 30) and y.shape == (569,)
    assert 0.3 < float(y.mean()) < 0.45
    x, y, a = synthetic.adult_like(torch.Generator().manual_seed(0))
    assert x.shape == (2000, 25) and torch.equal(x[:, -1], a)
    assert set(y.unique().tolist()) <= {0.0, 1.0}


# ---------------------------------------------------------------------------
# Sampler cores against the reference, given the same uniforms
# ---------------------------------------------------------------------------

def _fleet_counts(rng, n_):
    if rng.random() < 0.5:
        return rng.integers(1, 100, n_)
    return (rng.pareto(1.0, n_) * 10 + 1).astype(np.int64)


def test_weighted_cores_match_reference():
    """``capped_inclusion`` (float32 pi), ``systematic_pick`` and the
    weighted round (mask and Horvitz-Thompson weights) from the same
    uniform: bit-equal, over fleets of 2-32 clients with mild and
    heavy-tailed counts."""
    rng = np.random.default_rng(0)
    for trial in range(36):
        n_ = (5, 8, 20, 32)[trial % 4]
        m = (1, n_ // 2, n_)[trial % 3]
        cnt = _fleet_counts(rng, n_)
        jfleet = jax_prov.from_stacked((jnp.zeros((n_, 2, 1)),),
                                       count=jnp.asarray(cnt, jnp.int32))
        fleet = provision.from_stacked((torch.zeros((n_, 2, 1)),),
                                       count=t(cnt))
        q = provision.data_weights(fleet)
        assert_bits_equal(q, jax_prov.data_weights(jfleet))
        pi = samplers.capped_inclusion(q, m)
        assert_bits_equal(pi, jax_samp.capped_inclusion(
            jax_prov.data_weights(jfleet), m))
        key = jax.random.PRNGKey(trial)
        u = t(jax.random.uniform(key, ()))
        np.testing.assert_array_equal(
            n(samplers.systematic_pick(u, pi, m)),
            np.asarray(jax_samp.systematic_pick(key, jnp.asarray(n(pi)), m)))
        mask, weights, _ = jax_samp.get_sampler("weighted").sample(
            key, JFedConfig(n_clients=n_, m=m), fleet=jfleet)
        tmask, tweights = samplers.weighted_core(u, q, m)
        assert_bits_equal(tmask, mask)
        assert_bits_equal(tweights, weights)


def test_markov_step_matches_reference():
    rng = np.random.default_rng(1)
    for trial in range(36):
        n_ = (5, 8, 20, 32)[trial % 4]
        m = (1, n_ // 2, n_)[trial % 3]
        stay, ret = float(rng.random()), float(rng.random())
        cfg = JFedConfig(n_clients=n_, m=m, fleet=JFleetConfig(
            sampler="markov", avail_stay=stay, avail_return=ret))
        st = (rng.random(n_) < 0.5).astype(np.float32)
        key = jax.random.PRNGKey(trial)
        mask, weights, avail = jax_samp.get_sampler("markov").sample(
            key, cfg, state=jnp.asarray(st))
        kf, kp = jax.random.split(key)
        tmask, tavail = samplers.markov_step(
            t(st), t(jax.random.uniform(kf, (n_,))),
            t(jax.random.uniform(kp, (n_,))), m, stay, ret)
        assert_bits_equal(tmask, mask)
        assert_bits_equal(tavail, avail)


@pytest.mark.parametrize("name", ["uniform", "weighted", "markov"])
def test_inclusion_probs_match_reference(name):
    rng = np.random.default_rng(2)
    cnt = _fleet_counts(rng, N)
    jfleet = jax_prov.from_stacked((jnp.zeros((N, 2, 1)),),
                                   count=jnp.asarray(cnt, jnp.int32))
    fleet = provision.from_stacked((torch.zeros((N, 2, 1)),), count=t(cnt))
    fl = dict(sampler=name, avail_stay=0.8, avail_return=0.3)
    for f, jf in ((fleet, jfleet), (None, None)):
        assert_bits_equal(
            samplers.get_sampler(name).inclusion_probs(_tcfg(fleet=fl), f),
            jax_samp.get_sampler(name).inclusion_probs(_jcfg(fleet=fl), jf))


# ---------------------------------------------------------------------------
# The samplers' laws on the port's own draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["uniform", "weighted", "markov"])
def test_samplers_draw_exactly_m_distinct(name):
    cfg = _tcfg(fleet=dict(sampler=name))
    s = samplers.get_sampler(name)
    st = s.init(cfg)
    gen = torch.Generator().manual_seed(1)
    for _ in range(8):
        mask, w, st = s.sample(gen, cfg, st)
        assert float(mask.sum()) == cfg.m
        assert ((mask == 0) | (mask == 1)).all()
        if name != "weighted":
            assert w is mask


def test_weighted_inclusion_frequencies():
    """The empirical inclusion frequency of every client matches pi."""
    cfg = _tcfg()
    fleet = provision.from_stacked((torch.zeros((N, 16, 3)),),
                                   count=torch.arange(1, N + 1))
    s = samplers.get_sampler("weighted")
    pi = n(s.inclusion_probs(cfg, fleet))
    gen = torch.Generator().manual_seed(0)
    emp = np.mean([n(s.sample(gen, cfg, fleet=fleet)[0])
                   for _ in range(4000)], axis=0)
    np.testing.assert_allclose(emp, pi, atol=0.03)
    assert pi.sum() == pytest.approx(cfg.m, abs=1e-4)


def test_weighted_aggregation_unbiased():
    """E[sum_j w_j x_j / m] is the data-weighted mean sum_j q_j x_j."""
    cfg = _tcfg()
    count = torch.arange(1, N + 1)
    fleet = provision.from_stacked((torch.zeros((N, 16, 3)),), count=count)
    s = samplers.get_sampler("weighted")
    xs = torch.linspace(-2.0, 3.0, N)
    gen = torch.Generator().manual_seed(0)
    est = np.mean([float((s.sample(gen, cfg, fleet=fleet)[1] * xs).sum()
                         / cfg.m) for _ in range(4000)])
    q = n(count).astype(np.float64) / float(count.sum())
    assert est == pytest.approx(float((q * n(xs)).sum()), abs=0.05)


def test_markov_availability_is_sticky():
    """A frozen chain (stay 1, return 0) pins the participant pool."""
    cfg = _tcfg(fleet=dict(sampler="markov", avail_stay=1.0,
                           avail_return=0.0))
    s = samplers.get_sampler("markov")
    st = torch.tensor([1, 1, 1, 1, 1, 0, 0, 0, 0, 0], dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    pools = []
    for _ in range(6):
        mask, _, st = s.sample(gen, cfg, st)
        pools.append(frozenset(torch.nonzero(mask).flatten().tolist()))
    assert all(p == {0, 1, 2, 3, 4} for p in pools)


def test_markov_state_threads_through_rounds(np_data, one_thread):
    cfg = _tcfg(fleet=dict(sampler="markov"))
    state = rounds.init_state(_params(), cfg, device="cpu")
    assert state.sampler is not None and state.sampler.shape == (N,)
    # the chain's start is drawn from the seed: the same seed, the same
    assert torch.equal(state.sampler, samplers.get_sampler("markov")
                       .init(cfg))
    state2, _ = _traj(cfg, _batch(*np_data), T=2)
    assert state2.sampler.shape == (N,)


# ---------------------------------------------------------------------------
# Provisioning
# ---------------------------------------------------------------------------

def _ragged_fleet(poison=False):
    """Client j's rows all hold the value j; padded rows NaN (poison)."""
    data = torch.arange(8.0)[:, None, None].repeat(1, 6, 3)
    count = torch.tensor([6, 4, 2, 1, 6, 3, 5, 2])
    if poison:
        k = torch.arange(6)[None, :, None]
        data = torch.where(k >= count[:, None, None], float("nan"), data)
    return provision.from_stacked((data,), count=count)


def test_provisioning_shapes_and_client_identity():
    cfg = _tcfg(n_clients=8, fleet=dict(batch_size=4))
    (b,) = provision.minibatch(_ragged_fleet(), provision.round_key(cfg, 0),
                               cfg)
    assert b.shape == (8, 4, 3)
    assert torch.equal(b[:, :, 0], torch.arange(8.0)[:, None].expand(8, 4))


def test_provisioning_draws_only_valid_rows():
    cfg = _tcfg(n_clients=8, fleet=dict(batch_size=32, redraw=True))
    for r in range(5):
        (b,) = provision.minibatch(_ragged_fleet(poison=True),
                                   provision.round_key(cfg, r), cfg)
        assert torch.isfinite(b).all()
    rows = provision.draw_rows(provision.round_key(cfg, 0),
                               torch.tensor([6, 4, 2, 1, 6, 3, 5, 2]),
                               range(8), 64)
    assert (rows < torch.tensor([6, 4, 2, 1, 6, 3, 5, 2])[:, None]).all()
    assert (rows >= 0).all()


def test_gather_provisioning_matches_mask():
    """Per-client streams: provisioning only the m gathered clients draws
    exactly the rows provisioning all n draws for them."""
    fleet = _ragged_fleet()
    fleet = fleet._replace(data=(fleet.data[0] + torch.rand(8, 6, 3),))
    cfg = _tcfg(n_clients=8, fleet=dict(batch_size=5, redraw=True))
    key = provision.round_key(cfg, 9)
    idx = torch.tensor([1, 3, 6])
    (full,) = provision.minibatch(fleet, key, cfg)
    (part,) = provision.minibatch(fleet, key, cfg, idx=idx)
    assert_bits_equal(full[idx], part)


def test_batch_size_zero_returns_shards():
    fleet = _ragged_fleet()
    cfg = _tcfg(n_clients=8, fleet=dict(batch_size=0))
    (b,) = provision.minibatch(fleet, provision.round_key(cfg, 0), cfg)
    assert b is fleet.data[0]
    (g,) = provision.minibatch(fleet, provision.round_key(cfg, 0), cfg,
                               idx=torch.tensor([2, 5]))
    assert torch.equal(g, fleet.data[0][[2, 5]])


def test_pinned_draws_stay_pinned():
    """``redraw=False`` pins the key to the run seed: the same rows every
    round; ``redraw=True`` draws afresh."""
    fleet = _ragged_fleet()
    fleet = fleet._replace(data=(torch.rand(8, 6, 3),))
    pin = _tcfg(n_clients=8, fleet=dict(batch_size=4))
    re = _tcfg(n_clients=8, fleet=dict(batch_size=4, redraw=True))
    draws = {name: [provision.minibatch(fleet, provision.round_key(c, r),
                                        c)[0] for r in range(3)]
             for name, c in (("pin", pin), ("re", re))}
    assert all(torch.equal(d, draws["pin"][0]) for d in draws["pin"])
    assert not torch.equal(draws["re"][0], draws["re"][1])
    assert provision.round_key(pin, 5) == provision.round_key(pin, 0)


# ---------------------------------------------------------------------------
# The fleet defaults are the raw batches, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", STRATS)
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_fleet_defaults_equal_raw_batches(np_data, strategy, kind,
                                          one_thread):
    cfg = _tcfg(strategy=strategy, uplink=KINDS[kind],
                downlink=KINDS[kind])
    batches = _batch(*np_data)
    s_raw, m_raw = _traj(cfg, batches)
    s_fl, m_fl = _traj(cfg, provision.from_stacked(batches))
    _assert_states_equal(s_raw, s_fl)
    _assert_metrics_equal(m_raw, m_fl)


@pytest.mark.parametrize("comm", ["packed", "pallas"])
@pytest.mark.parametrize("mode", ["mask", "gather"])
def test_fleet_defaults_equal_raw_batches_on_wires(np_data, comm, mode,
                                                   one_thread):
    cfg = _tcfg(comm=comm, participation=mode, uplink=KINDS["topk"],
                downlink=KINDS["quant"])
    batches = _batch(*np_data)
    s_raw, m_raw = _traj(cfg, batches)
    s_fl, m_fl = _traj(cfg, provision.from_stacked(batches))
    _assert_states_equal(s_raw, s_fl)
    _assert_metrics_equal(m_raw, m_fl)


@pytest.mark.parametrize("sampler", ["uniform", "weighted", "markov"])
@pytest.mark.parametrize("comm", ["dense", "pallas"])
def test_provisioned_gather_equals_mask(np_data, sampler, comm, one_thread):
    """Fresh per-round minibatches keep gather == mask bit for bit, for
    every sampler law (the weighted one on ragged counts)."""
    fl = dict(batch_size=8, redraw=True, sampler=sampler)
    fleet = provision.from_stacked(_batch(*np_data), count=t(HT_COUNTS))
    cfg = _tcfg(fleet=fl, uplink=KINDS["topk"], downlink=KINDS["topk"],
                comm=comm)
    if sampler == "weighted":
        w = samplers.get_sampler(sampler).sample(
            torch.Generator().manual_seed(0), cfg, fleet=fleet)[1]
        assert float(w.max()) > 1.0
    s_mask, m_mask = _traj(cfg, fleet)
    s_gath, m_gath = _traj(cfg.replace(participation="gather"), fleet)
    _assert_states_equal(s_mask, s_gath)
    _assert_metrics_equal(m_mask, m_gath)
    if sampler == "markov":
        assert_bits_equal(s_mask.sampler, s_gath.sampler)


@pytest.mark.parametrize("sampler", ["uniform", "markov"])
def test_sparse_eval_provisions_only_the_sampled(np_data, sampler,
                                                 monkeypatch, one_thread):
    """With ``full_eval=False`` in gather mode the round draws rows for the
    m sampled clients only, and those are the rows that provisioning all
    n draws for them: the round equals the same round on the batches
    provisioned for all n beforehand, bit for bit."""
    fleet = provision.from_stacked(_batch(*np_data),
                                   count=torch.arange(5, 5 + 4 * N, 4))
    cfg = _tcfg(fleet=dict(batch_size=8, redraw=True, sampler=sampler),
                uplink=KINDS["topk"], downlink=KINDS["topk"],
                participation="gather", full_eval=False)
    drawn = []
    draw_rows = provision.draw_rows

    def counting(key, host_count, ids, b):
        drawn.append(list(ids))
        return draw_rows(key, host_count, ids, b)
    monkeypatch.setattr(provision, "draw_rows", counting)
    state = rounds.init_state(_params(), cfg, device="cpu")
    s_fleet, m_fleet = rounds.round_step(state, fleet, npc.loss_pair, cfg,
                                         device="cpu")
    assert len(drawn) == 1 and len(drawn[0]) == cfg.m
    full = provision.minibatch(fleet, provision.round_key(cfg, 0), cfg)
    state = rounds.init_state(_params(), cfg, device="cpu")
    s_raw, m_raw = rounds.round_step(state, full, npc.loss_pair, cfg,
                                     device="cpu")
    _assert_states_equal(s_fleet, s_raw)
    _assert_metrics_equal([m_fleet], [m_raw])


def test_weighted_full_participation_reweights(np_data, one_thread):
    """m = n on ragged counts: every client takes part and the weights are
    the data-weighted ones (not the mask)."""
    fleet = provision.from_stacked(_batch(*np_data),
                                   count=torch.arange(1, N + 1))
    cfg = _tcfg(m=N, fleet=dict(sampler="weighted", batch_size=4,
                                redraw=True))
    _, mets = _traj(cfg, fleet, T=2)
    assert np.isfinite(float(mets[-1].f))
    mask, w, _ = samplers.get_sampler("weighted").sample(
        torch.Generator().manual_seed(0), cfg, fleet=fleet)
    assert float(mask.sum()) == N
    assert float(w.max()) > 1.0 > float(w.min())
    assert float(w.sum()) == pytest.approx(N, rel=1e-5)


# ---------------------------------------------------------------------------
# Fleet rounds against the reference's round_step
# ---------------------------------------------------------------------------

def _reference_weighted_cohorts(jfleet, jcfg, R=2):
    """The reference's weighted-sampler draws for R rounds, to replay in
    both packages through the ``fixed`` law."""
    s = jax_samp.get_sampler("weighted")
    draws = [s.sample(jax.random.PRNGKey(100 + r), jcfg, fleet=jfleet)
             for r in range(R)]
    return (np.stack([np.asarray(d[0]) for d in draws]),
            np.stack([np.asarray(d[1]) for d in draws]))


def _rounds_vs_reference(np_data, count, R=2, **kw):
    xs, ys = np_data
    jfl = dict(sampler="fixed")
    jcfg = _jcfg(fleet=jfl, **kw)
    cfg = _tcfg(fleet=jfl, **kw)
    jfleet = jax_prov.from_stacked((jnp.asarray(xs), jnp.asarray(ys)),
                                   count=jnp.asarray(count, jnp.int32))
    fleet = provision.from_stacked(_batch(xs, ys), count=t(count))
    masks, weights = _reference_weighted_cohorts(
        jfleet, jcfg.replace(fleet=JFleetConfig(sampler="weighted")), R)
    # the port's weighted core draws the same cohorts from the same
    # uniforms
    q = provision.data_weights(fleet)
    for r in range(R):
        u = t(jax.random.uniform(jax.random.PRNGKey(100 + r), ()))
        tm, tw = samplers.weighted_core(u, q, min(cfg.m, N))
        assert_bits_equal(tm, masks[r])
        assert_bits_equal(tw, weights[r])
    assert not np.array_equal(weights, masks)
    jstate = jax_rounds.init_state(jax_npc.init_params(None, 30), jcfg)
    jstate = jstate._replace(sampler=jax_samp.fixed_state(
        jnp.asarray(masks), jnp.asarray(weights)))
    jstep = jax.jit(lambda s: jax_rounds.round_step(s, jfleet,
                                                    jax_npc.loss_pair, jcfg))
    state, hist = _traj(cfg, fleet, T=R,
                        sampler=samplers.fixed_state(masks, weights))
    for r in range(R):
        jstate, jm = jstep(jstate)
        m = hist[r]
        np.testing.assert_allclose(
            [float(m.f), float(m.g_hat), float(m.sigma),
             float(m.delta_norm)],
            [float(jm.f), float(jm.g_hat), float(jm.sigma),
             float(jm.delta_norm)], rtol=1e-5)
        for field in ("feasible", "up_bytes", "down_bytes"):
            assert float(getattr(m, field)) == float(getattr(jm, field))
    jw = np.asarray(jax_flat.flatten(jax_flat.spec_of(jstate.w), jstate.w))
    w = n(state.w)
    close = np.isclose(w, jw, rtol=1e-4, atol=1e-6)
    assert (~close).mean() <= 1e-3, f"{int((~close).sum())} of {w.size}"
    np.testing.assert_allclose(w, jw, rtol=0, atol=1e-3)


@pytest.mark.parametrize("kind", ["none", "topk"])
def test_weighted_full_participation_rounds_match_reference(np_data, kind,
                                                            one_thread):
    """m = n = 10 on a full-shard fleet with counts 1..10: the reference's
    weighted cohorts (everyone, Horvitz-Thompson weights != 1) replayed in
    both packages; two rounds (the fused eval: mask mode at m = n)."""
    _rounds_vs_reference(np_data, np.arange(1, N + 1), m=N,
                         uplink=KINDS[kind], downlink=KINDS[kind])


@pytest.mark.parametrize("mode", ["mask", "gather"])
@pytest.mark.parametrize("comm", ["dense", "pallas"])
def test_ragged_ht_rounds_match_reference(np_data, mode, comm, one_thread):
    """5 of 10 clients on a full-shard fleet with heavy-tailed counts: the
    reference's weighted cohorts (Horvitz-Thompson weights) replayed in
    both packages, top-k up and down, two rounds."""
    _rounds_vs_reference(np_data, HT_COUNTS, comm=comm, participation=mode,
                         uplink=KINDS["topk"], downlink=KINDS["topk"])


# ---------------------------------------------------------------------------
# drive, averaged_iterate, round_bytes, theory
# ---------------------------------------------------------------------------

def test_drive_equals_round_steps(np_data, one_thread):
    cfg = _tcfg(uplink=KINDS["topk"], downlink=KINDS["topk"],
                fleet=dict(batch_size=8, redraw=True, sampler="markov"))
    fleet = provision.from_stacked(_batch(*np_data))
    s_steps, m_steps = _traj(cfg, fleet, T=3)
    state = rounds.init_state(_params(), cfg, device="cpu")
    s_drive, hist = rounds.drive(state, fleet, npc.loss_pair, cfg, T=3,
                                 device="cpu")
    _assert_states_equal(s_steps, s_drive)
    for name in rounds.RoundMetrics._fields:
        if getattr(hist, name) is None:     # telemetry, obs off
            assert all(getattr(m, name) is None for m in m_steps)
            continue
        assert_bits_equal(np.stack([n(getattr(m, name)) for m in m_steps]),
                          getattr(hist, name))
    assert fedsgm.drive is rounds.drive


def test_averaged_iterate_matches_reference(np_data, one_thread):
    xs, ys = np_data
    jcfg, cfg = _jcfg(), _tcfg()
    jstate = jax_rounds.init_state(jax_npc.init_params(None, 30), jcfg)
    state = rounds.init_state(_params(), cfg, device="cpu")
    # before any round: w itself
    assert_bits_equal(rounds.averaged_iterate(state)["w"],
                      jax_rounds.averaged_iterate(jstate)["w"])
    wsum = np.random.default_rng(3).standard_normal(31).astype(np.float32)
    jstate = jstate._replace(
        wbar_sum={"b": jnp.asarray(wsum[0]), "w": jnp.asarray(wsum[1:])},
        wbar_weight=jnp.asarray(3.0, jnp.float32))
    state = state._replace(wbar_sum=t(wsum),
                           wbar_weight=torch.tensor(3.0))
    got, want = rounds.averaged_iterate(state), \
        jax_rounds.averaged_iterate(jstate)
    for k in ("w", "b"):
        assert_bits_equal(got[k], want[k])


@pytest.mark.parametrize("comm", ["dense", "packed", "pallas"])
@pytest.mark.parametrize("kind", ["topk", "quant", "none"])
def test_round_bytes_match_reference(comm, kind):
    jparams = jax_npc.init_params(None, 30)
    jcfg = _jcfg(comm=comm, uplink=KINDS[kind], downlink=KINDS["topk"])
    cfg = _tcfg(comm=comm, uplink=KINDS[kind], downlink=KINDS["topk"])
    assert rounds.round_bytes(_params(), cfg) == \
        jax_rounds.round_bytes(jparams, jcfg)


def test_theory_matches_reference():
    pi, q = [0.2, 0.5, 0.9, 0.4], [0.1, 0.3, 0.4, 0.2]
    for name, args in (("gamma_full", (5, 0.1, 0.2)),
                       ("gamma_partial", (5, 0.1, 0.2, 20, 10)),
                       ("ht_variance", (pi, q)),
                       ("effective_ratio", (pi, q, 2)),
                       ("gamma_partial_sampled", (5, 0.1, 0.2, pi, q, 2)),
                       ("eta_star", (1.0, 2.0, 5, 500, 3.0)),
                       ("eps_star_full", (1.0, 2.0, 5, 500, 3.0)),
                       ("eps_star_partial", (1.0, 2.0, 5, 500, 3.0, 20, 10,
                                             0.1, 0.5, 0.05)),
                       ("rate_bound", (1.0, 2.0, 5, 500, 3.0)),
                       ("beta_min", (0.35,))):
        assert getattr(theory, name)(*args) == \
            getattr(jax_theory, name)(*args)


# ---------------------------------------------------------------------------
# The NP task
# ---------------------------------------------------------------------------

def test_np_loss_pair_matches_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((57, 30)).astype(np.float32) * 3
    y = (rng.random(57) < 0.4).astype(np.float32)
    for scale in (0.0, 0.1, 5.0):
        w = (rng.standard_normal(30) * scale).astype(np.float32)
        b = np.float32(rng.standard_normal() * scale)
        got = npc.loss_pair({"w": t(w), "b": t(b)}, (t(x), t(y)))
        want = jax_npc.loss_pair({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                 (jnp.asarray(x), jnp.asarray(y)))
        np.testing.assert_allclose([float(v) for v in got],
                                   [float(v) for v in want], rtol=1e-6)
    # large logits: softplus stays log(1 + e^z), not the identity
    big = npc.loss_pair({"w": torch.zeros(1), "b": torch.tensor(30.0)},
                        (torch.zeros((1, 1)), torch.zeros(1)))
    assert float(big[0]) == pytest.approx(30.0 + math.exp(-30.0), rel=1e-7)


def _figure1(cls, comp, switch, mode, participation="mask"):
    return cls(n_clients=20, m=10, local_steps=5, lr=0.1,
               switch=switch(mode=mode, eps=EPS, beta=theory.beta_min(EPS)),
               uplink=comp(kind="topk", ratio=0.1),
               downlink=comp(kind="topk", ratio=0.1),
               participation=participation)


@pytest.mark.parametrize("mode", ["hard", "soft"])
def test_figure1_rounds_match_reference(mode, one_thread):
    """Two Figure-1 rounds (n = 20, m = 10, E = 5, top-k 0.1 up and down,
    the dense wire) from the same shards and recorded cohorts."""
    (xs, ys), _ = jax_npc.make_dataset(jax.random.PRNGKey(0), n_clients=20)
    xs, ys = np.asarray(xs), np.asarray(ys)
    rng = np.random.default_rng(5)
    masks = np.zeros((2, 20), np.float32)
    for r in range(2):
        masks[r, rng.choice(20, 10, replace=False)] = 1.0
    jcfg = _figure1(JFedConfig, JCompressorConfig, JSwitchConfig,
                    mode).replace(fleet=JFleetConfig(sampler="fixed"))
    cfg = _figure1(FedConfig, CompressorConfig, SwitchConfig,
                   mode).replace(fleet=FleetConfig(sampler="fixed"))
    jstate = jax_rounds.init_state(jax_npc.init_params(None, 30), jcfg)
    jstate = jstate._replace(sampler=jax_samp.fixed_state(
        jnp.asarray(masks), jnp.asarray(masks)))
    state = rounds.init_state(_params(), cfg, device="cpu")
    state = state._replace(sampler=samplers.fixed_state(masks, masks))
    jstate, jhist = jax_rounds.drive(jstate, (jnp.asarray(xs),
                                              jnp.asarray(ys)),
                                     jax_npc.loss_pair, jcfg, T=2)
    state, hist = fedsgm.drive(state, _batch(xs, ys), npc.loss_pair, cfg,
                               T=2, device="cpu")
    for name in ("f", "g_hat", "sigma", "g_full", "f_full"):
        np.testing.assert_allclose(getattr(hist, name),
                                   np.asarray(getattr(jhist, name)),
                                   rtol=1e-5)
    for name in ("feasible", "up_bytes", "down_bytes"):
        np.testing.assert_array_equal(getattr(hist, name),
                                      np.asarray(getattr(jhist, name)))
    for got, want in ((state.w, jstate.w), (state.x, jstate.x)):
        jw = np.asarray(jax_flat.flatten(jax_flat.spec_of(want), want))
        close = np.isclose(n(got), jw, rtol=1e-4, atol=1e-6)
        assert (~close).mean() <= 1e-3
        np.testing.assert_allclose(n(got), jw, rtol=0, atol=1e-3)
    jwbar = jax_rounds.averaged_iterate(jstate)
    wbar = fedsgm.averaged_iterate(state)
    np.testing.assert_allclose(n(wbar["w"]), np.asarray(jwbar["w"]),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("sampler", ["uniform", "weighted"])
def test_np_fleet_gather_equals_mask(sampler, one_thread):
    """The quickstart's engine check on the port: a Figure-1 fleet with
    fresh minibatches of 16, gather and mask bit-equal after 3 rounds."""
    out = {}
    for part in ("mask", "gather"):
        cfg = _figure1(FedConfig, CompressorConfig, SwitchConfig, "soft",
                       part).replace(fleet=FleetConfig(
                           batch_size=16, redraw=True, sampler=sampler))
        fleet, (x_test, _) = npc.make_fleet(torch.Generator().manual_seed(0),
                                            cfg, device="cpu")
        state = rounds.init_state(npc.init_params(x_test.shape[-1], "cpu"),
                                  cfg, device="cpu")
        out[part] = rounds.drive(state, fleet, npc.loss_pair, cfg, T=3,
                                 device="cpu")
    (sm, hm), (sg, hg) = out["mask"], out["gather"]
    _assert_states_equal(sm, sg)
    for name in rounds.RoundMetrics._fields:
        assert_bits_equal(getattr(hm, name), getattr(hg, name))


def test_np_make_dataset_and_fleet():
    gen = torch.Generator().manual_seed(0)
    (xs, ys), (xt, yt) = npc.make_dataset(gen, 20, device="cpu")
    assert xs.shape == (20, 22, 30) and ys.shape == (20, 22)
    assert xt.shape == (114, 30)
    (xs, ys), _ = npc.make_dataset(gen, 20, hetero=True, device="cpu")
    assert xs.shape == (20, 22, 30)
    cfg = FedConfig(n_clients=20, fleet=FleetConfig(
        partitioner="dirichlet", alpha=0.1, batch_size=16))
    fleet, _ = npc.make_fleet(gen, cfg, device="cpu")
    assert int(fleet.host_count.min()) >= 1
    assert int(fleet.host_count.sum()) <= 455
    assert fleet.data.x.shape[:2] == (20, math.ceil(2.0 * 455 / 20))
