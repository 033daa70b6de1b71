"""The fair-classification task (``repro_torch.tasks.fair``) and the
penalty baseline (``repro_torch.core.baselines``) against the JAX
reference on the CPU, on the reference's own arrays and draws.

Tolerances: ``loss_pair`` and the demographic-parity statistic within
1e-6 absolute (float32 sums over 2,000 rows in another order), the
gradients at rtol 1e-5 (zero parameters included: every logit is 0, where
the reference's ``abs`` has gradient +1); the split and the partition
bit-equal (index arithmetic); ``penalty_round`` within rtol 1e-5 of the
reference per round for 10 rounds (the reference documents about 1e-5
against its own earlier round, ``baselines.py:57-61``), w within 1e-5
absolute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import flat as jax_flat
from repro.configs.base import FedConfig as JFedConfig
from repro.configs.base import FleetConfig as JFleetConfig
from repro.core import baselines as jax_baselines
from repro.data import synthetic as jax_synthetic
from repro.fleet import partitions as jax_part
from repro.tasks import fair as jax_fair
from repro.tasks import np_classification as jax_npc
from repro_torch.comm import flat
from repro_torch.configs.base import FedConfig, FleetConfig
from repro_torch.core import baselines
from repro_torch.fleet import partitions
from repro_torch.models import params_from_numpy
from repro_torch.tasks import fair
from repro_torch.tasks import np_classification as npc
from torch_port_util import assert_bits_equal, n, t


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def adult():
    """The reference's adult-like data (2,000 x 25), as numpy arrays."""
    x, y, a = jax_synthetic.adult_like(jax.random.PRNGKey(4))
    return np.asarray(x), np.asarray(y), np.asarray(a)


def _jparams(seed, d=25, scale=1.0):
    jp = jax_fair.init_params(jax.random.PRNGKey(seed), d)
    return jax.tree_util.tree_map(lambda v: v * scale, jp)


@pytest.mark.parametrize("dp_budget", [0.0, 0.05])
@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 3.0), (2, 0.0)])
def test_loss_pair_matches_reference(adult, dp_budget, seed, scale):
    x, y, a = adult
    jp = _jparams(seed, scale=scale)
    jl = jax_fair.loss_pair_builder(dp_budget)
    want = jl(jp, (jnp.asarray(x), jnp.asarray(y), jnp.asarray(a)))
    jgrads = [np.asarray(jax_flat.flatten(jax_flat.spec_of(g), g)) for g in (
        jax.grad(lambda p, i=i: jl(p, (x, y, a))[i])(jp) for i in (0, 1))]
    params = params_from_numpy(jax.device_get(jp))
    spec = flat.spec_of(params)
    leaf = flat.flatten(spec, params).requires_grad_(True)
    got = fair.loss_pair_builder(dp_budget)(flat.unflatten(spec, leaf),
                                             (t(x), t(y), t(a)))
    np.testing.assert_allclose([float(v.detach()) for v in got],
                               [float(v) for v in want], rtol=0, atol=1e-6)
    for i, jg in enumerate(jgrads):
        (g,) = torch.autograd.grad(got[i], leaf, retain_graph=True)
        np.testing.assert_allclose(n(g), jg, rtol=1e-5,
                                   atol=1e-6 * np.abs(jg).max())


def test_demographic_parity_matches_reference(adult):
    x, y, a = adult
    for seed in range(3):
        jp = _jparams(seed, scale=2.0)
        want = jax_fair.demographic_parity(jp, jnp.asarray(x),
                                           jnp.asarray(y), jnp.asarray(a))
        got = fair.demographic_parity(params_from_numpy(jax.device_get(jp)),
                                      t(x), t(y), t(a))
        assert got == pytest.approx(want, rel=0, abs=1e-6)


@pytest.mark.parametrize("n_clients", [4, 10, 7])
def test_make_dataset_split_matches_reference(n_clients):
    """The reference's split of its own draw: the port's
    ``split_by_protected`` on the same (x, y, a) gives the same stacked
    shards, bit for bit (numpy does the shuffle in both)."""
    (jxs, jys, jas), (x, y, a) = jax_fair.make_dataset(jax.random.PRNGKey(0),
                                                       n_clients)
    xs, ys, as_ = fair.split_by_protected(t(x), t(y), t(a), n_clients)
    for got, want in ((xs, jxs), (ys, jys), (as_, jas)):
        assert_bits_equal(got, want)


def test_make_dataset_and_fleet_shapes():
    gen = torch.Generator().manual_seed(0)
    (xs, ys, as_), (x, y, a) = fair.make_dataset(gen, 10, device="cpu")
    assert xs.shape == (10, 200, 25) and ys.shape == as_.shape == (10, 200)
    cfg = FedConfig(n_clients=10, m=5, fleet=FleetConfig(
        partitioner="dirichlet", alpha=0.5, batch_size=32, redraw=True,
        sampler="weighted"))
    fleet, (x, y, a) = fair.make_fleet(torch.Generator().manual_seed(0),
                                       cfg, device="cpu")
    assert type(fleet.data) is tuple and len(fleet.data) == 3
    assert fleet.data[0].shape[:2] == (10, 400)      # cap factor 2
    assert 0 < int(fleet.host_count.min()) and \
        int(fleet.host_count.sum()) <= 2000


@pytest.mark.parametrize("alpha", [10.0, 0.5])
def test_fleet_partition_core_matches_reference(alpha):
    """``fair.make_fleet``'s partition of the protected attribute: the
    port's Dirichlet core on the reference's draws (the proportions from
    the key ``build_fleet`` hands the partitioner) gives the reference
    fleet's shards and counts, bit for bit."""
    key = jax.random.PRNGKey(0)
    fl = dict(partitioner="dirichlet", alpha=alpha, batch_size=32,
              redraw=True, sampler="weighted")
    jcfg = JFedConfig(n_clients=10, m=5, fleet=JFleetConfig(**fl))
    jfleet, (x, y, a) = jax_fair.make_fleet(key, jcfg)
    _, kp = jax.random.split(key)
    kpart, _ = jax.random.split(kp)
    props = jax.random.dirichlet(kpart, jnp.full((10,), alpha), shape=(2,))
    cap = jax_part.get_partitioner("dirichlet").cap(2000, 10, jcfg.fleet)
    assert partitions.get_partitioner("dirichlet").cap(
        2000, 10, FleetConfig(**fl)) == cap
    cp = partitions.dirichlet_core(t(props), t(a), 10, 2, cap)
    np.testing.assert_array_equal(n(cp.count), np.asarray(jfleet.count))
    for got, want in zip((t(x), t(y), t(a)), jfleet.data):
        assert_bits_equal(got[cp.idx.reshape(-1)].reshape(
            cp.idx.shape + got.shape[1:]), want)


# -- the penalty baseline ----------------------------------------------------

@pytest.fixture(scope="module")
def np_data():
    (xs, ys), _ = jax_npc.make_dataset(jax.random.PRNGKey(0), n_clients=10)
    return np.asarray(xs), np.asarray(ys)


def test_penalty_round_matches_reference(np_data):
    """10 penalty-FedAvg rounds at m = n = 10 on the NP shards (rho 2, E =
    2): the all-client f and g per round and the final w."""
    xs, ys = np_data
    kw = dict(rho=2.0, eps=0.35, lr=0.1, local_steps=2, n_clients=10, m=10)
    jp = jax_npc.init_params(jax.random.PRNGKey(1), 30)
    jp = jax.tree_util.tree_map(lambda v: v + 0.05, jp)
    jst = jax_baselines.penalty_init(jp)
    jstep = jax.jit(lambda s: jax_baselines.penalty_round(
        s, (xs, ys), jax_npc.loss_pair, **kw))
    st = baselines.penalty_init(params_from_numpy(jax.device_get(jp)))
    for _ in range(10):
        jst, jm = jstep(jst)
        st, m = baselines.penalty_round(st, npc.NPBatch(t(xs), t(ys)),
                                        npc.loss_pair, device="cpu", **kw)
        np.testing.assert_allclose([float(m["f"]), float(m["g"])],
                                   [float(jm["f"]), float(jm["g"])],
                                   rtol=1e-5)
    assert st.t == int(jst.t) == 10
    for k in ("w", "b"):
        np.testing.assert_allclose(n(st.w[k]), np.asarray(jst.w[k]),
                                   rtol=0, atol=1e-5)


def test_penalty_round_on_plain_tuples_and_checks(np_data):
    """The reference hands plain tuples to the engine: the same round on
    ``(xs, ys)`` as on the NamedTuple, bit for bit; ``client_chunk`` passes
    through to the engine config and leaves the round as it is."""
    xs, ys = np_data
    kw = dict(rho=1.0, eps=0.35, lr=0.1, local_steps=2, n_clients=10, m=5,
              device="cpu")
    out = []
    for batch in ((t(xs), t(ys)), npc.NPBatch(t(xs), t(ys))):
        st = baselines.penalty_init(npc.init_params(30, device="cpu"))
        for _ in range(2):
            st, m = baselines.penalty_round(st, batch, npc.loss_pair, **kw)
        out.append((st, m))
    (sa, ma), (sb, mb) = out
    for k in ("w", "b"):
        assert_bits_equal(sa.w[k], sb.w[k])
    assert_bits_equal(ma["f"], mb["f"])
    cfg = baselines.penalty_config(1.0, 0.35, 0.1, 2, 10, 5)
    assert cfg.strategy == "penalty-fedavg" and not cfg.track_wbar
    assert baselines.penalty_config(1.0, 0.35, 0.1, 2, 10, 5,
                                    client_chunk=4).client_chunk == 4
    st = baselines.penalty_init(npc.init_params(30, device="cpu"))
    for _ in range(2):
        st, m = baselines.penalty_round(st, (t(xs), t(ys)), npc.loss_pair,
                                        client_chunk=4, **kw)
    for k in ("w", "b"):
        assert_bits_equal(st.w[k], sa.w[k])
    assert_bits_equal(m["f"], ma["f"])


def test_penalty_baseline_rho_sensitivity(np_data):
    """The reference's property (paper Fig. 6): small rho -> infeasible;
    the penalty strength must matter."""
    xs, ys = np_data
    batch = npc.NPBatch(t(xs), t(ys))
    params = params_from_numpy(jax.device_get(
        jax_npc.init_params(jax.random.PRNGKey(1), 30)))
    g_final = {}
    for rho in (0.0, 5.0):
        st = baselines.penalty_init(params)
        for _ in range(150):
            st, _ = baselines.penalty_round(
                st, batch, npc.loss_pair, rho=rho, eps=0.35, lr=0.1,
                local_steps=3, n_clients=10, m=10, device="cpu")
        _, g = npc.loss_pair(st.w, (batch.x.reshape(-1, 30),
                                    batch.y.reshape(-1)))
        g_final[rho] = float(g)
    assert g_final[0.0] > g_final[5.0], "penalty strength must matter"
