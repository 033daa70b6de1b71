"""The CMDP task of the port (``repro_torch.tasks.cmdp``) against the JAX
reference (``repro.tasks.cmdp``) on the CPU.

The port draws from ``torch.Generator``s, so every comparison hands the
reference's own draws -- ``rollout``'s start states and action noise for a
key, reproduced here as ``cmdp.py`` makes them -- to the port's
deterministic core.

Tolerances, and why:

* The dynamics are bit-equal to the reference run op by op where no
  transcendental enters (x, theta).  The velocities go through sin and cos,
  which XLA's and PyTorch's CPU libraries round differently in the last
  place; the reference as it runs (jitted) also contracts a*b + c into FMAs
  and folds divisions by constants into reciprocal products.  So a step is
  held to a few ulps of the size of its largest term (``_term_scale``):
  4 for one step, teacher-forced, and 8 on random states.
* A whole rollout amplifies those ulps through the chaotic dynamics: the
  states agree to 1e-6 of each episode's largest component over the first
  20 steps and to 1e-4 at step 50; every reward, cost and alive flag is
  equal.
* ``loss_pair``'s value is the splice ``(value + surrogate) - surrogate``
  in float32, as in the reference, so it rounds at the surrogate's scale:
  equal to 1e-5 absolute; gradients within rtol 1e-4 of the largest entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import flat as jax_flat
from repro.configs.base import (CompressorConfig as JCompressorConfig,
                                FedConfig as JFedConfig,
                                FleetConfig as JFleetConfig,
                                SwitchConfig as JSwitchConfig)
from repro.engine import rounds as jax_rounds
from repro.fleet import samplers as jax_samp
from repro.tasks import cmdp as jax_cmdp
from repro_torch.comm import flat
from repro_torch.configs.base import (CompressorConfig, FedConfig,
                                      FleetConfig, SwitchConfig)
from repro_torch.engine import rounds
from repro_torch.fleet import provision, samplers
from repro_torch.models import params_from_numpy
from repro_torch.tasks import cmdp
from torch_port_util import assert_bits_equal, assert_within_ulp, n, t


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ulps_of(err, scale):
    return np.abs(err) / np.spacing(np.asarray(scale, np.float32)
                                    ).astype(np.float64)


def _term_scale(s, force):
    """Per component of ``env_step(s, force)``, the magnitude of its largest
    term (float64)."""
    x, xd, th, thd = np.moveaxis(s.astype(np.float64), -1, 0)
    f = np.asarray(force, np.float64)
    c, sn = np.cos(th), np.sin(th)
    num = np.abs(f) + 0.05 * thd ** 2 * np.abs(sn)
    den = 0.5 * (4 / 3 - 0.1 * c ** 2 / 1.1)
    th_acc = (9.8 * np.abs(sn) + np.abs(c) * num / 1.1) / den + num / 1.1 / den
    x_acc = num / 1.1 + 0.05 * th_acc / 1.1
    return np.stack([np.maximum(np.abs(x), 0.02 * np.abs(xd)),
                     np.maximum(np.abs(xd), 0.02 * x_acc),
                     np.maximum(np.abs(th), 0.02 * np.abs(thd)),
                     np.maximum(np.abs(thd), 0.02 * th_acc)], -1)


def _states(k=20000, seed=0):
    rng = np.random.default_rng(seed)
    s = (rng.standard_normal((k, 4)) * [1.2, 1.0, 0.15, 1.5]
         ).astype(np.float32)
    f = (10 * np.tanh(rng.standard_normal(k))).astype(np.float32)
    return s, f


def test_env_step_matches_reference():
    s, f = _states()
    got = n(cmdp.env_step(t(s), t(f)))
    with jax.disable_jit():
        eager = np.asarray(jax.vmap(jax_cmdp.env_step)(jnp.asarray(s),
                                                       jnp.asarray(f)))
    jitted = np.asarray(jax.jit(jax.vmap(jax_cmdp.env_step))(
        jnp.asarray(s), jnp.asarray(f)))
    # op by op: the positions are bit-equal, the velocities (through sin
    # and cos, each within 1 ulp of the reference's) within 4 ulps of their
    # largest term
    assert_bits_equal(got[:, [0, 2]], eager[:, [0, 2]])
    th = s[:, 2]
    for fn, jfn in ((torch.sin, jnp.sin), (torch.cos, jnp.cos)):
        ulps = np.abs(n(fn(t(th))).view(np.int32).astype(np.int64)
                      - np.asarray(jfn(jnp.asarray(th))).view(np.int32))
        assert ulps.max() <= 1
    scale = _term_scale(s, f)
    assert _ulps_of(got - eager.astype(np.float64), scale).max() <= 4
    # as the reference runs (fused: FMAs, reciprocal constants)
    assert _ulps_of(got - jitted.astype(np.float64), scale).max() <= 8


def test_cost_and_termination_flags_match_reference():
    s, _ = _states(seed=1)
    # states on the thresholds, as float32 values
    edge = np.array([[2.4, 0, 0, 0], [np.nextafter(np.float32(2.4), 3), 0, 0, 0],
                     [-2.2, 0, 0, 0], [0.1, 0, 0, 0], [1.3, 0, 0, 0],
                     [0, 0, np.float32(12 * 3.14159 / 180), 0],
                     [0, 0, np.nextafter(np.float32(12 * 3.14159 / 180), 1), 0],
                     [0, 0, -np.float32(6 * 3.14159 / 180), 0],
                     [0, 0, np.nextafter(np.float32(6 * 3.14159 / 180), 1), 0]],
                    np.float32)
    s = np.concatenate([s, edge])
    for fn, jfn in ((cmdp.step_cost, jax_cmdp.step_cost),
                    (cmdp.terminated, jax_cmdp.terminated)):
        want = np.asarray(jax.vmap(jfn)(jnp.asarray(s)))
        np.testing.assert_array_equal(n(fn(t(s))), want)
    assert n(cmdp.terminated(t(edge)))[[0, 1, 5, 6]].tolist() == \
        [False, True, False, True]


def _reference(seed, E=5, T=50, log_std=-0.5):
    """The reference's params (log-std set so the noise is not unit) and the
    rollout draws of ``rollout`` for a key, as ``cmdp.py:102-104`` makes
    them."""
    jp = jax_cmdp.init_params(jax.random.PRNGKey(seed))
    jp["pi"]["log_std"] = jnp.float32(log_std)
    key = jax.random.PRNGKey(100 + seed)
    k_init, k_act = jax.random.split(key)
    s0 = jax.random.uniform(k_init, (E, 4), minval=-0.05, maxval=0.05)
    noise = jax.random.normal(k_act, (T, E))
    return jp, key, np.asarray(s0), np.asarray(noise)


def test_teacher_forced_rollout_steps_match_reference():
    """Each step of a horizon-50 reference rollout, fed the reference's
    state: the action within 4 ulps of max(|a|, 1), the next state within 4
    ulps of its largest term, the cost and termination flags equal."""
    T, E = 50, 5
    for seed in range(4):
        jp, key, _, noise = _reference(seed, E, T)
        pp = params_from_numpy(jax.device_get(jp))
        tr = jax.jit(lambda p, k: jax_cmdp.rollout(p, k, E, T))(jp, key)
        obs, acts = np.asarray(tr.obs), np.asarray(tr.actions)
        alive = np.asarray(tr.alive)
        for step in range(T - 1):
            s = t(obs[:, step])
            with torch.no_grad():
                mu, std = cmdp.policy_dist(pp, s)
                a = n(mu + std * t(noise[step]))
            assert _ulps_of(a - acts[:, step].astype(np.float64),
                            np.maximum(np.abs(acts[:, step]), 1.0)
                            ).max() <= 4
            force = 10 * torch.tanh(t(acts[:, step]))
            nxt = n(cmdp.env_step(s, force))
            scale = _term_scale(obs[:, step], n(force))
            assert _ulps_of(nxt - obs[:, step + 1].astype(np.float64),
                            scale).max() <= 4
            np.testing.assert_array_equal(
                n(cmdp.step_cost(s)) * alive[:, step],
                np.asarray(tr.costs)[:, step])
            np.testing.assert_array_equal(
                alive[:, step] * (1 - n(cmdp.terminated(t(obs[:, step + 1])))),
                alive[:, step + 1])


@pytest.mark.parametrize("seed", range(6))
def test_rollout_from_reference_draws(seed):
    T, E = 50, 5
    jp, key, s0, noise = _reference(seed, E, T, log_std=0.0)
    want = jax.jit(lambda p, k: jax_cmdp.rollout(p, k, E, T))(jp, key)
    got = cmdp.rollout(params_from_numpy(jax.device_get(jp)), t(s0),
                       t(noise))
    for name in ("rewards", "costs", "alive"):
        assert_bits_equal(getattr(got, name), getattr(want, name))
    obs, wobs = n(got.obs), np.asarray(want.obs)
    scale = np.abs(wobs).max(axis=1, keepdims=True)
    err = np.abs(obs - wobs) / scale
    assert err[:, :20].max() <= 1e-6
    assert err.max() <= 1e-4


def test_returns_to_go_matches_reference():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((5, 40)).astype(np.float32)
    # the reference's scan contracts carry * gamma + x into an FMA: the
    # same back-to-front sums to within 1e-5 of the size of their terms
    for gamma in (0.9, 0.99, 1.0):
        scale = n(cmdp.returns_to_go(t(np.abs(x)), gamma))
        np.testing.assert_array_less(
            np.abs(n(cmdp.returns_to_go(t(x), gamma))
                   - np.asarray(jax_cmdp.returns_to_go(jnp.asarray(x),
                                                       gamma))),
            1e-5 * scale)
    flags = (rng.random((5, 200)) < 0.6).astype(np.float32)
    want = jax_cmdp.returns_to_go(jnp.asarray(flags), 1.0)
    assert_bits_equal(cmdp._counts_to_go(t(flags)), want)
    assert_bits_equal(cmdp.returns_to_go(t(flags), 1.0), want)


def _pair_and_grads(loss_pair, params, batch):
    spec = flat.spec_of(params)
    leaf = flat.flatten(spec, params).requires_grad_(True)
    f, g = loss_pair(flat.unflatten(spec, leaf), batch)
    (gf,) = torch.autograd.grad(f, leaf, retain_graph=True)
    (gg,) = torch.autograd.grad(g, leaf)
    return float(f.detach()), float(g.detach()), n(gf), n(gg)


def _jflat(tree):
    return np.asarray(jax_flat.flatten(jax_flat.spec_of(tree), tree))


@pytest.mark.parametrize("seed", range(4))
def test_loss_pair_matches_reference(seed):
    T, E = 50, 5
    jp, key, s0, noise = _reference(seed, E, T)
    jp = jax.tree_util.tree_map(
        lambda x: x + 0.1 * jax.random.normal(jax.random.PRNGKey(seed + 50),
                                              x.shape), jp)
    budget = np.float32(27.5)
    jl = jax_cmdp.make_loss_pair(E, T)
    jf, jg = jax.jit(jl)(jp, (key, jnp.asarray(budget)))
    jgf = _jflat(jax.jit(jax.grad(lambda p: jl(p, (key, budget))[0]))(jp))
    jgg = _jflat(jax.jit(jax.grad(lambda p: jl(p, (key, budget))[1]))(jp))
    f, g, gf, gg = _pair_and_grads(
        cmdp.make_loss_pair(E, T), params_from_numpy(jax.device_get(jp)),
        cmdp.CMDPBatch(t(s0), t(noise), t(budget)))
    np.testing.assert_allclose([f, g], [float(jf), float(jg)], rtol=0,
                               atol=1e-5)
    for got, want in ((gf, jgf), (gg, jgg)):
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())


def test_loss_pair_checks_the_draws():
    params = cmdp.init_params(torch.Generator().manual_seed(0), device="cpu")
    s0, noise = cmdp.rollout_draws(torch.Generator().manual_seed(1), 3, 20)
    with pytest.raises(ValueError, match="expects 5 x 20"):
        cmdp.make_loss_pair(5, 20)(params, cmdp.CMDPBatch(
            s0, noise, torch.tensor(30.0)))


def test_client_budgets_match_reference():
    """Within 1 ulp: XLA's compiled linspace rounds its interior points
    differently from ``torch.linspace`` (the ends are exact)."""
    for k in (1, 2, 3, 7, 10, 20, 33):
        got, want = cmdp.client_budgets(k), jax_cmdp.client_budgets(k)
        assert_within_ulp(got, want, 1)
        assert float(got[0]) == 25.0 and float(got[-1]) == (35.0 if k > 1
                                                            else 25.0)


def test_draws_and_params():
    gen = torch.Generator().manual_seed(0)
    s0, noise = cmdp.rollout_draws(gen, 5, 30)
    assert s0.shape == (5, 4) and noise.shape == (30, 5)
    assert float(s0.abs().max()) <= 0.05
    params = cmdp.init_params(torch.Generator().manual_seed(0), device="cpu")
    jparams = jax_cmdp.init_params(jax.random.PRNGKey(0))
    assert flat.spec_of(params).d == jax_flat.spec_of(jparams).d == 9091
    assert [ls.shape for ls in flat.spec_of(params).leaves] == \
        [ls.shape for ls in jax_flat.spec_of(jparams).leaves]


def _reference_row_draws(seeds, E, T):
    """s0 / noise of every fleet row from the reference's row keys."""
    def one(k):
        k_init, k_act = jax.random.split(k)
        return (jax.random.uniform(k_init, (E, 4), minval=-0.05, maxval=0.05),
                jax.random.normal(k_act, (T, E)))
    s0, noise = jax.vmap(jax.vmap(one))(seeds)
    return np.asarray(s0), np.asarray(noise)


def test_fleet_from_reference_draws():
    """The reference's fleet rows (rollout keys) turned into draws build the
    port's fleet: budgets bit-equal, and each row's loss pair equals the
    reference's fleet loss pair on that row."""
    E, T, N, POOL = 2, 20, 3, 4
    jcfg = JFedConfig(n_clients=N, m=N)
    jfleet = jax_cmdp.make_fleet(jax.random.PRNGKey(1), jcfg, pool=POOL)
    seeds, jbudgets = jfleet.data
    s0, noise = _reference_row_draws(seeds, E, T)
    fleet = cmdp.fleet_from_draws(t(s0), t(noise))
    assert_bits_equal(fleet.data.budget, jbudgets)
    assert fleet.host_count.tolist() == [POOL] * N
    jp, _, _, _ = _reference(0, E, T)
    pp = params_from_numpy(jax.device_get(jp))
    jl, pl = jax_cmdp.fleet_loss_pair(E, T), cmdp.fleet_loss_pair(E, T)
    for j, r in ((0, 0), (1, 3), (2, 1)):
        want = jl(jp, (seeds[j, r:r + 1], jbudgets[j, r:r + 1]))
        got = pl(pp, cmdp.CMDPBatch(*(leaf[j, r:r + 1]
                                      for leaf in fleet.data)))
        np.testing.assert_allclose([float(v) for v in got],
                                   [float(v) for v in want], rtol=0,
                                   atol=1e-5)
    # the port's own fleet: draws from one CPU generator, one row per round
    cfg = FedConfig(n_clients=N, m=N, fleet=FleetConfig(batch_size=1,
                                                        redraw=True))
    fl = cmdp.make_fleet(torch.Generator().manual_seed(0), cfg, pool=POOL,
                         n_episodes=E, horizon=T, device="cpu")
    assert fl.data.s0.shape == (N, POOL, E, 4)
    assert fl.data.noise.shape == (N, POOL, T, E)
    mb = provision.minibatch(fl, provision.round_key(cfg, 0), cfg)
    assert mb.s0.shape == (N, 1, E, 4) and mb.budget.shape == (N, 1)


def _engine_cfg(cls, comp, switch, fleet_cls, comm):
    return cls(n_clients=3, m=3, local_steps=1, lr=1e-2,
               switch=switch(mode="soft", eps=0.0, beta=1.0),
               uplink=comp(kind="topk", ratio=0.5),
               downlink=comp(kind="none"), comm=comm,
               fleet=fleet_cls(sampler="fixed"))


@pytest.mark.parametrize("comm", ["dense", "pallas"])
def test_engine_rounds_match_reference(comm):
    """Two engine rounds on fixed per-client batches (3 clients, 2 episodes
    of 30 steps, budgets 25 / 30 / 35), full participation, top-k 0.5 up:
    the reference's ``drive`` on its (key, budget) rows against the port's
    ``drive`` on ``CMDPBatch``es of the same draws."""
    E, T, N = 2, 30, 3
    keys = jax.random.split(jax.random.PRNGKey(9), N)
    budgets = jax_cmdp.client_budgets(N)
    s0, noise = _reference_row_draws(keys[None], E, T)
    jcfg = _engine_cfg(JFedConfig, JCompressorConfig, JSwitchConfig,
                       JFleetConfig, comm)
    cfg = _engine_cfg(FedConfig, CompressorConfig, SwitchConfig, FleetConfig,
                      comm)
    masks = np.ones((2, N), np.float32)
    jp = jax_cmdp.init_params(jax.random.PRNGKey(3))
    jstate = jax_rounds.init_state(jp, jcfg)._replace(
        sampler=jax_samp.fixed_state(jnp.asarray(masks), jnp.asarray(masks)))
    jstate, jhist = jax_rounds.drive(jstate, (keys, budgets),
                                     jax_cmdp.make_loss_pair(E, T), jcfg, T=2)
    state = rounds.init_state(params_from_numpy(jax.device_get(jp)), cfg,
                              device="cpu")
    state = state._replace(sampler=samplers.fixed_state(masks, masks))
    state, hist = rounds.drive(
        state, cmdp.CMDPBatch(t(s0[0]), t(noise[0]), t(budgets)),
        cmdp.make_loss_pair(E, T), cfg, T=2, device="cpu")
    for name in ("f", "g_hat", "g_full", "f_full"):
        np.testing.assert_allclose(getattr(hist, name),
                                   np.asarray(getattr(jhist, name)),
                                   rtol=0, atol=1e-5)
    np.testing.assert_allclose(hist.sigma, np.asarray(jhist.sigma),
                               rtol=1e-4, atol=1e-6)
    for name in ("up_bytes", "down_bytes"):
        np.testing.assert_array_equal(getattr(hist, name),
                                      np.asarray(getattr(jhist, name)))
    # feasible = 1{g_hat <= 0}.  In round 2 the mean cost meets the mean
    # budget exactly, so g_hat is 0 up to the splice's rounding at the
    # surrogates' scale (+-3e-7 here), whose last bits differ between the
    # packages: the flag is equal wherever g_hat is off that noise
    jg = np.asarray(jhist.g_hat)
    off = np.abs(jg) > 1e-5
    np.testing.assert_array_equal(hist.feasible[off],
                                  np.asarray(jhist.feasible)[off])
    assert np.abs(hist.g_hat[~off]).max(initial=0.0) <= 1e-5
    jw = _jflat(jstate.w)
    w = n(state.w)
    close = np.isclose(w, jw, rtol=1e-4, atol=1e-6)
    assert (~close).mean() <= 1e-3, f"{int((~close).sum())} of {w.size}"
    np.testing.assert_allclose(w, jw, rtol=0, atol=1e-3)
