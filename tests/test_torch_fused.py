"""The fused eval/step-1 round: where the eval rows are the local-step rows
(full participation in mask mode, or ``full_eval=False``), each client's
(f, g) forward is also its first local step's forward.

On the reduced smollm-360m, from the same weights and batches (numpy
seeds), with the recorded cohorts of the ``fixed`` sampler:

* the port's fused trajectory is bit-equal to its own unfused one, run
  through a strategy that overrides ``local_objective`` (the reference's
  oracle, ``tests/test_hotpath.py``), state and per-round metrics;
* the port's fused trajectory matches the reference's with the tolerances
  of ``test_torch_slice.py``: f, g_hat, sigma at rtol 1e-5, ``feasible``
  and the wire bytes exactly, w and x all but 0.1% of the coordinates
  within rtol 1e-4 / atol 1e-6 and every coordinate within atol 1e-3;
* ``loss_pair`` runs n*E times in a fused round, n + m*E in an unfused
  one;
* the fused forward's (f_j, g_j), taken with the graph kept, equal the
  no-grad eval's bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.configs.base import (CompressorConfig as JCompressorConfig,
                                FedConfig as JFedConfig,
                                FleetConfig as JFleetConfig,
                                SwitchConfig as JSwitchConfig)
from repro.comm import flat as jax_flat
from repro.engine import rounds as jax_rounds
from repro.fleet import samplers as jax_samplers
from repro.models import transformer as jax_transformer
from repro.tasks import lm as jax_lm
from repro_torch import configs
from repro_torch.comm import flat
from repro_torch.configs.base import (CompressorConfig, FedConfig,
                                      FleetConfig, SwitchConfig)
from repro_torch.engine import participation, rounds, strategies
from repro_torch.fleet import samplers
from repro_torch.models import params_from_numpy, transformer
from repro_torch.tasks import lm
from torch_port_util import assert_bits_equal, t

N, BATCH, SEQ = 4, 2, 16
# (participation, m, full_eval, recorded cohorts): full participation in
# mask mode, and 2 of 4 gathered without the full eval
SETTINGS = {
    "mask-full": ("mask", N, True, np.ones((2, N), np.float32)),
    "gather-sparse": ("gather", 2, False,
                      np.array([[1, 0, 1, 0], [0, 1, 1, 0]], np.float32)),
}


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_configs.get_reduced("smollm-360m")
    cfg = configs.get_reduced("smollm-360m")
    jparams = jax.device_get(jax_transformer.init(jax.random.PRNGKey(0),
                                                  jcfg))
    return jcfg, cfg, jparams


def _batches(seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 512, size=(N, BATCH, SEQ), dtype=np.int32)
    mask = np.zeros((N, BATCH, SEQ), np.float32)
    mask[..., -2:] = 1.0
    return toks, mask


def _fed(setting, strategy="fedsgm", E=1, cls=FedConfig,
         comp=CompressorConfig, switch=SwitchConfig, fleet=FleetConfig):
    mode, m, full_eval, _ = SETTINGS[setting]
    cc = comp(kind="topk", ratio=0.1)
    return cls(n_clients=N, m=m, local_steps=E, lr=0.03, comm="packed",
               switch=switch(mode="soft", eps=0.0, beta=2.0), uplink=cc,
               downlink=cc, participation=mode, full_eval=full_eval,
               strategy=strategy, rho=2.0, fleet=fleet(sampler="fixed"))


class _Unfused(strategies.FedSGM):
    """fedsgm with ``local_objective`` overridden (the same math): opts out
    of the fused round."""

    name = "fedsgm-unfused-test"

    def local_objective(self, loss_pair, sigma, cfg):
        def obj(p, b):
            f, g = loss_pair(p, b)
            return self.blend_values(f, g, sigma, cfg)
        return obj


class _UnfusedPenalty(strategies.PenaltyFedAvg):
    name = "penalty-fedavg-unfused-test"
    local_objective = _Unfused.local_objective


@pytest.fixture
def unfused():
    for cls in (_Unfused, _UnfusedPenalty):
        strategies.register_strategy(cls)
    yield {"fedsgm": _Unfused.name, "penalty-fedavg": _UnfusedPenalty.name}
    for cls in (_Unfused, _UnfusedPenalty):
        strategies._STRATEGIES.pop(cls.name, None)


def _port_rounds(jparams, cfg, fed, masks, R=2, pair=None):
    pair = pair or lm.make_loss_pair(transformer.forward, cfg, budget=6.0)
    state = rounds.init_state(params_from_numpy(jparams), fed, device="cpu")
    state = state._replace(sampler=samplers.fixed_state(masks, masks))
    history = []
    for r in range(R):
        toks, mask = _batches(r + 1)
        state, met = rounds.round_step(state, lm.LMBatch(t(toks), t(mask)),
                                       pair, fed, device="cpu")
        history.append(met)
    return state, history


@pytest.mark.parametrize("strategy", ["fedsgm", "penalty-fedavg"])
@pytest.mark.parametrize("setting", list(SETTINGS))
def test_fused_equals_unfused_bitwise(setting, strategy, setup, unfused,
                                      one_thread):
    _, cfg, jparams = setup
    masks = SETTINGS[setting][3]
    fed = _fed(setting, strategy, E=2)
    part = participation.finalize(t(masks[0]), None, fed)
    assert rounds.fuses(part, strategies.get_strategy(strategy), fed)
    assert not rounds.fuses(part, strategies.get_strategy(unfused[strategy]),
                            fed)
    sf, hf = _port_rounds(jparams, cfg, fed, masks)
    su, hu = _port_rounds(jparams, cfg, fed.replace(
        strategy=unfused[strategy]), masks)
    for name in ("w", "x", "e_up", "wbar_sum", "wbar_weight"):
        assert_bits_equal(getattr(sf, name), getattr(su, name))
    for a, b in zip(hf, hu):
        for name in rounds.RoundMetrics._fields:
            assert_bits_equal(getattr(a, name), getattr(b, name))


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_fused_rounds_match_reference(setting, setup, one_thread):
    jcfg, cfg, jparams = setup
    masks = SETTINGS[setting][3]
    jfed = _fed(setting, cls=JFedConfig, comp=JCompressorConfig,
                switch=JSwitchConfig, fleet=JFleetConfig)
    jpair = jax_lm.make_loss_pair(jax_transformer.forward, jcfg, budget=6.0)
    jstate = jax_rounds.init_state(jparams, jfed)
    jstate = jstate._replace(sampler=jax_samplers.fixed_state(
        jnp.asarray(masks), jnp.asarray(masks)))
    jstep = jax.jit(lambda s, b: jax_rounds.round_step(s, b, jpair, jfed))
    state, hist = _port_rounds(jparams, cfg, _fed(setting), masks)
    for r in range(2):
        toks, mask = _batches(r + 1)
        jstate, jm = jstep(jstate, jax_lm.LMBatch(jnp.asarray(toks),
                                                  jnp.asarray(mask)))
        m = hist[r]
        np.testing.assert_allclose(
            [float(m.f), float(m.g_hat), float(m.sigma), float(m.g_full)],
            [float(jm.f), float(jm.g_hat), float(jm.sigma),
             float(jm.g_full)], rtol=1e-5)
        for name in ("feasible", "up_bytes", "down_bytes"):
            assert float(getattr(m, name)) == float(getattr(jm, name))
    for got, want in ((state.w, jstate.w), (state.x, jstate.x)):
        jw = np.asarray(jax_flat.flatten(jax_flat.spec_of(want), want))
        w = got.numpy()
        close = np.isclose(w, jw, rtol=1e-4, atol=1e-6)
        assert (~close).mean() <= 1e-3, \
            f"{int((~close).sum())} of {w.size} differ"
        np.testing.assert_allclose(w, jw, rtol=0, atol=1e-3)


@pytest.mark.parametrize("setting,full_eval,m,fused", [
    ("mask-full", True, N, True),          # n*E, was n + n*E
    ("gather-sparse", False, 2, True),     # m*E
    ("gather-sparse", True, 2, False),     # n + m*E: the full eval stays
    ("mask-full", True, 2, False),         # partial mask: n + n*E
])
def test_loss_pair_calls_per_round(setting, full_eval, m, fused, setup,
                                   one_thread):
    _, cfg, jparams = setup
    E = 2
    fed = _fed(setting, E=E).replace(full_eval=full_eval, m=m)
    masks = SETTINGS[setting][3]
    if m < N and fed.participation == "mask":
        masks = SETTINGS["gather-sparse"][3]
    pair = lm.make_loss_pair(transformer.forward, cfg, budget=6.0)
    calls = []

    def counted(params, batch):
        calls.append(1)
        return pair(params, batch)

    _port_rounds(jparams, cfg, fed, masks, R=1, pair=counted)
    local_rows = m if fed.participation == "gather" else N
    want = local_rows * E if fused else N + local_rows * E
    assert len(calls) == want


def test_fused_forward_equals_no_grad_eval(setup, one_thread):
    """Each row's (f_j, g_j) from a forward that keeps its graph (the fused
    round's) against the no-grad eval forward: bit-equal."""
    _, cfg, jparams = setup
    pair = lm.make_loss_pair(transformer.forward, cfg, budget=6.0)
    state = rounds.init_state(params_from_numpy(jparams), _fed("mask-full"),
                              device="cpu")
    toks, mask = _batches(3)
    batches = lm.LMBatch(t(toks), t(mask))
    f_ev, g_ev = rounds.eval_clients(flat.unflatten(state.spec, state.w),
                                     batches, pair, N)
    for j in range(N):
        leaf = state.w.detach().requires_grad_(True)
        f, g = pair(flat.unflatten(state.spec, leaf),
                    rounds.client_batch(batches, j))
        assert f.requires_grad
        assert_bits_equal(f.detach(), f_ev[j])
        assert_bits_equal(g.detach(), g_ev[j])
