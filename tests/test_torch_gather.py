"""Partial participation in gather mode with a compressed uplink AND
downlink: the port against the JAX package, and the port's gather mode
against its own mask mode.

Both packages replay the same recorded cohorts through the ``fixed``
sampler (their random draws cannot match), from the same weights and
batches, on the reduced smollm-360m at n = 4 clients, m = 2.

Tolerances and why:

* against the reference, as ``test_torch_slice.py`` states them: per-round
  f, g_hat, sigma at rtol 1e-5; ``feasible``, ``up_bytes`` and
  ``down_bytes`` exactly; the final w and the server center x: all but at
  most 0.1% of the coordinates within rtol 1e-4 / atol 1e-6 and every
  coordinate within atol 1e-3 (a top-k member or a quant code near its
  threshold may flip on the last-bit differences of the gradients, now in
  both directions);
* ``delta_norm`` at rtol 1e-5 (a sum of squares over d, reordered);
* the port's gather mode against its mask mode: bit-equal, state and every
  metric (the reference promises the same of its own two modes).
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
from repro_torch.configs.base import (CompressorConfig, FedConfig,
                                      FleetConfig, SwitchConfig)
from repro_torch.engine import participation, rounds
from repro_torch.fleet import samplers
from repro_torch.models import params_from_numpy, transformer
from repro_torch.tasks import lm
from torch_port_util import assert_bits_equal, t

N, M, BATCH, SEQ = 4, 2, 2, 16
# two recorded rounds of 2-of-4 cohorts
MASKS = np.array([[1, 0, 1, 0], [0, 1, 1, 0]], np.float32)
WIRES = [("topk", 8), ("quant", 8)]


@pytest.fixture
def one_thread():
    # tiny shapes: one intra-op thread beats contending with the other
    # test workers for the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setup():
    jcfg = jax_configs.get_reduced("smollm-360m")
    cfg = configs.get_reduced("smollm-360m")
    jparams = jax.device_get(jax_transformer.init(jax.random.PRNGKey(0),
                                                  jcfg))
    return jcfg, cfg, jparams, params_from_numpy(jparams)


def _batches(seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 512, size=(N, BATCH, SEQ), dtype=np.int32)
    mask = np.zeros((N, BATCH, SEQ), np.float32)
    mask[..., -2:] = 1.0
    return toks, mask


def _fed(kind, bits, mode, cls=FedConfig, comp=CompressorConfig,
         switch=SwitchConfig, fleet=FleetConfig):
    cc = comp(kind=kind, ratio=0.1, bits=bits)
    return cls(n_clients=N, m=M, local_steps=1, lr=0.03, comm="pallas",
               switch=switch(mode="soft", eps=0.0, beta=2.0), uplink=cc,
               downlink=cc, participation=mode,
               fleet=fleet(sampler="fixed"))


def _port_rounds(params, cfg, fed, masks, R=2):
    pair = lm.make_loss_pair(transformer.forward, cfg, budget=6.0)
    state = rounds.init_state(params, fed, device="cpu")
    state = state._replace(sampler=samplers.fixed_state(masks, masks))
    history = []
    for r in range(R):
        toks, mask = _batches(r + 1)
        state, met = rounds.round_step(state, lm.LMBatch(t(toks), t(mask)),
                                       pair, fed, device="cpu")
        history.append(met)
    return state, history


@pytest.mark.parametrize("kind,bits", WIRES)
def test_gather_rounds_match_reference(kind, bits, one_thread):
    """Two gather-mode rounds with compression up and down against
    ``repro.engine.rounds.round_step``."""
    jcfg, cfg, jparams, params = _setup()
    jfed = _fed(kind, bits, "gather", JFedConfig, JCompressorConfig,
                JSwitchConfig, JFleetConfig)
    fed = _fed(kind, bits, "gather")
    jpair = jax_lm.make_loss_pair(jax_transformer.forward, jcfg, budget=6.0)
    jstate = jax_rounds.init_state(jparams, jfed)
    jstate = jstate._replace(sampler=jax_samplers.fixed_state(
        jnp.asarray(MASKS), jnp.asarray(MASKS)))
    jstep = jax.jit(lambda s, b: jax_rounds.round_step(s, b, jpair, jfed))
    state, hist = _port_rounds(params, cfg, fed, MASKS)
    for r in range(2):
        toks, mask = _batches(r + 1)
        jstate, jm = jstep(jstate, jax_lm.LMBatch(jnp.asarray(toks),
                                                  jnp.asarray(mask)))
        m = hist[r]
        np.testing.assert_allclose(
            [float(m.f), float(m.g_hat), float(m.sigma),
             float(m.delta_norm)],
            [float(jm.f), float(jm.g_hat), float(jm.sigma),
             float(jm.delta_norm)], rtol=1e-5)
        for field in ("feasible", "up_bytes", "down_bytes"):
            assert float(getattr(m, field)) == float(getattr(jm, field))
    for got, want in ((state.w, jstate.w), (state.x, jstate.x)):
        jw = np.asarray(jax_flat.flatten(jax_flat.spec_of(want), want))
        w = got.numpy()
        close = np.isclose(w, jw, rtol=1e-4, atol=1e-6)
        assert (~close).mean() <= 1e-3, \
            f"{int((~close).sum())} of {w.size} differ"
        np.testing.assert_allclose(w, jw, rtol=0, atol=1e-3)


@pytest.mark.parametrize("kind,bits", WIRES + [("quant", 4)])
def test_gather_equals_mask_bitwise(kind, bits, one_thread):
    """The port's gather mode against its mask mode, same recorded
    cohorts: state and every metric bit-equal."""
    _, cfg, _, params = _setup()
    sg, hg = _port_rounds(params, cfg, _fed(kind, bits, "gather"), MASKS)
    sm, hm = _port_rounds(params, cfg, _fed(kind, bits, "mask"), MASKS)
    for name in ("w", "x", "e_up", "wbar_sum", "wbar_weight"):
        assert_bits_equal(getattr(sg, name), getattr(sm, name))
    for a, b in zip(hg, hm):
        for name in rounds.RoundMetrics._fields:
            assert_bits_equal(getattr(a, name), getattr(b, name))


@pytest.mark.parametrize("kind,bits", WIRES)
def test_short_cohort_residual_matches_reference(kind, bits, one_thread):
    """A cohort of one client where m = 2: the gather pads with the sampled
    client, whose residual row is written once (any write wins) and whose
    message is not doubled.  Its residual, the new w, and the untouched
    rows match the reference's (w with the tolerances of the module
    docstring; the residual likewise, except that at a flipped member or
    code it jumps by a whole step, so there the two only differ in sign);
    the port's gather round equals its mask round bit for bit."""
    masks = np.array([[0, 1, 0, 0]], np.float32)
    jcfg, cfg, jparams, params = _setup()
    jfed = _fed(kind, bits, "gather", JFedConfig, JCompressorConfig,
                JSwitchConfig, JFleetConfig)
    fed = _fed(kind, bits, "gather")
    jpair = jax_lm.make_loss_pair(jax_transformer.forward, jcfg, budget=6.0)
    jstate = jax_rounds.init_state(jparams, jfed)
    jstate = jstate._replace(sampler=jax_samplers.fixed_state(
        jnp.asarray(masks), jnp.asarray(masks)))
    toks, mask = _batches(1)
    jstate, _ = jax_rounds.round_step(
        jstate, jax_lm.LMBatch(jnp.asarray(toks), jnp.asarray(mask)), jpair,
        jfed)
    state, _ = _port_rounds(params, cfg, fed, masks, R=1)
    je = np.asarray(jstate.e_up)
    e = state.e_up.numpy()
    assert np.abs(e[1]).max() > 0
    np.testing.assert_array_equal(e[[0, 2, 3]], 0.0)
    np.testing.assert_array_equal(je[[0, 2, 3]], 0.0)
    # the residual: a flipped top-k member leaves buf on one side and 0 on
    # the other, a flipped quant code leaves the two residuals on either
    # side of the rounding midpoint; either way they do not share a sign
    close = np.isclose(e[1], je[1], rtol=1e-4, atol=1e-6)
    assert (~close).mean() <= 1e-3
    assert (e[1][~close] * je[1][~close] <= 0).all()
    jw = np.asarray(jax_flat.flatten(jax_flat.spec_of(jstate.w), jstate.w))
    w = state.w.numpy()
    close = np.isclose(w, jw, rtol=1e-4, atol=1e-6)
    assert (~close).mean() <= 1e-3
    np.testing.assert_allclose(w, jw, rtol=0, atol=1e-3)
    sm, _ = _port_rounds(params, cfg, _fed(kind, bits, "mask"), masks, R=1)
    for name in ("w", "x", "e_up"):
        assert_bits_equal(getattr(state, name), getattr(sm, name))


def test_mask_indices_pad_with_first_sampled_client():
    full = torch.tensor([0.0, 1.0, 0.0, 1.0, 1.0])
    assert participation.mask_indices(full, 3).tolist() == [1, 3, 4]
    short = torch.tensor([0.0, 0.0, 1.0, 0.0, 1.0])
    assert participation.mask_indices(short, 4).tolist() == [2, 4, 2, 2]
    fed = FedConfig(n_clients=5, m=4, participation="gather")
    part = participation.finalize(short, short, fed)
    assert part.short and part.weights is part.mask
    part = participation.finalize(full, full, fed.replace(m=3))
    assert not part.short and part.idx.tolist() == [1, 3, 4]


def test_fixed_sampler_replays_and_holds_the_last_row():
    fed = FedConfig(n_clients=4, m=2, fleet=FleetConfig(sampler="fixed"))
    samp = samplers.get_sampler("fixed")
    state = samplers.fixed_state(MASKS, MASKS * 0.5)
    got = []
    for _ in range(3):
        mask, weights, state = samp.sample(None, fed, state)
        got.append((mask.tolist(), weights.tolist()))
    assert got[0] == (MASKS[0].tolist(), (MASKS[0] * 0.5).tolist())
    assert got[1] == got[2] == (MASKS[1].tolist(), (MASKS[1] * 0.5).tolist())
    assert state[2] == 3
    with pytest.raises(ValueError, match="matching"):
        samplers.fixed_state(MASKS, MASKS[:1])
