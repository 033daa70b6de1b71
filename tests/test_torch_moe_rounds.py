"""Two FedSGM rounds of each moe arch against
``repro.engine.rounds.round_step`` on ``comm="pallas"``, top-k 0.1 and
8-bit quant uplinks, n = m = 2 clients, from the reference's own weights
and the same numpy batches, at the reduced size and seq 64, with the
launcher's loss pair: g is the router's load imbalance minus the budget
6 (``aux_constraint``), and f carries v3's MTP term.

The law of ``test_torch_slice.py``: f, g_hat + budget and sigma at rtol
1e-5, ``feasible`` and ``up_bytes`` equal; all but 0.1% of the final w
within rtol 1e-4 / atol 1e-6 and every coordinate within atol 1e-3 (the
gradients differ in their last bits, so a top-k member or quant code near
its threshold may flip).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.comm import flat as jax_flat
from repro.configs.base import (CompressorConfig as JCompressorConfig,
                                FedConfig as JFedConfig,
                                SwitchConfig as JSwitchConfig)
from repro.engine import rounds as jax_rounds
from repro.models import build as jax_build
from repro.tasks import lm as jax_lm
from repro_torch.configs.base import CompressorConfig, FedConfig, SwitchConfig
from repro_torch.engine import rounds
from repro_torch.models import build
from repro_torch.tasks import lm
from test_torch_families import _batch, _setup
from test_torch_moe import ARCHS
from torch_port_util import one_thread, t  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

N_CLIENTS, SEQ = 2, 64


@pytest.mark.parametrize("kind", ["topk", "quant"])
@pytest.mark.parametrize("arch", ARCHS)
def test_two_rounds_match_reference(arch, kind, one_thread):
    jcfg, cfg, jparams, params = _setup(arch, {})
    both = dict(n_clients=N_CLIENTS, m=N_CLIENTS, local_steps=1, lr=0.03,
                comm="pallas")
    jfed = JFedConfig(
        switch=JSwitchConfig(mode="soft", eps=0.0, beta=2.0),
        uplink=JCompressorConfig(kind=kind, ratio=0.1, bits=8),
        downlink=JCompressorConfig(kind="none"), **both)
    fed = FedConfig(
        switch=SwitchConfig(mode="soft", eps=0.0, beta=2.0),
        uplink=CompressorConfig(kind=kind, ratio=0.1, bits=8),
        downlink=CompressorConfig(kind="none"), **both)
    jpair = jax_lm.make_loss_pair(jax_build(jcfg).forward, jcfg, budget=6.0,
                                  aux_constraint=True)
    pair = lm.make_loss_pair(build(cfg).forward, cfg, budget=6.0,
                             aux_constraint=True)
    jstate = jax_rounds.init_state(jparams, jfed)
    state = rounds.init_state(params, fed, device="cpu")
    jstep = jax.jit(lambda s, b: jax_rounds.round_step(s, b, jpair, jfed))
    for r in range(2):
        toks, mask = _batch(r + 1, SEQ, cfg.vocab, (N_CLIENTS,))
        jstate, jm = jstep(jstate, jax_lm.LMBatch(jnp.asarray(toks),
                                                  jnp.asarray(mask)))
        state, m = rounds.round_step(state, lm.LMBatch(t(toks), t(mask)),
                                     pair, fed, device="cpu")
        np.testing.assert_allclose(
            [float(m.f), float(m.g_hat) + 6.0, float(m.sigma)],
            [float(jm.f), float(jm.g_hat) + 6.0, float(jm.sigma)],
            rtol=1e-5)
        assert float(m.feasible) == float(jm.feasible) == 1.0
        assert float(m.up_bytes) == float(jm.up_bytes)
    jw = np.asarray(jax_flat.flatten(jax_flat.spec_of(jstate.w), jstate.w))
    w = state.w.numpy()
    close = np.isclose(w, jw, rtol=1e-4, atol=1e-6)
    assert (~close).mean() <= 1e-3, f"{int((~close).sum())} of {w.size} differ"
    np.testing.assert_allclose(w, jw, rtol=0, atol=1e-3)
