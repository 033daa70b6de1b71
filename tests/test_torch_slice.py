"""The slice as a whole against the JAX package: the reduced smollm-360m
forward and ``loss_pair``, then two ``round_step``s on ``comm="pallas"`` for
each uplink, from the same weights and the same batches.

n = m = 2 clients, so the participation mask is all ones and no random draw
is involved.  Tolerances and why:

* forward logits and (f, g): rtol 1e-5 -- float32 matmuls and reductions
  associate differently in XLA and PyTorch;
* per-round f, g_hat, sigma: rtol 1e-5 (sigma is a clip of g_hat);
  ``feasible`` and ``up_bytes`` exactly (the bytes are static);
* the final w: the gradients differ in the last bits, so a quant code or a
  top-k member near its threshold can flip, which moves that one
  coordinate by ``lr * |delta_j| / m``.  So all but at most 0.1% of the
  coordinates must agree to rtol 1e-4 / atol 1e-6, and every coordinate to
  atol 1e-3.  (Measured on these inputs: 10 of 348,800 coordinates flipped
  for top-k and 12 for quant, the largest by 2.8e-4.)
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jax_configs
from repro.configs.base import (CompressorConfig as JCompressorConfig,
                                FedConfig as JFedConfig,
                                SwitchConfig as JSwitchConfig)
from repro.comm import flat as jax_flat
from repro.engine import rounds as jax_rounds
from repro.models import transformer as jax_transformer
from repro.tasks import lm as jax_lm
from repro_torch import configs
from repro_torch.configs.base import CompressorConfig, FedConfig, SwitchConfig
from repro_torch.engine import rounds
from repro_torch.models import params_from_numpy, transformer
from repro_torch.tasks import lm
from torch_port_util import one_thread, t  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

N_CLIENTS, BATCH, SEQ = 2, 2, 16


def _setup():
    jcfg = jax_configs.get_reduced("smollm-360m")
    cfg = configs.get_reduced("smollm-360m")
    jparams = jax.device_get(jax_transformer.init(jax.random.PRNGKey(0),
                                                  jcfg))
    return jcfg, cfg, jparams, params_from_numpy(jparams)


def _batches(seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 512, size=(N_CLIENTS, BATCH, SEQ), dtype=np.int32)
    mask = np.zeros((N_CLIENTS, BATCH, SEQ), np.float32)
    mask[..., -2:] = 1.0
    return toks, mask


def test_forward_and_loss_pair_match_reference():
    jcfg, cfg, jparams, params = _setup()
    toks, mask = _batches(0)
    want = jax_transformer.forward(jparams, jcfg, jnp.asarray(toks[0]))
    got = transformer.forward(params, cfg, t(toks[0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    jpair = jax_lm.make_loss_pair(jax_transformer.forward, jcfg, budget=6.0)
    pair = lm.make_loss_pair(transformer.forward, cfg, budget=6.0)
    jf, jg = jpair(jparams, jax_lm.LMBatch(jnp.asarray(toks[0]),
                                           jnp.asarray(mask[0])))
    f, g = pair(params, lm.LMBatch(t(toks[0]), t(mask[0])))
    np.testing.assert_allclose([float(f), float(g)], [float(jf), float(jg)],
                               rtol=1e-5)


@pytest.mark.parametrize("kind", ["topk", "quant"])
def test_two_rounds_match_reference(kind):
    jcfg, cfg, jparams, params = _setup()
    common = dict(n_clients=N_CLIENTS, m=N_CLIENTS, local_steps=1, lr=0.03,
                  comm="pallas")
    jfed = JFedConfig(
        switch=JSwitchConfig(mode="soft", eps=0.0, beta=2.0),
        uplink=JCompressorConfig(kind=kind, ratio=0.1, bits=8),
        downlink=JCompressorConfig(kind="none"), **common)
    fed = FedConfig(
        switch=SwitchConfig(mode="soft", eps=0.0, beta=2.0),
        uplink=CompressorConfig(kind=kind, ratio=0.1, bits=8),
        downlink=CompressorConfig(kind="none"), **common)
    jpair = jax_lm.make_loss_pair(jax_transformer.forward, jcfg, budget=6.0)
    pair = lm.make_loss_pair(transformer.forward, cfg, budget=6.0)
    jstate = jax_rounds.init_state(jparams, jfed)
    state = rounds.init_state(params, fed, device="cpu")
    jstep = jax.jit(lambda s, b: jax_rounds.round_step(s, b, jpair, jfed))
    for r in range(2):
        toks, mask = _batches(r + 1)
        jstate, jm = jstep(jstate, jax_lm.LMBatch(jnp.asarray(toks),
                                                  jnp.asarray(mask)))
        state, m = rounds.round_step(state, lm.LMBatch(t(toks), t(mask)),
                                     pair, fed, device="cpu")
        np.testing.assert_allclose(
            [float(m.f), float(m.g_hat), float(m.sigma)],
            [float(jm.f), float(jm.g_hat), float(jm.sigma)], rtol=1e-5)
        assert float(m.feasible) == float(jm.feasible)
        assert float(m.up_bytes) == float(jm.up_bytes)
    jw = np.asarray(jax_flat.flatten(jax_flat.spec_of(jstate.w), jstate.w))
    w = state.w.numpy()
    close = np.isclose(w, jw, rtol=1e-4, atol=1e-6)
    assert (~close).mean() <= 1e-3, f"{int((~close).sum())} of {w.size} differ"
    np.testing.assert_allclose(w, jw, rtol=0, atol=1e-3)
