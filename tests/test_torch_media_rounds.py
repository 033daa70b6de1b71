"""Two FedSGM rounds of each media arch (the reduced llama-3.2-vision-90b
with its cross layers gated at 0.5 and -0.3, the reduced whisper-small)
against ``repro.engine.rounds.round_step`` on ``comm="pallas"``, top-k
0.1 and 8-bit quant uplinks, from the reference's own weights and the same
numpy batches (tokens, minority mask and media), seq 64, n = 4 clients of
which the recorded cohorts of the ``fixed`` sampler take 2, in mask mode
and in gather mode.  The vlm runs with ``d_media`` 256, so ``media_proj``
(256 -> 128) still runs: the reference's Pallas kernels run in interpret
mode on the CPU, about a minute a round over the reduced config's
8192-wide projection (1M entries); ``test_torch_media.py`` holds that
projection's forward and gradient.

The law of ``test_torch_moe_rounds.py`` without its atol-1e-3 bound on
every coordinate: f, g_hat + budget and sigma at rtol 1e-5, ``feasible``
and ``up_bytes`` equal; all but 0.1% of the final w within rtol 1e-4 /
atol 1e-6.  The gradients differ in their last bits, so a top-k member or
quant code near its threshold may flip; at a near-tie of a block's k-th
magnitude the two packages keep different members of one block, and each
of the two coordinates then differs by the tied value, which this law
does not bound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.comm import flat as jax_flat
from repro.configs.base import (CompressorConfig as JCompressorConfig,
                                FedConfig as JFedConfig,
                                FleetConfig as JFleetConfig,
                                SwitchConfig as JSwitchConfig)
from repro.engine import rounds as jax_rounds
from repro.fleet import samplers as jax_samplers
from repro.models import build as jax_build
from repro.tasks import lm as jax_lm
from repro_torch.configs.base import (CompressorConfig, FedConfig,
                                      FleetConfig, SwitchConfig)
from repro_torch.engine import rounds
from repro_torch.fleet import samplers
from repro_torch.models import build
from repro_torch.tasks import lm
from test_torch_media import ARCHS, media_batch, media_setup
from torch_port_util import one_thread, t  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

N, M, SEQ = 4, 2, 64
# two recorded rounds of 2-of-4 cohorts
MASKS = np.array([[1, 0, 1, 0], [0, 1, 1, 0]], np.float32)
OVER = {"llama-3.2-vision-90b": {"d_media": 256}}


def _fed(kind, mode, cls=FedConfig, comp=CompressorConfig,
         switch=SwitchConfig, fleet=FleetConfig):
    return cls(n_clients=N, m=M, local_steps=1, lr=0.03, comm="pallas",
               switch=switch(mode="soft", eps=0.0, beta=2.0),
               uplink=comp(kind=kind, ratio=0.1, bits=8),
               downlink=comp(kind="none"), participation=mode,
               fleet=fleet(sampler="fixed"))


@pytest.mark.parametrize("mode", ["mask", "gather"])
@pytest.mark.parametrize("kind", ["topk", "quant"])
@pytest.mark.parametrize("arch", ARCHS)
def test_two_rounds_match_reference(arch, kind, mode, one_thread):
    jcfg, cfg, jparams, params = media_setup(arch, OVER.get(arch))
    assert cfg.family == "audio" or "media_proj" in params
    jfed = _fed(kind, mode, JFedConfig, JCompressorConfig, JSwitchConfig,
                JFleetConfig)
    fed = _fed(kind, mode)
    jpair = jax_lm.make_loss_pair(jax_build(jcfg).forward, jcfg, budget=6.0)
    pair = lm.make_loss_pair(build(cfg).forward, cfg, budget=6.0)
    jstate = jax_rounds.init_state(jparams, jfed)
    jstate = jstate._replace(sampler=jax_samplers.fixed_state(
        jnp.asarray(MASKS), jnp.asarray(MASKS)))
    state = rounds.init_state(params, fed, device="cpu")
    state = state._replace(sampler=samplers.fixed_state(MASKS, MASKS))
    jstep = jax.jit(lambda s, b: jax_rounds.round_step(s, b, jpair, jfed))
    for r in range(2):
        toks, mask, media = media_batch(r + 1, cfg, SEQ, (N,))
        jstate, jm = jstep(jstate, jax_lm.LMBatch(
            jnp.asarray(toks), jnp.asarray(mask), jnp.asarray(media)))
        state, m = rounds.round_step(
            state, lm.LMBatch(t(toks), t(mask), t(media)), pair, fed,
            device="cpu")
        np.testing.assert_allclose(
            [float(m.f), float(m.g_hat) + 6.0, float(m.sigma)],
            [float(jm.f), float(jm.g_hat) + 6.0, float(jm.sigma)],
            rtol=1e-5)
        assert float(m.feasible) == float(jm.feasible)
        assert float(m.up_bytes) == float(jm.up_bytes)
    jw = np.asarray(jax_flat.flatten(jax_flat.spec_of(jstate.w), jstate.w))
    w = state.w.numpy()
    close = np.isclose(w, jw, rtol=1e-4, atol=1e-6)
    assert (~close).mean() <= 1e-3, f"{int((~close).sum())} of {w.size} differ"
