"""The weakly-convex measure (``repro_torch.core.weakly_convex``) against
the JAX reference (``repro.core.weakly_convex``) on the NP task with n = 4
clients, on the CPU.

Tolerances: the inner solver takes the same switch at every step as the
reference (checked: its iterates stay within 1e-5 absolute, far from a
switch flip), so ``proximal_point`` agrees within 1e-5 absolute and
``stationarity`` within rtol 1e-4 (float32 sums over the clients' rows in
another order, 200 steps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import CompressorConfig as JCompressorConfig
from repro.configs.base import FedConfig as JFedConfig
from repro.configs.base import SwitchConfig as JSwitchConfig
from repro.core import fedsgm as jax_fedsgm
from repro.core import weakly_convex as jax_wc
from repro.tasks import np_classification as jax_npc
from repro_torch.configs.base import CompressorConfig, FedConfig, SwitchConfig
from repro_torch.core import fedsgm, weakly_convex
from repro_torch.comm import flat
from repro_torch.models import params_from_numpy
from repro_torch.tasks import np_classification as npc
from torch_port_util import n, t

EPS = 0.35


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def np4():
    (xs, ys), _ = jax_npc.make_dataset(jax.random.PRNGKey(0), n_clients=4)
    return np.asarray(xs), np.asarray(ys)


def _params(scale, seed=0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal(30) * scale).astype(np.float32),
            "b": np.float32(rng.standard_normal() * scale)}


@pytest.mark.parametrize("scale", [0.0, 0.3])
@pytest.mark.parametrize("kw", [dict(), dict(rho_hat=4.0, inner_steps=120,
                                             lr=0.1)])
def test_proximal_point_and_stationarity_match_reference(np4, scale, kw):
    xs, ys = np4
    w = _params(scale)
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    want = jax_wc.proximal_point(jax_npc.loss_pair, (xs, ys), jw, eps=EPS,
                                 **kw)
    got = weakly_convex.proximal_point(npc.loss_pair, (t(xs), t(ys)),
                                       params_from_numpy(w), eps=EPS, **kw)
    for k in ("w", "b"):
        np.testing.assert_allclose(n(got[k]), np.asarray(want[k]), rtol=0,
                                   atol=1e-5)
    s = weakly_convex.stationarity(npc.loss_pair, npc.NPBatch(t(xs), t(ys)),
                                   params_from_numpy(w), eps=EPS, **kw)
    js = jax_wc.stationarity(jax_npc.loss_pair, (xs, ys), jw, eps=EPS, **kw)
    assert float(s) == pytest.approx(float(js), rel=1e-4)


def test_proximal_point_feasible(np4):
    """The reference's property: the inner solution meets the constraint
    (up to the solver's tolerance)."""
    xs, ys = np4
    y = weakly_convex.proximal_point(npc.loss_pair, (t(xs), t(ys)),
                                     npc.init_params(30, device="cpu"),
                                     eps=EPS, inner_steps=300)
    _, g = npc.loss_pair(y, (t(xs.reshape(-1, 30)), t(ys.reshape(-1))))
    assert float(g) <= EPS + 0.1


def _cfg(cls, comp, switch):
    return cls(n_clients=4, m=4, local_steps=2, lr=0.1,
               switch=switch(mode="hard", eps=EPS),
               uplink=comp(kind="none"), downlink=comp(kind="none"))


def test_stationarity_decreases_with_training(np4):
    """The reference's property (Theorem 10's measure shrinks as FedSGM
    runs): ||w - w_hat(w)|| after 150 rounds below half its value at w_0;
    the port's measure equals the reference's at both points."""
    xs, ys = np4
    batch = npc.NPBatch(t(xs), t(ys))
    params = npc.init_params(30, device="cpu")
    cfg = _cfg(FedConfig, CompressorConfig, SwitchConfig)
    state = fedsgm.init_state(params, cfg, device="cpu")
    s0 = float(weakly_convex.stationarity(npc.loss_pair, batch, params,
                                          eps=EPS))
    state, _ = fedsgm.drive(state, batch, npc.loss_pair, cfg, T=150,
                            device="cpu")
    wT = flat.unflatten(state.spec, state.w)
    sT = float(weakly_convex.stationarity(npc.loss_pair, batch, wT, eps=EPS))
    assert sT < 0.5 * s0, (s0, sT)
    jcfg = _cfg(JFedConfig, JCompressorConfig, JSwitchConfig)
    jstate = jax_fedsgm.init_state(jax_npc.init_params(None, 30), jcfg)
    js0 = float(jax_wc.stationarity(jax_npc.loss_pair, (xs, ys), jstate.w,
                                    eps=EPS))
    assert s0 == pytest.approx(js0, rel=1e-4)


def test_client_chunk_is_not_ported(np4):
    """``client_chunk`` is the reference's chunked client vmap; the port's
    clients run one after another, so the knob is accepted and leaves the
    proximal point as it is, bit for bit."""
    xs, ys = np4
    out = [weakly_convex.proximal_point(npc.loss_pair, (t(xs), t(ys)),
                                        npc.init_params(30, device="cpu"),
                                        inner_steps=20, client_chunk=chunk)
           for chunk in (0, 2)]
    for k in ("w", "b"):
        assert torch.equal(out[0][k], out[1][k])
