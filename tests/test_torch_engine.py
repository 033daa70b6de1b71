"""Engine-level parity of the port on the NP task, on the CPU: batches of
any tuple type, and the ``FedConfig`` knobs that no other port test sets
(``proj_radius``, ``lean_metrics``, ``track_wbar``), against
``repro.engine.rounds.drive`` on the same shards and recorded cohorts.

Tolerances: the knob rounds' metrics at rtol 1e-6 (the reference and the
port agree to 2.3e-7 relative on these rounds) and w within 1e-6 absolute;
a round on a plain tuple bit-equal to the same round on the NamedTuple.
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
from repro.tasks import np_classification as jax_npc
from repro_torch.configs.base import (CompressorConfig, FedConfig,
                                      FleetConfig, SwitchConfig)
from repro_torch.engine import participation, rounds
from repro_torch.fleet import samplers
from repro_torch.tasks import np_classification as npc
from torch_port_util import assert_bits_equal, n, t

N, M, R = 20, 10, 4


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def shards():
    """The reference's NP Figure-1 shards (n = 20) and R recorded cohorts
    of 10."""
    (xs, ys), _ = jax_npc.make_dataset(jax.random.PRNGKey(0), n_clients=N)
    rng = np.random.default_rng(7)
    masks = np.zeros((R, N), np.float32)
    for r in range(R):
        masks[r, rng.choice(N, M, replace=False)] = 1.0
    return np.asarray(xs), np.asarray(ys), masks


def _cfg(cls, comp, switch, fleet, kind="none", **kw):
    cc = comp(kind=kind, ratio=0.1)
    return cls(n_clients=N, m=M, local_steps=3, lr=0.1,
               switch=switch(mode="soft", eps=0.35, beta=10.0),
               uplink=cc, downlink=cc, fleet=fleet(sampler="fixed"), **kw)


def _drive_port(cfg, batches, masks, T):
    state = rounds.init_state({"w": torch.zeros(30), "b": torch.zeros(())},
                              cfg, device="cpu")
    state = state._replace(sampler=samplers.fixed_state(masks, masks))
    return rounds.drive(state, batches, npc.loss_pair, cfg, T=T,
                        device="cpu")


@pytest.mark.parametrize("mode", ["mask", "gather"])
def test_plain_tuple_batches_equal_named_tuple(shards, mode):
    """One round on ``(x, y)`` and on ``NPBatch(x, y)``: bit-equal state
    and metrics (the reference hands plain tuples to its engine)."""
    xs, ys, masks = shards
    cfg = _cfg(FedConfig, CompressorConfig, SwitchConfig, FleetConfig,
               kind="topk", participation=mode)
    out = [_drive_port(cfg, b, masks, 1)
           for b in ((t(xs), t(ys)), npc.NPBatch(t(xs), t(ys)))]
    (sa, ha), (sb, hb) = out
    for name in ("w", "x", "e_up", "wbar_sum"):
        assert_bits_equal(getattr(sa, name), getattr(sb, name))
    for name in rounds.RoundMetrics._fields:
        assert_bits_equal(getattr(ha, name), getattr(hb, name))


def test_batches_of_any_tuple_type():
    x = torch.arange(12.0).reshape(3, 4)
    y = torch.tensor([0.0, 1.0, 2.0])
    assert rounds.client_batch(x, 1).tolist() == [4.0, 5.0, 6.0, 7.0]
    row = rounds.client_batch((x, y), 2)
    assert type(row) is tuple and row[1].item() == 2.0
    assert type(rounds.client_batch(npc.NPBatch(x, y), 0)) is npc.NPBatch
    cfg = FedConfig(n_clients=3, m=2, participation="gather")
    part = participation.finalize(torch.tensor([1.0, 0.0, 1.0]), None, cfg)
    assert participation.gather(part, x)[:, 0].tolist() == [0.0, 8.0]
    got = participation.gather(part, (x, y))
    assert type(got) is tuple and got[1].tolist() == [0.0, 2.0]
    assert rounds.n_rows(x) == rounds.n_rows((x, y)) == 3


def test_single_tensor_batch_round():
    """A batch that is one tensor: the round runs, in mask and gather mode,
    and the two agree bit for bit."""
    rng = np.random.default_rng(3)
    x = t(rng.standard_normal((4, 6, 5)).astype(np.float32))

    def loss_pair(params, batch):
        z = batch @ params["w"]
        return (z ** 2).mean(), z.mean() - 0.1

    out = {}
    for mode in ("mask", "gather"):
        cfg = FedConfig(n_clients=4, m=2, local_steps=2, lr=0.1,
                        participation=mode)
        state = rounds.init_state({"w": torch.ones(5)}, cfg, device="cpu")
        out[mode] = rounds.drive(state, x, loss_pair, cfg, T=2,
                                 device="cpu")
    assert_bits_equal(out["mask"][0].w, out["gather"][0].w)
    assert np.isfinite(out["mask"][1].f).all()


KNOBS = {
    "proj_radius mask": dict(proj_radius=0.5),
    "proj_radius gather topk up and down": dict(
        proj_radius=0.5, participation="gather", kind="topk"),
    "lean_metrics": dict(lean_metrics=True, kind="topk"),
    "track_wbar off": dict(track_wbar=False),
}


@pytest.mark.parametrize("name", sorted(KNOBS))
def test_knobs_match_reference(shards, name):
    xs, ys, masks = shards
    kw = KNOBS[name]
    jcfg = _cfg(JFedConfig, JCompressorConfig, JSwitchConfig, JFleetConfig,
                **kw)
    cfg = _cfg(FedConfig, CompressorConfig, SwitchConfig, FleetConfig, **kw)
    jstate = jax_rounds.init_state(jax_npc.init_params(None, 30), jcfg)
    jstate = jstate._replace(sampler=jax_samp.fixed_state(
        jnp.asarray(masks), jnp.asarray(masks)))
    jstate, jhist = jax_rounds.drive(jstate, (jnp.asarray(xs),
                                              jnp.asarray(ys)),
                                     jax_npc.loss_pair, jcfg, T=R)
    state, hist = _drive_port(cfg, npc.NPBatch(t(xs), t(ys)), masks, R)
    for field in ("f", "g_hat", "sigma", "g_full", "f_full", "delta_norm"):
        np.testing.assert_allclose(getattr(hist, field),
                                   np.asarray(getattr(jhist, field)),
                                   rtol=1e-6, atol=1e-7)
    for field in ("feasible", "up_bytes", "down_bytes"):
        np.testing.assert_array_equal(getattr(hist, field),
                                      np.asarray(getattr(jhist, field)))
    if kw.get("lean_metrics"):
        assert not hist.delta_norm.any()
    for got, want in ((state.w, jstate.w), (state.x, jstate.x)):
        assert (got is None) == (want is None)
        if got is not None:
            jw = np.asarray(jax_flat.flatten(jax_flat.spec_of(want), want))
            np.testing.assert_allclose(n(got), jw, rtol=0, atol=1e-6)
    if kw.get("proj_radius"):
        assert float(torch.linalg.vector_norm(state.w)) <= 0.5 + 1e-6
    assert (state.wbar_sum is None) == (not jcfg.track_wbar)
    wbar = rounds.averaged_iterate(state)
    jwbar = jax_rounds.averaged_iterate(jstate)
    np.testing.assert_allclose(n(wbar["w"]), np.asarray(jwbar["w"]),
                               rtol=0, atol=1e-6)
