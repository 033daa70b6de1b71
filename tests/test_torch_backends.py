"""The dense (``comm="dense"``, the reference's default) and packed wires
against the JAX package, and the strategies ported with them.

Tolerances and why:

* wire bytes (``FlatTransport.wire_bytes``, the tree transports'
  ``wire_bytes`` and the rounds' ``up_bytes`` / ``down_bytes``): equal, for
  every kind and backend;
* encode on injected residuals and deltas: top-k messages and residuals
  bit-equal; quant codes bit-equal, values and residuals within 2 ulp of
  the block scale (XLA multiplies by the reciprocal of the levels where
  the port divides); the reduce at rtol 1e-5 (reordered sums);
* two reduced rounds: the tolerances of ``test_torch_slice.py`` (f and
  sigma at rtol 1e-5; ``feasible`` and the bytes exactly; w and x all but
  0.1% of the coordinates within rtol 1e-4 / atol 1e-6, every coordinate
  within atol 1e-3), with g_hat held at rtol 1e-5 as the minority-slice
  cross entropy it is before the budget (6.0) comes off: g_hat itself lies
  near 0, and after a top-k member flipped in round 1 (in the uplink, as
  the slice allows) it moves by ~5e-6 absolute in round 2, 3e-5 of g_hat
  but 8e-7 of the cross entropy;
* rand-k and natural: their streams differ from the reference's, so rounds
  are checked for finite values and the port's gather mode against its
  mask mode, bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.comm import flat as jax_flat
from repro.comm import transports as jax_transports
from repro.configs.base import (CompressorConfig as JCC,
                                FedConfig as JFedConfig,
                                FleetConfig as JFleetConfig,
                                SwitchConfig as JSwitchConfig)
from repro.engine import rounds as jax_rounds
from repro.engine import strategies as jax_strategies
from repro.fleet import samplers as jax_samplers
from repro.models import transformer as jax_transformer
from repro.tasks import lm as jax_lm
from repro_torch import configs
from repro_torch.comm import flat, transports
from repro_torch.configs.base import (CompressorConfig, FedConfig,
                                      FleetConfig, SwitchConfig)
from repro_torch.engine import rounds
from repro_torch.fleet import samplers
from repro_torch.launch import train
from repro_torch.models import params_from_numpy, transformer
from repro_torch.tasks import lm
from torch_port_util import assert_bits_equal, assert_within_ulp, n, t

BACKENDS = ["ref", "packed", "pallas"]
# (kind, bits) of every compressor; quant at 6 bits does not pack
KINDS = [("none", 8), ("topk", 8), ("randk", 8), ("quant", 8), ("quant", 6),
         ("natural", 8)]
BATCH, SEQ = 2, 16
BUDGET = 6.0                # lm.make_loss_pair's budget: g = CE - BUDGET


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _meta_params(cfg):
    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return torch.empty(tree, device="meta")
    return walk(transformer.param_shapes(cfg))


@pytest.fixture(scope="module")
def full_specs():
    shapes = jax.eval_shape(
        lambda k: jax_transformer.init(k, jax_configs.get_config(
            "smollm-360m")), jax.random.PRNGKey(0))
    return (jax_flat.spec_of(shapes), shapes,
            flat.spec_of(_meta_params(configs.get_config("smollm-360m"))))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kind,bits", KINDS)
def test_wire_bytes_match_reference(kind, bits, backend, full_specs):
    """Full smollm-360m: the flat transport's and the tree transport's
    bytes of one message, equal to the reference's."""
    jspec, jshapes, spec = full_specs
    jcc, cc = (JCC(kind=kind, ratio=0.1, bits=bits),
               CompressorConfig(kind=kind, ratio=0.1, bits=bits))
    jt, tt = (jax_transports.get_transport(jcc, backend),
              transports.get_transport(cc, backend))
    up = flat.FlatTransport(tt, spec)
    assert up.wire_bytes() == \
        jax_flat.FlatTransport(jt, jspec).wire_bytes()
    assert up.wire == jax_flat.FlatTransport(jt, jspec).wire
    assert tt.wire_bytes(flat.struct_tree(spec)) == jt.wire_bytes(jshapes)
    assert (tt.wire, tt.needs_key) == (jt.wire, jt.needs_key)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"emb": rng.standard_normal((12, 40)).astype(np.float32),
            "layer": {"w": rng.standard_normal((40, 30)).astype(np.float32),
                      "norm": rng.standard_normal(30).astype(np.float32)},
            "s": np.float32(rng.standard_normal())}


def _as_port(tree):
    return {k: _as_port(v) if isinstance(v, dict) else t(v)
            for k, v in tree.items()}


def _as_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kind,bits", [("topk", 8), ("quant", 8),
                                       ("quant", 4)])
def test_tree_ef_step_matches_reference(kind, bits, backend):
    """Tree-level ``compress`` / ``decompress`` / ``ef_step`` of the
    deterministic kinds (pallas quant through ``quantize_ef``)."""
    jcc = JCC(kind=kind, ratio=0.1, bits=bits, block=16)
    cc = CompressorConfig(kind=kind, ratio=0.1, bits=bits, block=16)
    jt = jax_transports.get_transport(jcc, backend)
    tt = transports.get_transport(cc, backend)
    e, d = _tree(1), _tree(2)
    jmsg, je = jt.ef_step(_as_jax(e), _as_jax(d))
    msg, e_new = tt.ef_step(_as_port(e), _as_port(d))
    jdense = jt.decompress(jmsg, _as_jax(e))
    dense = tt.decompress(msg, _as_port(e))
    for path in (("emb",), ("layer", "w"), ("layer", "norm"), ("s",)):
        def get(tree):
            for k in path:
                tree = tree[k]
            return tree
        if kind == "topk":
            assert_bits_equal(get(dense), get(jdense))
            assert_bits_equal(get(e_new), get(je))
        else:
            buf = n(get(e)) + n(get(d))
            scale = np.max(np.abs(buf)) if np.ndim(buf) else buf
            assert_within_ulp(get(dense), get(jdense), 2, of=scale)
            assert_within_ulp(get(e_new), get(je), 2, of=scale)


@pytest.mark.parametrize("backend", ["ref", "packed"])
@pytest.mark.parametrize("kind,bits", [("topk", 8), ("quant", 8),
                                       ("quant", 6)])
def test_flat_encode_matches_reference(kind, bits, backend):
    """``FlatTransport.encode`` / ``reduce`` on the reduced smollm with
    injected residuals and deltas (3 clients, 2 participating)."""
    jcfg = jax_configs.get_reduced("smollm-360m")
    jparams = jax.device_get(jax_transformer.init(jax.random.PRNGKey(0),
                                                  jcfg))
    jspec = jax_flat.spec_of(jparams)
    spec = flat.spec_of(params_from_numpy(jparams))
    rng = np.random.default_rng(3)
    e = (rng.standard_normal((3, spec.d)) * 0.01).astype(np.float32)
    d = rng.standard_normal((3, spec.d)).astype(np.float32)
    mask = np.array([1.0, 0.0, 1.0], np.float32)
    jup = jax_flat.FlatTransport(jax_transports.get_transport(
        JCC(kind=kind, ratio=0.1, bits=bits), backend), jspec)
    up = flat.FlatTransport(transports.get_transport(
        CompressorConfig(kind=kind, ratio=0.1, bits=bits), backend), spec)
    jmsgs, je = jup.encode(jnp.asarray(e), jnp.asarray(d), jnp.asarray(mask))
    msgs, e_new = up.encode(t(e), t(d), t(mask))
    if kind == "topk":
        for a, b in zip(jax.tree_util.tree_leaves(msgs),
                        jax.tree_util.tree_leaves(jmsgs)):
            assert_bits_equal(a, b)
        assert_bits_equal(e_new, je)
    else:
        buf = e + d
        scale = np.abs(buf).max(axis=-1, keepdims=True)
        if up.wire == "packed":
            assert_bits_equal(msgs.words, jmsgs.words)
            assert_bits_equal(msgs.scale, jmsgs.scale)
        else:
            assert_within_ulp(msgs, jmsgs, 2, of=np.broadcast_to(scale,
                                                                 buf.shape))
        assert_within_ulp(e_new, je, 2, of=np.broadcast_to(scale, buf.shape))
    np.testing.assert_allclose(n(up.reduce(msgs, t(mask), 2)),
                               n(jup.reduce(jmsgs, jnp.asarray(mask), 2)),
                               rtol=1e-5, atol=1e-6)


def _setup():
    jcfg = jax_configs.get_reduced("smollm-360m")
    cfg = configs.get_reduced("smollm-360m")
    jparams = jax.device_get(jax_transformer.init(jax.random.PRNGKey(0),
                                                  jcfg))
    return jcfg, cfg, jparams


def _batches(seed, nc):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 512, size=(nc, BATCH, SEQ), dtype=np.int32)
    mask = np.zeros((nc, BATCH, SEQ), np.float32)
    mask[..., -2:] = 1.0
    return toks, mask


def _fed(comm, kind, bits, cls=FedConfig, comp=CompressorConfig,
         switch=SwitchConfig, fleet=FleetConfig, nc=2, **kw):
    cc = comp(kind=kind, ratio=0.1, bits=bits)
    return cls(n_clients=nc, m=nc, local_steps=1, lr=0.03, comm=comm,
               switch=switch(mode="soft", eps=0.0, beta=2.0), uplink=cc,
               downlink=cc, fleet=fleet(sampler="fixed"), **kw)


def _match_reference(jfed, fed, nc, R=2):
    """R rounds of both packages from the same weights and batches, every
    client participating (recorded through the ``fixed`` sampler)."""
    jcfg, cfg, jparams = _setup()
    masks = np.ones((R, nc), np.float32)
    jpair = jax_lm.make_loss_pair(jax_transformer.forward, jcfg,
                                  budget=BUDGET)
    pair = lm.make_loss_pair(transformer.forward, cfg, budget=BUDGET)
    jstate = jax_rounds.init_state(jparams, jfed)
    jstate = jstate._replace(sampler=jax_samplers.fixed_state(
        jnp.asarray(masks), jnp.asarray(masks)))
    state = rounds.init_state(params_from_numpy(jparams), fed, device="cpu")
    state = state._replace(sampler=samplers.fixed_state(masks, masks))
    jstep = jax.jit(lambda s, b: jax_rounds.round_step(s, b, jpair, jfed))
    for r in range(R):
        toks, mask = _batches(r + 1, nc)
        jstate, jm = jstep(jstate, jax_lm.LMBatch(jnp.asarray(toks),
                                                  jnp.asarray(mask)))
        state, m = rounds.round_step(state, lm.LMBatch(t(toks), t(mask)),
                                     pair, fed, device="cpu")
        np.testing.assert_allclose(
            [float(m.f), float(m.g_hat) + BUDGET, float(m.sigma)],
            [float(jm.f), float(jm.g_hat) + BUDGET, float(jm.sigma)],
            rtol=1e-5)
        for name in ("feasible", "up_bytes", "down_bytes"):
            assert float(getattr(m, name)) == float(getattr(jm, name))
    pairs = [(state.w, jstate.w)]
    if state.x is not None:
        pairs.append((state.x, jstate.x))
    for got, want in pairs:
        jw = np.asarray(jax_flat.flatten(jax_flat.spec_of(want), want))
        w = got.numpy()
        close = np.isclose(w, jw, rtol=1e-4, atol=1e-6)
        assert (~close).mean() <= 1e-3, \
            f"{int((~close).sum())} of {w.size} differ"
        np.testing.assert_allclose(w, jw, rtol=0, atol=1e-3)


@pytest.mark.parametrize("comm,kind,bits", [
    ("dense", "topk", 8), ("dense", "quant", 8), ("packed", "topk", 8),
    ("packed", "quant", 8), ("packed", "quant", 6)])
def test_two_rounds_match_reference(comm, kind, bits, one_thread):
    """Two reduced rounds, the same compressor up and down."""
    _match_reference(
        _fed(comm, kind, bits, JFedConfig, JCC, JSwitchConfig,
             JFleetConfig), _fed(comm, kind, bits), nc=2)


@pytest.mark.parametrize("strategy,nc", [("penalty-fedavg", 2),
                                         ("centralized-sgm", 1)])
def test_strategies_match_reference(strategy, nc, one_thread):
    common = dict(nc=nc, strategy=strategy, rho=2.0)
    _match_reference(
        _fed("dense", "topk", 8, JFedConfig, JCC, JSwitchConfig,
             JFleetConfig, **common),
        _fed("dense", "topk", 8, **common), nc=nc)


def test_centralized_sgm_needs_one_client():
    for fed in (FedConfig(n_clients=2, m=2, strategy="centralized-sgm"),
                FedConfig(n_clients=2, m=1, strategy="centralized-sgm")):
        with pytest.raises(ValueError, match="n_clients == m == 1"):
            rounds.init_state({"w": torch.zeros(3)}, fed, device="cpu")
        with pytest.raises(ValueError, match="n_clients == m == 1"):
            jax_strategies.get_strategy("centralized-sgm").validate(
                JFedConfig(n_clients=fed.n_clients, m=fed.m))


def _round(comm, kind, bits, mode, strategy="fedsgm", nc=4, m=2, R=2,
           masks=None):
    """R tiny rounds of the port on the CPU (the reduced smollm at seq 8,
    batch 1): the final state and the metrics."""
    args = train.parser().parse_args(
        ["--reduced", "--device", "cpu", "--seq", "8", "--batch", "1",
         "--clients", str(nc), "--comm", comm])
    state, batch_fn, pair, fed, _, _ = train.setup(args)
    cc = CompressorConfig(kind=kind, ratio=0.1, bits=bits)
    fed = fed.replace(m=m, uplink=cc, downlink=cc, participation=mode,
                      strategy=strategy, fleet=FleetConfig(sampler="fixed"))
    if masks is None:
        rng = np.random.default_rng(7)
        masks = np.zeros((R, nc), np.float32)
        for r in range(R):
            masks[r, rng.choice(nc, m, replace=False)] = 1.0
    state = rounds.init_state(flat.unflatten(state.spec, state.w), fed,
                              device="cpu")
    state = state._replace(sampler=samplers.fixed_state(masks, masks))
    return rounds.run_rounds(state, batch_fn, pair, fed, T=R, device="cpu")


@pytest.mark.parametrize("mode", ["mask", "gather"])
@pytest.mark.parametrize("kind,bits", KINDS)
@pytest.mark.parametrize("comm", ["dense", "packed"])
def test_every_wire_runs(comm, kind, bits, mode, one_thread):
    state, hist = _round(comm, kind, bits, mode)
    assert np.isfinite(hist.f).all() and np.isfinite(hist.g_hat).all()
    assert torch.isfinite(state.w).all()
    up = flat.FlatTransport(transports.get_transport(
        CompressorConfig(kind=kind, ratio=0.1, bits=bits),
        transports.backend_for(comm)), state.spec)
    assert (hist.up_bytes == np.float32(up.wire_bytes())).all()


@pytest.mark.parametrize("strategy", ["fedsgm", "fedsgm-soft",
                                      "penalty-fedavg", "centralized-sgm"])
@pytest.mark.parametrize("comm", ["dense", "packed"])
def test_every_strategy_runs(comm, strategy, one_thread):
    nc = 1 if strategy == "centralized-sgm" else 4
    m = 1 if strategy == "centralized-sgm" else 2
    state, hist = _round(comm, "topk", 8, "gather", strategy, nc=nc, m=m)
    assert np.isfinite(hist.f).all() and torch.isfinite(state.w).all()


@pytest.mark.parametrize("comm,kind", [("packed", "randk"),
                                       ("dense", "randk"),
                                       ("dense", "natural"),
                                       ("pallas", "randk")])
def test_random_kinds_gather_equals_mask(comm, kind, one_thread):
    """Per-client streams: the same client draws the same numbers in mask
    and gather mode, so the two are bit-equal, up and down."""
    sg, hg = _round(comm, kind, 8, "gather")
    sm, hm = _round(comm, kind, 8, "mask")
    for name in ("w", "x", "e_up", "wbar_sum"):
        assert_bits_equal(getattr(sg, name), getattr(sm, name))
    for name in rounds.RoundMetrics._fields:
        assert_bits_equal(getattr(hg, name), getattr(hm, name))


def test_wire_key_streams():
    """One stream per (seed, round, direction, client): equal keys draw
    equal numbers, any other key other numbers."""
    def draw(seed, r, direction, client):
        g = transports.WireKey(seed, r, direction).generator(client, "cpu")
        return torch.rand(4, generator=g)
    up, down = transports.UPLINK, transports.DOWNLINK
    base = draw(0, 3, up, 2)
    assert torch.equal(base, draw(0, 3, up, 2))
    for other in ((1, 3, up, 2), (0, 4, up, 2), (0, 3, down, 2),
                  (0, 3, up, 1)):
        assert not torch.equal(base, draw(*other))
