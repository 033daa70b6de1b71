"""The moe family against the JAX package: the deepseek-v2 / v3 configs,
MLA (full-rank and low-rank queries), the MoE FFN's routing (top-k ties,
token-major capacity, overflow, pad tokens, shared experts, the balance
aux), the whole forward with the MTP head, and ``loss_pair`` with and
without ``aux_constraint``, at reduced width, from the reference's own
weights (``init`` then ``jax.device_get``) and the same numpy inputs.

Routing is a draw (the router's softmax and top-k) and a draw-free core
(dispatch, experts, combine, aux).  The core is held on the reference's
own ``probs`` / ``gates`` / ``idx``, so a routing flip from rounding (a
token whose k-th and (k+1)-th probabilities lie within the last bits)
cannot hide a fault, nor a fault pass for a flip; whole-layer tests assert
``idx`` equal wherever the reference's margin exceeds 1e-5 and print how
many tokens lie under it.

Tolerances and why:

* top-k on ties, the dispatch's slots, keep flags and expert inputs: bit
  for bit (integer bookkeeping and copies);
* the core's y: rtol 1e-5, atol 1e-6 (float32 matmuls associate
  differently in XLA and PyTorch); its aux: rtol 1e-6 on ``aux + 1 =
  E sum_e (f_e / k) p_e`` (the same choice counts, the mean probabilities
  summed in another order; the aux itself is that sum minus 1, near 0 at
  balanced routing, where an ulp of the sum is a large share of it);
* MLA's output, the logits, aux, MTP logits, f and g: rtol 1e-5 (atol 1e-5
  on logits-sized arrays whose entries cross zero);
* the gradients of f and g on the flat buffer: rtol 1e-4, atol 1e-6
  times the leaf's largest entry where that exceeds 1 (the backward adds
  more terms in a free order, and an absolute error scales with the
  leaf: the minority CE's gradient reaches 3-8 in the embedding, whose
  small entries then differ by about 2e-6, 2.5e-7 of the leaf's scale);
* the flat layout: paths, offsets and d equal, buffers bit for bit; the
  checkpoint's keys equal the reference's and its arrays bit for bit.

Two whole rounds per arch are in ``test_torch_moe_rounds.py``.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jax_checkpoint
from repro import configs as jax_configs
from repro.comm import flat as jax_flat
from repro.models import build as jax_build
from repro.models import mla as jax_mla
from repro.models import moe as jax_moe
from repro.tasks import lm as jax_lm
from repro_torch import checkpoint, configs
from repro_torch.comm import flat, payloads
from repro_torch.engine import rounds
from repro_torch.launch import train
from repro_torch.models import build, common, mla, moe, params_from_numpy
from repro_torch.tasks import lm
from test_torch_families import BATCH, _batch, _jax_paths, _setup
from torch_port_util import assert_bits_equal, one_thread, t  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ARCHS = ["deepseek-v2-236b", "deepseek-v3-671b"]
MARGIN = 1e-5


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch, reduced):
    """Every field the port has equals the reference's (the ``moe`` and
    ``mla`` sub-configs field by field), and so do ``n_params`` and
    ``n_active_params``."""
    get = "get_reduced" if reduced else "get_config"
    cfg = getattr(configs, get)(arch)
    jcfg = getattr(jax_configs, get)(arch)
    assert cfg.family == "moe" and cfg.moe is not None and cfg.mla is not None
    for f in dataclasses.fields(cfg):
        want, got = getattr(jcfg, f.name), getattr(cfg, f.name)
        if dataclasses.is_dataclass(got):
            assert dataclasses.asdict(got) == dataclasses.asdict(want), f.name
        else:
            assert got == want, f.name
    assert cfg.n_params() == jcfg.n_params()
    assert cfg.n_active_params() == jcfg.n_active_params()


@pytest.mark.parametrize("arch", ARCHS)
def test_flat_spec_and_checkpoint_keys_match_reference(arch, tmp_path):
    """``FlatSpec`` paths, offsets and d equal ``repro.comm.flat.spec_of``
    on the moe tree (top-level keys in ``jax.tree_util``'s order:
    ``dense_layers``, ``embed``, ``lm_head``, ``ln_f``, ``moe_layers``,
    ``mtp``), ``flatten`` is bit for bit the reference's, the port's own
    shapes and init lay out the same tree, and a saved checkpoint has the
    reference's keys and arrays."""
    jcfg, cfg, jparams, params = _setup(arch, {})
    jspec = jax_flat.spec_of(jparams)
    spec = flat.spec_of(params)
    assert list(spec.paths) == _jax_paths(jparams)
    top = list(dict.fromkeys(p[0] for p in spec.paths))
    assert top == ["dense_layers", "embed", "lm_head", "ln_f",
                   "moe_layers"] + (["mtp"] if cfg.mtp_depth else [])
    assert [(l.shape, l.offset, l.size) for l in spec.leaves] == \
        [(l.shape, l.offset, l.size) for l in jspec.leaves]
    assert spec.d == jspec.d
    w = flat.flatten(spec, params)
    assert_bits_equal(w, np.asarray(jax_flat.flatten(jspec, jparams)))
    for a, b in zip(payloads.tree_leaves(flat.unflatten(spec, w)),
                    jax.tree_util.tree_leaves(jparams)):
        assert_bits_equal(a, b)
    shapes = build(cfg).param_shapes(cfg)
    assert flat.spec_of(common.meta_tree(shapes)).paths == spec.paths
    mine = build(cfg).init(torch.Generator().manual_seed(0), cfg)
    assert [(l.shape, l.offset) for l in flat.spec_of(mine).leaves] == \
        [(l.shape, l.offset) for l in spec.leaves]
    checkpoint.save(str(tmp_path / "port"), params)
    jax_checkpoint.save(str(tmp_path / "ref"), jparams)
    keys = json.load(open(tmp_path / "port.json"))["keys"]
    assert keys == json.load(open(tmp_path / "ref.json"))["keys"]
    assert "moe_layers/moe/experts/w_gate" in keys
    mine, ref = np.load(tmp_path / "port.npz"), np.load(tmp_path / "ref.npz")
    for k in keys:
        assert_bits_equal(mine[k], ref[k])
    back = checkpoint.restore(str(tmp_path / "port"), params)
    for a, b in zip(payloads.tree_leaves(back), payloads.tree_leaves(params)):
        assert_bits_equal(a, b)


def test_init_norms_zero_and_expert_fan_in():
    """``kv_norm`` (and ``q_norm``, the layer norms) start at zero as the
    reference's do, and the experts draw with the reference's fan-in:
    ``d`` for ``w_gate`` / ``w_up`` ``[E, d, de]``, ``d_expert`` for
    ``w_down`` ``[E, de, d]``, stacked over the MoE layers or not; the
    port's standard deviations agree with the reference's init within 3%
    (each from at least 65k draws)."""
    arch = "deepseek-v3-671b"
    cfg = dataclasses.replace(configs.get_reduced(arch), d_model=256,
                              n_layers=3)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           d_expert=512))
    jcfg = dataclasses.replace(jax_configs.get_reduced(arch), d_model=256,
                               n_layers=3)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                             d_expert=512))
    jparams = jax.device_get(jax_build(jcfg).init(jax.random.PRNGKey(0),
                                                  jcfg))
    mine = build(cfg).init(torch.Generator().manual_seed(0), cfg)
    for name in ("kv_norm", "q_norm"):
        assert not mine["moe_layers"]["mla"][name].any()
        assert not mine["dense_layers"][0]["mla"][name].any()
        assert not mine["mtp"]["layer"]["mla"][name].any()
    assert not np.asarray(jparams["moe_layers"]["mla"]["kv_norm"]).any()
    d, de = cfg.d_model, cfg.moe.d_expert
    pairs = [(mine["moe_layers"]["moe"]["experts"],
              jparams["moe_layers"]["moe"]["experts"])]
    one = jax_moe.init(jax.random.PRNGKey(1), jcfg.d_model, jcfg.moe)
    pairs.append((build(cfg).init(torch.Generator().manual_seed(1), dataclasses
                                  .replace(cfg, n_layers=2))["moe_layers"]
                  ["moe"]["experts"], one["experts"]))
    for got, want in pairs:
        for name, fan in (("w_gate", d), ("w_up", d), ("w_down", de)):
            g = got[name].std().item()
            r = float(np.asarray(want[name]).std())
            assert abs(g * np.sqrt(fan) - 1) < 0.03, (name, g)
            assert abs(g / r - 1) < 0.03, (name, g, r)


# ---------------------------------------------------------------------------
# routing: top-k ties, the draw-free core, the whole layer
# ---------------------------------------------------------------------------

def test_top_k_ties_lowest_index_first():
    """``moe.top_k`` equals ``jax.lax.top_k`` bit for bit on rows with
    ties: uniform rows (a pad token's probabilities) go to ``0..k-1``,
    and repeated values keep index order."""
    rng = np.random.default_rng(0)
    E, k = 16, 6
    probs = rng.random((64, E)).astype(np.float32)
    probs[:8] = 1.0 / E                                    # uniform rows
    probs[8:32] = rng.integers(0, 3, (24, E)) / 4.0        # many ties
    probs[32:40, ::2] = probs[32:40, 1::2]                 # pairwise ties
    vals, idx = moe.top_k(t(probs), k)
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs), k)
    assert_bits_equal(idx.to(torch.int32), np.asarray(jidx))
    assert_bits_equal(vals, np.asarray(jvals))
    assert (idx[:8] == torch.arange(k)).all()


def _jax_route(p, x, mcfg):
    """The reference's routing draw, as ``repro.models.moe.moe_ffn``
    computes it (its lines 53-67): ``(xg, probs, gates, idx)``."""
    T, d = x.shape
    G = min(mcfg.router_group, T)
    ng = -(-T // G)
    pad = ng * G - T
    if pad:
        x = jnp.concatenate([x, jnp.zeros((pad, d), x.dtype)])
    xg = x.reshape(ng, G, d)
    probs = jax.nn.softmax((xg @ p["router"]).astype(jnp.float32), axis=-1)
    gates, idx = jax.lax.top_k(probs, mcfg.top_k)
    gates = (gates / jnp.maximum(gates.sum(-1, keepdims=True), 1e-9)
             ).astype(x.dtype)
    return xg, probs, gates, idx


# (id, MoEConfig changes, tokens T)
CORE_CASES = [
    ("two-groups", {}, 128),
    ("overflow", {"capacity_factor": 0.25}, 128),
    ("pads", {}, 80),
    ("no-shared", {"n_shared": 0}, 128),
    ("e8-k3-shared2", {"n_experts": 8, "top_k": 3, "n_shared": 2}, 96),
]


def _moe_case(over, T, seed=0):
    jcfg = jax_configs.get_reduced("deepseek-v2-236b")
    mcfg = dataclasses.replace(configs.get_reduced("deepseek-v2-236b").moe,
                               **over)
    jm = dataclasses.replace(jcfg.moe, **over)
    jp = jax.device_get(jax_moe.init(jax.random.PRNGKey(seed), jcfg.d_model,
                                     jm))
    x = np.random.default_rng(seed).standard_normal(
        (T, jcfg.d_model)).astype(np.float32)
    return jm, mcfg, jp, params_from_numpy(jp), x


@pytest.mark.parametrize("case", CORE_CASES, ids=lambda c: c[0])
def test_routing_core_on_reference_routing(case):
    """Given the reference's own ``probs`` / ``gates`` / ``idx``: the
    dispatch's slots, keep flags and expert inputs bit-equal to
    ``_route_group``'s (token-major capacity, the dump row); ``moe_core``'s
    y and aux against ``moe_ffn``'s.  Covers two groups, capacity
    overflow (C = 8 of 32 choices an expert), pad tokens (T = 80 in groups
    of 64: 48 zero rows routed to experts 0 and 1 and counted in f_e),
    no shared expert and two."""
    _, over, T = case
    jm, mcfg, jp, p, x = _moe_case(over, T)
    jy, jaux = jax_moe.moe_ffn(jp, jnp.asarray(x), jm)
    xg, probs, gates, idx = _jax_route(jp, jnp.asarray(x), jm)
    ng, G = xg.shape[:2]
    C = moe.capacity(G, mcfg)
    assert C == max(1, int(round(G * jm.top_k / jm.n_experts
                                 * jm.capacity_factor)))
    jin, jslot, jkeep = jax.vmap(lambda a, b, c: jax_moe._route_group(
        a, b, c, jm.n_experts, C))(xg, idx, gates)
    ein, slot, keep = moe.dispatch(t(xg), t(idx).long(), mcfg.n_experts, C)
    assert_bits_equal(slot.to(torch.int32), np.asarray(jslot))
    assert_bits_equal(keep, np.asarray(jkeep))
    assert_bits_equal(ein, np.asarray(jin))
    if case[0] == "overflow":
        assert not keep.all()
    if case[0] == "pads":
        pads = np.asarray(idx).reshape(-1, jm.top_k)[T:]
        assert (pads == np.arange(jm.top_k)).all()
        assert not keep.all()
    y, aux = moe.moe_core(p, t(xg), t(probs), t(gates), t(idx).long(), mcfg,
                          T)
    assert y.shape == (T, x.shape[1])
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(aux.item() + 1.0, float(jaux) + 1.0,
                               rtol=1e-6)


@pytest.mark.parametrize("case", CORE_CASES, ids=lambda c: c[0])
def test_moe_layer_matches_reference(case):
    """The whole layer, the port's own routing included: ``idx`` equal to
    the reference's wherever its margin (k-th minus (k+1)-th probability)
    exceeds 1e-5 (the count under it printed); with no flip, y at rtol
    1e-5 / atol 1e-6 and aux + 1 at rtol 1e-6, else y on the tokens whose
    routing agrees."""
    _, over, T = case
    jm, mcfg, jp, p, x = _moe_case(over, T, seed=1)
    jy, jaux = jax_moe.moe_ffn(jp, jnp.asarray(x), jm)
    _, jprobs, _, jidx = _jax_route(jp, jnp.asarray(x), jm)
    srt = -np.sort(-np.asarray(jprobs), axis=-1)
    margin = srt[..., jm.top_k - 1] - srt[..., jm.top_k]
    _, _, idx = moe.route(p["router"], moe.groups(t(x), mcfg), mcfg.top_k)
    same = (idx.numpy() == np.asarray(jidx)).all(-1)
    print(f"{case[0]}: {int((margin <= MARGIN).sum())} of {margin.size} "
          f"tokens within {MARGIN} of a flip, {int((~same).sum())} flipped")
    assert same[margin > MARGIN].all()
    y, aux = moe.moe_ffn(p, t(x), mcfg)
    rows = same.reshape(-1)[:T] if not same.all() else slice(None)
    np.testing.assert_allclose(y.numpy()[rows], np.asarray(jy)[rows],
                               rtol=1e-5, atol=1e-6)
    if same.all():
        np.testing.assert_allclose(aux.item() + 1.0, float(jaux) + 1.0,
                                   rtol=1e-6)


# ---------------------------------------------------------------------------
# MLA, the forward, the loss pair
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q_lora", [0, 32], ids=["full-rank-q", "lora-q"])
def test_mla_matches_reference(q_lora):
    """MLA's output (``q_lora_rank`` 0 as in v2, > 0 as in v3: the q
    latent's RMS norm), rtol 1e-5, at seq 40 (causal bias, shared RoPE
    key head)."""
    m = dataclasses.replace(configs.get_reduced("deepseek-v3-671b").mla,
                            q_lora_rank=q_lora)
    jmcfg = dataclasses.replace(jax_configs.get_reduced("deepseek-v3-671b")
                                .mla, q_lora_rank=q_lora)
    d, H, S = 128, 4, 40
    jp = jax.device_get(jax_mla.init(jax.random.PRNGKey(3), d, H, jmcfg))
    # nonzero norm gains, so that the (1 + gamma) of both norms is checked
    for name in ("kv_norm", "q_norm"):
        if name in jp:
            jp[name] = np.random.default_rng(4).standard_normal(
                jp[name].shape).astype(np.float32) * 0.1
    p = params_from_numpy(jp)
    assert set(p) == set(mla.mla_shapes(d, H, m))
    assert {k: tuple(v.shape) for k, v in p.items()} == mla.mla_shapes(d, H,
                                                                        m)
    x = np.random.default_rng(5).standard_normal((BATCH, S, d)).astype(
        np.float32)
    want = jax_mla.attention(jp, jnp.asarray(x), jnp.arange(S), 10_000.0, H,
                             jmcfg)
    got = mla.attention(p, t(x), torch.arange(S), 10_000.0, H, m)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, one_thread):
    """Logits, aux (the mean over the MoE layers) and, for v3, the MTP
    logits ``[B, S-1, V]``, at seq 40 (routing groups of 64 over 80
    tokens: the pad path)."""
    jcfg, cfg, jparams, params = _setup(arch, {})
    toks, _ = _batch(0, 40, cfg.vocab)
    want = jax.jit(lambda p, x: jax_build(jcfg).forward(p, jcfg, x))(
        jparams, jnp.asarray(toks))
    got = build(cfg).forward(params, cfg, t(toks))
    assert isinstance(got, tuple) and len(got) == len(want) \
        == (3 if cfg.mtp_depth else 2)
    assert got[0].shape == (BATCH, 40, cfg.vocab)
    if cfg.mtp_depth:
        assert got[2].shape == (BATCH, 39, cfg.vocab)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5 if a.ndim else 0)


@pytest.mark.parametrize("aux_constraint", [True, False],
                         ids=["aux-g", "minority-g"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_pair_and_grads_match_reference(arch, aux_constraint,
                                             one_thread):
    """``loss_pair``'s (f, g) at rtol 1e-5 (f with the 0.3-weighted MTP
    CE on v3; g the aux minus 6, or the minority CE minus 6) and the
    gradients of f and of g on the flat buffer at rtol 1e-4 / atol 1e-6
    (times the leaf's largest entry above 1)."""
    jcfg, cfg, jparams, params = _setup(arch, {})
    toks, mask = _batch(1, 64, cfg.vocab)
    jpair = jax_lm.make_loss_pair(jax_build(jcfg).forward, jcfg, budget=6.0,
                                  aux_constraint=aux_constraint)
    pair = lm.make_loss_pair(build(cfg).forward, cfg, budget=6.0,
                             aux_constraint=aux_constraint)
    jbatch = jax_lm.LMBatch(jnp.asarray(toks), jnp.asarray(mask))

    @jax.jit
    def reference(p):
        (jf, jg), vjp = jax.vjp(lambda q: jpair(q, jbatch), p)
        one = jnp.ones(())
        return jf, jg, vjp((one, 0 * one))[0], vjp((0 * one, one))[0]
    jf, jg, jgf, jgg = reference(jparams)
    spec = flat.spec_of(params)
    w = flat.flatten(spec, params).requires_grad_(True)
    f, g = pair(flat.unflatten(spec, w), lm.LMBatch(t(toks), t(mask)))
    np.testing.assert_allclose([f.item(), g.item()], [float(jf), float(jg)],
                               rtol=1e-5)
    gf, = torch.autograd.grad(f, w, retain_graph=True)
    gg, = torch.autograd.grad(g, w)
    for got, want in ((gf, jgf), (gg, jgg)):
        jw = np.asarray(jax_flat.flatten(jax_flat.spec_of(want), want))
        assert np.isfinite(got.numpy()).all()
        for path, leaf in zip(spec.paths, spec.leaves):
            sl = slice(leaf.offset, leaf.offset + leaf.size)
            scale = max(1.0, float(np.abs(jw[sl]).max()))
            np.testing.assert_allclose(got.numpy()[sl], jw[sl], rtol=1e-4,
                                       atol=1e-6 * scale, err_msg=str(path))
    if aux_constraint:
        # g reads the router: its gradient reaches the routers and the
        # layers below them, not the head
        router = spec.paths.index(("moe_layers", "moe", "router"))
        leaf = spec.leaves[router]
        assert gg[leaf.offset:leaf.offset + leaf.size].abs().sum() > 0
        head = spec.leaves[spec.paths.index(("lm_head",))]
        assert not gg[head.offset:head.offset + head.size].any()


# ---------------------------------------------------------------------------
# the launcher and the tree walkers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,argv", [
    ("deepseek-v2-236b", ["--comm", "pallas"]),
    ("deepseek-v3-671b", ["--comm", "pallas", "--uplink", "quant"])],
    ids=["v2-pallas-topk", "v3-pallas-quant"])
def test_launcher_runs_reduced_on_cpu(arch, argv, one_thread):
    """``--arch <deepseek> --reduced --device cpu --comm pallas``: the
    launcher's setup, whose g is the router imbalance minus 6 (g_hat + 6
    within the aux's range ``[-1, E - 1]``), then 2 rounds of
    ``run_rounds``; f and g_hat finite, w moved."""
    args = train.parser().parse_args(
        ["--arch", arch, "--reduced", "--device", "cpu", "--seq", "16"]
        + argv)
    state, batch_fn, loss_pair, fed, cfg, dev = train.setup(args)
    assert cfg == configs.get_reduced(arch) and dev.type == "cpu"
    w0 = state.w.clone()
    state, hist = rounds.run_rounds(state, batch_fn, loss_pair, fed, T=2,
                                    device=dev)
    assert np.isfinite(hist.f).all() and np.isfinite(hist.g_hat).all()
    assert ((hist.g_hat + 6.0 >= -1.0)
            & (hist.g_hat + 6.0 <= cfg.moe.n_experts - 1)).all()
    assert not torch.equal(state.w, w0)


def test_tree_walkers_on_the_moe_tree():
    """``payloads.tree_leaves`` / ``tree_map`` walk the moe tree (a list of
    dense layers, the stacked MoE layers, the MTP dict) in
    ``jax.tree_util``'s leaf order."""
    _, _, jparams, params = _setup("deepseek-v3-671b", {})
    want = jax.tree_util.tree_leaves(jparams)
    got = payloads.tree_leaves(params)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert_bits_equal(a, b)
    order = []
    payloads.tree_map(lambda x: order.append(tuple(x.shape)) or x, params)
    assert order == [tuple(x.shape) for x in want]
