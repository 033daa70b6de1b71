"""The token-only model families against the JAX package: the patterned
dense stack with qk-norm (gemma3-4b, qwen3-4b, minitron-4b), Mamba-2
(mamba2-130m) and Griffin (recurrentgemma-2b), at reduced width, from the
reference's own weights (``init`` then ``jax.device_get``) and the same
numpy tokens.

Cases chosen so that seq 64 reaches every code path: gemma3 at 7 layers
and ratio 2 (two whole periods in ``blocks``, one layer in ``rest``) with
window 32 < seq, so the local layers mask and the global ones do not;
Mamba-2 with chunk 32 (two SSD chunks) and at seq 40 (the padding path);
Griffin at 4 layers (one ``(rec, rec, attn)`` period and one ``rest``
layer) with window 32.

Tolerances and why:

* logits, f and g: rtol 1e-5 (float32 matmuls and reductions associate
  differently in XLA and PyTorch; Griffin's RG-LRU scan is a log-step scan
  against XLA's associative scan, another order of the same products);
* the gradient of f on the flat buffer: rtol 1e-4, atol 1e-6 (the
  backward adds more terms in a free order; entries that cancel to near
  zero keep an absolute error of a few 1e-7);
* the flat layout: paths, offsets and d equal, buffers bit for bit.

Two whole rounds per family are in ``test_torch_families_rounds.py`` (a
file of their own, so that a parallel run spreads the reference's
compile time).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.comm import flat as jax_flat
from repro.models import build as jax_build
from repro.tasks import lm as jax_lm
from repro_torch import configs
from repro_torch.comm import flat, payloads
from repro_torch.engine import rounds
from repro_torch.kernels import ops
from repro_torch.launch import train
from repro_torch.models import build, common, params_from_numpy
from repro_torch.scale import shard
from repro_torch.tasks import lm
from torch_port_util import assert_bits_equal, one_thread, t  # noqa: F401

NEW_ARCHS = ["qwen3-4b", "minitron-4b", "gemma3-4b", "mamba2-130m",
             "recurrentgemma-2b"]
BATCH = 2
# (id, arch, config changes, seq)
CASES = [
    ("gemma3-7L", "gemma3-4b", {"n_layers": 7}, 64),
    ("qwen3", "qwen3-4b", {}, 64),
    ("minitron", "minitron-4b", {}, 64),
    ("mamba2-2chunks", "mamba2-130m", {}, 64),
    ("mamba2-padded", "mamba2-130m", {}, 40),
    ("griffin-4L", "recurrentgemma-2b", {"n_layers": 4}, 64),
]


def _setup(arch, over):
    jcfg = dataclasses.replace(jax_configs.get_reduced(arch), **over)
    cfg = dataclasses.replace(configs.get_reduced(arch), **over)
    jparams = jax.device_get(jax_build(jcfg).init(jax.random.PRNGKey(0),
                                                  jcfg))
    return jcfg, cfg, jparams, params_from_numpy(jparams)


def _batch(seed, seq, vocab, lead=()):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=lead + (BATCH, seq), dtype=np.int32)
    mask = np.zeros(lead + (BATCH, seq), np.float32)
    mask[..., -4:] = 1.0
    return toks, mask


def _jax_paths(tree):
    return [tuple(k.key if hasattr(k, "key") else k.idx for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


# ---------------------------------------------------------------------------
# configs and the registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", NEW_ARCHS + ["smollm-360m",
                                  "llama-3.2-vision-90b", "whisper-small"])
def test_config_matches_reference(arch, reduced):
    """Every field the port has equals the reference's, and so does the
    analytic parameter count."""
    get = "get_reduced" if reduced else "get_config"
    cfg = getattr(configs, get)(arch)
    jcfg = getattr(jax_configs, get)(arch)
    for f in dataclasses.fields(cfg):
        want, got = getattr(jcfg, f.name), getattr(cfg, f.name)
        if dataclasses.is_dataclass(got):
            assert dataclasses.asdict(got) == dataclasses.asdict(want), f.name
        else:
            assert got == want, f.name
    assert cfg.n_params() == jcfg.n_params()


def _shape_tree(tree):
    """Dicts and lists inner; a leaf's shape (a port shape tuple is its
    own)."""
    if isinstance(tree, dict):
        return {k: _shape_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shape_tree(v) for v in tree]
    return tuple(getattr(tree, "shape", tree))


@pytest.mark.parametrize("arch", jax_configs.all_arch_names())
def test_every_reference_arch_is_ported(arch):
    """Each of the reference's architectures resolves in the port (full
    and reduced), ``build`` returns its family, and ``param_shapes`` of the
    reduced config is the tree of the reference's ``init`` shapes under
    ``jax.eval_shape``."""
    assert configs.get_config(arch).family == \
        jax_configs.get_config(arch).family
    cfg, jcfg = configs.get_reduced(arch), jax_configs.get_reduced(arch)
    fns = build(cfg)
    want = jax.eval_shape(lambda k: jax_build(jcfg).init(k, jcfg),
                          jax.random.PRNGKey(0))
    assert _shape_tree(fns.param_shapes(cfg)) == _shape_tree(want)


@pytest.mark.parametrize("n_layers", [2, 7, 34, 26])
def test_layer_plans_match_reference(n_layers):
    """gemma3's per-layer kind and window (window 0 on each period's last
    layer) and Griffin's block kinds equal the reference's."""
    from repro.models import griffin as jax_griffin
    from repro.models import transformer as jax_transformer
    from repro_torch.models import griffin, transformer
    for arch, port, ref in (
            ("gemma3-4b", transformer.layer_plan, jax_transformer.layer_plan),
            ("recurrentgemma-2b", griffin.block_kinds,
             jax_griffin.block_kinds)):
        for get, jget in ((configs.get_config, jax_configs.get_config),
                          (configs.get_reduced, jax_configs.get_reduced)):
            cfg = dataclasses.replace(get(arch), n_layers=n_layers)
            jcfg = dataclasses.replace(jget(arch), n_layers=n_layers)
            assert port(cfg) == ref(jcfg)


# ---------------------------------------------------------------------------
# the flat layout of list-bearing trees
# ---------------------------------------------------------------------------

LAYOUT_CASES = [("gemma3-7L", "gemma3-4b", {"n_layers": 7}),
                ("gemma3-2L-no-blocks", "gemma3-4b", {}),
                ("griffin-4L", "recurrentgemma-2b", {"n_layers": 4}),
                ("mamba2", "mamba2-130m", {})]


@pytest.mark.parametrize("case", LAYOUT_CASES, ids=lambda c: c[0])
def test_flat_spec_matches_reference(case):
    """``FlatSpec`` paths, offsets and d equal ``repro.comm.flat.spec_of``
    (lists in index order, an empty ``blocks`` giving no leaf), and
    ``flatten`` then ``unflatten`` gives back the tree bit for bit."""
    _, arch, over = case
    jcfg, cfg, jparams, params = _setup(arch, over)
    jspec = jax_flat.spec_of(jparams)
    spec = flat.spec_of(params)
    assert list(spec.paths) == _jax_paths(jparams)
    assert [(l.shape, l.offset, l.size) for l in spec.leaves] == \
        [(l.shape, l.offset, l.size) for l in jspec.leaves]
    assert spec.d == jspec.d
    assert isinstance(params.get("blocks", []), list)
    if case[0] == "gemma3-2L-no-blocks":
        assert params["blocks"] == [] and len(params["rest"]) == 2
    w = flat.flatten(spec, params)
    assert_bits_equal(w, np.asarray(jax_flat.flatten(jspec, jparams)))
    back = flat.unflatten(spec, w)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(params)
    for a, b in zip(payloads.tree_leaves(back), payloads.tree_leaves(params)):
        assert_bits_equal(a, b)
    # the port's own init and shapes lay out the same tree
    shapes = build(cfg).param_shapes(cfg)
    assert flat.spec_of(common.meta_tree(shapes)).paths == spec.paths
    mine = build(cfg).init(torch.Generator().manual_seed(0), cfg)
    assert [(l.shape, l.offset) for l in flat.spec_of(mine).leaves] == \
        [(l.shape, l.offset) for l in spec.leaves]


def test_tree_walkers_descend_lists():
    """``payloads.tree_map`` / ``tree_leaves``, ``ops.switch_blend_tree``
    and ``scale.shard.sharded_take`` on Griffin's list-bearing tree, in
    ``jax.tree_util``'s leaf order."""
    _, _, jparams, params = _setup("recurrentgemma-2b", {"n_layers": 4})
    want = jax.tree_util.tree_leaves(jparams)
    got = payloads.tree_leaves(params)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert_bits_equal(a, b)
    order = []
    doubled = payloads.tree_map(lambda x: order.append(x.shape) or x * 2,
                                params)
    assert order == [tuple(x.shape) for x in want]
    for a, b in zip(payloads.tree_leaves(doubled), want):
        assert_bits_equal(a, np.asarray(b) * 2)
    sigma = torch.tensor(0.25)
    gf = payloads.tree_map(torch.ones_like, params)
    blended = ops.switch_blend_tree(gf, payloads.tree_map(torch.zeros_like,
                                                          params), sigma)
    assert isinstance(blended["blocks"], list)
    for leaf in payloads.tree_leaves(blended):
        assert torch.equal(leaf, torch.full_like(leaf, 0.75))
    stacked = payloads.tree_map(lambda x: torch.stack([x, -x, 2 * x]),
                                params)
    taken = shard.sharded_take(stacked, torch.tensor([2, 0]))
    for a, b in zip(payloads.tree_leaves(taken), want):
        assert_bits_equal(a, np.stack([2 * np.asarray(b), np.asarray(b)]))


# ---------------------------------------------------------------------------
# forward, loss pair and gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_forward_loss_and_grad_match_reference(case, one_thread):
    _, arch, over, seq = case
    jcfg, cfg, jparams, params = _setup(arch, over)
    jfns, fns = jax_build(jcfg), build(cfg)
    toks, mask = _batch(0, seq, cfg.vocab)
    jpair = jax_lm.make_loss_pair(jfns.forward, jcfg, budget=6.0)
    pair = lm.make_loss_pair(fns.forward, cfg, budget=6.0)

    @jax.jit
    def reference(p, batch):
        logits = jfns.forward(p, jcfg, batch.tokens)
        return logits, jax.value_and_grad(lambda q: jpair(q, batch),
                                          has_aux=True)(p)
    want, ((jf, jg), jgrad) = reference(
        jparams, jax_lm.LMBatch(jnp.asarray(toks), jnp.asarray(mask)))
    got = fns.forward(params, cfg, t(toks))
    assert got.shape == (BATCH, seq, cfg.vocab)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)

    spec = flat.spec_of(params)
    w = flat.flatten(spec, params).requires_grad_(True)
    f, g = pair(flat.unflatten(spec, w), lm.LMBatch(t(toks), t(mask)))
    np.testing.assert_allclose([f.item(), g.item()], [float(jf), float(jg)],
                               rtol=1e-5)
    f.backward()
    jw = np.asarray(jax_flat.flatten(jax_flat.spec_of(jgrad), jgrad))
    assert np.isfinite(w.grad.numpy()).all()
    np.testing.assert_allclose(w.grad.numpy(), jw, rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_launcher_runs_each_arch_reduced_on_cpu(arch, one_thread):
    """``--arch <name> --reduced --device cpu``: the launcher's setup, then
    2 rounds of ``run_rounds`` on the pallas wire (4 clients, 2 sampled,
    gather); f and g_hat finite, w moved."""
    args = train.parser().parse_args(
        ["--arch", arch, "--reduced", "--device", "cpu", "--seq", "16",
         "--clients", "4", "--participating", "2", "--participation",
         "gather", "--comm", "pallas"])
    state, batch_fn, loss_pair, fed, cfg, dev = train.setup(args)
    assert cfg == configs.get_reduced(arch) and dev.type == "cpu"
    w0 = state.w.clone()
    state, hist = rounds.run_rounds(state, batch_fn, loss_pair, fed, T=2,
                                    device=dev)
    assert np.isfinite(hist.f).all() and np.isfinite(hist.g_hat).all()
    assert not torch.equal(state.w, w0)


@pytest.mark.parametrize("S,W", [(64, 2560), (2048, 256)])
def test_rglru_scan_against_reference_and_float64(S, W):
    """The RG-LRU recurrence ``h_t = a_t h_{t-1} + b_t``: the port's
    log-step scan against the reference's ``jax.lax.associative_scan`` and
    a float64 sequential loop, on gates as ``_rec_block`` makes them
    (``log a = -8 softplus(lam) r``).  The two scans add in different
    orders: they agree within 4 ulp of max |h| (most entries bit for bit),
    and each is within 4 ulp of max |h| of the float64 loop."""
    from repro.models import griffin as jax_griffin
    from repro_torch.models import griffin
    rng = np.random.default_rng(S + W)
    lam = np.linspace(2.0, 5.0, W)
    r = 1.0 / (1.0 + np.exp(-rng.standard_normal((2, S, W))))
    log_a = -8.0 * np.log1p(np.exp(lam)) * r
    a = np.exp(log_a).astype(np.float32)
    b = (np.sqrt(np.maximum(1.0 - np.exp(2.0 * log_a), 1e-9))
         * rng.standard_normal((2, S, W))).astype(np.float32)
    want = np.asarray(jax.jit(jax_griffin._rglru_scan)(jnp.asarray(a),
                                                      jnp.asarray(b)))
    got = griffin.rglru_scan(t(a), t(b)).numpy()
    h, ref = np.zeros((2, W)), np.zeros((2, S, W))
    for i in range(S):
        h = a[:, i].astype(np.float64) * h + b[:, i]
        ref[:, i] = h
    ulp = np.spacing(np.float32(np.abs(ref).max()))
    assert np.abs(got - want).max() <= 4 * ulp
    assert (got == want).mean() > 0.9
    assert np.abs(got - ref).max() <= 4 * ulp
    assert np.abs(want - ref).max() <= 4 * ulp
