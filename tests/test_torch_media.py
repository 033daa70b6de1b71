"""The vlm and audio families against the JAX package: the patterned
transformer's cross-attention layers over projected media tokens
(llama-3.2-vision-90b) and the whisper encoder-decoder (whisper-small),
at reduced width, from the reference's own weights (``init`` then
``jax.device_get``) and the same numpy tokens and media.

The cross-attention gate starts at 0, so a forward from the reference's
init adds nothing through the cross layers: the parity cases set every
gate to the same nonzero values in both packages first.  The reduced vlm
keeps ``d_media`` 8192 over ``d_model`` 128, so ``media_proj`` runs.
Whisper's decoder runs at seq 64 with its own ``max_target_len`` and at
48, where the learned positions wrap (``arange(S) % max_target_len``).

Tolerances and why:

* tree paths, shapes, ``n_params`` and the flat and wire layouts: equal
  (the configs field for field: ``test_torch_families.py``);
* attention pieces, encoder states, logits, f and g: rtol 1e-5 (float32
  matmuls and reductions associate differently in XLA and PyTorch), with
  atol 1e-6 on the attention pieces and 1e-5 on the logits, whose entries
  pass through zero;
* gradients on the flat buffer and of the cross layers' wq, wk, wv, wo
  and gate: rtol 1e-4, atol 1e-6 (the backward adds more terms in a free
  order; entries that cancel to near zero keep an absolute error of a few
  1e-7);
* init laws (the port draws its own weights): zeros exact; the 0.02 and
  fan-in scales within 5% of their std over at least 50,000 draws.

Two whole rounds per family are in ``test_torch_media_rounds.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.comm import flat as jax_flat
from repro.configs.base import CompressorConfig as JCompressorConfig
from repro.models import attention as jax_attention
from repro.models import build as jax_build
from repro.models import whisper as jax_whisper
from repro.tasks import lm as jax_lm
from repro_torch import configs
from repro_torch.comm import flat
from repro_torch.configs.base import CompressorConfig, FedConfig
from repro_torch.engine import participation, rounds
from repro_torch.fleet import partitions
from repro_torch.launch import train
from repro_torch.models import (attention, build, common, params_from_numpy,
                                whisper)
from repro_torch.tasks import lm
from test_torch_families import _jax_paths
from torch_port_util import assert_bits_equal, one_thread, t  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ARCHS = ["llama-3.2-vision-90b", "whisper-small"]
BATCH = 2
GATES = np.array([0.5, -0.3], np.float32)     # the reduced vlm's 2 cross layers
# (id, arch, config changes, seq)
CASES = [("vlm", "llama-3.2-vision-90b", {}, 64),
         ("whisper", "whisper-small", {}, 64),
         ("whisper-wrap", "whisper-small", {"max_target_len": 48}, 64)]


def _media_width(cfg):
    return cfg.n_media_tokens or cfg.n_audio_frames, cfg.d_media or \
        cfg.d_model


def media_setup(arch, over=None):
    """Both packages' reduced configs and the reference's weights (as numpy
    and as the port's tensors), the vlm's gates set to :data:`GATES`."""
    over = over or {}
    jcfg = dataclasses.replace(jax_configs.get_reduced(arch), **over)
    cfg = dataclasses.replace(configs.get_reduced(arch), **over)
    jparams = jax.device_get(jax_build(jcfg).init(jax.random.PRNGKey(0),
                                                  jcfg))
    if cfg.family == "vlm":
        jparams["blocks"][1]["attn"]["gate"] = GATES.copy()
    return jcfg, cfg, jparams, params_from_numpy(jparams)


def media_batch(seed, cfg, seq, lead=()):
    """Tokens, minority mask (the last 4 positions) and media ``* 0.02``."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=lead + (BATCH, seq),
                        dtype=np.int32)
    mask = np.zeros(lead + (BATCH, seq), np.float32)
    mask[..., -4:] = 1.0
    media = (rng.standard_normal(lead + (BATCH,) + _media_width(cfg))
             * 0.02).astype(np.float32)
    return toks, mask, media


# ---------------------------------------------------------------------------
# configs, trees, layouts, init
# ---------------------------------------------------------------------------

# the full-width cells of chip_smoke.py's phase 16: (arch, config changes,
# parameters)
CELLS = [("llama-3.2-vision-90b",
          {"n_layers": 1, "cross_attn_every": 1, "vocab": 16_032},
          1_118_330_881),
         ("whisper-small", {}, 239_649_036)]


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: c[0])
def test_full_width_layout_matches_reference(cell):
    """The phase-16 cells at their published widths, shapes only: the tree
    paths, ``FlatSpec`` and the top-k and quant ``WireLayout`` equal the
    reference's under ``jax.eval_shape`` (the vlm's stacked ``gate`` of
    shape ``(1,)`` is a run of block 1 of its own), d is the count the
    cell is sized by, and ``n_params`` the reference's (its analytic
    count, which counts the vlm's cross layer on top of a self layer)."""
    arch, over, d = cell
    jcfg = dataclasses.replace(jax_configs.get_config(arch), **over)
    cfg = dataclasses.replace(configs.get_config(arch), **over)
    assert cfg.n_params() == jcfg.n_params()
    if cfg.family == "vlm":
        assert cfg.n_params() == 2_091_384_832
    jshapes = jax.eval_shape(lambda k: jax_build(jcfg).init(k, jcfg),
                             jax.random.PRNGKey(0))
    jspec = jax_flat.spec_of(jshapes)
    spec = flat.spec_of(common.meta_tree(build(cfg).param_shapes(cfg)))
    assert list(spec.paths) == _jax_paths(jshapes)
    assert [(l.shape, l.offset, l.size) for l in spec.leaves] == \
        [(l.shape, l.offset, l.size) for l in jspec.leaves]
    assert spec.d == jspec.d == d
    for kind in ("topk", "quant"):
        want = jax_flat.wire_layout(jspec, JCompressorConfig(kind=kind))
        got = flat.wire_layout(spec, CompressorConfig(kind=kind))
        assert [tuple(r) for r in got.runs] == [tuple(r) for r in want.runs]
        assert (got.K_total, got.NB_total, got.W_total) == \
            (want.K_total, want.NB_total, want.W_total)
    if cfg.family == "vlm":
        i = spec.paths.index(("blocks", 0, "attn", "gate"))
        assert spec.leaves[i].shape == (1,)
        assert 1 in [r.block for r in got.runs]


@pytest.mark.parametrize("arch", ARCHS)
def test_tree_matches_reference(arch):
    """Paths in ``jax.tree_util``'s order and shapes: the port's
    ``param_shapes`` and ``init`` lay out the reference's tree, and
    ``params_from_numpy`` takes it as it is."""
    _, cfg, jparams, params = media_setup(arch)
    spec = flat.spec_of(params)
    assert list(spec.paths) == _jax_paths(jparams)
    shapes = build(cfg).param_shapes(cfg)
    assert flat.spec_of(common.meta_tree(shapes)).leaves == spec.leaves
    mine = build(cfg).init(torch.Generator().manual_seed(0), cfg)
    assert flat.spec_of(mine).leaves == spec.leaves
    if cfg.family == "vlm":
        assert params["media_proj"].shape == (cfg.d_media, cfg.d_model)
        assert params["blocks"][1]["attn"]["gate"].shape == (2,)
        assert "gate" not in params["blocks"][0]["attn"]
    else:
        assert params["decoder"]["xattn"]["gate"].shape == (cfg.n_layers,)
        assert "xattn" not in params["encoder"]


def _leaves_named(tree, names, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_named(v, names, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves_named(v, names, path + (i,))
    elif path[-1] in names:
        yield path, tree


@pytest.mark.parametrize("arch", ARCHS)
def test_init_laws(arch):
    """The port's init: gates, biases and the new norm gains zero (a gate
    of shape ``(n,)`` or ``()`` alike), positions 0.02-scaled normals,
    ``media_proj`` and the GELU MLP's weights fan-in scaled."""
    cfg = configs.get_reduced(arch)
    params = build(cfg).init(torch.Generator().manual_seed(0), cfg)
    zeros = list(_leaves_named(params, {"gate", "b_in", "b_out", "ln_x",
                                        "ln_mlp", "ln_enc", "ln1", "ln2"}))
    assert any(p[-1] == "gate" for p, _ in zeros)
    for path, leaf in zeros:
        assert torch.equal(leaf, torch.zeros_like(leaf)), path
    gate = attention.init_cross_attn(torch.Generator().manual_seed(0), 8, 8,
                                     2, 1, 4)["gate"]
    assert gate.shape == () and float(gate) == 0.0
    scaled = {"pos_emb_dec": 0.02, "pos_emb_enc": 0.02, "embed": 0.02,
              "media_proj": cfg.d_media ** -0.5 if cfg.d_media else None,
              "w_in": cfg.d_model ** -0.5, "w_out": cfg.d_ff ** -0.5}
    seen = set()
    for path, leaf in _leaves_named(params, set(scaled)):
        seen.add(path[-1])
        std = float(leaf.std())
        assert abs(std / scaled[path[-1]] - 1) < 0.05, (path, std)
    assert seen == ({"embed", "media_proj"} if cfg.family == "vlm" else
                    {"embed", "pos_emb_dec", "pos_emb_enc", "w_in",
                     "w_out"})


# ---------------------------------------------------------------------------
# attention pieces
# ---------------------------------------------------------------------------

H, KV, HD, D, DKV = 4, 2, 8, 24, 40


def _cross_params(rng):
    p = {"wq": rng.standard_normal((D, H * HD)) / np.sqrt(D),
         "wk": rng.standard_normal((DKV, KV * HD)) / np.sqrt(DKV),
         "wv": rng.standard_normal((DKV, KV * HD)) / np.sqrt(DKV),
         "wo": rng.standard_normal((H * HD, D)) / np.sqrt(H * HD),
         "gate": np.asarray(0.7)}
    return {k: v.astype(np.float32) for k, v in p.items()}


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("gated", [True, False], ids=["gated", "ungated"])
def test_cross_attention_matches_reference(gated):
    """``cross_kv`` and ``cross_attention`` (``tanh(gate)`` at gate 0.7, or
    ungated) on 13 queries over 11 media positions of another width."""
    rng = np.random.default_rng(3)
    p = _cross_params(rng)
    x = rng.standard_normal((2, 13, D)).astype(np.float32)
    media = rng.standard_normal((2, 11, DKV)).astype(np.float32)
    jkv = jax_attention.cross_kv(p, jnp.asarray(media), KV, HD)
    tp = params_from_numpy(p)
    kv = attention.cross_kv(tp, t(media), KV, HD)
    assert kv.k.shape == (2, 11, KV, HD)
    _close(kv.k, jkv.k)
    _close(kv.v, jkv.v)
    want = jax_attention.cross_attention(p, jnp.asarray(x), jkv, n_heads=H,
                                         head_dim=HD, gated=gated)
    got = attention.cross_attention(tp, t(x), kv, n_heads=H, head_dim=HD,
                                    gated=gated)
    _close(got, want)
    ungated = attention.cross_attention(tp, t(x), kv, n_heads=H,
                                        head_dim=HD, gated=False)
    if gated:
        _close(got, np.tanh(0.7) * ungated.numpy())


def test_bidir_attention_matches_reference():
    rng = np.random.default_rng(4)
    p = _cross_params(rng)
    p["wk"] = p["wk"][:D]
    p["wv"] = p["wv"][:D]
    x = rng.standard_normal((2, 17, D)).astype(np.float32)
    want = jax_attention.bidir_attention(p, jnp.asarray(x), n_heads=H,
                                         n_kv=KV, head_dim=HD)
    got = attention.bidir_attention(params_from_numpy(p), t(x), n_heads=H,
                                    n_kv=KV, head_dim=HD)
    _close(got, want)
    # no mask: the first position sees the last (a causal pass would not)
    x2 = x.copy()
    x2[:, -1] += 1.0
    moved = attention.bidir_attention(params_from_numpy(p), t(x2),
                                      n_heads=H, n_kv=KV, head_dim=HD)
    assert not torch.allclose(moved[:, 0], got[:, 0])


# ---------------------------------------------------------------------------
# forwards, loss pairs and gradients
# ---------------------------------------------------------------------------

def test_whisper_encode_matches_reference(one_thread):
    jcfg, cfg, jparams, params = media_setup("whisper-small")
    _, _, media = media_batch(5, cfg, 8)
    want = jax.jit(lambda p, m: jax_whisper.encode(p, jcfg, m))(
        jparams, jnp.asarray(media))
    got = whisper.encode(params, cfg, t(media))
    assert got.shape == media.shape
    _close(got, want, atol=1e-5)


def _cross_grads(cfg, tree):
    """The cross layers' attention leaves."""
    attn = tree["blocks"][1]["attn"] if cfg.family == "vlm" else \
        tree["decoder"]["xattn"]
    return {k: attn[k] for k in ("wq", "wk", "wv", "wo", "gate")}


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_forward_loss_and_grad_match_reference(case, one_thread):
    """Logits, the loss pair (f, g) and the gradient of f: on the whole
    flat buffer, and of the cross layers' wq, wk, wv, wo and gate (for
    whisper the gate's is 0 in both: the decoder reads no gate)."""
    _, arch, over, seq = case
    jcfg, cfg, jparams, params = media_setup(arch, over)
    jfns, fns = jax_build(jcfg), build(cfg)
    toks, mask, media = media_batch(0, cfg, seq)
    jpair = jax_lm.make_loss_pair(jfns.forward, jcfg, budget=6.0)
    pair = lm.make_loss_pair(fns.forward, cfg, budget=6.0)

    @jax.jit
    def reference(p, batch):
        logits = jfns.forward(p, jcfg, batch.tokens, media=batch.media)
        return logits, jax.value_and_grad(lambda q: jpair(q, batch),
                                          has_aux=True)(p)
    want, ((jf, jg), jgrad) = reference(
        jparams, jax_lm.LMBatch(jnp.asarray(toks), jnp.asarray(mask),
                                jnp.asarray(media)))
    got = fns.forward(params, cfg, t(toks), media=t(media))
    assert got.shape == (BATCH, seq, cfg.vocab)
    _close(got, want, atol=1e-5)

    spec = flat.spec_of(params)
    w = flat.flatten(spec, params).requires_grad_(True)
    f, g = pair(flat.unflatten(spec, w),
                lm.LMBatch(t(toks), t(mask), t(media)))
    np.testing.assert_allclose([f.item(), g.item()], [float(jf), float(jg)],
                               rtol=1e-5)
    f.backward()
    jw = np.asarray(jax_flat.flatten(jax_flat.spec_of(jgrad), jgrad))
    assert np.isfinite(w.grad.numpy()).all()
    np.testing.assert_allclose(w.grad.numpy(), jw, rtol=1e-4, atol=1e-6)
    grads = _cross_grads(cfg, flat.unflatten(spec, w.grad))
    jgrads = _cross_grads(cfg, jax.device_get(jgrad))
    for k in grads:
        _close(grads[k], jgrads[k], rtol=1e-4)
        if cfg.family == "vlm" or k != "gate":
            assert float(grads[k].abs().max()) > 0, k
    if cfg.family == "audio":
        assert float(grads["gate"].abs().max()) == 0.0


def test_vlm_gate_and_media_reach_the_logits(one_thread):
    """At the reference's init (gate 0) the cross layers add exactly
    nothing and the media cannot move the logits; at a nonzero gate they
    do."""
    jcfg = jax_configs.get_reduced("llama-3.2-vision-90b")
    cfg = configs.get_reduced("llama-3.2-vision-90b")
    zero = params_from_numpy(jax.device_get(
        jax_build(jcfg).init(jax.random.PRNGKey(0), jcfg)))
    _, _, _, gated = media_setup("llama-3.2-vision-90b")
    toks, _, media = media_batch(1, cfg, 16)
    other = media_batch(2, cfg, 16)[2]
    fwd = build(cfg).forward
    assert torch.equal(fwd(zero, cfg, t(toks), media=t(media)),
                       fwd(zero, cfg, t(toks), media=t(other)))
    assert not torch.allclose(fwd(gated, cfg, t(toks), media=t(media)),
                              fwd(gated, cfg, t(toks), media=t(other)))


# ---------------------------------------------------------------------------
# batches with a None field, and media batches through the engine
# ---------------------------------------------------------------------------

def test_leaves_of_and_rebuild_keep_none():
    toks, mask = torch.zeros(3, 2, 4), torch.ones(3, 2, 4)
    b = lm.LMBatch(toks, mask)
    assert b.media is None
    assert partitions.leaves_of(b) == [toks, mask]
    back = partitions.rebuild(b, [toks + 1, mask + 1])
    assert isinstance(back, lm.LMBatch) and back.media is None
    assert torch.equal(back.tokens, toks + 1)
    media = torch.arange(3.0)[:, None, None, None].expand(3, 2, 5, 6)
    full = lm.LMBatch(toks, mask, media)
    assert len(partitions.leaves_of(full)) == 3
    tup = (toks, None, mask)
    assert partitions.leaves_of(tup) == [toks, mask]
    back = partitions.rebuild(tup, [mask, toks])
    assert back[1] is None and back[0] is mask and back[2] is toks
    assert partitions.rebuild(toks, [mask]) is mask
    one = rounds.client_batch(full, 2)
    assert torch.equal(one.media, media[2])
    assert rounds.client_batch(b, 1).media is None
    assert rounds.n_rows(b) == 3


def test_gather_selects_rows_of_every_field():
    """``participation.gather`` on a media batch takes the sampled rows of
    tokens, mask and media; on a token-only batch media stays None."""
    n = 4
    fed = FedConfig(n_clients=n, m=2, participation="gather")
    mask = torch.tensor([0.0, 1.0, 0.0, 1.0])
    part = participation.finalize(mask, mask, fed)
    rows = torch.arange(float(n))
    batch = lm.LMBatch(rows[:, None, None].expand(n, 2, 3).long(),
                       rows[:, None, None].expand(n, 2, 3),
                       rows[:, None, None, None].expand(n, 2, 5, 6))
    got = participation.gather(part, batch)
    for leaf in got:
        assert leaf.shape[0] == 2
        assert leaf.reshape(2, -1)[:, 0].tolist() == [1.0, 3.0]
    assert participation.gather(part, batch._replace(media=None)).media \
        is None


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_runs_each_arch_reduced_on_cpu(arch, one_thread):
    """``--arch <name> --reduced --device cpu``: the launcher's setup draws
    each round's media with its tokens (``[n, B, M, d_media or d]``,
    normal * 0.02, on the CPU generator), then 2 rounds of ``run_rounds``
    on the pallas wire (4 clients, 2 sampled, gather); f and g_hat finite,
    w moved."""
    args = train.parser().parse_args(
        ["--arch", arch, "--reduced", "--device", "cpu", "--seq", "16",
         "--clients", "4", "--participating", "2", "--participation",
         "gather", "--comm", "pallas"])
    state, batch_fn, loss_pair, fed, cfg, dev = train.setup(args)
    assert cfg == configs.get_reduced(arch) and dev.type == "cpu"
    b = batch_fn(0, torch.Generator().manual_seed(1))
    assert b.media.shape == (4, 2) + _media_width(cfg)
    assert abs(float(b.media.std()) / 0.02 - 1) < 0.05
    assert_bits_equal(b.media,
                      batch_fn(0, torch.Generator().manual_seed(1)).media)
    w0 = state.w.clone()
    state, hist = rounds.run_rounds(state, batch_fn, loss_pair, fed, T=2,
                                    device=dev)
    assert np.isfinite(hist.f).all() and np.isfinite(hist.g_hat).all()
    assert not torch.equal(state.w, w0)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_fleet_refuses_media_archs(arch):
    args = train.parser().parse_args(["--arch", arch, "--reduced",
                                      "--device", "cpu", "--fleet"])
    with pytest.raises(SystemExit, match="--fleet does not support"):
        train.setup(args)
