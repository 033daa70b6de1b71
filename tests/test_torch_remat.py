"""Remat, ``param_dtype`` decode caches and ``flash_decode`` over a mesh,
against the JAX package at reduced width.

* **remat** (``ModelConfig.remat``, the reference's ``jax.checkpoint`` of a
  layer body, a whole period of a patterned stack, the MoE stack's body):
  the loss pair and its gradient on the flat buffer with remat on equal
  those with it off bit for bit on the CPU (the recomputed forward is the
  same arithmetic); both equal the reference's (remat on by default)
  within ``test_torch_families.py``'s tolerances: f and g rtol 1e-5, the
  gradient rtol 1e-4 / atol 1e-6.  A fused round (the eval's graph kept,
  one backward seeded twice) and a separate-eval round with remat on
  equal them with remat off, bit for bit.
* **param_dtype** (the giants' bf16): ``init_decode_cache`` has the
  reference's dtypes and shapes.  Four decode steps from it with the
  weights in bf16 in both packages (the dry run's dtypes; the reference
  cannot write float32 keys into a bf16 cache) agree within 5% of the
  largest logit: bf16 keeps 8 significant bits (a relative rounding of
  2^-9 per operation), and the two packages round at different points (XLA
  fuses, PyTorch rounds every op's output) through every layer and step.
  The moe archs' router is zeroed there, so that every route is a tie
  broken by index in both packages: in bf16, near-ties of the router's
  probabilities flip routes between the two roundings.
  With float32 weights the port reads the bf16 cache in float32 (bf16
  storage only); its decode then agrees with the reference's float32
  decode within 2% of the largest logit (each cached key and value is
  rounded to 2^-9 relative).
* **flash_decode over a mesh**: the reference's ``shard_map`` on a
  4-device host mesh (a subprocess with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=4``) against the
  port's 4-way length split of the cache, rtol 2e-5, atol 2e-6 (as the
  unsharded test).
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

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
from repro_torch.comm import flat
from repro_torch.configs.base import (CompressorConfig, FedConfig,
                                      SwitchConfig)
from repro_torch.engine import rounds
from repro_torch.launch import mesh
from repro_torch.models import build, flash_decode, params_from_numpy
from repro_torch.sharding import partition
from repro_torch.tasks import lm
from test_torch_families import _batch, _setup
from torch_port_util import n, one_thread, t  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = pathlib.Path(__file__).resolve().parents[1]
SEQ = 64
# (id, arch, config changes): every remat site -- the homogeneous stack,
# whole periods plus a rest layer (gemma3 at 7 layers, ratio 2; griffin at
# 4 layers), mamba2's layer body, the MoE stack after its dense layer
REMAT_CASES = [("smollm", "smollm-360m", {}),
               ("gemma3-7L", "gemma3-4b", {"n_layers": 7}),
               ("mamba2", "mamba2-130m", {}),
               ("griffin-4L", "recurrentgemma-2b", {"n_layers": 4}),
               ("deepseek-v2", "deepseek-v2-236b", {})]
GIANTS = ["deepseek-v2-236b", "deepseek-v3-671b", "llama-3.2-vision-90b"]


def _pair(cfg, jax_side=False):
    b = build(cfg) if not jax_side else jax_build(cfg)
    mk = lm.make_loss_pair if not jax_side else jax_lm.make_loss_pair
    return mk(b.forward, cfg, budget=6.0, aux_constraint=cfg.moe is not None)


@pytest.mark.parametrize("case", REMAT_CASES, ids=lambda c: c[0])
def test_remat_gradients_bit_equal_and_match_reference(case):
    _, arch, over = case
    jcfg, cfg, jparams, params = _setup(arch, over)
    assert cfg.remat and jcfg.remat
    toks, mask = _batch(0, SEQ, cfg.vocab)
    batch = lm.LMBatch(t(toks), t(mask))
    spec = flat.spec_of(params)
    got = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        w = flat.flatten(spec, params).requires_grad_(True)
        f, g = _pair(c)(flat.unflatten(spec, w), batch)
        (gf,) = torch.autograd.grad(f, w, retain_graph=True)
        (gg,) = torch.autograd.grad(g, w, allow_unused=True)
        got[remat] = (f.detach(), g.detach(), gf,
                      torch.zeros_like(gf) if gg is None else gg)
    for a, b in zip(got[True], got[False]):
        assert torch.equal(a, b)

    jpair = _pair(jcfg, jax_side=True)
    jbatch = jax_lm.LMBatch(jnp.asarray(toks), jnp.asarray(mask))
    (jf, jg), jgrad = jax.jit(jax.value_and_grad(
        lambda q: jpair(q, jbatch), has_aux=True))(jparams)
    f, g, gf, _ = got[True]
    np.testing.assert_allclose([f.item(), g.item() + 6.0],
                               [float(jf), float(jg) + 6.0], rtol=1e-5)
    jw = np.asarray(jax_flat.flatten(jax_flat.spec_of(jgrad), jgrad))
    np.testing.assert_allclose(n(gf), jw, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("m", [2, 1], ids=["fused", "separate-eval"])
def test_round_with_remat_equals_without(m):
    """Reduced smollm, 2 clients, two rounds on the packed top-k wire: w,
    the residual and the metrics with remat on equal those with it off."""
    _, cfg, _, params = _setup("smollm-360m", {})
    cc = CompressorConfig(kind="topk", ratio=0.1)
    fed = FedConfig(n_clients=2, m=m, lr=0.03, comm="packed",
                    switch=SwitchConfig(mode="soft", eps=0.0, beta=2.0),
                    uplink=cc, downlink=cc)
    toks, mask = _batch(1, SEQ, cfg.vocab, lead=(2,))
    batch = lm.LMBatch(t(toks), t(mask))
    out = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        state = rounds.init_state(params, fed, device="cpu")
        mets = []
        for _ in range(2):
            state, met = rounds.round_step(state, batch, _pair(c), fed,
                                           device="cpu")
            mets.append(met)
        out[remat] = (state, mets)
    (s1, m1), (s0, m0) = out[True], out[False]
    assert torch.equal(s1.w, s0.w) and torch.equal(s1.e_up, s0.e_up)
    for a, b in zip(m1, m0):
        for x, y in zip(a[:-1], b[:-1]):
            assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# param_dtype: the giants' bf16 decode caches
# ---------------------------------------------------------------------------

def _leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _bf16(x):
    return x.to(torch.bfloat16) if x.dtype == torch.float32 else x


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _zero_router(tree):
    if isinstance(tree, dict):
        return {k: np.zeros_like(v) if k == "router" else _zero_router(v)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zero_router(v) for v in tree)
    return tree


def _init_cache(fns, cfg, B, L, params, jax_side):
    if jax_side and cfg.family == "moe":
        return fns.init_decode_cache(cfg, B, L)   # no params argument
    return fns.init_decode_cache(cfg, B, L, params=params)


@pytest.mark.parametrize("arch", GIANTS)
def test_bf16_caches_and_decode_match_reference(arch):
    jcfg, cfg = jax_configs.get_reduced(arch), configs.get_reduced(arch)
    assert cfg.param_dtype == jcfg.param_dtype == "bfloat16"
    jfns, fns = jax_build(jcfg), build(cfg)
    npp = jax.device_get(jfns.init(jax.random.PRNGKey(0), jcfg))
    B, L, steps = 2, 16, 4
    jcache = _init_cache(jfns, jcfg, B, L, None, True)
    cache = fns.init_decode_cache(cfg, B, L, device="cpu")
    want = [(tuple(x.shape), str(x.dtype)) for x in _leaves(jcache)]
    assert [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for x in _leaves(cache)] == want
    assert {d for _, d in want} == {"bfloat16"}

    toks = np.random.default_rng(3).integers(0, cfg.vocab, (steps, B, 1),
                                             dtype=np.int32)
    # bf16 weights in both packages; a zero router (the moe archs) makes
    # every route a tie that both packages break by index: bf16's
    # near-ties otherwise flip routes between the two packages' roundings,
    # a discrete change no storage tolerance covers (the float32 check
    # below keeps the drawn router)
    np16 = _zero_router(npp)
    jp16 = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x).astype(jnp.bfloat16)
        if x.dtype == np.float32 else jnp.asarray(x), np16)
    p16 = _tree_map(_bf16, params_from_numpy(np16))
    # float32 weights: the reference on a float32 cache, the port on bf16
    f32cfg = dataclasses.replace(jcfg, param_dtype="float32")
    jp32, p32 = npp, params_from_numpy(npp)
    jc32 = _init_cache(jfns, f32cfg, B, L, None, True)
    with torch.inference_mode():
        c16 = fns.init_decode_cache(cfg, B, L, device="cpu")
        for pos in range(steps):
            jl, jcache = jfns.decode_step(jp16, jcfg, jnp.asarray(toks[pos]),
                                          jcache, pos)
            pl, c16 = fns.decode_step(p16, cfg, t(toks[pos]), c16, pos)
            a, b = np.asarray(jl.astype(jnp.float32)), n(pl.float())
            assert pl.dtype == torch.bfloat16
            assert np.abs(a - b).max() <= 0.05 * np.abs(a).max()

            jl32, jc32 = jfns.decode_step(jp32, f32cfg,
                                          jnp.asarray(toks[pos]), jc32, pos)
            pl32, cache = fns.decode_step(p32, cfg, t(toks[pos]), cache, pos)
            a, b = np.asarray(jl32), n(pl32)
            assert pl32.dtype == torch.float32
            assert np.abs(a - b).max() <= 0.02 * np.abs(a).max()
    assert {x.dtype for x in _leaves(cache)} == {torch.bfloat16}


def test_float32_configs_keep_float32_caches():
    for arch in ("smollm-360m", "gemma3-4b", "qwen3-4b"):
        cfg = configs.get_reduced(arch)
        cache = build(cfg).init_decode_cache(cfg, 2, 8, device="cpu")
        assert {x.dtype for x in _leaves(cache)} == {torch.float32}


# ---------------------------------------------------------------------------
# flash_decode over a 4-way model axis
# ---------------------------------------------------------------------------

_REFERENCE = """
import sys
import numpy as np
import jax
from repro.models import flash_decode
z = np.load(sys.argv[1])
mesh = jax.make_mesh((4,), ("model",))
out = flash_decode.flash_decode_attend(z["q"], z["k"], z["v"], z["valid"],
                                       mesh=mesh, axis="model")
np.save(sys.argv[2], np.asarray(out))
"""


@pytest.mark.parametrize("pos", [5, 27], ids=["shards-empty", "all-shards"])
def test_flash_decode_over_a_mesh_matches_reference(pos, tmp_path):
    """B 2, 8 heads over 2 KV heads, hd 16, a 32-slot cache split 4 ways;
    at pos 5 three shards hold no valid slot (their max is -inf)."""
    rng = np.random.default_rng(pos)
    q = rng.standard_normal((2, 1, 8, 16)).astype(np.float32)
    k = rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
    valid = np.arange(32) <= pos
    np.savez(tmp_path / "in.npz", q=q, k=k, v=v, valid=valid)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    subprocess.run([sys.executable, "-c", _REFERENCE,
                    str(tmp_path / "in.npz"), str(tmp_path / "out.npy")],
                   env=env, check=True, timeout=300)
    want = np.load(tmp_path / "out.npy")
    m = mesh.make_debug_mesh((4,), ("model",))
    got = flash_decode.flash_decode_attend(t(q), t(k), t(v), t(valid),
                                           mesh=m)
    np.testing.assert_allclose(n(got), want, rtol=2e-5, atol=2e-6)
    dense = flash_decode.flash_decode_attend(t(q), t(k), t(v), t(valid))
    np.testing.assert_allclose(n(got), n(dense), rtol=2e-5, atol=2e-6)
    # the active mesh is read when none is passed
    partition.activate_mesh(m)
    try:
        again = flash_decode.flash_decode_attend(t(q), t(k), t(v), t(valid))
    finally:
        partition.activate_mesh(None)
    assert torch.equal(again, got)

