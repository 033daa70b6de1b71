"""Serving of the dense and vlm families against the JAX package: the KV
cache pieces of ``models.attention``, ``models.flash_decode``, and
``prefill`` / ``decode_step`` / ``init_decode_cache`` of
``models.transformer`` at the reduced configs of smollm-360m, qwen3-4b,
minitron-4b, gemma3-4b and llama-3.2-vision-90b (``init_decode_cache`` of
every family's), from the reference's own
weights (``init`` then ``jax.device_get``; the vlm's gates set to 0.5, as
at 0 a cross layer adds nothing) and the same numpy tokens and media.
The reference's calls are jitted, as its launcher jits them.

Tolerances and why:

* ``causal_bias``: bit for bit (a mask of 0 and -1e30);
* attention outputs, caches, logits: rtol 1e-5, atol 1e-5 (float32
  matmuls and the softmax associate differently in XLA and PyTorch; the
  observed error is a few 1e-6 on logits of magnitude 1-5; the windowed
  cases reach 40 decode steps, each fed the same tokens in both
  packages);
* ``flash_decode_attend``: rtol 2e-5, atol 2e-6 (the reference test's
  shapes; its own tolerance against dense attention is 2e-4).

The windowed departure (ROADMAP Queue 3): a sliding-window layer's decode
attends the positions the forward attends, ``(pos - window, pos]``.  The
reference's ring attends every written slot (``window + 1`` of them, or
the whole prompt when it is longer than ``window + 1``), so its decode
leaves its own forward from ``pos = window`` on.  The tests show both.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import attention as jax_attention
from repro.models import build as jax_build
from repro.models import flash_decode as jax_flash
from repro_torch import configs
from repro_torch.examples import serve_batched
from repro_torch.launch import mesh, serve
from repro_torch.models import attention, build, flash_decode, transformer
from repro_torch.models import params_from_numpy
from torch_port_util import n, t

SERVE_ARCHS = ["smollm-360m", "qwen3-4b", "minitron-4b", "gemma3-4b",
               "llama-3.2-vision-90b"]
STATE_ARCHS = ["mamba2-130m", "recurrentgemma-2b", "deepseek-v2-236b",
               "deepseek-v3-671b", "whisper-small"]
TOL = dict(rtol=1e-5, atol=1e-5)
BATCH = 2


@pytest.fixture(autouse=True)
def one_thread():
    # small shapes: one intra-op thread beats contending with the other
    # test workers for the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, **tol):
    np.testing.assert_allclose(n(got), np.asarray(want), **(tol or TOL))


def _gates(tree, value=0.5):
    """The reference's weights with every cross-attention gate set."""
    if isinstance(tree, dict):
        return {k: (np.full_like(v, value) if k == "gate" else _gates(v))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_gates(v) for v in tree]
    return tree


def _replace(cfg, over):
    """``dataclasses.replace`` with ``over``; its ``capacity_factor`` goes
    to the MoE config."""
    over = dict(over)
    if "capacity_factor" in over:
        over["moe"] = dataclasses.replace(
            cfg.moe, capacity_factor=over.pop("capacity_factor"))
    return dataclasses.replace(cfg, **over)


def _setup(arch, **over):
    jcfg = _replace(jax_configs.get_reduced(arch), over)
    cfg = _replace(configs.get_reduced(arch), over)
    jparams = _gates(jax.device_get(
        jax_build(jcfg).init(jax.random.PRNGKey(0), jcfg)))
    return jcfg, cfg, jparams, params_from_numpy(jparams)


def _media(cfg, seed=3):
    """The vlm's media tokens or whisper's frames (``normal * 0.1``);
    None for a token-only family."""
    if cfg.family not in ("vlm", "audio"):
        return None
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((BATCH, cfg.n_media_tokens
                                 or cfg.n_audio_frames,
                                 cfg.d_media or cfg.d_model)) * 0.1
            ).astype(np.float32)


def _tokens(cfg, length, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(BATCH, length), dtype=np.int32)


def _paths(tree):
    """Each leaf's key path (dict keys, list / tuple indices, NamedTuple
    fields by index) and array: the trees of both packages flatten alike,
    None dropped."""
    return [(tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p), x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _assert_same_tree(got, want, values=True):
    """Same paths, shapes and dtypes (the giants' bf16 caches included);
    values compared in float32."""
    g, w = _paths(got), _paths(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert tuple(a.shape) == tuple(b.shape), path
        assert str(a.dtype).replace("torch.", "") == str(b.dtype), path
        if values:
            _close(a.float(), np.asarray(b).astype(np.float32))


class _Serve:
    """One arch in both packages: the reference's jitted prefill, decode
    and forward beside the port's."""

    def __init__(self, arch, **over):
        self.jcfg, self.cfg, self.jp, self.p = _setup(arch, **over)
        self.jf, self.f = jax_build(self.jcfg), build(self.cfg)
        media = _media(self.cfg)
        self.jkw = {} if media is None else {"media": jnp.asarray(media)}
        self.kw = {} if media is None else {"media": t(media)}

    def ref_prefill(self, toks, cap):
        return jax.jit(lambda p, x: self.jf.prefill(
            p, self.jcfg, x, cap, **self.jkw))(self.jp, toks)

    def ref_decoder(self):
        return jax.jit(lambda p, tok, c, i: self.jf.decode_step(
            p, self.jcfg, tok, c, i))

    def ref_forward(self, toks):
        return np.asarray(jax.jit(lambda p, x: self.jf.forward(
            p, self.jcfg, x, **self.jkw))(self.jp, toks))

    def prefill(self, toks, cap):
        with torch.inference_mode():
            return self.f.prefill(self.p, self.cfg, t(toks, torch.int64),
                                  cap, **self.kw)

    def decode(self, tok, cache, pos):
        with torch.inference_mode():
            return self.f.decode_step(self.p, self.cfg, t(tok, torch.int64),
                                      cache, pos)


# ---------------------------------------------------------------------------
# attention pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 3])
def test_causal_bias_kv_valid_bit_equal(window):
    """``causal_bias(q_pos, kv_pos, window, kv_valid)`` is the
    reference's, bit for bit."""
    valid = np.array([True, False, True, True, True, False, True, True])
    q_pos, kv_pos = np.arange(3, 8), np.arange(8)
    want = jax_attention.causal_bias(jnp.asarray(q_pos), jnp.asarray(kv_pos),
                                     window, jnp.asarray(valid))
    got = attention.causal_bias(t(q_pos), t(kv_pos), window, t(valid))
    assert got.shape == want.shape
    np.testing.assert_array_equal(n(got), np.asarray(want))


ATTN = dict(n_heads=4, n_kv=2, head_dim=8, theta=10_000.0, qk_norm=True,
            norm_eps=1e-6)


def _attn_params(d=16):
    rng = np.random.default_rng(5)
    p = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in attention.attn_shapes(d, 4, 2, 8, True).items()}
    p["q_norm"] = (0.1 * rng.standard_normal(8)).astype(np.float32)
    p["k_norm"] = (0.1 * rng.standard_normal(8)).astype(np.float32)
    return p, params_from_numpy(p), rng


@pytest.mark.parametrize("window", [0, 3])
def test_prefill_attention_matches_reference(window):
    """The prompt's attention output and its cache padded to
    ``cache_len`` slots (rtol 1e-5)."""
    jp, p, rng = _attn_params()
    x = rng.standard_normal((2, 6, 16)).astype(np.float32)
    out, cache = attention.prefill_attention(
        p, t(x), positions=torch.arange(6), cache_len=9, window=window,
        **ATTN)
    jout, jcache = jax_attention.prefill_attention(
        jp, jnp.asarray(x), positions=jnp.arange(6), cache_len=9,
        window=window, **ATTN)
    _close(out, jout)
    assert isinstance(cache, attention.KVCache)
    assert cache.k.shape == (2, 9, 2, 8)
    _close(cache.k, jcache.k)
    _close(cache.v, jcache.v)


@pytest.mark.parametrize("case", ["default", "ring", "window"])
def test_decode_attention_matches_reference(case):
    """One decode step into a filled cache: the default slot mask; a ring
    write (``write_pos``, ``kv_valid``, ``rope_pos``); a window.  The
    output and the cache after the write (rtol 1e-5); the write is in
    place (the returned cache holds the caller's tensors)."""
    jp, p, rng = _attn_params()
    x = rng.standard_normal((2, 1, 16)).astype(np.float32)
    k = rng.standard_normal((2, 7, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 7, 2, 8)).astype(np.float32)
    kw = {"default": dict(pos=4),
          "ring": dict(pos=9, write_pos=2,
                       kv_valid=np.array([1, 1, 1, 0, 1, 1, 1], bool),
                       rope_pos=9),
          "window": dict(pos=5, window=3)}[case]
    pos = kw.pop("pos")
    jkw = {a: (jnp.asarray(b) if isinstance(b, np.ndarray) else b)
           for a, b in kw.items()}
    tkw = {a: (t(b) if isinstance(b, np.ndarray) else b)
           for a, b in kw.items()}
    jout, jcache = jax_attention.decode_attention(
        jp, jnp.asarray(x), jax_attention.KVCache(jnp.asarray(k),
                                                  jnp.asarray(v)),
        pos, **jkw, **ATTN)
    cache = attention.KVCache(t(k), t(v))
    out, new = attention.decode_attention(p, t(x), cache, pos, **tkw,
                                          **ATTN)
    assert new.k is cache.k and new.v is cache.v
    _close(out, jout)
    _close(new.k, jcache.k)
    _close(new.v, jcache.v)


def test_cross_kv_is_a_kv_cache():
    """``cross_kv`` returns the reference's ``KVCache`` of the media."""
    rng = np.random.default_rng(2)
    shapes = attention.cross_attn_shapes(16, 16, 4, 2, 8)
    jp = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    media = rng.standard_normal((2, 5, 16)).astype(np.float32)
    kv = attention.cross_kv(params_from_numpy(jp), t(media), 2, 8)
    jkv = jax_attention.cross_kv(jp, jnp.asarray(media), 2, 8)
    assert isinstance(kv, attention.KVCache)
    _close(kv.k, jkv.k)
    _close(kv.v, jkv.v)


# ---------------------------------------------------------------------------
# flash_decode
# ---------------------------------------------------------------------------

def _qkv(B, S, H, KV, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, 1, H, hd)).astype(np.float32),
            rng.standard_normal((B, S, KV, hd)).astype(np.float32),
            rng.standard_normal((B, S, KV, hd)).astype(np.float32))


@pytest.mark.parametrize("B,S,H,KV,hd", [(2, 16, 4, 2, 8), (1, 33, 6, 1, 16)])
@pytest.mark.parametrize("valid", ["half", "none"])
def test_flash_decode_matches_reference(B, S, H, KV, hd, valid):
    """``flash_decode_attend`` on the shapes of the reference's test
    (``slot <= S // 2`` valid), and with no valid slot, where both give 0
    (rtol 2e-5, atol 2e-6)."""
    q, k, v = _qkv(B, S, H, KV, hd)
    mask = np.arange(S) <= S // 2 if valid == "half" else np.zeros(S, bool)
    want = jax_flash.flash_decode_attend(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), jnp.asarray(mask))
    got = flash_decode.flash_decode_attend(t(q), t(k), t(v), t(mask))
    _close(got, want, rtol=2e-5, atol=2e-6)
    if valid == "none":
        assert not n(got).any()


def test_partial_attend_matches_reference_with_no_valid_slot():
    """``_partial_attend``'s (m, l, o): m is -inf, l and o 0 where no slot
    is valid, as in the reference."""
    q, k, v = _qkv(1, 8, 2, 1, 4, seed=4)
    qg = q[:, 0].reshape(1, 1, 2, 4)
    for mask in (np.zeros(8, bool), np.arange(8) % 3 == 0):
        want = jax_flash._partial_attend(jnp.asarray(qg), jnp.asarray(k),
                                         jnp.asarray(v), jnp.asarray(mask))
        got = flash_decode._partial_attend(t(qg), t(k), t(v), t(mask))
        for a, b in zip(got, want):
            _close(a, b, rtol=2e-5, atol=2e-6)


def test_flash_decode_refuses_a_mesh():
    """A mesh whose axis does not split the cache length is refused (the
    reference's ``shard_map`` needs equal shards); a mesh without the axis
    takes the dense path, as in the reference.  The sharded path against
    the reference is ``test_torch_remat.py``'s."""
    q, k, v = _qkv(1, 6, 2, 1, 4)
    valid = torch.ones(6, dtype=torch.bool)
    with pytest.raises(ValueError, match="does not split"):
        flash_decode.flash_decode_attend(
            t(q), t(k), t(v), valid, mesh=mesh.make_debug_mesh((4,),
                                                               ("model",)))
    dense = flash_decode.flash_decode_attend(t(q), t(k), t(v), valid)
    other = flash_decode.flash_decode_attend(
        t(q), t(k), t(v), valid, mesh=mesh.make_debug_mesh((2,), ("data",)))
    assert torch.equal(other, dense)


# ---------------------------------------------------------------------------
# prefill, decode, init_decode_cache of the five reduced configs
# ---------------------------------------------------------------------------

PROMPT, STEPS = 6, 8


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """``prefill`` (the last position's logits ``[B, 1, V]`` and every
    cache leaf, on the same tree) then 8 ``decode_step`` calls on the same
    numpy tokens: logits and caches after each (rtol 1e-5, atol 1e-5)."""
    s = _Serve(arch)
    toks = _tokens(s.cfg, PROMPT + STEPS)
    cap = PROMPT + STEPS
    jl, jcache = s.ref_prefill(toks[:, :PROMPT], cap)
    logits, cache = s.prefill(toks[:, :PROMPT], cap)
    assert tuple(logits.shape) == (BATCH, 1, s.cfg.vocab)
    _close(logits, jl)
    _assert_same_tree(cache, jcache)
    decode = s.ref_decoder()
    for i in range(STEPS):
        pos = PROMPT + i
        jl, jcache = decode(s.jp, toks[:, pos:pos + 1], jcache, pos)
        logits, cache = s.decode(toks[:, pos:pos + 1], cache, pos)
        _close(logits, jl)
    _assert_same_tree(cache, jcache)


@pytest.mark.parametrize("with_media", [False, True],
                         ids=["empty", "media"])
@pytest.mark.parametrize("arch", SERVE_ARCHS + STATE_ARCHS)
def test_init_decode_cache_matches_reference(arch, with_media):
    """``init_decode_cache``'s tree and leaf shapes are the reference's
    for every family (ring slots for windowed layers, ``n_media_tokens or
    8`` media slots for cross layers, conv windows and states, MLA
    latents); empty caches are zeros; with media and params the cross
    caches hold the media's keys and values, and whisper's the encoder
    states (rtol 1e-5).  A token-only arch is given no media."""
    s = _Serve(arch)
    media = _media(s.cfg, seed=4) if with_media else None
    jkw = {} if media is None else dict(media=jnp.asarray(media),
                                        params=s.jp)
    kw = {} if media is None else dict(media=t(media), params=s.p)
    want = s.jf.init_decode_cache(s.jcfg, BATCH, 40, **jkw)
    got = s.f.init_decode_cache(s.cfg, BATCH, 40, **kw)
    _assert_same_tree(got, want)
    if media is None:
        assert all(not n(x).any() for _, x in _paths(got))


def test_vlm_init_decode_cache_without_media_uses_8_slots():
    """With ``n_media_tokens`` 0 the cross caches hold 8 slots, as in the
    reference."""
    s = _Serve("llama-3.2-vision-90b", n_media_tokens=0)
    want = s.jf.init_decode_cache(s.jcfg, BATCH, 12)
    got = s.f.init_decode_cache(s.cfg, BATCH, 12)
    _assert_same_tree(got, want)
    assert got.layers["blocks"][1].k.shape[2] == 8


def test_decode_from_init_cache_matches_prefill_cache():
    """The vlm's cross caches from ``init_decode_cache(media, params)``
    are the prefill's, bit for bit; with the prompt's self-layer caches
    copied in, a decode step from them gives the prefill path's logits bit
    for bit.  At ``param_dtype`` float32: the config's bf16 empty caches
    would round the copied self-layer caches (the bf16 caches are
    ``test_torch_remat.py``'s)."""
    s = _Serve("llama-3.2-vision-90b", param_dtype="float32")
    toks = _tokens(s.cfg, PROMPT + 1)
    _, cache = s.prefill(toks[:, :PROMPT], PROMPT + 1)
    init = s.f.init_decode_cache(s.cfg, BATCH, PROMPT + 1,
                                 media=s.kw["media"], params=s.p)
    for p, (got, want) in enumerate(zip(init.layers["blocks"],
                                        cache.layers["blocks"])):
        if transformer._pos_plan(s.cfg, p)["kind"] == "cross":
            assert torch.equal(got.k, want.k) and torch.equal(got.v, want.v)
        else:
            got.k.copy_(want.k)
            got.v.copy_(want.v)
    a, _ = s.decode(toks[:, PROMPT:], cache, PROMPT)
    b, _ = s.decode(toks[:, PROMPT:], init, PROMPT)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the windowed departure
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prompt,steps", [(8, 40), (40, 4)])
def test_windowed_decode_attends_what_the_forward_attends(prompt, steps):
    """Reduced gemma3-4b (window 32, two local layers; rings of
    ``max(min(cache_len, 33), prompt)`` slots).  The port's decode logits
    equal the reference's ``forward`` at every decoded position, past the
    window and with a prompt longer than ``window + 1`` (rtol 1e-5, atol
    1e-5); they equal the reference's decode before ``pos = window``; the
    reference's decode leaves its forward from ``pos = window`` on, by
    more than 1e-3 (the behaviour the port departs from)."""
    s = _Serve("gemma3-4b")
    w = s.cfg.window
    toks = _tokens(s.cfg, prompt + steps, seed=7)
    want = s.ref_forward(toks)
    cap = prompt + steps
    jl, jcache = s.ref_prefill(toks[:, :prompt], cap)
    logits, cache = s.prefill(toks[:, :prompt], cap)
    _close(logits, want[:, prompt - 1:prompt])
    decode = s.ref_decoder()
    ref_gap = {}
    for pos in range(prompt, prompt + steps):
        tok = toks[:, pos:pos + 1]
        jl, jcache = decode(s.jp, tok, jcache, pos)
        logits, cache = s.decode(tok, cache, pos)
        _close(logits, want[:, pos:pos + 1])
        if pos < w:
            _close(logits, jl)
        ref_gap[pos] = float(np.abs(np.asarray(jl) - want[:, pos:pos + 1])
                             .max())
    late = {p: g for p, g in ref_gap.items() if p >= w}
    assert late and min(late.values()) > 1e-3, ref_gap
    assert all(g < 1e-4 for p, g in ref_gap.items() if p < w), ref_gap


# ---------------------------------------------------------------------------
# the launcher and the example
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-4b", "llama-3.2-vision-90b"])
def test_serve_launcher_on_cpu(arch, capsys):
    """``launch.serve`` with ``--device cpu`` serves the reduced config
    (the default) and prints the reference's line."""
    rec = serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                      "--prompt-len", "8", "--steps", "3"])
    out = capsys.readouterr().out
    assert f"[{arch}] batch=2 decode " in out and "ms/step" in out
    assert rec["device"] == "cpu" and np.isfinite(rec["decode_ms"])


def test_serve_batched_example_on_cpu(capsys):
    """The example decodes ``steps`` tokens a sequence on the CPU and
    names the device in its line."""
    gen = serve_batched.main("gemma3-4b", batch=2, prompt_len=8, steps=4,
                             device="cpu")
    out = capsys.readouterr().out
    assert tuple(gen.shape) == (2, 5)
    assert "[gemma3-4b] prefill (2, 8) -> logits (2, 1, 512)" in out
    assert "(cpu, reduced config)" in out and "sample tokens:" in out


def test_serve_entry_points_need_a_card_by_default(monkeypatch):
    """Without a card, the launcher and the example raise unless given the
    CPU; ``--no-reduced`` selects the full config."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen3-4b"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_batched.main("gemma3-4b", batch=1, prompt_len=2, steps=1)
    assert serve.parser().parse_args(["--no-reduced"]).reduced is False
    assert serve.parser().parse_args([]).reduced is True
