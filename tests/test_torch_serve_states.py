"""Serving of the state-cache families against the JAX package: ``ssd``
from an initial state, the conv windows and one-step recurrences of
``models.mamba2`` and ``models.griffin``, the latent cache and the
absorbed decode of ``models.mla``, and ``prefill`` / ``decode_step`` of
the reduced mamba2-130m, recurrentgemma-2b, deepseek-v2-236b,
deepseek-v3-671b (each at its published ``capacity_factor`` 1.25, where a
decode step of 2 tokens drops routes, and at 8) and whisper-small, from
the reference's own weights (``init`` then ``jax.device_get``) and the
same numpy tokens and frames.  The reference's calls are jitted, as its
launcher jits them.  ``init_decode_cache`` of every family is in
``test_torch_serve.py``.

Tolerances and why: rtol 1e-5, atol 1e-5 on outputs, logits and every
cache leaf, as in ``test_torch_serve.py`` (float32 matmuls, the softmax
and the SSD's einsums associate differently in XLA and PyTorch; the
observed error is 1e-7 to 5e-6 on logits of magnitude 1-5 and on caches,
including whisper's 440-token prompt).  The MoE cases route alike in
both packages: their router margins are far above float32's rounding, so
the same routes are kept and dropped.

Three reference behaviours the port reproduces or departs from (ROADMAP
Queue 3): griffin's local-attention ring is masked by the position each
slot holds, as the transformer's ring is (the port's decode equals the
forward at every position; the reference's leaves it from ``pos =
window`` on); a MoE decode step's capacity is that of its ``B`` tokens,
drops included, as in the reference; whisper past ``max_target_len``
(448) wraps its learned positions but not RoPE's, in prefill and decode
as in the reference.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.models import mamba2 as jax_mamba2
from repro.models import mla as jax_mla
from repro_torch import configs
from repro_torch.examples import serve_batched
from repro_torch.launch import serve
from repro_torch.models import build, griffin, mamba2, mla, moe
from repro_torch.models import moe_transformer, params_from_numpy, whisper
from test_torch_serve import (BATCH, STATE_ARCHS, _assert_same_tree, _close,
                              _Serve, _tokens)
from torch_port_util import t


@pytest.fixture(autouse=True)
def one_thread():
    # small shapes: one intra-op thread beats contending with the other
    # test workers for the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the pieces: ssd, conv windows, MLA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("l,chunk", [(11, 4), (8, 8), (3, 16)])
def test_ssd_from_an_initial_state_matches_reference(l, chunk):
    """``ssd(..., init_state=S0)``: y and the final state, with a padded
    last chunk, one whole chunk, and a sequence shorter than a chunk
    (rtol 1e-5)."""
    rng = np.random.default_rng(0)
    b, h, p, g, n = 2, 4, 3, 2, 5
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    A = -np.linspace(1.0, 4.0, h).astype(np.float32)
    Bm = rng.standard_normal((b, l, g, n)).astype(np.float32)
    Cm = rng.standard_normal((b, l, g, n)).astype(np.float32)
    S0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    jy, jS = jax_mamba2.ssd(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk,
                            init_state=jnp.asarray(S0))
    y, S = mamba2.ssd(*map(t, (x, dt, A, Bm, Cm)), chunk, init_state=t(S0))
    _close(y, jy)
    _close(S, jS)


@pytest.mark.parametrize("prompt", [1, 2, 3, 5])
@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-2b"])
def test_conv_windows_after_short_prompts(arch, prompt):
    """After a prompt of 1-5 tokens the conv windows (``d_conv - 1 = 3``
    inputs, left-padded with zeros after a shorter prompt) and states are
    the reference's; so are 3 decode steps' logits and caches (rtol
    1e-5)."""
    s = _Serve(arch)
    toks = _tokens(s.cfg, prompt + 3)
    cap = prompt + 3
    jl, jcache = s.ref_prefill(toks[:, :prompt], cap)
    logits, cache = s.prefill(toks[:, :prompt], cap)
    _close(logits, jl)
    _assert_same_tree(cache, jcache)
    convs = [cache.conv] if arch == "mamba2-130m" else \
        [blk["conv"] for blk in cache.layers["blocks"][:2]]
    for conv in convs:
        assert conv.shape[-2] == 3
        if prompt < 3:
            assert not conv[..., : 3 - prompt, :].any()
    decode = s.ref_decoder()
    for pos in range(prompt, cap):
        jl, jcache = decode(s.jp, toks[:, pos:pos + 1], jcache, pos)
        logits, cache = s.decode(toks[:, pos:pos + 1], cache, pos)
        _close(logits, jl)
        _assert_same_tree(cache, jcache)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "deepseek-v3-671b"])
def test_mla_serving_matches_reference(arch):
    """MLA at v2's (``q_lora_rank`` 0) and v3's (> 0) reduced dims:
    ``prefill``'s output and latents padded to 9 slots, ``init_cache``'s
    zeros, then 4 absorbed ``decode`` steps (output, latents; written in
    place) against the reference (rtol 1e-5)."""
    m = configs.get_reduced(arch).mla
    d, heads, theta = 32, 4, 10_000.0
    jp = jax.device_get(jax_mla.init(jax.random.PRNGKey(2), d, heads, m))
    p = params_from_numpy(jp)
    assert ("wq_a" in p) == bool(m.q_lora_rank)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((BATCH, 9, d)).astype(np.float32)
    jout, jcache = jax_mla.prefill(jp, jnp.asarray(x[:, :5]), jnp.arange(5),
                                   theta, heads, m, 9)
    out, cache = mla.prefill(p, t(x[:, :5]), torch.arange(5), theta, heads,
                             m, 9)
    _close(out, jout)
    assert isinstance(cache, mla.MLACache)
    _assert_same_tree(cache, jcache)
    _assert_same_tree(mla.init_cache(BATCH, 9, m),
                      jax_mla.init_cache(BATCH, 9, m))
    for pos in range(5, 9):
        jout, jcache = jax_mla.decode(jp, jnp.asarray(x[:, pos:pos + 1]),
                                      jcache, pos, theta, heads, m)
        out, new = mla.decode(p, t(x[:, pos:pos + 1]), cache, pos, theta,
                              heads, m)
        assert new.c_kv is cache.c_kv and new.k_rope is cache.k_rope
        _close(out, jout)
        _assert_same_tree(cache, jcache)


# ---------------------------------------------------------------------------
# prefill + decode of the reduced configs
# ---------------------------------------------------------------------------

SERVE_CASES = [("mamba2-130m", {}), ("recurrentgemma-2b", {}),
               ("deepseek-v2-236b", {}),
               ("deepseek-v2-236b", {"capacity_factor": 8.0}),
               ("deepseek-v3-671b", {}),
               ("deepseek-v3-671b", {"capacity_factor": 8.0}),
               ("whisper-small", {})]
PROMPT, STEPS = 6, 8


def _case_id(case):
    arch, over = case
    return arch + ("-cf8" if over else "")


class _DropCount:
    """Counts the routes :func:`moe.dispatch` drops (``keep`` False)."""

    def __init__(self, monkeypatch):
        self.dropped = 0
        real = moe.dispatch

        def dispatch(xg, idx, E, C):
            out = real(xg, idx, E, C)
            self.dropped += int((~out[2]).sum())
            return out
        monkeypatch.setattr(moe, "dispatch", dispatch)


@pytest.mark.parametrize("case", SERVE_CASES, ids=_case_id)
def test_prefill_and_decode_match_reference(case, monkeypatch):
    """``prefill`` (the last position's logits ``[B, 1, V]`` and every
    cache leaf, on the same tree) then 8 ``decode_step`` calls on the same
    numpy tokens: logits and every cache leaf after each step (rtol 1e-5,
    atol 1e-5).  At the published capacity factor the decode steps drop
    routes (``C = 1`` for 2 tokens), as the reference's do."""
    arch, over = case
    s = _Serve(arch, **over)
    drops = _DropCount(monkeypatch)
    toks = _tokens(s.cfg, PROMPT + STEPS)
    cap = PROMPT + STEPS
    jl, jcache = s.ref_prefill(toks[:, :PROMPT], cap)
    logits, cache = s.prefill(toks[:, :PROMPT], cap)
    assert tuple(logits.shape) == (BATCH, 1, s.cfg.vocab)
    _close(logits, jl)
    _assert_same_tree(cache, jcache)
    decode = s.ref_decoder()
    drops.dropped = 0
    for i in range(STEPS):
        pos = PROMPT + i
        jl, jcache = decode(s.jp, toks[:, pos:pos + 1], jcache, pos)
        logits, new = s.decode(toks[:, pos:pos + 1], cache, pos)
        assert all(a is b for a, b in zip(jax.tree_util.tree_leaves(new),
                                          jax.tree_util.tree_leaves(cache)))
        _close(logits, jl)
        _assert_same_tree(cache, jcache)
    if s.cfg.family == "moe":
        assert (drops.dropped > 0) == (not over), drops.dropped


@pytest.mark.parametrize("arch,over,prompt", [
    ("mamba2-130m", {}, 40),          # past a chunk of 32
    ("deepseek-v2-236b", {"capacity_factor": 8.0}, 8),
    ("deepseek-v3-671b", {"capacity_factor": 8.0}, 8),
    ("whisper-small", {}, 8)], ids=["mamba2", "dsv2-cf8", "dsv3-cf8",
                                    "whisper"])
def test_decode_equals_the_ports_forward(arch, over, prompt):
    """The port's prefill and 6 decode steps equal the port's own
    ``forward`` over the same tokens (rtol 1e-5, atol 1e-5): the
    recurrence matches the chunked SSD; with no route dropped the latent
    decode matches the expanded forward; whisper within 448 positions."""
    s = _Serve(arch, **over)
    toks = _tokens(s.cfg, prompt + 6, seed=5)
    with torch.inference_mode():
        want = s.f.forward(s.p, s.cfg, t(toks, torch.int64), **s.kw)
    if s.cfg.family == "moe":
        want = want[0]
    logits, cache = s.prefill(toks[:, :prompt], prompt + 6)
    got = [logits]
    for pos in range(prompt, prompt + 6):
        logits, cache = s.decode(toks[:, pos:pos + 1], cache, pos)
        got.append(logits)
    _close(torch.cat(got, dim=1), want[:, prompt - 1:].numpy())


# ---------------------------------------------------------------------------
# griffin's ring, whisper past max_target_len
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prompt,steps", [(8, 40), (40, 4)])
def test_griffin_ring_attends_what_the_forward_attends(prompt, steps):
    """Reduced recurrentgemma-2b (window 32, one local layer; its ring of
    ``max(min(cache_len, 33), prompt)`` slots).  The port's decode logits
    equal the reference's ``forward`` at every decoded position, past the
    window and with a prompt longer than ``window + 1`` (rtol 1e-5, atol
    1e-5); they equal the reference's decode before ``pos = window``; the
    reference's decode leaves its forward from ``pos = window`` on, by
    more than 1e-3 (the behaviour the port departs from)."""
    s = _Serve("recurrentgemma-2b")
    w = s.cfg.rglru.window
    toks = _tokens(s.cfg, prompt + steps, seed=7)
    want = s.ref_forward(toks)
    cap = prompt + steps
    jl, jcache = s.ref_prefill(toks[:, :prompt], cap)
    logits, cache = s.prefill(toks[:, :prompt], cap)
    assert cache.layers["blocks"][2].k.shape[2] == max(min(cap, w + 1),
                                                       prompt)
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


def test_whisper_past_max_target_len_matches_reference():
    """Reduced whisper-small, a prompt of 440 and 16 decode steps (to
    position 455, past ``max_target_len`` 448): the port's prefill and
    decode equal the reference's prefill and decode (rtol 1e-5, atol
    1e-5), wrapped learned positions and unwrapped RoPE alike."""
    s = _Serve("whisper-small")
    prompt, steps = 440, 16
    toks = _tokens(s.cfg, prompt + steps, seed=9)
    cap = prompt + steps
    jl, jcache = s.ref_prefill(toks[:, :prompt], cap)
    logits, cache = s.prefill(toks[:, :prompt], cap)
    _close(logits, jl)
    _assert_same_tree(cache, jcache)
    decode = s.ref_decoder()
    for pos in range(prompt, cap):
        jl, jcache = decode(s.jp, toks[:, pos:pos + 1], jcache, pos)
        logits, cache = s.decode(toks[:, pos:pos + 1], cache, pos)
        _close(logits, jl)
    _assert_same_tree(cache, jcache)


# ---------------------------------------------------------------------------
# the registry, the launcher, the example
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(configs.ALIASES))
def test_build_serves_every_family(arch):
    """``build`` returns the family module's own serving functions for all
    ten archs; the empty caches are in ``param_dtype`` (the giants' bf16,
    float32 elsewhere)."""
    cfg = configs.get_reduced(arch)
    fns = build(cfg)
    mod = {"ssm": mamba2, "hybrid": griffin, "moe": moe_transformer,
           "audio": whisper}.get(cfg.family)
    if mod is not None:
        assert (fns.prefill, fns.decode_step, fns.init_decode_cache) == \
            (mod.prefill, mod.decode_step, mod.init_decode_cache)
    cache = fns.init_decode_cache(cfg, 1, 4)
    want = torch.bfloat16 if arch in ("deepseek-v2-236b", "deepseek-v3-671b",
                                      "llama-3.2-vision-90b") \
        else torch.float32
    assert all(x.dtype == want for x in jax.tree_util.tree_leaves(cache))


@pytest.mark.parametrize("arch", STATE_ARCHS)
def test_serve_launcher_on_cpu_state_families(arch, capsys):
    """``launch.serve`` with ``--device cpu`` serves the reduced config of
    each state-cache arch and prints the reference's line."""
    rec = serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                      "--prompt-len", "8", "--steps", "3"])
    out = capsys.readouterr().out
    assert f"[{arch}] batch=2 decode " in out and "ms/step" in out
    assert rec["device"] == "cpu" and np.isfinite(rec["decode_ms"])


@pytest.mark.parametrize("arch", STATE_ARCHS)
def test_serve_batched_example_on_cpu_state_families(arch, capsys):
    """The example decodes ``steps`` tokens a sequence on the CPU for each
    state-cache arch (whisper with its frames)."""
    gen = serve_batched.main(arch, batch=2, prompt_len=8, steps=4,
                             device="cpu")
    out = capsys.readouterr().out
    assert tuple(gen.shape) == (2, 5)
    assert f"[{arch}] prefill (2, 8) -> logits (2, 1, 512)" in out
    assert "(cpu, reduced config)" in out
