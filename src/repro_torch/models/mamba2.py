"""Mamba-2 (SSD, arXiv:2405.21060), attention-free state-space decoder
(port of ``repro.models.mamba2``: ``init``, ``forward``, and serving --
``prefill``, ``init_decode_cache``, ``decode_step``).

Training and prefill run the chunked SSD block decomposition: a quadratic
form inside each chunk against the 1-semiseparable mask, and the
inter-chunk state recurrence as a loop over the chunks.  Decode is the
O(1) state update of one token.  Parameters, per-layer leaves stacked on
a leading ``[n_layers]`` axis::

    {"embed": [V, d], "ln_f": [d],
     "layers": {"ln", "in_proj", "conv_w", "conv_b", "A_log", "D",
                "dt_bias", "gnorm", "out_proj"}}

The serving cache is :class:`ServeCache`: each layer's conv window (the
last ``d_conv - 1`` inputs of the depthwise conv, left-padded with zeros
after a shorter prompt) and its SSM state, stacked over the layers.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, n_heads, conv_dim


def param_shapes(cfg: ModelConfig) -> dict:
    """The tree of leaf shapes :func:`init` fills."""
    s, d, L = cfg.ssm, cfg.d_model, cfg.n_layers
    d_inner, n_heads, conv_dim = _dims(cfg)
    d_in_proj = 2 * d_inner + 2 * s.n_groups * s.d_state + n_heads
    layer = {"ln": (d,), "in_proj": (d, d_in_proj),
             "conv_w": (s.d_conv, conv_dim), "conv_b": (conv_dim,),
             "A_log": (n_heads,), "D": (n_heads,), "dt_bias": (n_heads,),
             "gnorm": (d_inner,), "out_proj": (d_inner, d)}
    shapes = {"embed": (cfg.vocab, d), "ln_f": (d,),
              "layers": common.stack_shapes(layer, L)}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab)
    return shapes


def init(gen: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    """Random weights (the reference's distributions, not its bits):
    ``A_log = log(linspace(1, 16))``, ``D = 1``, ``dt_bias = -1``, a
    0.1-scaled normal depthwise conv, fan-in scaled projections."""
    return common.init_tree(gen, param_shapes(cfg), device)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a ``[..., Q]`` -> ``[..., Q, Q]``: ``sum_{j < k <= i} a_k`` on and
    below the diagonal, ``-inf`` above (masked before any ``exp``, so
    the backward meets no overflow)."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(Q, device=a.device)
    mask = i[:, None] >= i[None, :]
    return seg.masked_fill(~mask, -torch.inf)


def ssd(x, dt, A, Bm, Cm, chunk: int, init_state=None):
    """Chunked SSD from ``init_state`` ``[b,h,p,n]`` (zeros when None).
    x ``[b,l,h,p]``; dt ``[b,l,h]``; A ``[h]`` (< 0); Bm, Cm ``[b,l,g,n]``.
    Returns (y ``[b,l,h,p]``, the final state ``[b,h,p,n]``)."""
    b, l, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    rep = h // g
    Bh = Bm.repeat_interleave(rep, dim=2)
    Ch = Cm.repeat_interleave(rep, dim=2)
    Q = min(chunk, l)
    pad = (-l) % Q
    if pad:                                  # zero-pad the time axis
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bh = F.pad(Bh, (0, 0, 0, 0, 0, pad))
        Ch = F.pad(Ch, (0, 0, 0, 0, 0, pad))
    L = x.shape[1]
    c = L // Q

    a = dt * A[None, None, :]                              # [b,L,h] (< 0)
    xdt = x * dt[..., None]
    x_c = xdt.reshape(b, c, Q, h, p)
    a_c = a.reshape(b, c, Q, h)
    B_c = Bh.reshape(b, c, Q, h, n)
    C_c = Ch.reshape(b, c, Q, h, n)

    a_cs = torch.cumsum(a_c, dim=2)                        # [b,c,Q,h]
    Lmat = torch.exp(_segsum(a_c.movedim(3, 2)))           # [b,c,h,Q,Q]
    scores = torch.einsum("bcqhn,bckhn->bchqk", C_c, B_c) * Lmat
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", scores, x_c)

    decay_states = torch.exp(a_cs[:, :, -1:, :] - a_cs)    # [b,c,Q,h]
    states = torch.einsum("bcqhn,bcqh,bcqhp->bchpn", B_c, decay_states, x_c)
    chunk_decay = torch.exp(a_cs[:, :, -1, :])             # [b,c,h]

    S = torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device) \
        if init_state is None else init_state
    prev = []
    for j in range(c):                       # the inter-chunk recurrence
        prev.append(S)
        S = chunk_decay[:, j, :, None, None] * S + states[:, j]
    states_prev = torch.stack(prev, dim=1)                 # [b,c,h,p,n]

    out_decay = torch.exp(a_cs)                            # [b,c,Q,h]
    y_off = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", C_c, states_prev,
                         out_decay)
    y = (y_diag + y_off).reshape(b, L, h, p)[:, :l]
    return y, S


def _causal_conv(x, w, b):
    """x ``[B,S,C]``; w ``[K,C]``: depthwise causal conv, then silu."""
    K = w.shape[0]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = sum(xp[:, i: i + x.shape[1]] * w[i] for i in range(K))
    return F.silu(out + b)


def _mixer(lp, cfg: ModelConfig, x, conv_cache=None, ssm_state=None,
           decode: bool = False):
    """The SSD mixer: x ``[B, S, d]`` -> ``(y, conv window [B, K-1,
    conv_dim], SSM state [B, h, p, n])``.  In decode (S = 1) the conv runs
    over ``conv_cache`` and this input, and the state is updated from
    ``ssm_state``; otherwise the causal conv and the chunked SSD run over
    the sequence from ``ssm_state`` (zeros when None)."""
    s = cfg.ssm
    d_inner, n_heads, conv_dim = _dims(cfg)
    B_, S_, _ = x.shape
    proj = x @ lp["in_proj"]
    z, xBC, dt_raw = proj.split([d_inner, conv_dim, n_heads], dim=-1)
    dt = common.softplus(dt_raw + lp["dt_bias"])           # [B,S,h]
    A = -torch.exp(lp["A_log"])
    if decode:          # the conv over the cached window and this input
        win = torch.cat([conv_cache, xBC], dim=1)          # [B,K,conv_dim]
        conv_out = F.silu((win * lp["conv_w"]).sum(1, keepdim=True)
                          + lp["conv_b"])
        new_conv = win[:, 1:]
    else:
        conv_out = _causal_conv(xBC, lp["conv_w"], lp["conv_b"])
        new_conv = F.pad(xBC, (0, 0, max(s.d_conv - 1 - S_, 0), 0))[
            :, -(s.d_conv - 1):]
    gs = s.n_groups * s.d_state
    xs, B0, C0 = conv_out.split([d_inner, gs, gs], dim=-1)
    xh = xs.reshape(B_, S_, n_heads, s.head_dim)
    Bm = B0.reshape(B_, S_, s.n_groups, s.d_state)
    Cm = C0.reshape(B_, S_, s.n_groups, s.d_state)
    if decode:          # S = 1: one token's state update
        rep = n_heads // s.n_groups
        Bh = Bm[:, 0].repeat_interleave(rep, dim=1)        # [B,h,n]
        Ch = Cm[:, 0].repeat_interleave(rep, dim=1)
        dt0 = dt[:, 0]                                     # [B,h]
        dec = torch.exp(dt0 * A[None])                     # [B,h]
        upd = torch.einsum("bh,bhp,bhn->bhpn", dt0, xh[:, 0], Bh)
        S_new = dec[..., None, None] * ssm_state + upd
        y = torch.einsum("bhn,bhpn->bhp", Ch, S_new)[:, None]
    else:
        y, S_new = ssd(xh, dt, A, Bm, Cm, s.chunk, init_state=ssm_state)
    y = y + lp["D"][None, None, :, None] * xh
    y = y.reshape(B_, S_, d_inner) * F.silu(z)
    y = common.rms_norm(y, lp["gnorm"], cfg.norm_eps)
    return y @ lp["out_proj"], new_conv, S_new


def _logits(params, cfg: ModelConfig, h):
    h = common.rms_norm(h, params["ln_f"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ w


def forward(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """tokens ``[B, S]`` -> logits ``[B, S, V]`` (the embedding unscaled)."""
    h = params["embed"][tokens]

    def body(h, lp):
        return h + _mixer(lp, cfg, common.rms_norm(h, lp["ln"],
                                                   cfg.norm_eps))[0]
    for lp in common.unstack(params["layers"], cfg.n_layers):
        h = common.remat(cfg, body, h, lp)
    return _logits(params, cfg, h)


# ---------------------------------------------------------------------------
# Serving: prefill + one-token decode
# ---------------------------------------------------------------------------

class ServeCache(NamedTuple):
    conv: torch.Tensor      # [L, B, K-1, conv_dim]
    ssm: torch.Tensor       # [L, B, h, p, n]


def init_decode_cache(cfg: ModelConfig, batch: int, cache_len: int,
                      media=None, params=None, device=None) -> ServeCache:
    """Zero conv windows and states on ``device``, in float32 (the state
    is O(1): ``cache_len``, ``media`` and ``params`` are not read)."""
    s = cfg.ssm
    _, n_heads, conv_dim = _dims(cfg)
    L = cfg.n_layers
    return ServeCache(
        torch.zeros((L, batch, s.d_conv - 1, conv_dim), device=device),
        torch.zeros((L, batch, n_heads, s.head_dim, s.d_state),
                    device=device))


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor,
            cache_len: int):
    """The prompt ``tokens`` ``[B, S]`` through the stack: the last
    position's logits ``[B, 1, V]`` and each layer's conv window and final
    state (``cache_len`` is not read)."""
    h = params["embed"][tokens]
    caches = []
    for lp in common.unstack(params["layers"], cfg.n_layers):
        y, conv, state = _mixer(lp, cfg, common.rms_norm(h, lp["ln"],
                                                         cfg.norm_eps))
        h = h + y
        caches.append(ServeCache(conv, state))
    return _logits(params, cfg, h[:, -1:]), common.tree_stack(caches)


def decode_step(params, cfg: ModelConfig, token: torch.Tensor,
                cache: ServeCache, pos: int):
    """token ``[B, 1]`` -> ``(logits [B, 1, V], cache)``.  The conv
    windows and states are written in place: the returned cache holds the
    caller's tensors.  ``pos`` is not read."""
    h = params["embed"][token]
    for i, lp in enumerate(common.unstack(params["layers"], cfg.n_layers)):
        y, conv, state = _mixer(
            lp, cfg, common.rms_norm(h, lp["ln"], cfg.norm_eps),
            conv_cache=cache.conv[i], ssm_state=cache.ssm[i], decode=True)
        h = h + y
        cache.conv[i].copy_(conv)
        cache.ssm[i].copy_(state)
    return _logits(params, cfg, h), cache
