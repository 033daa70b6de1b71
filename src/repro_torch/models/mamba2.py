"""Mamba-2 (SSD, arXiv:2405.21060), attention-free state-space decoder,
training forward (port of ``repro.models.mamba2``: ``init`` and
``forward``; prefill and decode are not ported yet).

The chunked SSD block decomposition: a quadratic form inside each chunk
against the 1-semiseparable mask, and the inter-chunk state recurrence as
a loop over the chunks.  Parameters, per-layer leaves stacked on a leading
``[n_layers]`` axis::

    {"embed": [V, d], "ln_f": [d],
     "layers": {"ln", "in_proj", "conv_w", "conv_b", "A_log", "D",
                "dt_bias", "gnorm", "out_proj"}}
"""
from __future__ import annotations

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


def ssd(x, dt, A, Bm, Cm, chunk: int):
    """Chunked SSD from a zero state.  x ``[b,l,h,p]``; dt ``[b,l,h]``;
    A ``[h]`` (< 0); Bm, Cm ``[b,l,g,n]``.  Returns (y ``[b,l,h,p]``, the
    final state ``[b,h,p,n]``)."""
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

    S = torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
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


def _mixer(lp, cfg: ModelConfig, x):
    """The SSD mixer in train mode."""
    s = cfg.ssm
    d_inner, n_heads, conv_dim = _dims(cfg)
    B_, S_, _ = x.shape
    proj = x @ lp["in_proj"]
    z, xBC, dt_raw = proj.split([d_inner, conv_dim, n_heads], dim=-1)
    dt = common.softplus(dt_raw + lp["dt_bias"])           # [B,S,h]
    A = -torch.exp(lp["A_log"])
    conv_out = _causal_conv(xBC, lp["conv_w"], lp["conv_b"])
    gs = s.n_groups * s.d_state
    xs, B0, C0 = conv_out.split([d_inner, gs, gs], dim=-1)
    xh = xs.reshape(B_, S_, n_heads, s.head_dim)
    Bm = B0.reshape(B_, S_, s.n_groups, s.d_state)
    Cm = C0.reshape(B_, S_, s.n_groups, s.d_state)
    y, _ = ssd(xh, dt, A, Bm, Cm, s.chunk)
    y = y + lp["D"][None, None, :, None] * xh
    y = y.reshape(B_, S_, d_inner) * F.silu(z)
    y = common.rms_norm(y, lp["gnorm"], cfg.norm_eps)
    return y @ lp["out_proj"]


def forward(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """tokens ``[B, S]`` -> logits ``[B, S, V]`` (the embedding unscaled)."""
    h = params["embed"][tokens]
    for lp in common.unstack(params["layers"], cfg.n_layers):
        h = h + _mixer(lp, cfg, common.rms_norm(h, lp["ln"], cfg.norm_eps))
    h = common.rms_norm(h, params["ln_f"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ w
