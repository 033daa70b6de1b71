"""DeepSeek-style decoder (port of ``repro.models.moe_transformer``:
``init``, ``forward``, and serving -- ``prefill``, ``init_decode_cache``,
``decode_step``): MLA attention, the first ``first_dense`` layers with a
dense SwiGLU FFN (width ``d_expert * (n_shared + top_k)``), the rest with
the MoE FFN, and the optional MTP head (v3), which takes no part in
serving.

Parameters are a nested dict laid out as the reference's pytree::

    {"embed": [V, d], "ln_f": [d], "lm_head": [d, V],
     "dense_layers": [{"ln1", "ln2", "mla": {...}, "mlp": {...}}, ...],
     "moe_layers": {"ln1": [L', d], "ln2": [L', d], "mla": {...},
                    "moe": {"router", "experts": {...}[, "shared"]}},
     "mtp": {"combine": [2d, d], "ln": [d], "layer": <a dense layer>}}

with the MoE layers stacked on a leading ``[L' = n_layers - first_dense]``
axis (the reference scans them; here they are unstacked and walked in
order).  ``forward`` returns ``(logits, aux)``, or ``(logits, aux,
mtp_logits)`` with the MTP head; ``aux`` is the router load imbalance
averaged over the MoE layers, the functional constraint g(w) of the LM
task's ``aux_constraint``.

Serving caches each layer's MLA latents (:class:`ServeCache`: a list for
the dense layers, one stacked :class:`mla.MLACache` for the MoE layers);
a decode step routes its ``B`` tokens through :func:`moe.moe_ffn` with the
reference's capacity ``C = round(G k / E * capacity_factor)`` at ``G =
B``, so tokens that share an expert past ``C`` are dropped, as there.

Atomics: the token embedding's backward (an accumulating index put) adds
the rows of repeated tokens with atomics on CUDA, as in the dense
transformer; the MoE layer's are in ``models/moe.py``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common, mla, moe


def _layer_shapes(cfg: ModelConfig, dense_ffn: bool) -> dict:
    d = cfg.d_model
    shapes = {"ln1": (d,), "ln2": (d,),
              "mla": mla.mla_shapes(d, cfg.n_heads, cfg.mla)}
    if dense_ffn:
        dff = cfg.moe.d_expert * (cfg.moe.n_shared + cfg.moe.top_k)
        shapes["mlp"] = {"w_gate": (d, dff), "w_up": (d, dff),
                         "w_down": (dff, d)}
    else:
        shapes["moe"] = moe.moe_shapes(d, cfg.moe)
    return shapes


def param_shapes(cfg: ModelConfig) -> dict:
    """The tree of leaf shapes :func:`init` fills."""
    d, nd = cfg.d_model, cfg.moe.first_dense
    shapes = {"embed": (cfg.vocab, d), "ln_f": (d,),
              "lm_head": (d, cfg.vocab),
              "dense_layers": [_layer_shapes(cfg, True) for _ in range(nd)],
              "moe_layers": common.stack_shapes(_layer_shapes(cfg, False),
                                                cfg.n_layers - nd)}
    if cfg.mtp_depth:
        shapes["mtp"] = {"combine": (2 * d, d), "ln": (d,),
                         "layer": _layer_shapes(cfg, True)}
    return shapes


def init(gen: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    """Random weights (the reference's distributions, not its bits):
    fan-in scaled normals (the experts' fan-in is ``d`` up and ``d_expert``
    down), 0.02-scaled embedding, zero norm gains."""
    return common.init_tree(gen, param_shapes(cfg), device)


def _layer_fwd(lp, cfg: ModelConfig, h, positions):
    a = mla.attention(lp["mla"], common.rms_norm(h, lp["ln1"], cfg.norm_eps),
                      positions, cfg.rope_theta, cfg.n_heads, cfg.mla,
                      cfg.norm_eps)
    return _ffn(lp, cfg, h + a)


def _ffn(lp, cfg: ModelConfig, h):
    """The layer's dense or MoE FFN on ``h`` ``[B, S, d]`` (its residual
    added): ``(h, aux)``."""
    hn = common.rms_norm(h, lp["ln2"], cfg.norm_eps)
    if "mlp" in lp:
        out = common.swiglu(hn, lp["mlp"]["w_gate"], lp["mlp"]["w_up"],
                            lp["mlp"]["w_down"])
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    else:
        B, S, d = hn.shape
        out, aux = moe.moe_ffn(lp["moe"], hn.reshape(B * S, d), cfg.moe)
        out = out.reshape(B, S, d)
    return h + out, aux


def forward(params, cfg: ModelConfig, tokens: torch.Tensor):
    """tokens ``[B, S]`` -> ``(logits [B, S, V], aux)``, plus
    ``mtp_logits [B, S-1, V]`` with the MTP head."""
    S = tokens.shape[1]
    scale = math.sqrt(float(cfg.d_model))
    h = params["embed"][tokens] * scale
    positions = torch.arange(S, device=tokens.device)
    for lp in params["dense_layers"]:
        h, _ = _layer_fwd(lp, cfg, h, positions)
    n_moe = cfg.n_layers - cfg.moe.first_dense
    aux_sum = torch.zeros((), dtype=torch.float32, device=h.device)

    def body(h, aux_sum, lp):
        h, a = _layer_fwd(lp, cfg, h, positions)
        return h, aux_sum + a
    for lp in common.unstack(params["moe_layers"], n_moe):
        h, aux_sum = common.remat(cfg, body, h, aux_sum, lp)
    aux = aux_sum / max(n_moe, 1)
    logits = common.rms_norm(h, params["ln_f"], cfg.norm_eps) \
        @ params["lm_head"]
    if cfg.mtp_depth and "mtp" in params:
        # MTP: predict t+2 from [h_t ; emb(tok_{t+1})] through one more
        # dense layer; h is the last layer's output before ln_f, and the
        # head reads no ln_f (the reference's design)
        mtp = params["mtp"]
        emb_next = params["embed"][tokens[:, 1:]] * scale
        comb = torch.cat([h[:, :-1], emb_next], dim=-1) @ mtp["combine"]
        comb = common.rms_norm(comb, mtp["ln"], cfg.norm_eps)
        comb, _ = _layer_fwd(mtp["layer"], cfg, comb, positions[:-1])
        return logits, aux, comb @ params["lm_head"]
    return logits, aux


# ---------------------------------------------------------------------------
# Serving: prefill + one-token decode
# ---------------------------------------------------------------------------

class ServeCache(NamedTuple):
    dense: list             # one mla.MLACache a dense layer
    moe: mla.MLACache       # stacked [L', B, S_cap, ...]


def _serve_layer(lp, cfg: ModelConfig, h, *, positions=None, cache=None,
                 pos=None, cache_len=0):
    """One layer of a prefill (``cache`` None: the prompt's MLA and its
    latents padded to ``cache_len``) or of a decode step (the absorbed
    MLA over ``cache``, written in place).  Returns ``(h, cache)``."""
    hn = common.rms_norm(h, lp["ln1"], cfg.norm_eps)
    if cache is None:
        a, cache = mla.prefill(lp["mla"], hn, positions, cfg.rope_theta,
                               cfg.n_heads, cfg.mla, cache_len, cfg.norm_eps)
    else:
        a, cache = mla.decode(lp["mla"], hn, cache, pos, cfg.rope_theta,
                              cfg.n_heads, cfg.mla, cfg.norm_eps)
    return _ffn(lp, cfg, h + a)[0], cache


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor,
            cache_len: int):
    """The prompt ``tokens`` ``[B, S]`` through the stack: the last
    position's logits ``[B, 1, V]`` and a :class:`ServeCache` of
    ``cache_len >= S`` slots a layer."""
    S = tokens.shape[1]
    h = params["embed"][tokens] * math.sqrt(float(cfg.d_model))
    positions = torch.arange(S, device=tokens.device)
    dense = []
    for lp in params["dense_layers"]:
        h, c = _serve_layer(lp, cfg, h, positions=positions,
                            cache_len=cache_len)
        dense.append(c)
    made = []
    for lp in common.unstack(params["moe_layers"],
                             cfg.n_layers - cfg.moe.first_dense):
        h, c = _serve_layer(lp, cfg, h, positions=positions,
                            cache_len=cache_len)
        made.append(c)
    moe_cache = common.tree_stack(made)
    logits = common.rms_norm(h[:, -1:], params["ln_f"], cfg.norm_eps) \
        @ params["lm_head"]
    return logits, ServeCache(dense, moe_cache)


def init_decode_cache(cfg: ModelConfig, batch: int, cache_len: int,
                      media=None, params=None, device=None) -> ServeCache:
    """Zero latents of ``cache_len`` slots a layer, on ``device``, in
    ``cfg.param_dtype`` (``media`` and ``params`` are not read)."""
    caches = [mla.init_cache(batch, cache_len, cfg.mla, device=device,
                             dtype=common.param_dtype(cfg))
              for _ in range(cfg.n_layers)]
    nd = cfg.moe.first_dense
    return ServeCache(caches[:nd], common.tree_stack(caches[nd:]))


def decode_step(params, cfg: ModelConfig, token: torch.Tensor,
                cache: ServeCache, pos: int):
    """token ``[B, 1]`` at position ``pos`` (a Python int) -> ``(logits
    [B, 1, V], cache)``.  The cache is written in place: the returned one
    holds the caller's tensors."""
    h = params["embed"][token] * math.sqrt(float(cfg.d_model))
    for lp, c in zip(params["dense_layers"], cache.dense):
        h, _ = _serve_layer(lp, cfg, h, cache=c, pos=pos)
    n_moe = cfg.n_layers - cfg.moe.first_dense
    for i, lp in enumerate(common.unstack(params["moe_layers"], n_moe)):
        h, _ = _serve_layer(lp, cfg, h, cache=common.tree_at(cache.moe, i),
                            pos=pos)
    logits = common.rms_norm(h, params["ln_f"], cfg.norm_eps) \
        @ params["lm_head"]
    return logits, cache
