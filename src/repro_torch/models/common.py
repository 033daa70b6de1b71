"""Shared model building blocks (port of ``repro.models.common``).

Under a plan that splits a model over the model axis of a rank mesh
(``sharding.partition.tensor_plan``) :func:`swiglu` runs on a rank's ffn
block and :func:`cross_entropy` on its vocab block of the logits, with
the axis's collectives (``sharding.collectives``)."""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding import collectives, partition


def dense_init(gen: torch.Generator, shape, in_axis: int = 0,
               device=None) -> torch.Tensor:
    """Fan-in scaled normal init; ``in_axis`` indexes ``shape``."""
    fan_in = shape[in_axis]
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return x / math.sqrt(max(fan_in, 1))


def embed_init(gen: torch.Generator, vocab: int, d: int,
               device=None) -> torch.Tensor:
    return torch.randn((vocab, d), generator=gen, device=device,
                       dtype=torch.float32) * 0.02


def param_dtype(cfg) -> torch.dtype:
    """``cfg.param_dtype`` ("float32", "bfloat16") as a torch dtype."""
    return getattr(torch, cfg.param_dtype)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it
    (``logaddexp(x, 0)``; ``F.softplus`` returns ``x`` above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + gamma)).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: ``[..., S, H, hd]``; positions broadcastable to ``[..., S]``."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # [hd/2]
    angles = positions[..., None].to(torch.float32) * freqs  # [..., S, hd/2]
    angles = angles[..., None, :]                           # [..., S, 1, hd/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def remat(cfg, fn, *args):
    """``fn(*args)``; with ``cfg.remat`` and autograd recording, its
    activations are not kept but recomputed in the backward (the
    reference's ``jax.checkpoint`` of a layer body; non-reentrant, so
    ``torch.autograd.grad`` and a graph kept across several backward
    seeds work as without it; the bodies draw no random numbers, so no RNG
    state is stashed)."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def unstack(tree, n: int) -> list:
    """A tree of ``[n, ...]``-stacked layer leaves as n per-layer trees.
    Each leaf is unbound once, so its backward stacks the per-layer
    gradients in one allocation (indexing layer by layer would build a
    full-stack zero gradient for every layer)."""
    if isinstance(tree, dict):
        parts = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(tree.unbind(0))


def tree_stack(trees: list):
    """Per-layer caches of one structure (tensors in NamedTuples and
    dicts) stacked on a new leading layer axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_stack([t[k] for t in trees]) for k in first}
    if isinstance(first, tuple):
        return type(first)(*(tree_stack([t[i] for t in trees])
                             for i in range(len(first))))
    return torch.stack(trees)


def tree_at(tree, i: int):
    """Layer ``i`` of a stacked cache: views (a decode writes through
    them)."""
    if isinstance(tree, dict):
        return {k: tree_at(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(tree_at(v, i) for v in tree))
    return tree[i]


def run_periods(params, P: int, n_full: int, h, apply, mode: str,
                caches=None, cfg=None):
    """A patterned stack: the ``n_full`` whole periods in order (position
    ``p``'s layer from its stack ``params["blocks"][p]``), then the
    remainder's layers ``params["rest"]`` (position ``i % P``).
    ``apply(lp, p, h, cache) -> (h, cache)`` runs one layer; ``caches``
    (``{"blocks", "rest"}``, decode mode) are passed as per-layer views.
    In train mode each whole period is one :func:`remat` body under
    ``cfg`` (the remainder's layers are not, as in the reference).
    Returns ``(h, caches)``: None in train mode, prefill's new caches
    (``"blocks"`` is ``[None] * P`` when there is no whole period, as in
    the reference), or decode's (the caller's, written in place)."""
    blocks = [unstack(b, n_full) for b in params["blocks"]]
    made = [[] for _ in range(P)]

    def period(h, *lps):
        for p in range(P):
            h, _ = apply(lps[p], p, h, None)
        return h
    for i in range(n_full):
        if mode == "train":
            h = remat(cfg, period, h, *(blocks[p][i] for p in range(P)))
            continue
        for p in range(P):
            c = tree_at(caches["blocks"][p], i) if caches else None
            h, nc = apply(blocks[p][i], p, h, c)
            made[p].append(nc)
    rest = []
    for i, lp in enumerate(params["rest"]):
        h, nc = apply(lp, i % P, h, caches["rest"][i] if caches else None)
        rest.append(nc)
    if mode == "train":
        return h, None
    if not n_full:
        blk = [None] * P
    elif mode == "decode":
        blk = list(caches["blocks"])
    else:
        blk = [tree_stack(cs) for cs in made]
    return h, {"blocks": blk, "rest": rest}


def stack_shapes(shapes, n: int):
    """A tree of leaf shapes with a leading ``[n]`` axis on every leaf."""
    if isinstance(shapes, dict):
        return {k: stack_shapes(v, n) for k, v in shapes.items()}
    return (n,) + tuple(shapes)


# leaves drawn or filled by name (the reference's initializers); every
# other leaf (``media_proj``, whisper's ``w_in`` / ``w_out`` among them) is
# a fan-in scaled normal, its fan-in the axis before the last (the
# reference's ``in_axis=1`` for the ``[E, d, de]`` / ``[E, de, d]``
# experts, stacked or not).  ``gate``, the cross-attention gate, is 0-d or
# stacked ``[n]``: named here, or it would be drawn (``[n]``) or raise (0-d)
_ZEROS = {"ln", "ln1", "ln2", "ln_f", "gnorm", "q_norm", "k_norm", "kv_norm",
          "conv_b", "b_a", "b_i", "gate", "ln_x", "ln_mlp", "ln_enc", "b_in",
          "b_out"}
_EMBEDS = {"embed", "pos_emb_dec", "pos_emb_enc"}


def _init_leaf(gen, name: str, shape: tuple, device) -> torch.Tensor:
    def fill(row):                       # a per-layer row on every layer
        return row.to(device).expand(shape).contiguous()
    if name in _ZEROS:
        return torch.zeros(shape, dtype=torch.float32, device=device)
    if name in _EMBEDS:
        return embed_init(gen, *shape, device=device)
    if name == "conv_w":
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32) * 0.1
    if name == "A_log":                  # Mamba-2 decay rates 1..16
        return fill(torch.log(torch.linspace(1.0, 16.0, shape[-1])))
    if name == "D":
        return torch.ones(shape, dtype=torch.float32, device=device)
    if name == "dt_bias":
        return torch.full(shape, -1.0, dtype=torch.float32, device=device)
    if name == "lam":                    # RG-LRU gate constants 2..5
        return fill(torch.linspace(2.0, 5.0, shape[-1]))
    return dense_init(gen, shape, in_axis=len(shape) - 2, device=device)


def init_tree(gen: torch.Generator, shapes, device=None):
    """Random weights for a tree of leaf shapes (dicts and lists inner,
    shape tuples leaves; draws in the tree's own order): the reference's
    distributions, not its bits."""
    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, name) for v in tree]
        return _init_leaf(gen, name, tuple(tree), device)
    return walk(shapes, None)


def meta_tree(shapes):
    """A tree of leaf shapes as ``meta`` tensors (for ``flat.spec_of``
    without an allocation)."""
    if isinstance(shapes, dict):
        return {k: meta_tree(v) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [meta_tree(v) for v in shapes]
    return torch.empty(tuple(shapes), device="meta")


def swiglu(x, w_gate, w_up, w_down, split: bool = False):
    """The SwiGLU MLP; ``split``: the weights are this model rank's ffn
    block (``w_gate`` / ``w_up`` by columns, ``w_down`` by rows), so ``x``
    enters through "f" and the row-parallel product's partials are summed
    by "g"."""
    if split:
        x = collectives.copy_in(x)
    h = torch.nn.functional.silu(x @ w_gate) * (x @ w_up)
    return collectives.reduce_sum(h @ w_down) if split else h @ w_down


def gelu_mlp(x, w_in, b_in, w_out, b_out):
    return gelu(x @ w_in + b_in) @ w_out + b_out


def vocab_block(vocab: int, width: int):
    """The first vocab id of this model rank's block of logits (or
    embedding rows) ``width`` of ``vocab`` wide; None when they are
    whole."""
    ma = partition.model_axis()
    if width == vocab or ma is None:
        return None
    return ma.rank * width


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor | None = None,
                  vocab_lo: int | None = None) -> torch.Tensor:
    """Mean next-token CE; logits ``[B, S, V]``, targets ``[B, S]``.

    ``vocab_lo`` (:func:`vocab_block`): the logits are this model rank's
    vocab block from that id.  The logsumexp's shift is the maximum over
    the ranks, the sum of its exponentials is summed over them ("g"), and
    each target's logit comes from the rank that holds it (zero elsewhere,
    summed): the same value on every rank, within rounding of the whole
    logits' (the sums add in another order)."""
    lf = logits.to(torch.float32)
    if vocab_lo is None:
        logz = torch.logsumexp(lf, dim=-1)
        ll = torch.gather(lf, -1, targets[..., None].to(torch.int64))[..., 0]
    else:
        V = lf.shape[-1]
        shift = collectives.reduce_max(lf.detach().amax(dim=-1))
        total = collectives.reduce_sum(
            torch.exp(lf - shift[..., None]).sum(dim=-1))
        logz = torch.log(total) + shift
        local = targets.to(torch.int64) - vocab_lo
        inside = (local >= 0) & (local < V)
        ll = torch.gather(lf, -1, local.clamp(0, V - 1)[..., None])[..., 0]
        ll = collectives.reduce_sum(torch.where(inside, ll,
                                                torch.zeros_like(ll)))
    nll = logz - ll
    if mask is None:
        return nll.mean()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
