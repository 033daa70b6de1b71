"""Build ``(step_fn, inputs)`` for every (arch x input shape x mesh)
combination (port of ``repro.launch.steps``): the cases the dry run
(``launch/dryrun.py``) counts and the card runs.

A case's inputs are ``meta`` tensors of the reference's shapes and dtypes
(the giants' float32 leaves in ``cfg.param_dtype``), so building one
allocates nothing; each input carries its spec tree beside it
(``Case.specs``: a tuple of mesh-axis names per dim, as
``sharding.partition`` builds them).  :func:`materialize` turns the meta
inputs into zero tensors on a device, the shapes the card runs.

The train case is the port's engine round: ``engine.rounds.round_step``
(or ``async_round_step`` with ``async_buffer``) on a
``rounds.FedState``, whose model is one flat ``[d]`` buffer where the
reference's state holds the parameter pytree; its residual is the
reference's ``[n, d]`` stack.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import configs
from repro_torch.configs.base import (AsyncConfig, CompressorConfig,
                                      FedConfig, FleetConfig, InputShape,
                                      ModelConfig, ObsConfig, SwitchConfig)
from repro_torch.models import build, common
from repro_torch.sharding import partition
from repro_torch.tasks import lm

GIANTS = {"deepseek-v3-671b", "deepseek-v2-236b", "llama-3.2-vision-90b"}


class Case(NamedTuple):
    fn: Callable            # (*args) -> outputs
    args: tuple             # meta tensors (trees of them), Python ints
    specs: tuple            # a spec tree beside each arg (None: no tensor)
    out_specs: Callable     # outputs -> their spec tree
    meta: dict


def _axes(mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _strip_axis(spec: tuple, axis: str) -> tuple:
    """``spec`` without ``axis``; a tuple entry left with one axis is that
    axis (as ``PartitionSpec`` normalises it)."""
    out = []
    for e in spec:
        if e == axis:
            out.append(None)
        elif isinstance(e, tuple):
            kept = tuple(a for a in e if a != axis)
            out.append(kept if len(kept) > 1 else
                       (kept[0] if kept else None))
        else:
            out.append(e)
    return tuple(out)


def fed_config_for(cfg: ModelConfig, mesh, local_steps: int = 1,
                   comm: str = "dense", uplink_ratio: float = 0.1,
                   partial: bool = True, participation: str = "mask",
                   client_chunk: int = 0,
                   sampler: str = "uniform",
                   async_buffer: bool = False,
                   staleness: str = "constant",
                   obs: bool = False) -> FedConfig:
    """The default FedSGM policy per architecture class, the reference's
    field for field: the giants federate one client per pod, the others
    one per data shard (0.75 of them sampled with ``partial``); top-k up
    (and down, except for the giants) in blocks of 2048 that divide the
    model axis's shards."""
    from repro_torch.comm import transports
    from repro_torch.engine import async_rounds, participation as part
    from repro_torch.fleet import samplers
    transports.backend_for(comm)        # validate early, before the case
    samplers.get_sampler(sampler)
    async_rounds.get_staleness_law(staleness)
    if participation not in part.MODES:
        raise ValueError(f"unknown participation mode {participation!r}; "
                         f"expected one of {part.MODES}")
    fleet = FleetConfig(sampler=sampler)
    async_ = AsyncConfig(enabled=async_buffer, staleness=staleness)
    obs_ = ObsConfig(enabled=obs)
    axes = _axes(mesh)
    shards = axes.get("model", 1)
    if cfg.name in GIANTS:
        n = axes.get("pod", 1)
        return FedConfig(
            n_clients=n, m=n, local_steps=1, lr=1e-3,
            switch=SwitchConfig(mode="soft", eps=0.05, beta=40.0),
            uplink=CompressorConfig(kind="topk", ratio=uplink_ratio,
                                    block=2048, shards=shards),
            downlink=CompressorConfig(kind="none"),
            comm=comm, client_axis="pod" if "pod" in axes else None,
            track_wbar=False, participation=participation,
            client_chunk=client_chunk, fleet=fleet, async_=async_,
            obs=obs_)
    n = axes.get("data", 1)
    m = max(1, int(0.75 * n)) if partial else n
    return FedConfig(
        n_clients=n, m=m, local_steps=local_steps, lr=1e-3,
        switch=SwitchConfig(mode="soft", eps=0.05, beta=40.0),
        uplink=CompressorConfig(kind="topk", ratio=uplink_ratio,
                                block=2048, shards=shards),
        downlink=CompressorConfig(kind="topk", ratio=uplink_ratio,
                                  block=2048, shards=shards),
        comm=comm, client_axis="data", track_wbar=False,
        participation=participation, client_chunk=client_chunk, fleet=fleet,
        async_=async_, obs=obs_)


def _activate(cfg: ModelConfig, mesh, kind: str, fed: Optional[FedConfig]):
    logical = {}
    multi = "pod" in mesh.axis_names
    if kind == "train":
        ca = fed.client_axis
        logical["client"] = ca
        if ca == "data":
            logical["batch"] = None        # per-client batch dim
        elif ca == "pod":
            logical["batch"] = "data"
        if cfg.moe is not None:
            # the expert axis must not collide with the client axis
            logical["experts"] = "data" if ca != "data" else "model"
            logical["cap"] = "model" if logical["experts"] == "data" \
                else "data"
    else:
        logical["batch"] = ("pod", "data") if multi else "data"
        if cfg.moe is not None:
            logical["experts"] = "data"
            logical["cap"] = "model"
    partition.activate_mesh(mesh, logical=logical,
                            client_axis=fed.client_axis if fed else None)


def _param_dtype_map(cfg: ModelConfig) -> Callable:
    """float32 -> ``cfg.param_dtype``; other dtypes kept."""
    target = common.param_dtype(cfg)

    def f(dtype):
        return target if dtype == torch.float32 else dtype
    return f


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _param_specs(cfg: ModelConfig, fns):
    """The params as meta tensors in ``param_dtype``, and their specs."""
    shapes = fns.param_shapes(cfg)
    dt = _param_dtype_map(cfg)(torch.float32)
    params = partition.map_leaves(lambda _, s: _meta(s, dt), shapes)
    return params, partition.make_specs(shapes, fns.param_rules)


def _loss_pair(cfg: ModelConfig, fns):
    return lm.make_loss_pair(
        fns.forward, cfg,
        budget=(cfg.moe.balance_budget if cfg.moe else 4.0),
        aux_constraint=cfg.moe is not None)


# ---------------------------------------------------------------------------
# Training case: one FedSGM round
# ---------------------------------------------------------------------------

def build_train_case(cfg: ModelConfig, shape: InputShape, mesh,
                     fed: Optional[FedConfig] = None, comm: str = "dense",
                     local_steps: int = 1, dtype: Optional[str] = None,
                     seq_shard: bool = False,
                     uplink_ratio: float = 0.1,
                     participation: str = "mask",
                     client_chunk: int = 0,
                     sampler: str = "uniform",
                     async_buffer: bool = False,
                     staleness: str = "constant",
                     obs: bool = False) -> Case:
    from repro_torch.engine import async_rounds, rounds
    if dtype:
        cfg = dataclasses.replace(cfg, param_dtype=dtype)
    fns = build(cfg)
    fed = fed or fed_config_for(cfg, mesh, local_steps=local_steps, comm=comm,
                                uplink_ratio=uplink_ratio,
                                participation=participation,
                                client_chunk=client_chunk,
                                sampler=sampler, async_buffer=async_buffer,
                                staleness=staleness, obs=obs)
    _activate(cfg, mesh, "train", fed)
    if seq_shard:
        # sequence parallelism of the residual stream (the reference's
        # knob; a spec-only change here)
        partition._LOGICAL["seq"] = "model"
    params, _ = _param_specs(cfg, fns)
    n = fed.n_clients
    ca = fed.client_axis
    state = rounds.init_state(params, fed, device="meta")
    d = state.spec.d
    fspec = partition.check_divisible(partition.resolve("flat"), (d,))
    e_spec = partition.check_divisible((ca, partition.resolve("flat")[0]),
                                       (n, d))
    state_specs = state._replace(
        w=fspec, x=fspec if state.x is not None else None,
        e_up=e_spec if state.e_up is not None else None,
        wbar_sum=fspec if state.wbar_sum is not None else None,
        wbar_weight=(), t=None, gen=None, spec=None, sampler=None)

    b_per = shape.global_batch // n
    batch_spec = (ca, "data" if ca != "data" else None, None)
    tokens = _meta((n, b_per, shape.seq_len), torch.int32)
    mmask = _meta((n, b_per, shape.seq_len), torch.float32)
    media = media_spec = None
    if cfg.family in ("vlm", "audio"):
        M = cfg.n_media_tokens or cfg.n_audio_frames
        media = _meta((n, b_per, M, cfg.d_media or cfg.d_model),
                      common.param_dtype(cfg))
        media_spec = batch_spec + (None,)
    batches = lm.LMBatch(tokens=tokens, minority_mask=mmask, media=media)
    batch_specs = lm.LMBatch(batch_spec, batch_spec, media_spec)
    loss_pair = _loss_pair(cfg, fns)
    meta = dict(kind="train", fed=fed, arch=cfg.name, shape=shape.name,
                dtype=cfg.param_dtype)

    def state_out(out_state):
        return state_specs._replace(
            x=fspec if out_state.x is not None else None)

    if fed.async_.enabled:
        buf = async_rounds.init_buffer(state, fed)
        buf_specs = partition.map_leaves(
            lambda _, x: (ca,) + (None,) * (x.dim() - 1), buf)

        def astep(state, buf, b):
            return async_rounds.async_round_step(
                state, buf, b, loss_pair, fed, device=state.w.device)
        return Case(astep, (state, buf, batches),
                    (state_specs, buf_specs, batch_specs),
                    lambda out: (state_out(out[0]), buf_specs, None),
                    dict(meta, async_buffer=True))

    def step(state, b):
        return rounds.round_step(state, b, loss_pair, fed,
                                 device=state.w.device)

    return Case(step, (state, batches), (state_specs, batch_specs),
                lambda out: (state_out(out[0]), None), meta)


# ---------------------------------------------------------------------------
# Serving cases
# ---------------------------------------------------------------------------

def _baxis(mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else "data"


def _logits_spec(B: int, V: int, mesh) -> tuple:
    return partition.check_divisible(
        (_baxis(mesh), None, partition.resolve("vocab")[0]), (B, 1, V))


def build_prefill_case(cfg: ModelConfig, shape: InputShape, mesh) -> Case:
    fns = build(cfg)
    _activate(cfg, mesh, "serve", None)
    params, p_specs = _param_specs(cfg, fns)
    baxis = _baxis(mesh)
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "audio":
        S = min(S, cfg.max_target_len * 64)  # whisper positions wrap
    tokens = _meta((B, S), torch.int32)
    args, specs = [params, tokens], [p_specs, (baxis, None)]
    if cfg.family in ("vlm", "audio"):
        M = cfg.n_media_tokens or cfg.n_audio_frames
        args.append(_meta((B, M, cfg.d_media or cfg.d_model),
                          common.param_dtype(cfg)))
        specs.append((baxis, None, None))

    def fn(params, toks, media=None):
        extra = {"media": media} if media is not None else {}
        return fns.prefill(params, cfg, toks, shape.seq_len, **extra)

    def out_specs(out):
        logits, cache = out
        return (_logits_spec(B, cfg.vocab, mesh),
                _cache_specs(cache, B, shape.seq_len, mesh))

    return Case(fn, tuple(args), tuple(specs), out_specs,
                dict(kind="prefill", arch=cfg.name, shape=shape.name,
                     dtype=cfg.param_dtype))


def _cache_specs(cache, B: int, cache_len: int, mesh):
    """The reference's cache layout: the batch dim over the batch axes
    when it divides, the first ``cache_len`` dim over ``model``, else a
    wide (>= 512) last dim over ``model``."""
    axes = _axes(mesh)
    model = axes.get("model", 1)
    baxis = _baxis(mesh)
    bsz = int(np.prod([axes.get(a, 1) for a in (
        baxis if isinstance(baxis, tuple) else (baxis,))]))

    def spec_for(_, x):
        dims = [None] * x.dim()
        used_model = False
        for i, d in enumerate(x.shape):
            if d == B and B > 1 and dims.count(baxis) == 0 and B % bsz == 0:
                dims[i] = baxis
            elif d == cache_len and not used_model and d % model == 0:
                dims[i] = "model"
                used_model = True
        if not used_model and x.dim() >= 3:
            last = x.shape[-1]
            if last >= 512 and last % model == 0 and dims[-1] is None:
                dims[-1] = "model"
        return tuple(dims)

    return partition.map_leaves(spec_for, cache)


def build_decode_case(cfg: ModelConfig, shape: InputShape, mesh) -> Case:
    """One decode step at the cache's last slot (``pos = seq_len - 1``)
    over zero caches of ``seq_len`` slots (``init_decode_cache``, as the
    reference lowers them; a vlm's cross slots and whisper's encoder
    states computed from meta media)."""
    fns = build(cfg)
    _activate(cfg, mesh, "serve", None)
    params, p_specs = _param_specs(cfg, fns)
    baxis = _baxis(mesh)
    B, S = shape.global_batch, shape.seq_len
    extra = {}
    if cfg.family in ("vlm", "audio"):
        extra["media"] = _meta(
            (B, cfg.n_media_tokens or cfg.n_audio_frames,
             cfg.d_media or cfg.d_model), common.param_dtype(cfg))
    with torch.no_grad():
        cache = fns.init_decode_cache(cfg, B, S, params=params,
                                      device="meta", **extra)
    token = _meta((B, 1), torch.int32)
    pos = S - 1

    def fn(params, tok, cache, p):
        return fns.decode_step(params, cfg, tok, cache, p)

    cache_specs = _cache_specs(cache, B, S, mesh)
    return Case(fn, (params, token, cache, pos),
                (p_specs, (baxis if B > 1 else None, None), cache_specs,
                 None),
                lambda out: (_logits_spec(B, cfg.vocab, mesh),
                             _cache_specs(out[1], B, S, mesh)),
                dict(kind="decode", arch=cfg.name, shape=shape.name,
                     dtype=cfg.param_dtype))


def build_case(arch: str, shape_name: str, mesh, **kw) -> Case:
    cfg = configs.get_config(arch)
    shape = configs.INPUT_SHAPES[shape_name]
    if shape.kind == "train":
        return build_train_case(cfg, shape, mesh, **kw)
    dtype = kw.get("dtype")
    if dtype:
        cfg = dataclasses.replace(cfg, param_dtype=dtype)
    if shape.kind == "prefill":
        return build_prefill_case(cfg, shape, mesh)
    return build_decode_case(cfg, shape, mesh)


def skip_reason(arch: str, shape_name: str) -> Optional[str]:
    """The reference's skips."""
    cfg = configs.get_config(arch)
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return ("pure full-attention arch: long_500k requires sub-quadratic "
                "attention (DESIGN.md §5)")
    if cfg.family == "audio" and shape_name == "long_500k":
        return "whisper operating range is 448-token targets"
    return None


# ---------------------------------------------------------------------------
# Per-device bytes, and the inputs on a device
# ---------------------------------------------------------------------------

def _pairs(tree, specs):
    """(tensor, spec) for every tensor leaf of ``tree`` (dicts, lists,
    NamedTuples) beside its spec tree of the same structure (a missing
    spec: replicated)."""
    if isinstance(tree, torch.Tensor):
        yield tree, (specs if isinstance(specs, tuple) else ())
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _pairs(v, None if specs is None else specs.get(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _pairs(v, specs[i] if specs is not None
                              and i < len(specs) else None)


def shard_bytes(x: torch.Tensor, spec: tuple) -> int:
    """The bytes of one device's shard of ``x`` under ``spec`` on the
    active mesh."""
    n = x.numel() * x.element_size()
    for entry in spec:
        if entry is not None:
            n //= partition._axis_size(entry)
    return n


def tree_bytes(tree, specs, seen: Optional[set] = None) -> int:
    """Per-device bytes of every distinct tensor of ``tree`` (a tensor met
    twice, such as the state's ``x`` that is ``w`` at round 0, counts
    once; ``seen`` carries the ids across calls)."""
    seen = set() if seen is None else seen
    total = 0
    for x, spec in _pairs(tree, specs):
        if id(x) in seen:
            continue
        seen.add(id(x))
        total += shard_bytes(x, spec)
    return total


def materialize(tree, device):
    """A case's meta inputs as zero tensors on ``device`` (non-tensor
    leaves kept): the bytes the dry run counts, allocated."""
    memo = {}

    def one(x):
        if not isinstance(x, torch.Tensor):
            return x
        if id(x) not in memo:
            memo[id(x)] = torch.zeros(x.shape, dtype=x.dtype, device=device)
        return memo[id(x)]

    def walk(t):
        if isinstance(t, torch.Tensor):
            return one(t)
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(walk(v) for v in t))
        if isinstance(t, tuple):
            return tuple(walk(v) for v in t)
        return t
    return walk(tree)
