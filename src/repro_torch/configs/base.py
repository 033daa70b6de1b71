"""Configuration dataclasses for models, federation and input shapes (port
of ``repro.configs.base``: the LM trainer's families (dense, patterned
dense, Mamba-2, Griffin, the DeepSeek MoE with MLA and MTP, the
cross-attention VLM, the whisper encoder-decoder) on every wire, the async
engine, obs, the population scale-out, and the launch tooling's shapes).

Every architecture file (``configs/<id>.py``) exports ``CONFIG`` (the exact
full-scale :class:`ModelConfig`) and ``reduced()`` (a smoke-test variant).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0              # routed experts
    n_shared: int = 0               # shared (always-on) experts
    top_k: int = 1
    d_expert: int = 0               # per-expert FFN hidden dim
    capacity_factor: float = 1.25
    router_group: int = 1024        # GShard-style routing group size (tokens)
    balance_budget: float = 0.02    # constraint budget for g(w) = imbalance - budget
    first_dense: int = 1            # leading layers with dense FFN (deepseek)


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0            # 0 => full-rank q projection
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256
    n_groups: int = 1


@dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int = 0              # 0 => d_model
    d_conv: int = 4
    block_pattern: Tuple[str, ...] = ("rec", "rec", "attn")
    window: int = 2048


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 => d_model // n_heads
    qk_norm: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    window: int = 0                 # 0 => full attention
    local_global_ratio: int = 0     # e.g. 5 => 5 local : 1 global
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    # cross-attention (VLM): every `cross_attn_every` layers insert a cross block
    cross_attn_every: int = 0
    n_media_tokens: int = 0         # stub frontend: patches/frames per example
    d_media: int = 0                # stub embedding dim (0 => d_model)
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    n_audio_frames: int = 0
    max_target_len: int = 448
    mtp_depth: int = 0              # deepseek-v3 multi-token prediction depth
    # serving limits
    sub_quadratic: bool = False     # eligible for long_500k decode
    remat: bool = True              # recompute each layer body in backward
    # distribution
    fsdp: bool = False              # shard params over the data axis (giants)
    param_dtype: str = "float32"    # the giants' bf16: their decode caches
                                    # and the dry run's parameter bytes

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def n_params(self) -> int:
        """Analytic parameter count, the reference's (approximate for the
        ssm and moe families, norms and biases left out, every moe layer
        counted with experts; a cross layer counted on top of the self
        layers it replaces; embeddings included)."""
        d, L, V = self.d_model, self.n_layers, self.vocab
        hd = self.resolved_head_dim
        emb = V * d * (1 if self.tie_embeddings else 2)
        if self.ssm is not None:
            di = self.ssm.expand * d
            per_layer = d * (2 * di) + di * self.ssm.d_conv + di * d \
                + 2 * di * self.ssm.d_state // max(self.ssm.n_groups, 1)
        elif self.mla is not None:
            m = self.mla
            qdim = self.n_heads * (m.nope_head_dim + m.rope_head_dim)
            q = d * m.q_lora_rank + m.q_lora_rank * qdim if m.q_lora_rank \
                else d * qdim
            kv = d * (m.kv_lora_rank + m.rope_head_dim) + m.kv_lora_rank \
                * self.n_heads * (m.nope_head_dim + m.v_head_dim)
            per_layer = q + kv + self.n_heads * m.v_head_dim * d
        else:
            per_layer = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                + self.n_heads * hd * d
        if self.moe is not None:
            e = self.moe
            per_layer += 3 * d * e.d_expert * (e.n_shared + e.n_experts) \
                + d * e.n_experts
        elif self.ssm is None:
            per_layer += 3 * d * self.d_ff
        total = emb + L * per_layer
        if self.cross_attn_every:
            n_cross = L // self.cross_attn_every
            total += n_cross * (4 * d * d + 3 * d * self.d_ff)
        if self.encoder_layers:
            total += self.encoder_layers * (4 * d * d + 2 * d * self.d_ff)
        return total

    def n_active_params(self) -> int:
        """Per-token active params (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.n_params()
        e = self.moe
        inactive = 3 * self.d_model * e.d_expert * (e.n_experts - e.top_k)
        return self.n_params() - self.n_layers * inactive


# ---------------------------------------------------------------------------
# Federated / FedSGM configuration (Algorithm 1)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CompressorConfig:
    kind: str = "none"              # none | topk | randk | quant | natural
    ratio: float = 0.1              # topk/randk: k/d (k/block blockwise)
    bits: int = 8                   # quant: bits per code
    block: int = 1024               # preferred block (largest divisor <= it)
    shards: int = 1                 # blocks divide D/shards when possible


@dataclass(frozen=True)
class SwitchConfig:
    mode: str = "hard"              # hard | soft
    eps: float = 0.05               # constraint tolerance epsilon
    beta: float = 40.0              # soft sharpness


@dataclass(frozen=True)
class AsyncConfig:
    """Asynchronous buffered rounds (``repro_torch.engine.async_rounds``).

    A sampled client that departs mid-round parks its *compressed* uplink
    in a per-client staleness buffer slot; the payload merges into a later
    server update with weight ``lambda(s) * w_origin`` (s = age in rounds,
    ``w_origin`` = the sampler's Horvitz-Thompson weight at the round it
    was computed), or is dropped once ``s >= max_staleness``.
    ``enabled=False`` (the default) is the bit-parity point: the async
    drive loops reproduce the synchronous ones exactly."""
    enabled: bool = False
    max_staleness: int = 4          # a payload may merge up to this age;
                                    # undelivered entries expire at it
    staleness: str = "constant"     # constant | poly | constraint
                                    # (async_rounds.staleness_law registry)
    decay: float = 1.0              # poly/constraint exponent:
                                    # lambda(s) = (1+s)^-decay
    depart: float = 0.25            # mid-round departure probability for
                                    # samplers without an availability model
                                    # (markov uses its own chain instead)
    rejoin: float = 0.5             # per-round delivery probability for a
                                    # parked payload under those samplers
    boundary_width: float = 0.0     # constraint law: width of the
                                    # feasibility-boundary window (0 =>
                                    # max(switch.eps, 1e-3))


@dataclass(frozen=True)
class ObsConfig:
    """Observability (``repro_torch.obs``).  ``enabled=False`` leaves
    ``RoundMetrics.telemetry`` None and the round untouched; enabled, a
    :class:`repro_torch.obs.Telemetry` record of optimizer-health counters
    rides the round metrics, and the state trajectory stays bit-identical
    either way (observation only)."""
    enabled: bool = False
    window: int = 8                 # trailing window (rounds) for the
                                    # switching-fraction counter


@dataclass(frozen=True)
class ScaleConfig:
    """Population scale-out (``repro_torch.scale``).  The defaults are the
    parity point: the dense ``[n, d]`` uplink residual and single-tier
    aggregation."""
    ef_slots: int = 0               # >0: capacity of the [cap, d] uplink EF
                                    # slot store (scale.slots) replacing the
                                    # dense residual; needs gather mode and
                                    # cap >= m; cap >= n_clients is the dense
                                    # residual bit for bit (no eviction)
    cohorts: int = 1                # >1: two-tier aggregation, k edge
                                    # reducers over contiguous cohorts of the
                                    # stacked rows, partials summed left to
                                    # right; must divide the rows (n)


@dataclass(frozen=True)
class FleetConfig:
    """The client-population axis (``repro_torch.fleet``).  The defaults
    are the parity point: IID partition, uniform sampler, full-shard
    batches, no per-round re-draw -- a round on ``from_stacked(batches)``
    under them is the round on ``batches``, bit for bit."""
    # -- partitioner (fleet.partitions registry) ----------------------------
    partitioner: str = "iid"        # iid | dirichlet | zipf | shift
    alpha: float = 2.0              # dirichlet concentration (label skew)
    zipf_a: float = 1.2             # zipf exponent (quantity skew)
    shift: float = 0.0              # covariate-drift strength (shift)
    balance: bool = False           # equal-size re-slice of ragged label skew
    cap_factor: float = 2.0         # padded shard capacity x (n / n_clients)
    n_classes: int = 0              # 0 => infer from labels at build time
    # -- sampler (fleet.samplers registry) ----------------------------------
    sampler: str = "uniform"        # uniform | weighted | markov | fixed
    avail_stay: float = 0.9         # markov: P(available -> available)
    avail_return: float = 0.5       # markov: P(unavailable -> available)
    # -- provisioning (fleet.provision) -------------------------------------
    batch_size: int = 0             # per-client minibatch rows; 0 => full shard
    redraw: bool = False            # fresh minibatch draw every round


@dataclass(frozen=True)
class FedConfig:
    n_clients: int = 8
    m: int = 8                      # participating clients per round
    local_steps: int = 1            # E
    lr: float = 0.1                 # eta
    switch: SwitchConfig = field(default_factory=SwitchConfig)
    uplink: CompressorConfig = field(default_factory=CompressorConfig)
    downlink: CompressorConfig = field(default_factory=CompressorConfig)
    comm: str = "dense"             # dense | packed | pallas (the wire
                                    # backend: comm.transports.backend_for)
    proj_radius: float = 0.0        # Pi_X: L2 ball radius (0 => none)
    client_axis: Optional[str] = "data"   # mesh axis carrying the client dim
    track_wbar: bool = True         # keep the averaged-iterate accumulator
    seed: int = 0
    strategy: str = "fedsgm"        # engine.strategies registry key
    participation: str = "mask"     # mask (dense simulation) | gather
                                    # (compute-sparse: local steps over m)
    client_chunk: int = 0           # the reference's chunked client vmap;
                                    # the port runs clients one after another
                                    # (per-client results do not depend on it)
    full_eval: bool = True          # eval forward over all n clients; False:
                                    # the m sampled only, fused with the
                                    # first local step (engine.rounds)
    lean_metrics: bool = False      # skip the per-round delta_norm reduction
    rho: float = 1.0                # penalty-fedavg strength
    fleet: FleetConfig = field(default_factory=FleetConfig)
    async_: AsyncConfig = field(default_factory=AsyncConfig)
    scale: ScaleConfig = field(default_factory=ScaleConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)

    def replace(self, **kw) -> "FedConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input shapes (the launch tooling's cases)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def reduce_model(cfg: ModelConfig, **overrides) -> ModelConfig:
    """The reduced smoke-test variant of a full config."""
    kw = dict(
        n_layers=2,
        d_model=min(cfg.d_model, 128),
        n_heads=min(cfg.n_heads, 4),
        n_kv_heads=min(cfg.n_kv_heads, 2),
        d_ff=min(cfg.d_ff, 256),
        vocab=min(cfg.vocab, 512),
        head_dim=32 if cfg.head_dim else 0,
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, n_shared=min(cfg.moe.n_shared, 1),
            top_k=2, d_expert=64, router_group=64, first_dense=1)
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(
            kv_lora_rank=32, q_lora_rank=(32 if cfg.mla.q_lora_rank else 0),
            rope_head_dim=16, nope_head_dim=16, v_head_dim=16)
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=16,
                                        chunk=32)
    if cfg.rglru is not None:
        kw["rglru"] = dataclasses.replace(cfg.rglru, lru_width=0, window=32)
    if cfg.window:
        kw["window"] = 32
    if cfg.encoder_layers:
        kw["encoder_layers"] = 2
        kw["n_audio_frames"] = 16
    if cfg.cross_attn_every:
        kw["cross_attn_every"] = 2
        kw["n_media_tokens"] = 8
    if cfg.n_media_tokens and not cfg.cross_attn_every:
        kw["n_media_tokens"] = 8
    kw.update(overrides)
    return dataclasses.replace(cfg, **kw)
