"""Parameter-sharding rules per model family (port of
``repro.models.rules``, regex for regex).

Each rule is (path-regex, logical-axes-tuple-right-aligned).  Logical
names resolve through :mod:`repro_torch.sharding.partition`.  ``fsdp`` adds
data-axis sharding on a heavy dim for giant models (llama-90b, deepseek
v2/v3 dense parts).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def dense_rules(cfg: ModelConfig, fsdp: bool = None):
    if fsdp is None:
        fsdp = cfg.fsdp
    wide = "fsdp" if fsdp else None
    return [
        (r"embed$", (None, "vocab", "embed")),
        (r"lm_head$", (None, "embed", "vocab")),
        (r"media_proj$", (None, None, None)),
        (r"attn/wq$", (None, wide, "heads")),
        (r"attn/w[kv]$", (None, wide, "kv_heads")),
        (r"attn/wo$", (None, "heads", wide)),
        (r"attn/gate$", ()),
        (r"mlp/w_(gate|up)$", (None, wide, "ffn")),
        (r"mlp/w_down$", (None, "ffn", wide)),
        (r"ln", (None, None)),
        (r"norm", (None, None)),
    ]


def moe_rules(cfg: ModelConfig):
    # experts sharded over the expert axis (data); TP over model (ffn);
    # MLA/dense parts FSDP-sharded over data for the giants (cfg.fsdp).
    wide = "fsdp" if cfg.fsdp else None
    return [
        (r"experts/w_(gate|up)$", (None, "experts", None, "ffn")),
        (r"experts/w_down$", (None, "experts", "ffn", None)),
        (r"shared/w_(gate|up)$", (None, wide, "ffn")),
        (r"shared/w_down$", (None, "ffn", wide)),
        (r"router", (None, None, None)),
        (r"mla/wq_b$", (None, wide, "heads")),
        (r"mla/wq_a$", (None, wide, None)),
        (r"mla/w(kv_a|k_b|v_b)$", (None, wide, "heads")),
        (r"mla/wo$", (None, "heads", wide)),
        (r"mla/", (None, None, "heads")),
        (r"mtp/combine$", (None, wide, None)),
    ] + dense_rules(cfg)


def ssm_rules(cfg: ModelConfig):
    return [
        (r"in_proj$", (None, None, "ffn")),
        (r"out_proj$", (None, "ffn", None)),
        (r"conv_w$", (None, None, "ffn")),
        (r"conv_b$", (None, "ffn")),
        (r"(A_log|D|dt_bias)$", (None, None)),
    ] + dense_rules(cfg)


def hybrid_rules(cfg: ModelConfig):
    return [
        (r"lru/w_(x|a|gate|y)$", (None, None, "ffn")),
        (r"lru/(lam|b_x|b_a)$", (None, "ffn")),
        (r"lru/conv_w$", (None, None, "ffn")),
        (r"lru/conv_b$", (None, "ffn")),
    ] + dense_rules(cfg)


def audio_rules(cfg: ModelConfig):
    return [
        (r"pos_emb", (None, None, None)),
        (r"mlp/w_in$", (None, None, "ffn")),
        (r"mlp/w_out$", (None, "ffn", None)),
        (r"mlp/b_in$", (None, "ffn")),
        (r"mlp/b_out$", (None, None)),
    ] + dense_rules(cfg)
