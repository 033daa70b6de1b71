"""gemma3-4b [dense] 34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144
5:1 local:global, 128k context, sliding window 1024  [hf:google/gemma-3-1b-pt]"""
from repro_torch.configs.base import ModelConfig, reduce_model

CONFIG = ModelConfig(
    name="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4,
    d_ff=10240, vocab=262144, head_dim=256,
    qk_norm=True, tie_embeddings=True,
    window=1024, local_global_ratio=5, rope_theta=1_000_000.0,
    sub_quadratic=True,   # 5:1 sliding locals; globals linear per token
)


def reduced():
    return reduce_model(CONFIG, local_global_ratio=2)
