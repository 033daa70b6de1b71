"""recurrentgemma-2b [hybrid] 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000 -- RG-LRU + local attn, 1 attn : 2 recurrent  [arXiv:2402.19427]"""
from repro_torch.configs.base import ModelConfig, RGLRUConfig, reduce_model

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
    d_ff=7680, vocab=256000, head_dim=256, tie_embeddings=True,
    rglru=RGLRUConfig(lru_width=2560, d_conv=4,
                      block_pattern=("rec", "rec", "attn"), window=2048),
    sub_quadratic=True,
)


def reduced():
    return reduce_model(CONFIG, n_layers=3, n_heads=2, n_kv_heads=1)
