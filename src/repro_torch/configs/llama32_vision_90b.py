"""llama-3.2-vision-90b [vlm] 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 -- cross-attn image layers every 5th; ViT frontend is a STUB
(the batch supplies patch embeddings)  [hf:meta-llama/Llama-3.2-11B-Vision]"""
from repro_torch.configs.base import ModelConfig, reduce_model

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256, head_dim=128,
    cross_attn_every=5, n_media_tokens=1601, d_media=8192,
    rope_theta=500_000.0,
    fsdp=True, param_dtype="bfloat16",
)


def reduced():
    return reduce_model(CONFIG, n_layers=4, cross_attn_every=2,
                        n_media_tokens=8)
