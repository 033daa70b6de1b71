"""smollm-360m [dense] 32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152
llama-arch small  [hf:HuggingFaceTB/SmolLM-360M]"""
from repro_torch.configs.base import ModelConfig, reduce_model

CONFIG = ModelConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
    d_ff=2560, vocab=49152, tie_embeddings=True,
)


def reduced():
    return reduce_model(CONFIG, n_heads=3, n_kv_heads=1)
