"""mamba2-130m [ssm] 24L d_model=768 (attn-free) vocab=50280 ssm_state=128
SSD state-space duality  [arXiv:2405.21060]"""
from repro_torch.configs.base import ModelConfig, SSMConfig, reduce_model

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=50280, tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
    sub_quadratic=True,
)


def reduced():
    return reduce_model(CONFIG)
