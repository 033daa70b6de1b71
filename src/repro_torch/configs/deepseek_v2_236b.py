"""deepseek-v2-236b [moe] 60L d_model=5120 128H (MLA kv_lora=512)
d_ff(expert)=1536 vocab=102400, MoE 2 shared + 160 routed top-6
[arXiv:2405.04434]"""
from repro_torch.configs.base import (MLAConfig, ModelConfig, MoEConfig,
                                      reduce_model)

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=1536, vocab=102400,
    moe=MoEConfig(n_experts=160, n_shared=2, top_k=6, d_expert=1536,
                  capacity_factor=1.25, router_group=4096, first_dense=1),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    fsdp=True, param_dtype="bfloat16",
)


def reduced():
    return reduce_model(CONFIG, n_layers=2)
