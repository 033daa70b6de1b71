"""deepseek-v3-671b [moe] 61L d_model=7168 128H (MLA) d_ff(expert)=2048
vocab=129280, MoE 1 shared + 256 routed top-8, MLA kv_lora=512, MTP
[arXiv:2412.19437]"""
from repro_torch.configs.base import (MLAConfig, ModelConfig, MoEConfig,
                                      reduce_model)

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=2048, vocab=129280,
    moe=MoEConfig(n_experts=256, n_shared=1, top_k=8, d_expert=2048,
                  capacity_factor=1.25, router_group=4096, first_dense=3),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    mtp_depth=1,
    fsdp=True, param_dtype="bfloat16",
)


def reduced():
    return reduce_model(CONFIG, n_layers=3, mtp_depth=1)
