"""whisper-small [audio] 12L dec + 12L enc, d_model=768 12H d_ff=3072
vocab=51865 -- enc-dec; conv/mel frontend is a STUB (the batch supplies
frame embeddings)  [arXiv:2212.04356]"""
from repro_torch.configs.base import ModelConfig, reduce_model

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=51865, tie_embeddings=True,
    encoder_layers=12, n_audio_frames=1500, max_target_len=448,
)


def reduced():
    return reduce_model(CONFIG)
