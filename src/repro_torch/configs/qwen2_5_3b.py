"""qwen2.5-3b [dense]: 36L d_model=2048 16H (GQA kv=2) d_ff=11008.

vocab=151936, QKV bias, tied embeddings.  [hf:Qwen/Qwen2.5-0.5B; hf]
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b", family="dense",
        num_layers=36, d_model=2048, num_heads=16, num_kv_heads=2,
        head_dim=128, d_ff=11008, vocab_size=151_936,
        qkv_bias=True, rope_theta=1_000_000.0, tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    import torch
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, compute_dtype=torch.float32,
    )
