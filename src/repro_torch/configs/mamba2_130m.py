"""mamba2-130m [ssm]: 24L d_model=768, attn-free, SSD, d_state=128.

[arXiv:2405.21060; unverified]  Tied embeddings (GPT-NeoX vocab 50280).
"""
from repro_torch.models.common import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m", family="ssm",
        num_layers=24, d_model=768, num_heads=12, num_kv_heads=12,
        head_dim=64, d_ff=0, vocab_size=50280, tie_embeddings=True,
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=128),
    )


def smoke_config() -> ModelConfig:
    import torch
    return config().replace(
        num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, head_dim=32,
        vocab_size=256,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32, chunk=32),
        compute_dtype=torch.float32,
    )
