"""granite-20b [dense]: 52L d_model=6144 48H (MQA kv=1) d_ff=24576.

vocab=49152, llama-style per assignment (RoPE/SwiGLU/RMSNorm) with MQA.
[arXiv:2405.04324; hf]
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-20b", family="dense",
        num_layers=52, d_model=6144, num_heads=48, num_kv_heads=1,
        head_dim=128, d_ff=24576, vocab_size=49152,
        rope_theta=10_000.0,
    )


def smoke_config() -> ModelConfig:
    import torch
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
        d_ff=256, vocab_size=256, compute_dtype=torch.float32,
    )
