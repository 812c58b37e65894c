"""hymba-1.5b [hybrid]: 32L d_model=1600, 25H (GQA kv=5), parallel attn+SSM.

d_ff=5504 vocab=32001 d_state=16.  Sliding-window attention (1024) on local
layers, full attention on layers {0, 15, 31}.  [arXiv:2411.13676; hf]
"""
from repro_torch.models.common import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b", family="hybrid",
        num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
        head_dim=64, d_ff=5504, vocab_size=32001,
        sliding_window=1024, global_layers=(0, 15, 31),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=1, head_dim=64, chunk=128),
    )


def smoke_config() -> ModelConfig:
    import torch
    return config().replace(
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, sliding_window=16, global_layers=(0, 3),
        ssm=SSMConfig(d_state=8, d_conv=4, expand=1, head_dim=16, chunk=16),
        compute_dtype=torch.float32,
    )
