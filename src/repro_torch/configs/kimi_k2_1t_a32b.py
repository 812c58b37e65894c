"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) hd=128.

MoE: 384 routed top-8 + 1 shared, expert d_ff=2048, first layer dense.
vocab=163840.  Trillion-param MoE (paper-table).  [arXiv:2501.kimi2]
"""
from repro_torch.models.common import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b", family="moe",
        num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
        head_dim=128, d_ff=2048, vocab_size=163_840,
        rope_theta=50_000.0,
        moe=MoEConfig(num_experts=384, top_k=8, num_shared=1,
                      expert_d_ff=2048, first_dense=1),
    )


def smoke_config() -> ModelConfig:
    import torch
    return config().replace(
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=64, vocab_size=256,
        moe=MoEConfig(num_experts=8, top_k=2, num_shared=1,
                      expert_d_ff=64, first_dense=1),
        moe_impl="dense", compute_dtype=torch.float32,
    )
