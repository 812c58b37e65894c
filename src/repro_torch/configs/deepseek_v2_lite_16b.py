"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H, MLA kv_lora=512.

MoE: 64 routed top-6 + 2 shared, expert d_ff=1408, first layer dense.
vocab=102400.  [arXiv:2405.04434; hf]
"""
from repro_torch.models.common import MLAConfig, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b", family="moe",
        num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
        head_dim=128, d_ff=1408, vocab_size=102_400,
        mla=MLAConfig(kv_lora_rank=512, qk_rope_dim=64, qk_nope_dim=128,
                      v_head_dim=128),
        moe=MoEConfig(num_experts=64, top_k=6, num_shared=2,
                      expert_d_ff=1408, first_dense=1),
    )


def smoke_config() -> ModelConfig:
    import torch
    return config().replace(
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=64, vocab_size=256,
        mla=MLAConfig(kv_lora_rank=32, qk_rope_dim=8, qk_nope_dim=16,
                      v_head_dim=16),
        moe=MoEConfig(num_experts=8, top_k=2, num_shared=1,
                      expert_d_ff=64, first_dense=1),
        moe_impl="dense", compute_dtype=torch.float32,
    )
