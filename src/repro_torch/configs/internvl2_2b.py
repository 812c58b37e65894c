"""internvl2-2b [vlm]: InternViT frontend (stub) + InternLM2-1.8B backbone.

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.
[arXiv:2404.16821; hf]  ``input_specs()`` supplies precomputed patch
embeddings for the leading image-token positions.
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b", family="vlm",
        num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8,
        head_dim=128, d_ff=8192, vocab_size=92553,
        rope_theta=1_000_000.0, num_image_tokens=256,
    )


def smoke_config() -> ModelConfig:
    import torch
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, num_image_tokens=8,
        compute_dtype=torch.float32,
    )
