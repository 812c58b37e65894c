"""whisper-tiny [audio]: enc-dec, 4+4L d_model=384 6H d_ff=1536 vocab=51865.

[arXiv:2212.04356; unverified]  Conv frontend stubbed: frame embeddings come
precomputed.  LayerNorm + GELU + learned positions (rope_theta=0).  The
assigned seq shapes apply to the decoder (self-KV cache length).
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny", family="audio",
        num_layers=4, encoder_layers=4, d_model=384, num_heads=6,
        num_kv_heads=6, head_dim=64, d_ff=1536, vocab_size=51865,
        norm="layernorm", mlp="gelu", rope_theta=0.0, tie_embeddings=True,
        encoder_seq=1500, max_target_len=448,
    )


def smoke_config() -> ModelConfig:
    import torch
    return config().replace(
        num_layers=2, encoder_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256,
        encoder_seq=32, max_target_len=32, compute_dtype=torch.float32,
    )
