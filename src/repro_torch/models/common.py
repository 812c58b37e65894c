"""Model configuration shared by all 10 assigned architectures."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch


def shard_hint(x, ctx, dims: tuple) -> Any:
    """Layout pin of the JAX package; the identity on one device."""
    return x


@dataclass
class MoEConfig:
    num_experts: int = 0           # routed experts
    top_k: int = 0
    num_shared: int = 0            # shared (always-on) experts
    expert_d_ff: int = 0           # per-expert hidden
    first_dense: int = 0           # leading dense layers before MoE starts
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01


@dataclass
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass
class MLAConfig:
    """DeepSeek-style Multi-head Latent Attention."""

    kv_lora_rank: int = 512
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128
    q_lora_rank: int = 0  # 0 = full-rank q projection (V2-Lite)


@dataclass
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    mlp: str = "swiglu"            # swiglu | gelu
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    max_seq_len: int = 1 << 20

    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    mla: MLAConfig | None = None

    # hybrid (hymba): sliding window for local attention layers; indices of
    # layers using global (full) attention
    sliding_window: int = 0        # 0 = full attention everywhere
    global_layers: tuple[int, ...] = ()

    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 1500        # fixed 30s audio frames
    max_target_len: int = 448

    # vlm: number of leading positions replaced by patch embeddings
    num_image_tokens: int = 0

    # numerics / execution
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    # "pallas" keeps the JAX package's name: here it selects the hand-written
    # CUDA flash-attention kernel (the plain version on CPU tensors)
    attention_impl: str = "reference"   # reference | pallas
    attention_chunk: int = 1024         # KV chunk for online-softmax reference
    # serving: all requests in a decode batch write the same cache slot
    # (aligned continuous batching): one contiguous slice write per step
    # instead of a ragged per-row scatter.
    aligned_decode: bool = False
    # scan_layers: kept for config parity; the port loops over the stacked
    # layer dim either way.
    scan_layers: bool = True
    moe_impl: str = "ep"                # ep (shard_map all-to-all) | dense
    remat: str = "none"                 # none | dots | full
    num_microbatches: int = 1
    logits_chunk: int = 0               # 0 = single logits matmul

    def __post_init__(self) -> None:
        if self.head_dim == 0:
            self.head_dim = self.d_model // self.num_heads

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    def replace(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- parameter counting (for MODEL_FLOPS = 6·N·D roofline term) ----------

    def param_counts(self) -> dict[str, int]:
        """Analytic parameter counts: total and active-per-token."""
        d, f, V = self.d_model, self.d_ff, self.vocab_size
        H, KV, hd = self.num_heads, self.num_kv_heads, self.head_dim

        embed = V * d if self.tie_embeddings else 2 * V * d

        if self.mla is not None:
            m = self.mla
            q_dim = H * (m.qk_nope_dim + m.qk_rope_dim)
            attn = (
                d * q_dim                                   # q proj
                + d * (m.kv_lora_rank + m.qk_rope_dim)      # kv down
                + m.kv_lora_rank * H * (m.qk_nope_dim + m.v_head_dim)  # kv up
                + H * m.v_head_dim * d                      # o proj
            )
        else:
            attn = d * H * hd + 2 * d * KV * hd + H * hd * d

        mlp_mult = 3 if self.mlp == "swiglu" else 2
        dense_mlp = mlp_mult * d * f

        ssm = 0
        if self.ssm is not None:
            s = self.ssm
            din = s.d_inner(d)
            nh = s.n_heads(d)
            ssm = (
                d * (2 * din + 2 * s.d_state + nh)  # in_proj (x,z,B,C,dt)
                + din * s.d_conv                     # conv
                + din * d                            # out_proj
                + 2 * nh                             # A, D
            )

        per_layer_total = per_layer_active = 0
        n_moe_layers = 0
        if self.moe is not None:
            mo = self.moe
            expert = mlp_mult * d * mo.expert_d_ff
            router = d * mo.num_experts
            moe_total = mo.num_experts * expert + mo.num_shared * expert + router
            moe_active = mo.top_k * expert + mo.num_shared * expert + router
            n_moe_layers = self.num_layers - mo.first_dense
            per_layer_total = attn + moe_total
            per_layer_active = attn + moe_active
            dense_layers = mo.first_dense
        else:
            dense_layers = self.num_layers

        if self.family == "ssm":
            layer = ssm
        elif self.family == "hybrid":
            layer = attn + ssm + dense_mlp
        else:
            layer = attn + dense_mlp

        total = embed + dense_layers * layer + n_moe_layers * per_layer_total
        active = embed + dense_layers * layer + n_moe_layers * per_layer_active
        if self.is_encdec:
            # encoder layers: self-attn + mlp; decoder adds cross-attn
            enc = self.encoder_layers * (attn + dense_mlp)
            dec = self.num_layers * (2 * attn + dense_mlp)
            total = embed + enc + dec
            active = total
        return {"total": total, "active": active}
