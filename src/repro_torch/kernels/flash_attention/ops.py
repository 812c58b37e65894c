"""Public wrapper for the flash-attention kernel.

Keeps the JAX wrapper's contract (``repro/kernels/flash_attention/ops.py``):
layout (B, H, S, hd) for q and (B, KV, S, hd) for k and v, ``H % KV == 0``,
and ``scale = hd**-0.5`` by default.  CPU tensors take the plain version
(``ref.attention_ref``); CUDA tensors launch the hand-written kernel, which
masks ragged lengths itself (no padding), or the call raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
from repro_torch.kernels.flash_attention.ref import attention_ref

#: kernel launches since the count was last set to 0
launch_count = 0


def flash_attention_gqa(
    q: torch.Tensor,   # (B, H, Sq, hd)
    k: torch.Tensor,   # (B, KV, Skv, hd)
    v: torch.Tensor,   # (B, KV, Skv, hd)
    *,
    causal: bool = True,
    scale: float | None = None,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Flash attention with grouped-query heads. Returns (B, H, Sq, hd).

    ``block_q``/``block_k`` are accepted for the JAX signature; the CUDA
    kernel's tiles are fixed at compile time and the plain version has none.
    """
    global launch_count
    B, H, Sq, hd = q.shape
    KV = k.shape[1]
    if H % KV != 0:
        raise ValueError(f"H={H} not a multiple of KV={KV}")
    if scale is None:
        scale = hd**-0.5
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, scale=scale)
    if q.numel() == 0:
        return torch.empty_like(q)
    out = flash_attention_fwd(q, k, v, causal=causal, scale=scale)
    launch_count += 1
    return out
