"""Plain PyTorch version of flash attention (materializes the score matrix).

Counterpart of ``repro/kernels/flash_attention/ref.py::attention_ref``.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,   # (B, H, Sq, hd)
    k: torch.Tensor,   # (B, KV, Skv, hd)
    v: torch.Tensor,   # (B, KV, Skv, hd)
    *,
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else hd**-0.5
    qg = q.reshape(B, KV, G, Sq, hd)
    s = torch.einsum("bkgqh,bkch->bkgqc", qg.float(), k.float()) * scale
    if causal:
        pos_k = torch.arange(Skv, device=q.device)
        pos_q = torch.arange(Sq, device=q.device)
        mask = pos_k[None, :] <= pos_q[:, None]
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqc,bkch->bkgqh", p, v.float())
    return o.reshape(B, H, Sq, hd).to(q.dtype)
