"""Plain reference of the hybrid decoder (hymba as the port defines it):
each layer averages windowed or full attention and an SSD mixer over one
normed input, then a SwiGLU MLP."""

from __future__ import annotations

import torch

from chipbench.families.hybrid import layer_groups
from chipbench.reference import dense
from chipbench.reference.common import Prec, attention, mamba, mlp, rmsnorm


def block(x: torch.Tensor, w: dict, model: dict, window: int, p: Prec) -> torch.Tensor:
    eps = model["norm_eps"]
    h = rmsnorm(x, w["ln1"]["scale"], eps)
    y = 0.5 * (attention(h, w["attn"], model, window, p) * w["beta_attn"].float()
               + mamba(h, w["mamba"], model, p) * w["beta_ssm"].float())
    x = x + y
    return x + mlp(rmsnorm(x, w["ln2"]["scale"], eps), w["mlp"], p)


def logits(model: dict, weights: dict, tokens: torch.Tensor, positions: list[int],
           mode: str = "f32") -> torch.Tensor:
    return dense.logits(model, weights, tokens, positions, mode, block_fn=block,
                        groups=layer_groups(model))
