"""Plain reference of a dense decoder (RMSNorm, RoPE, GQA, SwiGLU): the
logits at chosen positions of whole sequences, layer by layer."""

from __future__ import annotations

import torch

from chipbench.families.dense import layer_groups
from chipbench.reference.common import (
    Prec,
    attention,
    check_positions,
    full_float32,
    head_logits,
    layer_weights,
    mlp,
    rmsnorm,
)


def block(x: torch.Tensor, w: dict, model: dict, window: int, p: Prec) -> torch.Tensor:
    eps = model["norm_eps"]
    x = x + attention(rmsnorm(x, w["ln1"]["scale"], eps), w["attn"], model, window, p)
    return x + mlp(rmsnorm(x, w["ln2"]["scale"], eps), w["mlp"], p)


def logits(model: dict, weights: dict, tokens: torch.Tensor, positions: list[int],
           mode: str = "f32", block_fn=block, groups=None) -> torch.Tensor:
    """(n, len(positions), V) float32 logits of ``tokens`` (n, T): every
    layer runs over each sequence in turn, so one layer's weights and one
    sequence's activations are live at a time.  ``groups``: the (name,
    layers, window) stacks of the weights (a dense model's one by default)."""
    check_positions(positions, tokens.shape[1])
    p = Prec(mode)
    with torch.no_grad(), full_float32():
        xs = [weights["embedding"]["embed"][row].float() for row in tokens]
        for name, count, window in groups or layer_groups(model):
            for i in range(count):
                w = layer_weights(weights[name], i)
                xs = [block_fn(x, w, model, window, p) for x in xs]
        last = torch.stack([x[positions] for x in xs])
        n, k, d = last.shape
        return head_logits(last.reshape(n * k, d), weights, model, p).reshape(n, k, -1)
