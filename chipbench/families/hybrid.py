"""The hybrid decoder family (hymba as the port defines it): in every layer
windowed or full attention beside an SSD mixer over one normed input, then
a SwiGLU MLP.  Its layer stacks, weight layout and request work, from the
configuration file's sizes."""

from __future__ import annotations

from typing import Any

import torch

from chipbench.families import dense
from chipbench.work import group_windows, ssd_chunk_flops


def layer_groups(model: dict[str, Any]) -> list[tuple[str, int, int]]:
    """(name, layers, window) of each stack of layers, as the port groups
    them: each global layer alone and each run of windowed layers between
    them."""
    L = model["num_layers"]
    glob = set(model["global_layers"])
    groups: list[tuple[str, int, int]] = []
    i = g = 0
    while i < L:
        if i in glob:
            groups.append((f"global{g}", 1, 0))
            g += 1
            i += 1
            continue
        j = i
        while j < L and j not in glob:
            j += 1
        groups.append((f"local{len(groups)}", j - i, model["sliding_window"]))
        i = j
    return groups


def ssm_sizes(model: dict[str, Any]) -> dict[str, int]:
    s = model["ssm"]
    din = s["expand"] * model["d_model"]
    return {"din": din, "H": din // s["head_dim"], "P": s["head_dim"], "N": s["d_state"],
            "K": s["d_conv"], "chunk": s["chunk"], "conv_dim": din + 2 * s["d_state"]}


def layer_layout(model: dict[str, Any]) -> dict[str, Any]:
    """A dense layer's leaves, then the mixer's and the two branch gates (the
    order of the draw, kept from the first benchmark so the same seed gives
    the same weights)."""
    d = model["d_model"]
    s = ssm_sizes(model)
    din, Hs, N, K = s["din"], s["H"], s["N"], s["K"]
    layer = dense.layer_layout(model)
    layer["mamba"] = {
        "w_in": ((d, 2 * din + 2 * N + Hs), ("normal", d ** -0.5)),
        "conv_w": ((s["conv_dim"], K), ("normal", K ** -0.5)),
        "conv_b": ((s["conv_dim"],), ("zeros",)),
        "a_log": ((Hs,), ("a_log",)),
        "dt_bias": ((Hs,), ("dt_bias",)),
        "d_skip": ((Hs,), ("ones",)),
        "norm_scale": ((din,), ("ones",)),
        "w_out": ((din, d), ("normal", din ** -0.5)),
    }
    layer["beta_attn"] = ((d,), ("ones",))
    layer["beta_ssm"] = ((d,), ("ones",))
    return layer


def layout(model: dict[str, Any]) -> dict[str, Any]:
    return dense.model_layout(model, dense.stacked(layer_groups(model), layer_layout(model)))


def _a_log(t: torch.Tensor) -> torch.Tensor:
    """Each head's log decay rate, log(1) ... log(16) over the heads."""
    row = torch.log(torch.linspace(1.0, 16.0, t.shape[-1], device=t.device))
    return t.copy_(row.expand(t.shape))


def _dt_bias(t: torch.Tensor) -> torch.Tensor:
    """softplus(dt_bias) = 0.01 in every head."""
    row = torch.log(torch.expm1(torch.full((t.shape[-1],), 0.01, device=t.device)))
    return t.copy_(row.expand(t.shape))


#: the fills of the mixer's decay tables, as the port sets them
INITS = {"a_log": _a_log, "dt_bias": _dt_bias}


def linear_weights(model: dict[str, Any]) -> int:
    """Weight elements of one layer's products: a dense layer's and the
    mixer's in and out projections."""
    d = model["d_model"]
    s = ssm_sizes(model)
    return (dense.linear_weights(model) + d * (2 * s["din"] + 2 * s["N"] + s["H"])
            + s["din"] * d)


def request_flops(model: dict[str, Any], prompt_len: int, gen: int) -> float:
    """A dense request's FLOPs over the hybrid's windows and wider layers,
    and the mixer's: the SSD scan in its chunked form over the prompt, each
    decode step's update and read-out 4NP a head, the causal convolution 2K
    per channel and token."""
    layers = group_windows(layer_groups(model))
    s = ssm_sizes(model)
    per_layer = ssd_chunk_flops(prompt_len, s) + (gen - 1) * 4 * s["H"] * s["P"] * s["N"]
    per_layer += (prompt_len + gen - 1) * 2 * s["K"] * s["conv_dim"]
    return float(dense.stack_flops(model, prompt_len, gen, layers, linear_weights(model))
                 + len(layers) * per_layer)


PUBLISHED = dense.PUBLISHED | {
    "sliding_window": lambda cfg: cfg.sliding_window,
    "global_attn_idx": lambda cfg: list(cfg.global_layers),
    "mamba_expand": lambda cfg: cfg.ssm.d_inner(cfg.d_model) / cfg.d_model,
    "mamba_d_state": lambda cfg: cfg.ssm.d_state,
    "mamba_d_conv": lambda cfg: cfg.ssm.d_conv,
}
