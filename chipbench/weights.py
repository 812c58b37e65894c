"""Weights made from the seed, on the device, in the tree ``repro_torch.models.
transformer`` takes.

The layout is worked out here from the configuration file's sizes (the CPU
tests hold it to the port's own ``init_params``).  Every matrix is drawn from
one ``torch.Generator`` on the device in a few large ``randn`` calls into one
flat buffer in the served dtype, and each leaf is a view of its slice scaled
by the fan-in rule the port's initialiser uses (``normal_`` in place, so no
draw needs a second buffer); norms, gates and the SSM's
decay tables are set as the port sets them.  The program and the reference
are handed these same tensors.
"""

from __future__ import annotations

import math
from typing import Any

import torch

#: elements per ``randn`` call: a few calls for a model of billions
DRAW = 1 << 30


def layer_groups(model: dict[str, Any]) -> list[tuple[str, int, int]]:
    """(name, layers, window) of each stack of layers, as the port groups
    them: one stack for a dense model; for a hybrid one each global layer
    alone and each run of windowed layers between them."""
    L = model["num_layers"]
    if model["family"] != "hybrid":
        return [("layers", L, 0)]
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


def _layer(model: dict[str, Any]) -> dict[str, Any]:
    """One layer's leaves: (shape, init) where init is ("normal", std) or a
    fixed fill."""
    d, H, KV, hd, f = (model[k] for k in ("d_model", "num_heads", "num_kv_heads",
                                           "head_dim", "d_ff"))
    attn = {
        "w_q": ((d, H, hd), ("normal", d ** -0.5)),
        "w_k": ((d, KV, hd), ("normal", d ** -0.5)),
        "w_v": ((d, KV, hd), ("normal", d ** -0.5)),
        "w_o": ((H, hd, d), ("normal", (H * hd) ** -0.5)),
    }
    if model["qkv_bias"]:
        attn |= {"b_q": ((H, hd), ("zeros",)), "b_k": ((KV, hd), ("zeros",)),
                 "b_v": ((KV, hd), ("zeros",))}
    layer = {
        "ln1": {"scale": ((d,), ("ones",))},
        "attn": attn,
        "ln2": {"scale": ((d,), ("ones",))},
        "mlp": {
            "w_gate": ((d, f), ("normal", d ** -0.5)),
            "w_up": ((d, f), ("normal", d ** -0.5)),
            "w_down": ((f, d), ("normal", f ** -0.5)),
        },
    }
    if model["family"] == "hybrid":
        s = ssm_sizes(model)
        din, Hs, N, K = s["din"], s["H"], s["N"], s["K"]
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
    """The whole tree of (shape, init) leaves, layer stacks with a leading
    layer dim."""
    V, d = model["vocab_size"], model["d_model"]
    tree: dict[str, Any] = {"embedding": {"embed": ((V, d), ("normal", 0.02))}}
    if not model["tie_embeddings"]:
        tree["embedding"]["unembed"] = ((V, d), ("normal", d ** -0.5))
    one = _layer(model)
    for name, count, _ in layer_groups(model):
        tree[name] = _map(lambda leaf, n=count: ((n, *leaf[0]), leaf[1]), one)
    tree["final_norm"] = {"scale": ((d,), ("ones",))}
    return tree


def _is_leaf(x: Any) -> bool:
    return isinstance(x, tuple)


def _map(fn, tree):
    if _is_leaf(tree):
        return fn(tree)
    return {k: _map(fn, v) for k, v in tree.items()}


def _leaves(tree):
    if _is_leaf(tree):
        yield tree
    else:
        for v in tree.values():
            yield from _leaves(v)


def make(model: dict[str, Any], seed: int, device: torch.device,
         dtype: torch.dtype) -> dict[str, Any]:
    """The weight tree for ``seed``: the same seed gives the same weights."""
    tree = layout(model)
    drawn = sum(math.prod(s) for s, init in _leaves(tree) if init[0] == "normal")
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    flat = torch.empty(drawn, dtype=dtype, device=device)
    for start in range(0, drawn, DRAW):
        flat[start:start + DRAW].normal_(generator=gen)
    offset = 0

    def fill(leaf):
        nonlocal offset
        shape, init = leaf
        kind = init[0]
        if kind == "normal":
            n = math.prod(shape)
            t = flat[offset:offset + n].view(shape)
            offset += n
            return t.mul_(init[1])
        t = torch.empty(shape, dtype=dtype, device=device)
        if kind == "ones":
            return t.fill_(1.0)
        if kind == "zeros":
            return t.zero_()
        H = shape[-1]
        if kind == "a_log":
            row = torch.log(torch.linspace(1.0, 16.0, H, device=device))
        else:  # dt_bias: softplus(dt_bias) = 0.01
            row = torch.log(torch.expm1(torch.full((H,), 0.01, device=device)))
        return t.copy_(row.expand(shape))

    return _map(fill, tree)
