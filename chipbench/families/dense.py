"""The dense decoder family (RMSNorm, RoPE, GQA, SwiGLU), from the
configuration file's sizes: its layer stack, its weight layout, the work a
request needs, and ``PUBLISHED``, how each key of a ``published`` block
(the source's ``config.json`` name) reads off the port's config.  Other
families build on its pieces."""

from __future__ import annotations

from typing import Any

from chipbench.weights import tree_map
from chipbench.work import causal_pairs, decode_keys, group_windows


def layer_groups(model: dict[str, Any]) -> list[tuple[str, int, int]]:
    """(name, layers, window) of each stack of layers, as the port groups
    them: one stack, full attention."""
    return [("layers", model["num_layers"], 0)]


def attention_layout(model: dict[str, Any]) -> dict[str, Any]:
    """One layer's attention leaves: (shape, init), where init is
    ("normal", std) or a fixed fill."""
    d, H, KV, hd = (model[k] for k in ("d_model", "num_heads", "num_kv_heads", "head_dim"))
    attn = {
        "w_q": ((d, H, hd), ("normal", d ** -0.5)),
        "w_k": ((d, KV, hd), ("normal", d ** -0.5)),
        "w_v": ((d, KV, hd), ("normal", d ** -0.5)),
        "w_o": ((H, hd, d), ("normal", (H * hd) ** -0.5)),
    }
    if model["qkv_bias"]:
        attn |= {"b_q": ((H, hd), ("zeros",)), "b_k": ((KV, hd), ("zeros",)),
                 "b_v": ((KV, hd), ("zeros",))}
    return attn


def mlp_layout(d: int, f: int) -> dict[str, Any]:
    """A SwiGLU MLP's leaves, d wide with a hidden of f."""
    return {
        "w_gate": ((d, f), ("normal", d ** -0.5)),
        "w_up": ((d, f), ("normal", d ** -0.5)),
        "w_down": ((f, d), ("normal", f ** -0.5)),
    }


def layer_layout(model: dict[str, Any]) -> dict[str, Any]:
    d = model["d_model"]
    return {
        "ln1": {"scale": ((d,), ("ones",))},
        "attn": attention_layout(model),
        "ln2": {"scale": ((d,), ("ones",))},
        "mlp": mlp_layout(d, model["d_ff"]),
    }


def stacked(groups: list[tuple[str, int, int]], one: dict[str, Any]) -> dict[str, Any]:
    """Each group's stack of ``one`` layer's leaves, with a leading layer dim."""
    return {name: tree_map(lambda leaf, n=count: ((n, *leaf[0]), leaf[1]), one)
            for name, count, _ in groups}


def model_layout(model: dict[str, Any], groups: dict[str, Any]) -> dict[str, Any]:
    """The whole tree: the embedding, the stacked ``groups``, the final norm."""
    V, d = model["vocab_size"], model["d_model"]
    tree: dict[str, Any] = {"embedding": {"embed": ((V, d), ("normal", 0.02))}}
    if not model["tie_embeddings"]:
        tree["embedding"]["unembed"] = ((V, d), ("normal", d ** -0.5))
    tree |= groups
    tree["final_norm"] = {"scale": ((d,), ("ones",))}
    return tree


def layout(model: dict[str, Any]) -> dict[str, Any]:
    """The whole tree of (shape, init) leaves, layer stacks with a leading
    layer dim."""
    return model_layout(model, stacked(layer_groups(model), layer_layout(model)))


def linear_weights(model: dict[str, Any]) -> int:
    """Weight elements of one layer's products (norms and gates aside)."""
    d, H, KV, hd, f = (model[k] for k in ("d_model", "num_heads", "num_kv_heads",
                                           "head_dim", "d_ff"))
    return d * H * hd + 2 * d * KV * hd + H * hd * d + 3 * d * f


def stack_flops(model: dict[str, Any], prompt_len: int, gen: int, windows: list[int],
                linear: int) -> int:
    """FLOPs of one request through a stack of attention layers with
    ``linear`` weight elements each, and the LM head.  Every weight once per
    token that passes the layer (the prompt, then each of the G - 1 decode
    steps' one token); each (query, key) pair the causal mask and the
    layer's window keep costs 4 hd per head, scores and values; the head at
    the last prompt position and at every decode step."""
    H, hd = model["num_heads"], model["head_dim"]
    tokens = prompt_len + gen - 1
    flops = 2 * tokens * len(windows) * linear
    flops += 2 * gen * model["d_model"] * model["vocab_size"]
    for w in windows:
        flops += 4 * H * hd * (causal_pairs(prompt_len, w) + decode_keys(prompt_len, gen, w))
    return flops


def request_flops(model: dict[str, Any], prompt_len: int, gen: int) -> float:
    """FLOPs one request of ``prompt_len`` tokens and ``gen`` answer tokens
    needs: a prefill and G - 1 decode steps."""
    return float(stack_flops(model, prompt_len, gen, group_windows(layer_groups(model)),
                             linear_weights(model)))


def _heads(cfg) -> int | None:
    """The query heads, each hidden / heads wide as the source derives its
    head size (None where the port's head size is another)."""
    return cfg.num_heads if cfg.num_heads * cfg.head_dim == cfg.d_model else None


PUBLISHED = {
    "num_hidden_layers": lambda cfg: cfg.num_layers,
    "hidden_size": lambda cfg: cfg.d_model,
    "num_attention_heads": _heads,
    "num_key_value_heads": lambda cfg: cfg.num_kv_heads,
    "intermediate_size": lambda cfg: cfg.d_ff,
    "vocab_size": lambda cfg: cfg.vocab_size,
    "tie_word_embeddings": lambda cfg: cfg.tie_embeddings,
    "rope_theta": lambda cfg: cfg.rope_theta,
}
