"""The MoE decoder family (DeepSeek-V2 as the port defines it): latent
attention (MLA) in every layer; the leading ``first_dense`` layers end in a
SwiGLU MLP, the rest in a mixture of routed experts beside shared ones.  Its
layer stacks, weight layout and request work, from the configuration file's
sizes."""

from __future__ import annotations

from typing import Any

from chipbench.families import dense
from chipbench.work import causal_pairs, decode_keys


def layer_groups(model: dict[str, Any]) -> list[tuple[str, int, int]]:
    """(name, layers, window): the leading dense layers, then the MoE ones."""
    fd = model["moe"]["first_dense"]
    return [(name, n, 0) for name, n in (("dense0", fd), ("moe", model["num_layers"] - fd))
            if n]


def dense_width(model: dict[str, Any]) -> int:
    """The leading dense layers' MLP hidden: the active experts' width, as
    the port sets it."""
    mo = model["moe"]
    return (mo["top_k"] + mo["num_shared"]) * mo["expert_d_ff"]


def attention_layout(model: dict[str, Any]) -> dict[str, Any]:
    d, H = model["d_model"], model["num_heads"]
    m = model["mla"]
    r, rope, nope, v = m["kv_lora_rank"], m["qk_rope_dim"], m["qk_nope_dim"], m["v_head_dim"]
    return {
        "w_q": ((d, H, nope + rope), ("normal", d ** -0.5)),
        "w_dkv": ((d, r + rope), ("normal", d ** -0.5)),
        "w_uk": ((r, H, nope), ("normal", r ** -0.5)),
        "w_uv": ((r, H, v), ("normal", r ** -0.5)),
        "w_o": ((H, v, d), ("normal", (H * v) ** -0.5)),
    }


def moe_layout(model: dict[str, Any]) -> dict[str, Any]:
    d = model["d_model"]
    mo = model["moe"]
    E, f = mo["num_experts"], mo["expert_d_ff"]
    tree = {
        "router": ((d, E), ("normal", d ** -0.5)),
        "w_gate": ((E, d, f), ("normal", d ** -0.5)),
        "w_up": ((E, d, f), ("normal", d ** -0.5)),
        "w_down": ((E, f, d), ("normal", f ** -0.5)),
    }
    if mo["num_shared"]:
        tree["shared"] = dense.mlp_layout(d, mo["num_shared"] * f)
    return tree


def layout(model: dict[str, Any]) -> dict[str, Any]:
    """The port's tree, in ``init_params``' order."""
    d = model["d_model"]
    groups = {}
    for name, count, _ in layer_groups(model):
        one = {"ln1": {"scale": ((d,), ("ones",))}, "attn": attention_layout(model),
               "ln2": {"scale": ((d,), ("ones",))}}
        if name == "moe":
            one["moe"] = moe_layout(model)
        else:
            one["mlp"] = dense.mlp_layout(d, dense_width(model))
        groups |= dense.stacked([(name, count, 0)], one)
    return dense.model_layout(model, groups)


def request_flops(model: dict[str, Any], prompt_len: int, gen: int) -> float:
    """FLOPs one request needs: every weight once per token that passes the
    layer, the routed experts a token's ``top_k`` and the shared ones; the
    latent's up-projections once per token (the prompt's keys and values
    expanded from it, each decode step's query and output absorbed into
    it), each (query, key) pair of the prompt 2 (qk + v) per head and each
    key a decode step reads 2 (2 r + rope) per head; the LM head at the last
    prompt position and at every decode step."""
    d, H = model["d_model"], model["num_heads"]
    m, mo = model["mla"], model["moe"]
    r, rope, nope, v = m["kv_lora_rank"], m["qk_rope_dim"], m["qk_nope_dim"], m["v_head_dim"]
    attn = d * H * (nope + rope) + d * (r + rope) + H * v * d + r * H * (nope + v)
    experts = (mo["top_k"] + mo["num_shared"]) * 3 * d * mo["expert_d_ff"]
    tokens = prompt_len + gen - 1
    per_pair = 2 * H * (nope + rope + v) * causal_pairs(prompt_len)
    per_key = 2 * H * (2 * r + rope) * decode_keys(prompt_len, gen)
    flops = 2 * gen * d * model["vocab_size"]
    for name, count, _ in layer_groups(model):
        mlp = experts + d * mo["num_experts"] if name == "moe" else 3 * d * dense_width(model)
        flops += count * (2 * tokens * (attn + mlp) + per_pair + per_key)
    return float(flops)


PUBLISHED = {
    "num_hidden_layers": lambda cfg: cfg.num_layers,
    "hidden_size": lambda cfg: cfg.d_model,
    "num_attention_heads": lambda cfg: cfg.num_heads,
    "num_key_value_heads": lambda cfg: cfg.num_kv_heads,
    "intermediate_size": lambda cfg: (cfg.moe.top_k + cfg.moe.num_shared) * cfg.moe.expert_d_ff,
    "vocab_size": lambda cfg: cfg.vocab_size,
    "tie_word_embeddings": lambda cfg: cfg.tie_embeddings,
    "rope_theta": lambda cfg: cfg.rope_theta,
    "kv_lora_rank": lambda cfg: cfg.mla.kv_lora_rank,
    "q_lora_rank": lambda cfg: cfg.mla.q_lora_rank or None,
    "qk_rope_head_dim": lambda cfg: cfg.mla.qk_rope_dim,
    "qk_nope_head_dim": lambda cfg: cfg.mla.qk_nope_dim,
    "v_head_dim": lambda cfg: cfg.mla.v_head_dim,
    "n_routed_experts": lambda cfg: cfg.moe.num_experts,
    "num_experts_per_tok": lambda cfg: cfg.moe.top_k,
    "n_shared_experts": lambda cfg: cfg.moe.num_shared,
    "moe_intermediate_size": lambda cfg: cfg.moe.expert_d_ff,
    "first_k_dense_replace": lambda cfg: cfg.moe.first_dense,
}
