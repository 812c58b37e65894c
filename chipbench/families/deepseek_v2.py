"""The DeepSeek-V2 family, an MoE decoder: latent attention (MLA) in every
layer; the leading ``first_dense`` layers end in a SwiGLU MLP, the rest in a
mixture of routed experts beside shared ones.  Its layer stacks, weight
layout, request work, the prompt work of its two distinctive layers, and
``PUBLISHED``, from the configuration file's sizes.

The published model's options are read from the file's ``model`` with the
defaults the port's config has (its zoo's maths): ``mla.latent_norm``,
``yarn``, ``moe.norm_topk_prob`` and ``moe.dense_d_ff``."""

from __future__ import annotations

from typing import Any

from chipbench.families import dense
from chipbench.work import ITEM_BYTES, causal_pairs, decode_keys


def layer_groups(model: dict[str, Any]) -> list[tuple[str, int, int]]:
    """(name, layers, window): the leading dense layers, then the MoE ones."""
    fd = model["moe"]["first_dense"]
    return [(name, n, 0) for name, n in (("dense0", fd), ("moe", model["num_layers"] - fd))
            if n]


def dense_width(model: dict[str, Any]) -> int:
    """The leading dense layers' MLP hidden: the file's ``dense_d_ff``, else
    the active experts' width, as the port sets it."""
    mo = model["moe"]
    return mo.get("dense_d_ff") or (mo["top_k"] + mo["num_shared"]) * mo["expert_d_ff"]


def attention_layout(model: dict[str, Any]) -> dict[str, Any]:
    d, H = model["d_model"], model["num_heads"]
    m = model["mla"]
    r, rope, nope, v = m["kv_lora_rank"], m["qk_rope_dim"], m["qk_nope_dim"], m["v_head_dim"]
    tree = {
        "w_q": ((d, H, nope + rope), ("normal", d ** -0.5)),
        "w_dkv": ((d, r + rope), ("normal", d ** -0.5)),
    }
    if m.get("latent_norm"):
        tree["kv_norm"] = {"scale": ((r,), ("ones",))}
    return tree | {
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


def mla_prefill_work(model: dict[str, Any], rows: int, S: int,
                     dtype: str = "bfloat16") -> tuple[float, float]:
    """(FLOPs, bytes) of the prompt's latent attention in every layer over
    ``rows`` prompts of S tokens, at the true widths: the up-projections of
    the latent to each head's keys and values, and 2 H (qk + v) per causal
    (query, key) pair; the latent, the rope keys, q, the up-projections'
    weights and the output once."""
    H = model["num_heads"]
    m = model["mla"]
    r, rope, nope, v = m["kv_lora_rank"], m["qk_rope_dim"], m["qk_nope_dim"], m["v_head_dim"]
    L, e = model["num_layers"], ITEM_BYTES[dtype]
    flops = 2 * S * r * H * (nope + v) + 2 * H * (nope + rope + v) * causal_pairs(S)
    nbytes = (S * (r + rope + H * (nope + rope) + H * v) * e) * rows + r * H * (nope + v) * e
    return float(flops * rows * L), float(nbytes * L)


def moe_prefill_work(model: dict[str, Any], rows: int, S: int,
                     dtype: str = "bfloat16") -> tuple[float, float]:
    """(FLOPs, bytes) of the prompt's expert products in every MoE layer
    over ``rows`` prompts of S tokens: each token's ``top_k`` routed and its
    shared experts, a SwiGLU of three products each; every expert's weights
    read once."""
    d, mo = model["d_model"], model["moe"]
    f, k, shared, E = mo["expert_d_ff"], mo["top_k"], mo["num_shared"], mo["num_experts"]
    layers = model["num_layers"] - mo["first_dense"]
    flops = 2 * rows * S * (k + shared) * 3 * d * f
    nbytes = (E + shared) * 3 * d * f * ITEM_BYTES[dtype]
    return float(flops * layers), float(nbytes * layers)


def _rope_scaling(cfg) -> dict[str, Any] | None:
    y = cfg.yarn
    if y is None:
        return None
    return {"type": "yarn", "factor": y.factor,
            "original_max_position_embeddings": y.original_max_position_embeddings,
            "beta_fast": y.beta_fast, "beta_slow": y.beta_slow, "mscale": y.mscale,
            "mscale_all_dim": y.mscale_all_dim}


#: how each published key reads off the port's config; the constants are the
#: port's fixed choices (``run.port_config`` refuses another ``norm_eps``): a
#: source that states another value shows as a gap
PUBLISHED = {
    "num_hidden_layers": lambda cfg: cfg.num_layers,
    "hidden_size": lambda cfg: cfg.d_model,
    "num_attention_heads": lambda cfg: cfg.num_heads,
    "num_key_value_heads": lambda cfg: cfg.num_kv_heads,
    "intermediate_size": lambda cfg: (cfg.moe.dense_d_ff
                                      or (cfg.moe.top_k + cfg.moe.num_shared)
                                      * cfg.moe.expert_d_ff),
    "vocab_size": lambda cfg: cfg.vocab_size,
    "tie_word_embeddings": lambda cfg: cfg.tie_embeddings,
    "rope_theta": lambda cfg: cfg.rope_theta,
    "rope_scaling": _rope_scaling,
    "rms_norm_eps": lambda cfg: 1e-06,
    "hidden_act": lambda cfg: "silu" if cfg.mlp == "swiglu" else cfg.mlp,
    "attention_bias": lambda cfg: cfg.qkv_bias,
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
    "moe_layer_freq": lambda cfg: 1,
    "norm_topk_prob": lambda cfg: cfg.moe.norm_topk_prob,
    "routed_scaling_factor": lambda cfg: 1,
    "scoring_func": lambda cfg: "softmax",
    "topk_method": lambda cfg: "greedy",
    "n_group": lambda cfg: 1,
    "topk_group": lambda cfg: 1,
}
