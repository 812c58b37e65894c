"""Plain reference of the MoE decoder (DeepSeek-V2): latent attention with
keys and values expanded per head, then a SwiGLU MLP in the leading dense
layers and in the others a mixture of experts, each routed expert run on its
own tokens only, plus the shared experts.

Published maths, each as an option of the file's ``model`` with the port's
zoo maths as its default: the latent's RMSNorm before the cache and the
up-projections (``mla.latent_norm``; the rope keys are not normalised);
YaRN (``yarn``): the rope dims' frequencies ramped between the plain ones
and the plain ones over ``factor``, cos and sin scaled by m(factor, mscale)
/ m(factor, mscale_all_dim), and the softmax scale by m(factor,
mscale_all_dim)^2, where m(s, a) = 0.1 a ln s + 1; the router's softmax
over the experts in float32, greedy top k, weighted by the chosen
probabilities, renormalised over them only with ``moe.norm_topk_prob``
(routed_scaling_factor 1); the dense layers' width ``moe.dense_d_ff``.  The
rope dims are rotated as split halves, the port's layout; the published
model's interleaved pairs are the same function under a fixed permutation
of the rope columns of ``w_q`` and ``w_dkv``."""

from __future__ import annotations

import math

import torch

from chipbench.reference import dense
from chipbench.reference.common import Prec, mlp, rmsnorm

#: query rows per block of attention scores
Q_BLOCK = 512


def _mscale(scale: float, a: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * a * math.log(scale) + 1.0


def rope(x: torch.Tensor, theta: float, yarn: dict | None) -> torch.Tensor:
    """x: (T, heads, hd) at positions 0..T-1, split halves rotated as pairs,
    at YaRN's frequencies and magnitude with ``yarn``."""
    T, _, hd = x.shape
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd)
    mag = 1.0
    if yarn:
        dim = lambda rot: (hd * math.log(yarn["original_max_position_embeddings"]  # noqa: E731
                                         / (rot * 2 * math.pi)) / (2 * math.log(theta)))
        low = max(math.floor(dim(yarn["beta_fast"])), 0)
        high = min(math.ceil(dim(yarn["beta_slow"])), hd - 1)
        i = torch.arange(hd // 2, dtype=torch.float64, device=x.device)
        ramp = ((i - low) / max(high - low, 1e-3)).clamp(0, 1)
        freqs = freqs / yarn["factor"] * ramp + freqs * (1 - ramp)
        mag = (_mscale(yarn["factor"], yarn["mscale"])
               / _mscale(yarn["factor"], yarn["mscale_all_dim"]))
    ang = torch.arange(T, dtype=torch.float64, device=x.device)[:, None] * freqs
    cos, sin = (torch.cos(ang) * mag).float()[:, None], (torch.sin(ang) * mag).float()[:, None]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def mla(h: torch.Tensor, w: dict, model: dict, p: Prec) -> torch.Tensor:
    """Causal latent attention of one sequence h (T, d)."""
    T, d = h.shape
    H, theta, yarn = model["num_heads"], model["rope_theta"], model.get("yarn")
    m = model["mla"]
    r, rp, nope, v = m["kv_lora_rank"], m["qk_rope_dim"], m["qk_nope_dim"], m["v_head_dim"]
    scale = (nope + rp) ** -0.5
    if yarn and yarn["mscale_all_dim"]:
        scale *= _mscale(yarn["factor"], yarn["mscale_all_dim"]) ** 2
    q = p.mm(h, w["w_q"].reshape(d, -1)).view(T, H, nope + rp)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], theta, yarn)], dim=-1)
    c, k_rope = p.mm(h, w["w_dkv"]).split([r, rp], dim=-1)
    if m.get("latent_norm"):
        c = rmsnorm(c, w["kv_norm"]["scale"], model["norm_eps"])
    k_rope = rope(k_rope[:, None], theta, yarn).expand(T, H, rp)
    k = torch.cat([p.mm(c, w["w_uk"].reshape(r, -1)).view(T, H, nope), k_rope], dim=-1)
    vals = p.mm(c, w["w_uv"].reshape(r, -1)).view(T, H, v)
    qh, kh, vh = (p.q(t.transpose(0, 1)) for t in (q, k, vals))
    out = torch.empty((H, T, v), dtype=torch.float32, device=h.device)
    for q0 in range(0, T, Q_BLOCK):
        q1 = min(T, q0 + Q_BLOCK)
        s = (qh[:, q0:q1] @ kh[:, :q1].transpose(1, 2)) * scale
        keep = (torch.arange(q1, device=h.device)[None, :]
                <= torch.arange(q0, q1, device=h.device)[:, None])
        s = s.masked_fill(~keep, float("-inf"))
        out[:, q0:q1] = p.q(torch.softmax(s, dim=-1)) @ vh[:, :q1]
    return p.mm(out.transpose(0, 1).reshape(T, H * v), w["w_o"].reshape(H * v, d))


def moe(h: torch.Tensor, w: dict, model: dict, p: Prec) -> torch.Tensor:
    """The mixture on tokens h (T, d): each routed expert on the tokens that
    chose it, weighted by their router weights, plus the shared experts."""
    mo = model["moe"]
    probs = torch.softmax(p.mm(h, w["router"]), dim=-1)
    top_w, top_i = torch.topk(probs, mo["top_k"], dim=-1)
    if mo.get("norm_topk_prob", True):
        top_w = top_w / top_w.sum(-1, keepdim=True)
    y = torch.zeros_like(h)
    for e in range(probs.shape[-1]):
        tok, slot = (top_i == e).nonzero(as_tuple=True)
        if len(tok):
            out = mlp(h[tok], {k: w[k][e] for k in ("w_gate", "w_up", "w_down")}, p)
            y.index_add_(0, tok, top_w[tok, slot, None] * out)
    return y + mlp(h, w["shared"], p) if "shared" in w else y


def block(x: torch.Tensor, w: dict, model: dict, window: int, p: Prec) -> torch.Tensor:
    eps = model["norm_eps"]
    x = x + mla(rmsnorm(x, w["ln1"]["scale"], eps), w["attn"], model, p)
    h = rmsnorm(x, w["ln2"]["scale"], eps)
    return x + (moe(h, w["moe"], model, p) if "moe" in w else mlp(h, w["mlp"], p))


def logits(model: dict, weights: dict, tokens: torch.Tensor, positions: list[int],
           mode: str = "f32") -> torch.Tensor:
    fd = model["moe"]["first_dense"]
    groups = [(name, n, 0) for name, n in (("dense0", fd), ("moe", model["num_layers"] - fd))
              if n]
    return dense.logits(model, weights, tokens, positions, mode, block_fn=block, groups=groups)
