"""Plain reference of the MoE decoder as the port defines it today:
DeepSeek-V2's latent attention (no q low rank, no latent norm, plain RoPE
on the rope dims) with keys and values expanded per head, then a SwiGLU MLP
in the leading dense layers and in the others the dense form of the
mixture: every expert on every token weighted by its combine weight (the
router's softmax over the experts, the top k renormalised, zero elsewhere),
plus the shared experts."""

from __future__ import annotations

import torch

from chipbench.reference import dense
from chipbench.reference.common import Prec, mlp, rmsnorm, rope

#: query rows per block of attention scores
Q_BLOCK = 512


def mla(h: torch.Tensor, w: dict, model: dict, p: Prec) -> torch.Tensor:
    """Causal latent attention of one sequence h (T, d)."""
    T, d = h.shape
    H, theta = model["num_heads"], model["rope_theta"]
    m = model["mla"]
    r, rp, nope, v = m["kv_lora_rank"], m["qk_rope_dim"], m["qk_nope_dim"], m["v_head_dim"]
    q = p.mm(h, w["w_q"].reshape(d, -1)).view(T, H, nope + rp)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], theta)], dim=-1)
    c, k_rope = p.mm(h, w["w_dkv"]).split([r, rp], dim=-1)
    k_rope = rope(k_rope[:, None], theta).expand(T, H, rp)
    k = torch.cat([p.mm(c, w["w_uk"].reshape(r, -1)).view(T, H, nope), k_rope], dim=-1)
    vals = p.mm(c, w["w_uv"].reshape(r, -1)).view(T, H, v)
    qh, kh, vh = (p.q(t.transpose(0, 1)) for t in (q, k, vals))
    out = torch.empty((H, T, v), dtype=torch.float32, device=h.device)
    for q0 in range(0, T, Q_BLOCK):
        q1 = min(T, q0 + Q_BLOCK)
        s = (qh[:, q0:q1] @ kh[:, :q1].transpose(1, 2)) * (nope + rp) ** -0.5
        keep = (torch.arange(q1, device=h.device)[None, :]
                <= torch.arange(q0, q1, device=h.device)[:, None])
        s = s.masked_fill(~keep, float("-inf"))
        out[:, q0:q1] = p.q(torch.softmax(s, dim=-1)) @ vh[:, :q1]
    return p.mm(out.transpose(0, 1).reshape(T, H * v), w["w_o"].reshape(H * v, d))


def moe(h: torch.Tensor, w: dict, model: dict, p: Prec) -> torch.Tensor:
    probs = torch.softmax(p.mm(h, w["router"]), dim=-1)
    top_w, top_i = torch.topk(probs, model["moe"]["top_k"], dim=-1)
    combine = torch.zeros_like(probs).scatter(1, top_i, top_w / top_w.sum(-1, keepdim=True))
    y = sum(combine[:, e:e + 1] * mlp(h, {k: w[k][e] for k in ("w_gate", "w_up", "w_down")}, p)
            for e in range(probs.shape[-1]))
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
