"""A plain float32 DeepSeek-V2 forward, for the tests: the published maths
written out once more, with no kernel, cache or batching, importing nothing
of the port.

``model`` is a configuration file's ``model`` object (as under
``chipbench/configs``: sizes, ``mla``, ``moe`` and ``yarn``), ``weights``
the port's parameter tree.  Every layer: RMSNorm; latent attention with the
latent ``c = x w_dkv[:, :r]`` RMSNorm'd (``mla.latent_norm``), keys and
values expanded per head from it, the rope dims of q and of the one shared
rope key rotated (split halves; YaRN's frequencies and magnitude under
``yarn``), softmax scale ``(nope + rope) ** -0.5`` times YaRN's
``m(factor, mscale_all_dim) ** 2``; RMSNorm; a SwiGLU MLP in the leading
``first_dense`` layers, else softmax routing over the experts, greedy top k
weighted by the chosen probabilities (renormalised only under
``moe.norm_topk_prob``), each expert run on the tokens that chose it, plus
the shared experts.  Products in float32 with TF32 off.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _rms(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale.float()


def _m(scale, a):
    return 1.0 if scale <= 1 else 0.1 * a * math.log(scale) + 1.0


def _rope(x, theta, yarn):
    """x (T, heads, hd) at positions 0..T-1."""
    T, _, hd = x.shape
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64) / hd)
    mag = 1.0
    if yarn:
        orig = yarn["original_max_position_embeddings"]

        def dim(rot):
            return hd * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(theta))

        lo = max(math.floor(dim(yarn["beta_fast"])), 0)
        hi = min(math.ceil(dim(yarn["beta_slow"])), hd - 1)
        ramp = ((torch.arange(hd // 2, dtype=torch.float64) - lo) / max(hi - lo, 1e-3)).clamp(0, 1)
        inv = inv / yarn["factor"] * ramp + inv * (1 - ramp)
        mag = _m(yarn["factor"], yarn["mscale"]) / _m(yarn["factor"], yarn["mscale_all_dim"])
    ang = torch.arange(T, dtype=torch.float64)[:, None] * inv
    cos, sin = (ang.cos() * mag).float()[:, None], (ang.sin() * mag).float()[:, None]
    a, b = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def _swiglu(h, w):
    return (F.silu(h @ w["w_gate"].float()) * (h @ w["w_up"].float())) @ w["w_down"].float()


def _attention(h, w, model):
    T, d = h.shape
    H, m, yarn = model["num_heads"], model["mla"], model.get("yarn")
    r, rp, nope, dv = m["kv_lora_rank"], m["qk_rope_dim"], m["qk_nope_dim"], m["v_head_dim"]
    q = (h @ w["w_q"].float().reshape(d, -1)).view(T, H, nope + rp)
    q = torch.cat([q[..., :nope], _rope(q[..., nope:], model["rope_theta"], yarn)], -1)
    ckr = h @ w["w_dkv"].float()
    c, k_rope = ckr[:, :r], ckr[:, r:]
    if m.get("latent_norm"):
        c = _rms(c, w["kv_norm"]["scale"], model["norm_eps"])
    k_rope = _rope(k_rope[:, None], model["rope_theta"], yarn).expand(T, H, rp)
    k = torch.cat([(c @ w["w_uk"].float().reshape(r, -1)).view(T, H, nope), k_rope], -1)
    v = (c @ w["w_uv"].float().reshape(r, -1)).view(T, H, dv)
    scale = (nope + rp) ** -0.5
    if yarn and yarn["mscale_all_dim"]:
        scale *= _m(yarn["factor"], yarn["mscale_all_dim"]) ** 2
    s = torch.einsum("qhk,shk->hqs", q, k) * scale
    s = s.masked_fill(~torch.ones(T, T, dtype=torch.bool).tril(), float("-inf"))
    out = torch.einsum("hqs,shd->qhd", s.softmax(-1), v).reshape(T, H * dv)
    return out @ w["w_o"].float().reshape(H * dv, d)


def _experts(h, w, model):
    mo = model["moe"]
    probs = (h @ w["router"].float()).softmax(-1)
    top_w, top_i = probs.topk(mo["top_k"], dim=-1)
    if mo.get("norm_topk_prob", True):
        top_w = top_w / top_w.sum(-1, keepdim=True)
    y = torch.zeros_like(h)
    for e in range(probs.shape[-1]):
        tok, slot = (top_i == e).nonzero(as_tuple=True)
        if len(tok):
            one = {k: w[k][e] for k in ("w_gate", "w_up", "w_down")}
            y.index_add_(0, tok, top_w[tok, slot, None] * _swiglu(h[tok], one))
    return y + _swiglu(h, w["shared"]) if "shared" in w else y


def forward(model: dict, weights: dict, tokens: torch.Tensor) -> torch.Tensor:
    """(B, T, V) float32 logits of ``tokens`` (B, T) at every position."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        out = []
        eps, fd = model["norm_eps"], model["moe"]["first_dense"]
        for row in tokens:
            x = weights["embedding"]["embed"][row].float()
            for name, n in (("dense0", fd), ("moe", model["num_layers"] - fd)):
                for i in range(n):
                    w = _layer(weights[name], i)
                    x = x + _attention(_rms(x, w["ln1"]["scale"], eps), w["attn"], model)
                    h = _rms(x, w["ln2"]["scale"], eps)
                    x = x + (_experts(h, w["moe"], model) if "moe" in w else _swiglu(h, w["mlp"]))
            x = _rms(x, weights["final_norm"]["scale"], eps)
            emb = weights["embedding"]
            out.append(x @ emb.get("unembed", emb["embed"]).float().T)
        return torch.stack(out)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _layer(group: dict, i: int) -> dict:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in group.items()}
