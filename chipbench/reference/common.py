"""Plain PyTorch pieces of the references: norms, RoPE, attention, MLP, SSD.

One sequence at a time, activations in float32, every product in float32
with TF32 off (``mode="f32"``).  ``mode="fp8"`` is the control: each
operand of each product is rounded to float8 e4m3 with one scale per tensor
(its largest magnitude at 448) before the float32 product, the precision
below the configuration's bfloat16.  Imports nothing of ``repro_torch``.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch
import torch.nn.functional as F

#: query rows per block of attention scores
Q_BLOCK = 512
FP8_MAX = 448.0


@contextlib.contextmanager
def full_float32() -> Iterator[None]:
    """Float32 products without TF32 (restored after)."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev[:2]
        torch.set_float32_matmul_precision(prev[2])


class Prec:
    """The products' precision: ``q`` rounds a product's operand."""

    def __init__(self, mode: str):
        if mode not in ("f32", "fp8"):
            raise ValueError(f"precision {mode!r}: f32 or fp8")
        self.mode = mode

    def q(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.mode == "f32":
            return x
        scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (T, heads, hd) at positions 0..T-1; the halves of each head are
    rotated as pairs (the port's split-halves form)."""
    T, _, hd = x.shape
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd)
    ang = torch.arange(T, dtype=torch.float64, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang).float()[:, None], torch.sin(ang).float()[:, None]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(h: torch.Tensor, w: dict, model: dict, window: int, p: Prec) -> torch.Tensor:
    """Causal grouped-query attention of one sequence h (T, d); a window
    keeps the keys with query - key < window."""
    T, d = h.shape
    H, KV, hd = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    q = p.mm(h, w["w_q"].reshape(d, H * hd)).view(T, H, hd)
    k = p.mm(h, w["w_k"].reshape(d, KV * hd)).view(T, KV, hd)
    v = p.mm(h, w["w_v"].reshape(d, KV * hd)).view(T, KV, hd)
    if "b_q" in w:
        q, k, v = q + w["b_q"].float(), k + w["b_k"].float(), v + w["b_v"].float()
    q, k = rope(q, model["rope_theta"]), rope(k, model["rope_theta"])
    G = H // KV
    kh = p.q(k.repeat_interleave(G, dim=1).transpose(0, 1))   # (H, T, hd)
    vh = p.q(v.repeat_interleave(G, dim=1).transpose(0, 1))
    qh = p.q(q.transpose(0, 1))
    scale = hd ** -0.5
    out = torch.empty((H, T, hd), dtype=torch.float32, device=h.device)
    for q0 in range(0, T, Q_BLOCK):
        q1 = min(T, q0 + Q_BLOCK)
        k0 = 0 if window <= 0 else max(0, q0 - window + 1)
        s = (qh[:, q0:q1] @ kh[:, k0:q1].transpose(1, 2)) * scale
        qi = torch.arange(q0, q1, device=h.device)[:, None]
        kj = torch.arange(k0, q1, device=h.device)[None, :]
        keep = kj <= qi
        if window > 0:
            keep &= (qi - kj) < window
        s = s.masked_fill(~keep, float("-inf"))
        out[:, q0:q1] = p.q(torch.softmax(s, dim=-1)) @ vh[:, k0:q1]
    return p.mm(out.transpose(0, 1).reshape(T, H * hd), w["w_o"].reshape(H * hd, d))


def mlp(h: torch.Tensor, w: dict, p: Prec) -> torch.Tensor:
    return p.mm(F.silu(p.mm(h, w["w_gate"])) * p.mm(h, w["w_up"]), w["w_down"])


def ssd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, chunk: int,
        p: Prec) -> torch.Tensor:
    """y_t = sum_{s <= t} (c_t . b_s) exp(a_{s+1} + ... + a_t) x_s for one
    sequence: x (T, H, P), a (T, H) log-decays, b and c (T, N) shared by the
    heads; computed chunk by chunk in float32."""
    T, H, P = x.shape
    N = b.shape[-1]
    state = torch.zeros((H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t0 in range(0, T, chunk):
        t1 = min(T, t0 + chunk)
        xc, bc, cc = x[t0:t1], b[t0:t1], c[t0:t1]
        cs = torch.cumsum(a[t0:t1].transpose(0, 1), dim=-1)           # (H, q)
        q = t1 - t0
        diff = cs[:, :, None] - cs[:, None, :]
        lower = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
        decay = torch.exp(diff.masked_fill(~lower, float("-inf")))     # (H, q, q)
        cb = p.mm(cc, bc.transpose(0, 1))                             # (q, q)
        y_in = p.q(decay * cb) @ p.q(xc.transpose(0, 1))              # (H, q, P)
        y_state = (p.q(cc) @ p.q(state).transpose(1, 2)) * torch.exp(cs)[:, :, None]
        ys.append((y_in + y_state).transpose(0, 1))
        to_end = torch.exp(cs[:, -1:] - cs)                           # (H, q)
        state = state * torch.exp(cs[:, -1])[:, None, None] + torch.einsum(
            "hjp,hjn->hpn", p.q(xc.transpose(0, 1) * to_end[:, :, None]), p.q(bc).expand(H, q, N)
        )
    return torch.cat(ys, dim=0)


def mamba(h: torch.Tensor, w: dict, model: dict, p: Prec) -> torch.Tensor:
    """The SSD mixer of one sequence h (T, d)."""
    T, d = h.shape
    s = model["ssm"]
    din = s["expand"] * d
    N, K, P = s["d_state"], s["d_conv"], s["head_dim"]
    H = din // P
    z, xs, b, c, dt = torch.split(p.mm(h, w["w_in"]), [din, din, N, N, H], dim=-1)
    conv_in = torch.cat([xs, b, c], dim=-1)                            # (T, din + 2N)
    padded = F.pad(conv_in, (0, 0, K - 1, 0))
    cw = w["conv_w"].float()
    conv = sum(padded[i:i + T] * cw[:, i] for i in range(K)) + w["conv_b"].float()
    xs, b, c = torch.split(F.silu(conv), [din, N, N], dim=-1)
    xh = xs.reshape(T, H, P)
    dt = F.softplus(dt + w["dt_bias"].float())                         # (T, H)
    a = dt * -torch.exp(w["a_log"].float())
    y = ssd(xh * dt[:, :, None], a, b, c, s["chunk"], p)
    y = (y + xh * w["d_skip"].float()[None, :, None]).reshape(T, din)
    g = y * F.silu(z)
    g = g * torch.rsqrt((g * g).mean(-1, keepdim=True) + model["norm_eps"])
    return p.mm(g * w["norm_scale"].float(), w["w_out"])


def layer_weights(group: dict, i: int) -> dict:
    """Layer i of a stacked group, as views."""
    return {k: layer_weights(v, i) if isinstance(v, dict) else v[i] for k, v in group.items()}


def head_logits(x: torch.Tensor, weights: dict, model: dict, p: Prec) -> torch.Tensor:
    """Final norm and the LM head of rows x (n, d)."""
    x = rmsnorm(x, weights["final_norm"]["scale"], model["norm_eps"])
    emb = weights["embedding"]
    table = emb.get("unembed", emb["embed"])
    return p.mm(x, table.transpose(0, 1))


def check_positions(positions: list[int], T: int) -> None:
    if not positions or min(positions) < 0 or max(positions) >= T:
        raise ValueError(f"positions {positions[:3]}... outside a sequence of {T}")
