"""Mamba-2 (SSD: state-space duality) block: ``repro/models/ssm.py`` on tensors.

Training/prefill uses the chunked dual form (quadratic attention-like
within chunks, linear recurrence across chunks), the computation the
hand-written ``ssd_scan`` kernel tiles; decode is a constant-time state
update.  Shapes follow the JAX package: X (B,S,H,P), dt (B,S,H), A (H,)
negative scalars, B/C (B,S,H,N) broadcast over heads from one group.

One dispatch differs from the JAX package: with ``attention_impl ==
"pallas"`` and a cache, a prompt of more than 4 steps goes through the
kernel with the cache's state as its initial state, and the kernel's final
state becomes the cache's.  The JAX package computes that case with
``ssd_chunked(initial_state=..., return_final_state=True)``: the same
function, and ``prefill`` always starts it from the zero state of
``init_mamba_cache``, which is exactly the kernel's case.

Caches are updated **in place**: the conv tail and the state of the cache
passed in are written, and the same dict is returned.
"""

from __future__ import annotations

import functools
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models.common import (
    batch_local,
    copy_into,
    grad_in_layout,
    shard_hint,
    unshard,
)
from repro_torch.models.layers import normal_init

Params = dict[str, Any]


# -- SSD core (chunked dual form) ---------------------------------------------

def segsum(a: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = sum a[..., j+1:i+1], -inf for j>i."""
    L = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]  # (..., i, j) = sum (j, i]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=a.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(
    x: torch.Tensor,      # (B, S, H, P)  (already multiplied by dt)
    a: torch.Tensor,      # (B, S, H)     log-decay per step (dt * A, negative)
    b: torch.Tensor,      # (B, S, H, N)  input matrix (heads already broadcast)
    c: torch.Tensor,      # (B, S, H, N)  output matrix
    initial_state: torch.Tensor | None = None,  # (B, H, P, N)
    *,
    chunk: int = 128,
    return_final_state: bool = False,
):
    """Products take operands of the compute dtype and accumulate in f32, as
    ``preferred_element_type=f32`` does in the JAX package."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    Q = min(chunk, S)
    nC = -(-S // Q)
    pad = nC * Q - S
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
    dt = c.dtype
    state = (
        initial_state.float()
        if initial_state is not None
        else torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    )
    ys = []
    for k in range(nC):
        sl = slice(k * Q, (k + 1) * Q)
        xq, bq, cq = x[:, sl].float(), b[:, sl].float(), c[:, sl].float()
        a_hc = a[:, sl].float().transpose(1, 2)          # (B,H,Q)
        a_cum = torch.cumsum(a_hc, dim=-1)               # (B,H,Q)
        # intra-chunk (dual quadratic form)
        L = torch.exp(segsum(a_hc)).to(dt).float()       # (B,H,Q,Q)
        cb = torch.einsum("bqhn,bshn->bhqs", cq, bq)
        y_diag = torch.einsum("bhqs,bshp->bqhp", cb * L, xq)
        # contribution of carried-in state
        state_decay = torch.exp(a_cum).transpose(1, 2).to(dt).float()  # (B,Q,H)
        y_off = torch.einsum(
            "bqhn,bhpn->bqhp", cq, state.to(dt).float()
        ) * state_decay[..., None]
        # state update for the next chunk
        decay_to_end = torch.exp(a_cum[..., -1:] - a_cum).transpose(1, 2)  # (B,Q,H)
        state = state * torch.exp(a_cum[:, :, -1])[..., None, None] + torch.einsum(
            "bqhn,bqhp->bhpn", bq * decay_to_end.to(b.dtype).float()[..., None], xq
        )
        ys.append((y_diag + y_off).to(x.dtype))
    y = torch.cat(ys, dim=1)[:, :S]
    if return_final_state:
        return y, state
    return y


def ssd_decode_step(
    state: torch.Tensor,  # (B, H, P, N)
    x: torch.Tensor,      # (B, H, P)   (already multiplied by dt)
    a: torch.Tensor,      # (B, H)      log-decay (dt * A)
    b: torch.Tensor,      # (B, H, N)
    c: torch.Tensor,      # (B, H, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """O(1) recurrent update: returns (y, new_state)."""
    decay = torch.exp(a.float())[..., None, None]
    new_state = state * decay + x[..., None].float() * b[:, :, None, :].float()
    y = torch.einsum("bhn,bhpn->bhp", c.float(), new_state)
    return y.to(x.dtype), new_state


# -- full Mamba-2 mixer block -----------------------------------------------------

def init_mamba(cfg, gen: torch.Generator, d_model: int | None = None) -> Params:
    s = cfg.ssm
    d = d_model or cfg.d_model
    din = s.d_inner(d)
    H = s.n_heads(d)
    N, K = s.d_state, s.d_conv
    G = 1
    conv_dim = din + 2 * G * N
    std = d**-0.5
    dt, dev = cfg.param_dtype, gen.device
    return {
        # order: [z, x, B, C, dt]
        "w_in": normal_init(gen, (d, 2 * din + 2 * G * N + H), std, dt),
        "conv_w": normal_init(gen, (conv_dim, K), K**-0.5, dt),
        "conv_b": torch.zeros((conv_dim,), dtype=dt, device=dev),
        "a_log": torch.log(torch.linspace(1.0, 16.0, H, device=dev)).to(dt),
        "dt_bias": torch.log(torch.expm1(torch.full((H,), 0.01, device=dev))).to(dt),
        "d_skip": torch.ones((H,), dtype=dt, device=dev),
        "norm_scale": torch.ones((din,), dtype=dt, device=dev),
        "w_out": normal_init(gen, (din, d), din**-0.5, dt),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d (a cross-correlation).  x: (B, S, C), w: (C, K)."""
    C, K = w.shape
    xp = F.pad(x.transpose(1, 2), (K - 1, 0))        # (B, C, K-1+S)
    out = F.conv1d(xp, w[:, None, :], groups=C)      # (C, 1, K) weight
    return out.transpose(1, 2) + b


def apply_mamba(
    cfg,
    p: Params,
    x: torch.Tensor,                 # (B, S, d)
    *,
    cache: Params | None = None,     # {"conv": (B,K-1,C), "state": (B,H,P,N)}, in place
    d_model: int | None = None,
    ctx: Any = None,
) -> tuple[torch.Tensor, Params | None]:
    s = cfg.ssm
    ct = cfg.compute_dtype
    d = d_model or cfg.d_model
    din, H, N, K = s.d_inner(d), s.n_heads(d), s.d_state, s.d_conv
    P = s.head_dim
    B, S, _ = x.shape
    x = x.to(ct)

    # batch rows whole along the projection: where the tokens moved (a
    # decode step), their partial sums over the data axes reduce here, once
    zxbcdt = shard_hint(x @ p["w_in"].to(ct), ctx, ("dp", None, None))
    z, xs, b, c, dt = torch.split(zxbcdt, [din, din, N, N, H], dim=-1)
    conv_in = torch.cat([xs, b, c], dim=-1)  # (B, S, din + 2N)

    if cache is None:
        conv_out = F.silu(batch_local(
            _causal_conv, conv_in, p["conv_w"].to(ct), p["conv_b"].to(ct)
        ))
    else:
        # the cached conv tail stands in for the left padding
        full = torch.cat([cache["conv"].to(ct), conv_in], dim=1)
        w = p["conv_w"].to(ct)  # (C, K)
        segs = [full[:, i : i + S, :] * w[:, i] for i in range(K)]
        conv_out = F.silu(sum(segs) + p["conv_b"].to(ct))
        copy_into(cache["conv"], full[:, -(K - 1) :, :])

    xs, b, c = torch.split(conv_out, [din, N, N], dim=-1)
    xh = unshard(xs, (2,)).reshape(B, S, H, P)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())  # (H,) negative
    log_decay = dt * a  # (B, S, H)
    x_dt = xh * dt[..., None].to(ct)
    bh = b[:, :, None, :].expand(B, S, H, N).to(ct)
    ch = c[:, :, None, :].expand(B, S, H, N).to(ct)

    # the scan is independent per batch row: on DTensors each rank scans its
    # own rows (``batch_local``), the chunk loop on local shards
    if cache is None:
        if cfg.attention_impl == "pallas":
            y, _ = batch_local(functools.partial(ssd_scan, chunk=s.chunk),
                               x_dt, log_decay.float(), bh, ch, rows=4, n_out=2)
        else:
            y = batch_local(functools.partial(ssd_chunked, chunk=s.chunk),
                            x_dt, log_decay, bh, ch, rows=4)
    else:
        state = cache["state"]
        if S > 4 and cfg.attention_impl == "pallas":
            # prefill through the kernel (see the module docstring)
            y, state = batch_local(
                functools.partial(ssd_scan, chunk=s.chunk),
                x_dt, log_decay.float(), bh, ch, state, rows=5, n_out=2,
            )
        elif S > 4:  # prefill: chunked dual form carrying the recurrent state
            y, state = batch_local(
                functools.partial(ssd_chunked, chunk=s.chunk, return_final_state=True),
                x_dt, log_decay, bh, ch, state, rows=5, n_out=2,
            )
        else:  # decode: O(1) recurrent updates
            ys = []
            for t in range(S):
                y_t, state = ssd_decode_step(
                    state, x_dt[:, t], log_decay[:, t], bh[:, t], ch[:, t]
                )
                ys.append(y_t)
            y = torch.stack(ys, dim=1)
        copy_into(cache["state"], state)

    y = y + xh * p["d_skip"].to(ct)[None, None, :, None]
    y = grad_in_layout(y.reshape(B, S, din))
    # gated RMSNorm (mamba2): norm(y * silu(z))
    g = y * F.silu(z)
    var = (g.float() ** 2).mean(-1, keepdim=True)
    g = (g.float() * torch.rsqrt(var + 1e-6)).to(ct) * p["norm_scale"].to(ct)
    out = g @ p["w_out"].to(ct)
    return out, cache


def init_mamba_cache(cfg, batch: int, d_model: int | None = None, *, device) -> Params:
    s = cfg.ssm
    d = d_model or cfg.d_model
    din, H, N, K = s.d_inner(d), s.n_heads(d), s.d_state, s.d_conv
    conv_dim = din + 2 * N
    return {
        "conv": torch.zeros((batch, K - 1, conv_dim), dtype=cfg.compute_dtype, device=device),
        "state": torch.zeros((batch, H, s.head_dim, N), dtype=torch.float32, device=device),
    }
