"""Attention: the GQA/MQA half of ``repro/models/attention.py`` on tensors.

The train/prefill reference path is a *chunked online-softmax* attention in
plain PyTorch (the score matrix is tiled, never (S, S) at once).  With
``cfg.attention_impl == "pallas"`` the cache-free causal case goes to the
hand-written CUDA flash kernel in ``repro_torch.kernels.flash_attention``
(the plain version on CPU tensors), through the JAX package's own gate.

One dispatch differs from the JAX package: ``prefill`` always fills an empty
cache at positions ``0..S-1`` (``transformer.prefill``), so its prompt
attention is exactly the kernel's causal case over the S new keys.  The
JAX package computes it with ``kv_len = S`` over the zero tail of the cache,
where every masked slot adds ``exp(-1e30 - m) = 0``: the same function.  The
port sends it to the kernel when the kernel is configured.

Caches are updated **in place**: the k/v slots and the length of the
(stacked) cache buffers passed in are written, and the same buffers are
returned.  Ring (windowed) caches, cross attention and MLA wait for later
slices and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention_gqa
from repro_torch.models.common import shard_hint
from repro_torch.models.layers import apply_rope, normal_init

Params = dict[str, Any]

NEG_INF = -1e30


# -- parameter init -----------------------------------------------------------

def init_attention(cfg, gen: torch.Generator) -> Params:
    if cfg.mla is not None:
        raise NotImplementedError("MLA attention is not ported yet")
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    std = d**-0.5
    dt = cfg.param_dtype
    p = {
        "w_q": normal_init(gen, (d, H, hd), std, dt),
        "w_k": normal_init(gen, (d, KV, hd), std, dt),
        "w_v": normal_init(gen, (d, KV, hd), std, dt),
        "w_o": normal_init(gen, (H, hd, d), (H * hd) ** -0.5, dt),
    }
    if cfg.qkv_bias:
        p["b_q"] = torch.zeros((H, hd), dtype=dt, device=gen.device)
        p["b_k"] = torch.zeros((KV, hd), dtype=dt, device=gen.device)
        p["b_v"] = torch.zeros((KV, hd), dtype=dt, device=gen.device)
    return p


# -- chunked online-softmax core ------------------------------------------------

def _as_column(x: Any, device) -> torch.Tensor:
    """Scalar or (B,) offsets/lengths as an int64 (B', 1) column.

    A Python int is filled on the device: a host-to-device copy would wait
    for the stream to drain.
    """
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64).reshape(-1, 1)
    return torch.full((1, 1), int(x), dtype=torch.int64, device=device)


def chunked_attention(
    q: torch.Tensor,        # (B, Sq, KV, G, hd)
    k: torch.Tensor,        # (B, Skv, KV, hd)
    v: torch.Tensor,        # (B, Skv, KV, hdv)
    *,
    causal: bool,
    window: int = 0,        # 0 = unlimited
    q_offset: Any = 0,      # scalar or (B,): absolute position of q[0]
    kv_len: Any = None,     # scalar or (B,): valid prefix length of k/v
    chunk: int = 1024,
    scale: float | None = None,
) -> torch.Tensor:
    """Tiled attention; never materializes (Sq, Skv) for long sequences.

    Scores and the value product accumulate in f32 from inputs of the
    compute dtype, as ``preferred_element_type=f32`` does in the JAX package;
    probabilities are rounded to v's dtype before the value product.
    """
    B, Sq, KV, G, hd = q.shape
    Skv = k.shape[1]
    hdv = v.shape[-1]
    scale = scale if scale is not None else hd**-0.5
    if Sq <= 4 and Skv > Sq:
        return _decode_attention(
            q, k, v, causal=causal, window=window, q_offset=q_offset,
            kv_len=kv_len, scale=scale,
        )
    dev = q.device
    qc = min(chunk, Sq)
    kc = min(chunk, Skv)
    q_off = _as_column(q_offset, dev)
    valid = _as_column(Skv if kv_len is None else kv_len, dev)

    outs = []
    for q0 in range(0, Sq, qc):
        # ragged last chunks are sliced, not padded: a padded key sits past
        # kv_len and a padded query row is dropped, so neither changes a row
        q_i = q[:, q0:q0 + qc].float()
        n_q = q_i.shape[1]
        q_pos = q_off + q0 + torch.arange(n_q, device=dev)[None, :]  # (B', n_q)
        m = torch.full((B, n_q, KV, G), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, n_q, KV, G), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, n_q, KV, G, hdv), dtype=torch.float32, device=dev)
        for k0 in range(0, Skv, kc):
            k_j = k[:, k0:k0 + kc]
            v_j = v[:, k0:k0 + kc]
            s = torch.einsum("bqkgh,bckh->bqkgc", q_i, k_j.float()) * scale
            k_pos = k0 + torch.arange(k_j.shape[1], device=dev)
            mask = k_pos[None, None, :] < valid[:, :, None]  # (B', 1, kc)
            if causal:
                mask = mask & (k_pos[None, None, :] <= q_pos[:, :, None])
            if window > 0:
                mask = mask & (q_pos[:, :, None] - k_pos[None, None, :] < window)
            s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqkgc,bckh->bqkgh", p.to(v_j.dtype).float(), v_j.float()
            )
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    return torch.cat(outs, dim=1).to(v.dtype)


def _decode_attention(q, k, v, *, causal, window, q_offset, kv_len, scale):
    """Unchunked attention for tiny Sq against a (possibly huge) cache."""
    B, Sq, KV, G, hd = q.shape
    Skv = k.shape[1]
    dev = q.device
    q_off = _as_column(q_offset, dev)
    valid = _as_column(Skv if kv_len is None else kv_len, dev)
    q_pos = q_off + torch.arange(Sq, device=dev)[None, :]  # (B', Sq)
    k_pos = torch.arange(Skv, device=dev)
    mask = k_pos[None, None, :] < valid[:, :, None]     # (B', 1, Skv)
    if causal:
        mask = mask & (k_pos[None, None, :] <= q_pos[:, :, None])
    if window > 0:
        mask = mask & (q_pos[:, :, None] - k_pos[None, None, :] < window)
    s = torch.einsum("bqkgh,bckh->bqkgc", q.float(), k.float()) * scale
    s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqkgc,bckh->bqkgh", p.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def _flash(q, k, v, *, causal):
    """Model layout q (B,S,KV,G,hd), k/v (B,S,KV,hd) through the kernel's
    (B,H,S,hd) layout.  The kernel takes strides, so the transposes are views."""
    B, S, KV, G, hd = q.shape
    qk = q.permute(0, 2, 3, 1, 4).reshape(B, KV * G, S, hd)
    out = flash_attention_gqa(qk, k.transpose(1, 2), v.transpose(1, 2), causal=causal)
    return out.reshape(B, KV, G, S, hd).permute(0, 3, 1, 2, 4)


def _maybe_pallas_attention(cfg, q, k, v, *, causal, window, q_offset, kv_len):
    """Dispatch to the flash kernel when configured and applicable."""
    if (
        cfg.attention_impl == "pallas"
        and window == 0
        and kv_len is None
        and isinstance(q_offset, int)
        and q_offset == 0
    ):
        return _flash(q, k, v, causal=causal)
    return chunked_attention(
        q, k, v,
        causal=causal, window=window, q_offset=q_offset, kv_len=kv_len,
        chunk=cfg.attention_chunk,
    )


# -- GQA full layer ----------------------------------------------------------------

def apply_attention(
    cfg,
    p: Params,
    x: torch.Tensor,                # (B, S, d)
    *,
    positions: torch.Tensor,        # (B, S) absolute positions
    causal: bool = True,
    window: int = 0,
    cache: Params | None = None,    # decode KV cache, updated in place
    cross_kv: tuple | None = None,
    ctx: Any = None,
) -> tuple[torch.Tensor, Params | None]:
    """``ctx.prefill`` marks a prefill into an empty cache at positions 0..S-1."""
    if cross_kv is not None:
        raise NotImplementedError("cross attention is not ported yet")
    if cache is not None and window > 0:
        raise NotImplementedError("ring (windowed) KV caches are not ported yet")
    ct = cfg.compute_dtype
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // KV
    B, S, _ = x.shape
    x = x.to(ct)

    q = torch.einsum("bsd,dhk->bshk", x, p["w_q"].to(ct))
    k = torch.einsum("bsd,dhk->bshk", x, p["w_k"].to(ct))
    v = torch.einsum("bsd,dhk->bshk", x, p["w_v"].to(ct))
    if "b_q" in p:
        q = q + p["b_q"].to(ct)
    if "b_k" in p:
        k = k + p["b_k"].to(ct)
        v = v + p["b_v"].to(ct)
    if cfg.rope_theta > 0:  # 0 = learned/absolute positions (whisper)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q = q.reshape(B, S, KV, G, hd)

    prefill = bool(getattr(ctx, "prefill", False))
    if cache is not None and prefill and cfg.attention_impl == "pallas":
        # Prompt attention of a prefill: the kernel's causal case over the S
        # new keys (see the module docstring); they land in slots [0, S).
        _, _, new_cache, _, _, _ = _update_kv_cache(
            cache, k, v, positions, window, aligned=cfg.aligned_decode
        )
        out = _flash(q, k, v, causal=True)
    elif cache is not None:
        k, v, new_cache, kv_len, q_offset, cache_causal = _update_kv_cache(
            cache, k, v, positions, window, aligned=cfg.aligned_decode
        )
        out = chunked_attention(
            q, k, v,
            causal=cache_causal,
            window=0,
            kv_len=kv_len,
            q_offset=q_offset,
            chunk=cfg.attention_chunk,
        )
    else:
        new_cache = None
        out = _maybe_pallas_attention(
            cfg, q, k, v, causal=causal, window=window, q_offset=0, kv_len=None
        )

    out = out.reshape(B, S, H, -1)
    y = torch.einsum("bshk,hkd->bsd", out, p["w_o"].to(ct))
    return shard_hint(y, ctx, ("dp", None, None)), new_cache


def init_kv_cache(cfg, batch: int, max_len: int, window: int = 0, *, device) -> Params:
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    size = min(window, max_len) if window > 0 else max_len
    return {
        "k": torch.zeros((batch, size, KV, hd), dtype=cfg.compute_dtype, device=device),
        "v": torch.zeros((batch, size, KV, hd), dtype=cfg.compute_dtype, device=device),
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def _update_kv_cache(cache, k_new, v_new, positions, window, aligned=False):
    """Write new keys into the linear cache buffer, in place.

    Returns ``(k, v, cache, kv_len, q_offset, causal)`` like the JAX
    function; ``cache`` is the dict passed in, with its buffers updated.
    """
    if window > 0:
        raise NotImplementedError("ring (windowed) KV caches are not ported yet")
    B, S_new = k_new.shape[0], k_new.shape[1]
    size = cache["k"].shape[1]
    length = cache["length"].clone()  # (B,) before this write
    steps = torch.arange(S_new, device=k_new.device)
    if aligned:
        # aligned continuous batching: one write slot for the whole batch,
        # clamped into the buffer as a dynamic-update-slice is
        start = length[0].to(torch.int64).clamp(0, size - S_new)
        idx = start + steps
        cache["k"].index_copy_(1, idx, k_new)
        cache["v"].index_copy_(1, idx, v_new)
    else:
        # for a linear cache length < size, so the modulo never wraps
        write_pos = (length[:, None].to(torch.int64) + steps) % size  # (B, S_new)
        bidx = torch.arange(B, device=k_new.device)[:, None]
        cache["k"][bidx, write_pos] = k_new
        cache["v"][bidx, write_pos] = v_new
    cache["length"].add_(S_new)
    # slot index == absolute position, so causal masking with q at absolute
    # offset `length` is exact for both prefill and decode
    return cache["k"], cache["v"], cache, length + S_new, length, True
