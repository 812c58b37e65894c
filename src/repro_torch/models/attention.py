"""Attention: the GQA/MQA half of ``repro/models/attention.py`` on tensors.

The train/prefill reference path is a *chunked online-softmax* attention in
plain PyTorch (the score matrix is tiled, never (S, S) at once).  With
``cfg.attention_impl == "pallas"`` the cache-free case goes to the
hand-written CUDA flash kernel in ``repro_torch.kernels.flash_attention``
(the plain version on CPU tensors), through the JAX package's own gate:
causal for the decoders, non-causal for whisper's encoder.

One dispatch differs from the JAX package: ``prefill`` always fills an empty
cache at positions ``0..S-1`` (``transformer.prefill``, and the decoder of
``whisper.prefill``), so its prompt attention is exactly the kernel's
causal case over the S new keys.  The
JAX package computes it with ``kv_len = S`` over the zero tail of the cache,
where every masked slot adds ``exp(-1e30 - m) = 0``: the same function.  The
port sends it to the kernel when the kernel is configured.

A sliding-window layer (``window > 0``, hymba's local layers) keeps a ring
cache of ``min(window, max_len)`` slots.  Its prefill attends over the prompt
itself with the window's mask and keeps the prompt's last ``window`` keys
(``_fill_ring_cache``); a decode step writes slot ``length % size`` and
attends over every valid slot, as the JAX package does.  The prefill's
attention is the flash kernel's causal case with a window, and with the
kernel configured the port sends it there (another dispatch difference:
the JAX package takes ``chunked_attention``, the same function); the
cache-free forward and decode keep the JAX package's dispatch.

MLA (DeepSeek's multi-head latent attention, ``apply_mla``): without a
cache it expands keys and values per head, as the JAX package does; with
one it writes the latent ``c`` and the rotated ``k_rope`` at slots
``(length + i) % size``.  A decode step, and any prefill off the kernel,
attends in the latent space (the *absorbed* form) through
``chunked_attention``, as the JAX package does.  A prefill into an empty
cache with the kernel configured (the dense path's condition) expands keys
and values per head and runs the flash kernel (``_mla_flash``), where the
JAX package takes the absorbed form: the same function.  The configuration
may add the published model's latent RMSNorm (``MLAConfig.latent_norm``) and
YaRN (``ModelConfig.yarn``: the rotary frequencies and the softmax scale).

Cross attention (whisper's decoder, ``cross_kv=(k, v)``) projects q only and
attends over the encoder's keys with ``chunked_attention``, unmasked and with
no kernel, as in the JAX package.

Caches are updated **in place**: the k/v (or latent) slots and the length
of the (stacked) cache buffers passed in are written, and the same buffers
are returned.

On ``DTensor`` inputs (a step laid out on a ``DeviceMesh``) the chunk loops
run on each rank's batch rows and heads (``_sharded_attention``), the flash
kernel on each rank's rows, and the cache writes on each rank's shard
(``common.write_rows``).
"""

from __future__ import annotations

import functools
import math
from typing import Any

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels.flash_attention.ops import flash_attention_gqa
from repro_torch.models.common import (
    as_dtensor,
    batch_local,
    contiguous_grad,
    relayout,
    shard_hint,
    unshard,
    write_rows,
)
from repro_torch.models.layers import apply_norm, apply_rope, init_norm, normal_init, yarn_mscale
from repro_torch.runtime import trace

Params = dict[str, Any]

NEG_INF = -1e30


# -- parameter init -----------------------------------------------------------

def init_attention(cfg, gen: torch.Generator) -> Params:
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    std = d**-0.5
    dt = cfg.param_dtype
    if cfg.mla is not None:
        m = cfg.mla
        r = m.kv_lora_rank
        p = {
            "w_q": normal_init(gen, (d, H, m.qk_nope_dim + m.qk_rope_dim), std, dt),
            "w_dkv": normal_init(gen, (d, r + m.qk_rope_dim), std, dt),
        }
        if m.latent_norm:
            p["kv_norm"] = init_norm(cfg, r, gen.device)
        return p | {
            "w_uk": normal_init(gen, (r, H, m.qk_nope_dim), r**-0.5, dt),
            "w_uv": normal_init(gen, (r, H, m.v_head_dim), r**-0.5, dt),
            "w_o": normal_init(gen, (H, m.v_head_dim, d), (H * m.v_head_dim) ** -0.5, dt),
        }
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


def _mask(q_pos: torch.Tensor, Skv: int, valid: torch.Tensor, *, causal: bool,
          window: int) -> torch.Tensor:
    """(B', n_q, Skv): the keys of each query row at absolute positions
    ``q_pos`` (B', n_q) that attention keeps: inside the valid prefix
    ``valid`` (B', 1), not after the query when causal, and fewer than
    ``window`` positions before it when ``window > 0``."""
    k_pos = torch.arange(Skv, device=q_pos.device)[None, None, :]
    mask = k_pos < valid[:, :, None]
    if causal:
        mask = mask & (k_pos <= q_pos[:, :, None])
    if window > 0:
        mask = mask & (q_pos[:, :, None] - k_pos < window)
    return mask


def chunked_attention(
    q: torch.Tensor,        # (B, Sq, KV, G, hd)
    k: torch.Tensor,        # (B, Skv, KV, hd)
    v: torch.Tensor,        # (B, Skv, KV, hdv)
    q_offset: Any = 0,      # scalar or (B,): absolute position of q[0]
    kv_len: Any = None,     # scalar or (B,): valid prefix length of k/v
    *,
    causal: bool,
    window: int = 0,        # 0 = unlimited
    chunk: int = 1024,
    scale: float | None = None,
) -> torch.Tensor:
    """Tiled attention; never materializes (Sq, Skv) for long sequences.

    Scores and the value product accumulate in f32 from inputs of the
    compute dtype, as ``preferred_element_type=f32`` does in the JAX package;
    probabilities are rounded to v's dtype before the value product.
    """
    if isinstance(q, DTensor) or isinstance(k, DTensor):
        return _sharded_attention(
            q, k, v, causal=causal, window=window, q_offset=q_offset, kv_len=kv_len,
            chunk=chunk, scale=scale,
        )
    B, Sq, KV, G, hd = q.shape
    Skv = k.shape[1]
    hdv = v.shape[-1]
    scale = scale if scale is not None else hd**-0.5
    if _unchunked(Sq, Skv):
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
        # the q chunk's mask over every key, sliced per kv chunk below
        mask = _mask(q_pos, Skv, valid, causal=causal, window=window)
        mask = mask[:, :, None, None, :]                             # (B', n_q|1, 1, 1, Skv)
        m = torch.full((B, n_q, KV, G), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, n_q, KV, G), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, n_q, KV, G, hdv), dtype=torch.float32, device=dev)
        for k0 in range(0, Skv, kc):
            k_j = k[:, k0:k0 + kc]
            v_j = v[:, k0:k0 + kc]
            s = torch.einsum("bqkgh,bckh->bqkgc", q_i, k_j.float()) * scale
            s = torch.where(mask[..., k0:k0 + kc], s, NEG_INF)
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


def _sharded_attention(q, k, v, *, q_offset, kv_len, **kw):
    """``chunked_attention`` on ``DTensor`` inputs: each rank attends over its
    own batch rows and heads, through ``local_map`` (the port's
    ``shard_map``), so the chunk loops run on local shards.

    The batch keeps q's batch sharding.  The heads shard over the mesh dims
    the batch leaves free when the kv heads divide them; else, when all H =
    KV * G query heads do, k and v are repeated to H heads and the output is
    returned as (B, Sq, H, 1, hdv), the (KV, G) order flattened (every caller
    reshapes it to (B, Sq, H, hdv)); else the heads are whole on every rank.
    A cache sharded along its slots (context-parallel) is gathered whole."""
    mesh = (q if isinstance(q, DTensor) else k).device_mesh
    q, k, v = (as_dtensor(t, mesh) for t in (q, k, v))
    B, Sq, KV, G, hd = q.shape
    batch = [i for i, p in enumerate(q.placements) if p.is_shard() and p.dim == 0]
    free = [i for i in range(mesh.ndim) if i not in batch]
    n_free = math.prod(mesh.size(i) for i in free)
    if KV % n_free and (KV * G) % n_free == 0:
        q = unshard(q, (2, 3)).reshape(B, Sq, KV * G, 1, hd)
        k = unshard(k, (2,)).repeat_interleave(G, dim=2)
        v = unshard(v, (2,)).repeat_interleave(G, dim=2)
    # free mesh dims of size 1 split nothing: a Shard there would only
    # forbid the callers' reshape of a one-head dim (MLA's latent q)
    head_pl = Shard(2) if n_free > 1 and q.shape[2] % n_free == 0 else Replicate()
    pl = [Shard(0) if i in batch else head_pl for i in range(mesh.ndim)]
    rows = [Shard(0) if i in batch else Replicate() for i in range(mesh.ndim)]
    q, k, v = (relayout(t, pl) for t in (q, k, v))

    def per_row(x):
        if not isinstance(x, torch.Tensor):
            return x, None
        x = as_dtensor(x, mesh)
        return (relayout(x, rows), rows) if x.ndim else (x, [Replicate()] * mesh.ndim)

    (q_offset, off_pl), (kv_len, len_pl) = per_row(q_offset), per_row(kv_len)

    def body(q, k, v, q_offset, kv_len):
        q, k, v = (contiguous_grad(t) for t in (q, k, v))
        return chunked_attention(q, k, v, q_offset, kv_len, **kw)

    local = local_map(body, out_placements=pl, in_placements=(pl, pl, pl, off_pl, len_pl))
    return local(q, k, v, q_offset, kv_len)


def _unchunked(Sq: int, Skv: int) -> bool:
    """Whether ``chunked_attention`` takes ``_decode_attention``: a few
    queries against a longer cache."""
    return Sq <= 4 and Skv > Sq


def _decode_attention(q, k, v, *, causal, window, q_offset, kv_len, scale):
    """Unchunked attention for tiny Sq against a (possibly huge) cache."""
    B, Sq, KV, G, hd = q.shape
    Skv = k.shape[1]
    dev = q.device
    q_off = _as_column(q_offset, dev)
    valid = _as_column(Skv if kv_len is None else kv_len, dev)
    q_pos = q_off + torch.arange(Sq, device=dev)[None, :]  # (B', Sq)
    mask = _mask(q_pos, Skv, valid, causal=causal, window=window)
    s = torch.einsum("bqkgh,bckh->bqkgc", q.float(), k.float()) * scale
    s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqkgc,bckh->bqkgh", p.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def _flash(q, k, v, *, causal, scale=None, window=0):
    """Model layout q (B,S,KV,G,hd), k/v (B,S,KV,hd) through the kernel's
    (B,H,S,hd) layout.  The kernel takes strides, so the transposes are views.
    On ``DTensor`` inputs each rank runs the kernel on its batch rows."""
    return batch_local(functools.partial(_flash_rows, causal=causal, scale=scale, window=window),
                       q, k, v, rows=3)


def _flash_rows(q, k, v, *, causal, scale=None, window=0):
    B, S, KV, G, hd = q.shape
    qk = q.permute(0, 2, 3, 1, 4).reshape(B, KV * G, S, hd)
    out = flash_attention_gqa(qk, k.transpose(1, 2), v.transpose(1, 2), causal=causal,
                              scale=scale, window=window)
    return out.reshape(B, KV, G, S, hd).permute(0, 3, 1, 2, 4)


def _takes_flash(cfg, *, window, q_offset, kv_len) -> bool:
    """Whether a cache-free attention goes to the flash kernel."""
    return (
        cfg.attention_impl == "pallas"
        and window == 0
        and kv_len is None
        and isinstance(q_offset, int)
        and q_offset == 0
    )


def _maybe_pallas_attention(cfg, q, k, v, *, causal, window, q_offset, kv_len):
    """Dispatch to the flash kernel when configured and applicable."""
    if _takes_flash(cfg, window=window, q_offset=q_offset, kv_len=kv_len):
        return _flash(q, k, v, causal=causal)
    return chunked_attention(
        q, k, v,
        causal=causal, window=window, q_offset=q_offset, kv_len=kv_len,
        chunk=cfg.attention_chunk,
    )


def _impl(Sq: int, Skv: int) -> str:
    """The ``attn.core`` span's ``impl`` for a ``chunked_attention`` call."""
    return "decode" if _unchunked(Sq, Skv) else "chunked"


def _out_proj(out: torch.Tensor, w_o: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd", out, w_o)`` as one product over the flattened
    (heads, head dim): on head-sharded ``DTensor``s its backward keeps the
    heads split (the einsum's took them whole on every rank: 16x the
    gradient products and an all-gather of the heads)."""
    B, S = out.shape[:2]
    return out.reshape(B, S, -1) @ w_o.reshape(-1, w_o.shape[-1])


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
    """``ctx.prefill`` marks a prefill into an empty cache at positions 0..S-1.

    With ``cross_kv = (k, v)``, each (B, T, KV, hd), only q is projected and
    attends over all T keys (no mask, no cache, no kernel).

    Spans: ``attn.proj`` (the q/k/v projections and RoPE, then the output
    projection), ``attn.cache`` (the cache writes) and ``attn.core`` (the
    attention itself, from q, k and v in the model's layout to the output
    back in it, with the layer's ``window`` and the ``impl`` that ran it).
    The flash kernel writes (B, H, S, hd); its output is made contiguous in
    (B, S, H, hd) inside ``attn.core``, so the copy the output projection
    needed anyway counts as the attention's."""
    ct = cfg.compute_dtype
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // KV
    B, S, _ = x.shape
    with trace.span("attn.proj"):
        x = x.to(ct)
        q = torch.einsum("bsd,dhk->bshk", x, p["w_q"].to(ct))
        if "b_q" in p:
            q = q + p["b_q"].to(ct)
        # keep attention batch-parallel (heads shard only when they divide TP)
        q = shard_hint(q, ctx, ("dp", None, "tp", None))
        if cross_kv is None:
            k = torch.einsum("bsd,dhk->bshk", x, p["w_k"].to(ct))
            v = torch.einsum("bsd,dhk->bshk", x, p["w_v"].to(ct))
            if "b_k" in p:
                k = k + p["b_k"].to(ct)
                v = v + p["b_v"].to(ct)
            k = shard_hint(k, ctx, ("dp", None, "tp", None))
            v = shard_hint(v, ctx, ("dp", None, "tp", None))
            if cfg.rope_theta > 0:  # 0 = learned/absolute positions (whisper)
                q = apply_rope(q, positions, cfg.rope_theta)
                k = apply_rope(k, positions, cfg.rope_theta)
            q = unshard(q, (2,)).reshape(B, S, KV, G, hd)
    if cross_kv is not None:
        k, v = cross_kv
        with trace.span("attn.core", window=0, impl=_impl(S, k.shape[1])):
            out = chunked_attention(
                unshard(q, (2,)).reshape(B, S, KV, G, hd), k, v, causal=False,
                chunk=cfg.attention_chunk,
            ).reshape(B, S, H, -1)
        with trace.span("attn.proj"):
            y = _out_proj(out, p["w_o"].to(ct))
            return shard_hint(y, ctx, ("dp", None, None)), None

    prefill = bool(getattr(ctx, "prefill", False))
    if cache is not None and window > 0 and S > 1:
        # Windowed prefill: ring slots are not position-addressable for
        # S > window, so attend over the prompt with the window's mask and
        # keep its last `window` keys in the ring.  With the kernel
        # configured that is its causal case with the window (see the
        # module docstring).
        with trace.span("attn.cache"):
            new_cache = _fill_ring_cache(cache, k, v)
        if cfg.attention_impl == "pallas":
            with trace.span("attn.core", window=window, impl="flash"):
                out = _flash(q, k, v, causal=True, window=window)
                out = out.reshape(B, S, H, -1).contiguous()
        else:
            with trace.span("attn.core", window=window, impl=_impl(S, S)):
                out = chunked_attention(
                    q, k, v, causal=True, window=window, chunk=cfg.attention_chunk
                ).reshape(B, S, H, -1)
    elif cache is not None and prefill and cfg.attention_impl == "pallas":
        # Prompt attention of a prefill: the kernel's causal case over the S
        # new keys (see the module docstring); they land in slots [0, S).
        with trace.span("attn.cache"):
            _, _, new_cache, _, _, _ = _update_kv_cache(
                cache, k, v, positions, window, aligned=cfg.aligned_decode
            )
        with trace.span("attn.core", window=window, impl="flash"):
            out = _flash(q, k, v, causal=True).reshape(B, S, H, -1).contiguous()
    elif cache is not None:
        with trace.span("attn.cache"):
            k, v, new_cache, kv_len, q_offset, cache_causal = _update_kv_cache(
                cache, k, v, positions, window, aligned=cfg.aligned_decode
            )
        with trace.span("attn.core", window=window, impl=_impl(S, k.shape[1])):
            out = chunked_attention(
                q, k, v,
                causal=cache_causal,
                window=0,
                kv_len=kv_len,
                q_offset=q_offset,
                chunk=cfg.attention_chunk,
            ).reshape(B, S, H, -1)
    else:
        new_cache = None
        flash = _takes_flash(cfg, window=window, q_offset=0, kv_len=None)
        with trace.span("attn.core", window=window,
                        impl="flash" if flash else _impl(S, S)):
            out = _maybe_pallas_attention(
                cfg, q, k, v, causal=causal, window=window, q_offset=0, kv_len=None
            ).reshape(B, S, H, -1).contiguous()

    with trace.span("attn.proj"):
        y = _out_proj(out, p["w_o"].to(ct))
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
    """Write new keys into the linear or ring cache buffer, in place.

    Returns ``(k, v, cache, kv_len, q_offset, causal)`` like the JAX
    function; ``cache`` is the dict passed in, with its buffers updated.
    """
    B, S_new = k_new.shape[0], k_new.shape[1]
    size = cache["k"].shape[1]
    length = cache["length"].clone()  # (B,) before this write
    steps = torch.arange(S_new, device=k_new.device)
    if aligned and window == 0:
        # aligned continuous batching: one write slot for the whole batch,
        # clamped into the buffer as a dynamic-update-slice is
        start = length[0].to(torch.int64).clamp(0, size - S_new)
        idx = start + steps
        cache["k"].index_copy_(1, idx, k_new)
        cache["v"].index_copy_(1, idx, v_new)
    else:
        # ring slots; for a linear cache length < size, so the modulo never wraps
        write_pos = (length[:, None].to(torch.int64) + steps) % size  # (B, S_new)
        write_rows(cache["k"], write_pos, k_new)
        write_rows(cache["v"], write_pos, v_new)
    cache["length"].add_(S_new)
    new_len = length + S_new
    if window > 0:
        # ring (decode only): the buffer holds the last `size` tokens, every
        # valid slot is attendable, and softmax(QK)V ignores their order
        kv_len = torch.clamp(new_len, max=size)
        return cache["k"], cache["v"], cache, kv_len, torch.zeros_like(new_len), False
    # slot index == absolute position, so causal masking with q at absolute
    # offset `length` is exact for both prefill and decode
    return cache["k"], cache["v"], cache, new_len, length, True


def _fill_ring_cache(cache, k, v):
    """Fill a ring cache, in place, with the last ``min(size, S)`` keys and
    values of an S-token prefill: absolute position ``pos`` lands in slot
    ``pos % size``, and the length becomes S."""
    size = cache["k"].shape[1]
    S = k.shape[1]
    W = min(size, S)
    slots = torch.arange(S - W, S, device=k.device) % size
    cache["k"].index_copy_(1, slots, k[:, S - W:])
    cache["v"].index_copy_(1, slots, v[:, S - W:])
    cache["length"].fill_(S)
    return cache


# -- MLA (multi-head latent attention) ------------------------------------------------

def apply_mla(
    cfg,
    p: Params,
    x: torch.Tensor,                # (B, S, d)
    *,
    positions: torch.Tensor,        # (B, S) absolute positions
    cache: Params | None = None,    # latent cache, updated in place
    ctx: Any = None,
) -> tuple[torch.Tensor, Params | None]:
    """DeepSeek-V2 MLA: low-rank compressed KV with decoupled RoPE keys.

    The cache holds only the (normalised, with ``latent_norm``) latent and
    the rotated rope keys, ``kv_lora_rank + qk_rope_dim`` wide.  A decode
    step computes the scores in the latent space (the absorbed form); a
    prefill with ``ctx.prefill`` and the kernel configured runs
    ``_mla_flash``.  Spans: ``attn.proj`` (with ``attn.norm``, the latent
    norm, inside it), ``attn.cache``, and ``attn.core`` with ``impl`` flash,
    absorbed or chunked (the cache-free expanded form).
    """
    m = cfg.mla
    ct = cfg.compute_dtype
    H = cfg.num_heads
    B, S, _ = x.shape
    scale = mla_scale(cfg)

    with trace.span("attn.proj"):
        x = x.to(ct)
        q = torch.einsum("bsd,dhk->bshk", x, p["w_q"].to(ct))
        q = shard_hint(q, ctx, ("dp", None, "tp", None))
        q_nope, q_rope = q.split([m.qk_nope_dim, m.qk_rope_dim], dim=-1)
        q_rope = apply_rope(q_rope, positions, cfg.rope_theta, cfg.yarn)

        ckr = x @ p["w_dkv"].to(ct)  # (B, S, r + rope)
        c, k_rope = ckr.split([m.kv_lora_rank, m.qk_rope_dim], dim=-1)
        if m.latent_norm:
            with trace.span("attn.norm"):
                c = apply_norm(cfg, p["kv_norm"], c)
        k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta,
                            cfg.yarn)[:, :, 0]

    if cache is None:
        # train / cache-free forward: keys and values expanded per head
        with trace.span("attn.core", window=0, impl=_impl(S, S)):
            qf, k, vfull = _mla_expand(p, q_nope, q_rope, c, k_rope, ct)
            out = chunked_attention(
                qf.reshape(B, S, H, 1, -1), k, vfull,
                causal=True, chunk=cfg.attention_chunk, scale=scale,
            ).reshape(B, S, H, m.v_head_dim)
        new_cache = None
    elif getattr(ctx, "prefill", False) and cfg.attention_impl == "pallas":
        # prompt attention of a prefill into an empty cache: the kernel's
        # causal case over the S new keys, as the dense path's
        with trace.span("attn.cache"):
            new_cache = _update_latent_cache(cache, c, k_rope)[2]
        with trace.span("attn.core", window=0, impl="flash"):
            out = _mla_flash(p, q_nope, q_rope, c, k_rope, scale=scale, ct=ct)
    else:
        # absorbed form against the latent cache
        with trace.span("attn.cache"):
            c_all, kr_all, new_cache, length, new_len = _update_latent_cache(
                cache, c, k_rope)
        with trace.span("attn.core", window=0, impl="absorbed"):
            q_abs = torch.einsum("bshk,rhk->bshr", q_nope, p["w_uk"].to(ct))
            # latent "keys" = [c, k_rope]; latent "queries" = [q_abs, q_rope]
            k_lat = torch.cat([c_all, kr_all], dim=-1)   # (B, T, r + rope)
            q_lat = torch.cat([q_abs, q_rope], dim=-1)   # (B, S, H, r + rope)
            out_lat = chunked_attention(
                q_lat[:, :, None],           # (B, S, 1 kv head, H groups, dim)
                k_lat[:, :, None],           # one shared "kv head"
                c_all[:, :, None],           # attend into the latent values
                causal=True, kv_len=new_len, q_offset=length,
                chunk=cfg.attention_chunk, scale=scale,
            ).reshape(B, S, H, m.kv_lora_rank)
            out = torch.einsum("bshr,rhk->bshk", out_lat, p["w_uv"].to(ct))

    with trace.span("attn.proj"):
        y = _out_proj(out, p["w_o"].to(ct))
        return shard_hint(y, ctx, ("dp", None, None)), new_cache


def mla_scale(cfg) -> float:
    """MLA's softmax scale: ``(nope + rope) ** -0.5``, times
    ``yarn_mscale(factor, mscale_all_dim) ** 2`` under YaRN."""
    m, y = cfg.mla, cfg.yarn
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    if y is not None and y.mscale_all_dim:
        scale *= yarn_mscale(y.factor, y.mscale_all_dim) ** 2
    return scale


def _mla_expand(p, q_nope, q_rope, c, k_rope, ct):
    """MLA's queries, keys and values expanded per head from the latent ``c``:
    q and k (B, S, H, nope + rope), the rotated ``k_rope`` shared by every
    head, and v (B, S, H, v_head_dim)."""
    B, S, H, _ = q_nope.shape
    k_nope = torch.einsum("bsr,rhk->bshk", c, p["w_uk"].to(ct))
    v = torch.einsum("bsr,rhk->bshk", c, p["w_uv"].to(ct))
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, k_rope.shape[-1])], dim=-1)
    return torch.cat([q_nope, q_rope], dim=-1), k, v


def _mla_flash(p, q_nope, q_rope, c, k_rope, *, scale, ct):
    """Causal MLA over the S prompt tokens on the flash kernel, from
    ``_mla_expand``'s per-head keys and values: (B, S, H, v_head_dim).  The
    kernel takes one head dim for q, k and v, so the narrower side is
    zero-padded (v, to q . k's nope + rope, in DeepSeek-V2): zero columns add
    nothing to q . k, and v's zero output columns are sliced off."""
    B, S, H, _ = q_nope.shape
    q, k, v = _mla_expand(p, q_nope, q_rope, c, k_rope, ct)
    dv = v.shape[-1]
    w = max(q.shape[-1], dv)
    q, k, v = (t if t.shape[-1] == w else torch.nn.functional.pad(t, (0, w - t.shape[-1]))
               for t in (q, k, v))
    out = _flash(q[:, :, :, None], k, v, causal=True, scale=scale)  # (B, S, H, 1, w)
    return out[..., :dv].reshape(B, S, H, dv).contiguous()


def _update_latent_cache(cache, c, k_rope):
    """Write the latent ``c`` and ``k_rope`` of S new tokens at slots
    ``(length + i) % size``, in place.  Returns the whole buffers, the
    cache, and the lengths before and after the write."""
    B, S = c.shape[0], c.shape[1]
    size = cache["c"].shape[1]
    length = cache["length"].clone()
    write_pos = (length[:, None].to(torch.int64) + torch.arange(S, device=c.device)) % size
    write_rows(cache["c"], write_pos, c)
    write_rows(cache["k_rope"], write_pos, k_rope)
    cache["length"].add_(S)
    return cache["c"], cache["k_rope"], cache, length, length + S


def init_mla_cache(cfg, batch: int, max_len: int, *, device) -> Params:
    m = cfg.mla
    return {
        "c": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=cfg.compute_dtype,
                         device=device),
        "k_rope": torch.zeros((batch, max_len, m.qk_rope_dim), dtype=cfg.compute_dtype,
                              device=device),
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
