"""Whisper-style encoder-decoder: ``repro/models/whisper.py`` on tensors.

The conv frontend is a stub, as in the JAX package: the caller hands in
frame embeddings (B, T_enc, d) in place of the mel + conv stack.  The
encoder is bidirectional; the decoder has causal self-attention and cross
attention into the encoder output.  Learned absolute positions
(``rope_theta = 0``), LayerNorm, GELU.  The parameter tree keeps the JAX
layout (``encoder``/``decoder`` stacked with a leading layer dim), so weights
bridge leaf by leaf; where the JAX package scans over the layers, the port
loops over ``unbind(0)`` of the stacks, as ``transformer.py`` does.

With ``attention_impl == "pallas"`` the encoder's self-attention is the
flash kernel's non-causal case, through the JAX package's own gate (no
cache).  Its decoder follows the port's prefill rule (``attention.py``):
``prefill`` marks its context, so the prompt's causal self-attention takes
the kernel too, where the JAX package's prefill attends over the cache's
zero tail with ``chunked_attention``.  Cross attention never takes a kernel.

The cache is ``{"self": a stacked KV cache, "cross_k", "cross_v"}``, each
cross buffer (L, B, T_enc, KV, hd), and it is updated **in place**:
``prefill`` writes the prompt's keys into ``self`` and the encoder output's
cross K/V projections into ``cross_k``/``cross_v``, where the JAX function
returns a new cache holding the same; ``decode_step`` reads them back.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models.common import (
    ModelConfig,
    copy_into,
    fsdp_gather,
    last_masked,
    shard_hint,
)
from repro_torch.models.layers import (
    apply_mlp,
    apply_norm,
    embed_tokens,
    init_embedding,
    init_mlp,
    init_norm,
    logits_matmul,
    normal_init,
)
from repro_torch.models.transformer import RunCtx, _pin, _tree_map

Params = dict[str, Any]


def _stack(layers: list) -> Any:
    """Per-layer trees as one tree whose leaves have a leading layer dim."""
    if isinstance(layers[0], dict):
        return {k: _stack([layer[k] for layer in layers]) for k in layers[0]}
    return torch.stack(layers)


def _unstack(stacked: Params, n: int) -> list[Params]:
    """The ``n`` per-layer trees of a stacked tree.  ``unbind(0)`` splits each
    leaf once, so the backward stacks the layers' gradients once."""
    parts = _tree_map(lambda t: t.unbind(0), stacked)
    return [_tree_map(lambda ts: ts[i], parts) for i in range(n)]


def _init_enc_layer(cfg: ModelConfig, gen: torch.Generator) -> Params:
    return {
        "ln1": init_norm(cfg, cfg.d_model, gen.device),
        "attn": attn_mod.init_attention(cfg, gen),
        "ln2": init_norm(cfg, cfg.d_model, gen.device),
        "mlp": init_mlp(cfg, gen, cfg.d_model, cfg.d_ff),
    }


def _init_dec_layer(cfg: ModelConfig, gen: torch.Generator) -> Params:
    return {
        "ln1": init_norm(cfg, cfg.d_model, gen.device),
        "self_attn": attn_mod.init_attention(cfg, gen),
        "ln_x": init_norm(cfg, cfg.d_model, gen.device),
        "cross_attn": attn_mod.init_attention(cfg, gen),
        "ln2": init_norm(cfg, cfg.d_model, gen.device),
        "mlp": init_mlp(cfg, gen, cfg.d_model, cfg.d_ff),
    }


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random weights on ``gen.device``, in the JAX package's tree layout."""
    return {
        "embedding": init_embedding(cfg, gen),
        "enc_pos": normal_init(gen, (cfg.encoder_seq, cfg.d_model), 0.02, cfg.param_dtype),
        "dec_pos": normal_init(gen, (cfg.max_target_len, cfg.d_model), 0.02, cfg.param_dtype),
        "encoder": _stack([_init_enc_layer(cfg, gen) for _ in range(cfg.encoder_layers)]),
        "decoder": _stack([_init_dec_layer(cfg, gen) for _ in range(cfg.num_layers)]),
        "enc_norm": init_norm(cfg, cfg.d_model, gen.device),
        "final_norm": init_norm(cfg, cfg.d_model, gen.device),
    }


def encode(cfg: ModelConfig, params: Params, frames: torch.Tensor, ctx=None) -> torch.Tensor:
    """frames: (B, T_enc, d) precomputed frame embeddings (frontend stub)."""
    B, T, _ = frames.shape
    ct = cfg.compute_dtype
    # cast, then add: the JAX package's rounding order
    x = frames.to(ct) + fsdp_gather(params["enc_pos"], ctx)[:T].to(ct)
    x = shard_hint(x, ctx, ("dp", None, None))
    positions = torch.arange(T, device=frames.device)[None, :].expand(B, T)
    for lp in _unstack(params["encoder"], cfg.encoder_layers):
        lp = fsdp_gather(lp, ctx)
        h = apply_norm(cfg, lp["ln1"], x)
        y, _ = attn_mod.apply_attention(
            cfg, lp["attn"], h, positions=positions, causal=False, ctx=ctx
        )
        x = x + y
        h2 = apply_norm(cfg, lp["ln2"], x)
        x = _pin(x + apply_mlp(cfg, lp["mlp"], h2), ctx)
    return apply_norm(cfg, params["enc_norm"], x)


def _cross_kv(cfg: ModelConfig, lp: Params, enc_out: torch.Tensor):
    ct = cfg.compute_dtype
    k = torch.einsum("bsd,dhk->bshk", enc_out, lp["cross_attn"]["w_k"].to(ct))
    v = torch.einsum("bsd,dhk->bshk", enc_out, lp["cross_attn"]["w_v"].to(ct))
    return k, v


def decode_forward(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,            # (B, S)
    enc_out: torch.Tensor | None,    # (B, T_enc, d); None: the cache's cross K/V
    *,
    positions: torch.Tensor | None = None,
    cache: Params | None = None,
    ctx=None,
) -> tuple[torch.Tensor, Params | None]:
    """Decoder hidden states (B, S, d) and the cache (updated in place).

    Cross K/V come from ``enc_out`` when it is given, and are then written
    into the cache's ``cross_k``/``cross_v`` if there is a cache (a
    prefill); without ``enc_out`` they are read from the cache (a decode
    step).  These are the JAX package's two cached calls: its prefill hands
    in the encoder output and a cache without cross buffers, its decode step
    no encoder output and the whole cache.  Positions are the first row's,
    broadcast over the batch, as in the JAX package.
    """
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    x = embed_tokens(cfg, fsdp_gather(params["embedding"], ctx), tokens)
    dec_pos = fsdp_gather(params["dec_pos"], ctx)
    x = x + dec_pos[positions[0].long()].to(cfg.compute_dtype)[None]
    x = shard_hint(x, ctx, ("dp", None, None))
    for i, lp in enumerate(_unstack(params["decoder"], cfg.num_layers)):
        lp = fsdp_gather(lp, ctx)
        h = apply_norm(cfg, lp["ln1"], x)
        self_cache = None if cache is None else {k: t[i] for k, t in cache["self"].items()}
        y, _ = attn_mod.apply_attention(
            cfg, lp["self_attn"], h, positions=positions, causal=True,
            cache=self_cache, ctx=ctx,
        )
        x = x + y
        hx = apply_norm(cfg, lp["ln_x"], x)
        if enc_out is None:
            ck, cv = cache["cross_k"][i], cache["cross_v"][i]
        else:
            ck, cv = _cross_kv(cfg, lp, enc_out)
            if cache is not None:
                copy_into(cache["cross_k"][i], ck)
                copy_into(cache["cross_v"][i], cv)
        y2, _ = attn_mod.apply_attention(
            cfg, lp["cross_attn"], hx, positions=positions, cross_kv=(ck, cv), ctx=ctx,
        )
        x = x + y2
        h2 = apply_norm(cfg, lp["ln2"], x)
        x = _pin(x + apply_mlp(cfg, lp["mlp"], h2), ctx)
    x = apply_norm(cfg, params["final_norm"], x)
    return x, cache


def loss_fn(cfg: ModelConfig, params: Params, batch: dict[str, torch.Tensor],
            ctx=None) -> torch.Tensor:
    """Next-token cross-entropy of the decoder given ``batch["frame_embeds"]``,
    the last position masked."""
    enc_out = encode(cfg, params, batch["frame_embeds"], ctx=ctx)
    tokens = batch["tokens"]
    x, _ = decode_forward(cfg, params, tokens, enc_out, ctx=ctx)
    logits = logits_matmul(cfg, fsdp_gather(params["embedding"], ctx), x)
    targets = batch.get("labels")
    if targets is None:
        # the next token, 0 after the last (masked) position
        targets = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], dim=1)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    mask = last_masked(nll)
    return (nll * mask).sum() / mask.sum()


def init_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int, *,
               device) -> Params:
    L, KV, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    one = attn_mod.init_kv_cache(cfg, batch, max_len, device=device)
    cross = (L, batch, enc_len, KV, hd)
    return {
        "self": {k: t[None].repeat(L, *([1] * t.dim())) for k, t in one.items()},
        "cross_k": torch.zeros(cross, dtype=cfg.compute_dtype, device=device),
        "cross_v": torch.zeros(cross, dtype=cfg.compute_dtype, device=device),
    }


def prefill(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,    # (B, S)
    frames: torch.Tensor,    # (B, T_enc, d)
    cache: Params,
    ctx=None,
) -> tuple[torch.Tensor, Params]:
    """The encoder, then the decoder over the prompt into the (empty) cache:
    the prompt's keys and the encoder output's cross K/V land in it."""
    if cache["cross_k"].shape[2] != frames.shape[1]:
        raise ValueError(f"the cache holds {cache['cross_k'].shape[2]} encoder positions, "
                         f"the frames {frames.shape[1]}")
    enc_out = encode(cfg, params, frames, ctx=ctx)
    ctx = dataclasses.replace(ctx or RunCtx(), prefill=True)
    x, cache = decode_forward(cfg, params, tokens, enc_out, cache=cache, ctx=ctx)
    logits = logits_matmul(cfg, fsdp_gather(params["embedding"], ctx), x[:, -1:])
    return logits, cache


def decode_step(
    cfg: ModelConfig,
    params: Params,
    cache: Params,
    tokens: torch.Tensor,       # (B, 1)
    positions: torch.Tensor,    # (B, 1)
    ctx=None,
) -> tuple[torch.Tensor, Params]:
    ctx = dataclasses.replace(ctx or RunCtx(), prefill=False)
    x, cache = decode_forward(cfg, params, tokens, None, positions=positions, cache=cache,
                              ctx=ctx)
    logits = logits_matmul(cfg, fsdp_gather(params["embedding"], ctx), x[:, -1:])
    return logits, cache
