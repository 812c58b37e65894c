"""Model assembly: layer blocks, the loop over stacked layers, prefill/decode.

The dense decoder path of ``repro/models/transformer.py`` on tensors.  The
parameter tree keeps the JAX layout: ``{"embedding", <group>: stacked layer
params with a leading layer dim, "final_norm"}``, so weights bridge leaf by
leaf.  Where the JAX package scans over the stacked dim, the port loops.
MoE, SSM and hybrid layer kinds wait for later slices and raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models.common import ModelConfig, shard_hint
from repro_torch.models.layers import (
    apply_mlp,
    apply_norm,
    embed_tokens,
    init_embedding,
    init_mlp,
    init_norm,
    logits_matmul,
)

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LayerGroup:
    name: str
    count: int
    kind: str          # dense | moe | ssm | hybrid
    window: int = 0    # sliding window (0 = full attention)


def layer_groups(cfg: ModelConfig) -> list[LayerGroup]:
    if cfg.family == "ssm":
        return [LayerGroup("layers", cfg.num_layers, "ssm")]
    if cfg.family == "hybrid":
        groups: list[LayerGroup] = []
        gl = set(cfg.global_layers)
        i, g = 0, 0
        while i < cfg.num_layers:
            if i in gl:
                groups.append(LayerGroup(f"global{g}", 1, "hybrid", window=0))
                g += 1
                i += 1
            else:
                j = i
                while j < cfg.num_layers and j not in gl:
                    j += 1
                groups.append(
                    LayerGroup(f"local{len(groups)}", j - i, "hybrid",
                               window=cfg.sliding_window)
                )
                i = j
        return groups
    if cfg.family == "moe":
        fd = cfg.moe.first_dense
        out = []
        if fd:
            out.append(LayerGroup("dense0", fd, "dense"))
        out.append(LayerGroup("moe", cfg.num_layers - fd, "moe"))
        return out
    return [LayerGroup("layers", cfg.num_layers, "dense")]


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.is_encdec:
        raise NotImplementedError(f"{cfg.name}: the encoder-decoder path is not ported yet")
    if cfg.mla is not None:
        raise NotImplementedError(f"{cfg.name}: MLA is not ported yet")
    for group in layer_groups(cfg):
        if group.kind != "dense":
            raise NotImplementedError(
                f"{cfg.name}: {group.kind} layers are not ported yet"
            )


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# -- layer init ---------------------------------------------------------------

def _init_layer(cfg: ModelConfig, group: LayerGroup, gen: torch.Generator) -> Params:
    return {
        "ln1": init_norm(cfg, cfg.d_model, gen.device),
        "attn": attn_mod.init_attention(cfg, gen),
        "ln2": init_norm(cfg, cfg.d_model, gen.device),
        "mlp": init_mlp(cfg, gen, cfg.d_model, cfg.d_ff),
    }


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random weights on ``gen.device``; layer params stacked per group.

    Each group's stacked tensors are allocated once and filled layer by
    layer, so the peak is one layer above the model's size.
    """
    _check_ported(cfg)
    params: Params = {"embedding": init_embedding(cfg, gen)}
    for group in layer_groups(cfg):
        first = _init_layer(cfg, group, gen)
        stacked = _tree_map(
            lambda t: t.new_empty((group.count, *t.shape)), first
        )
        for i in range(group.count):
            layer = first if i == 0 else _init_layer(cfg, group, gen)
            for dst, src in zip(_leaves(stacked), _leaves(layer)):
                dst[i].copy_(src)
            del layer
        params[group.name] = stacked
    params["final_norm"] = init_norm(cfg, cfg.d_model, gen.device)
    return params


# -- layer apply -----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RunCtx:
    """Per-call context.  ``mesh``/``dp_axes``/``ep_axis`` keep the JAX
    fields (one device: unused); ``prefill`` marks a prefill into an empty
    cache, which lets attention take the flash kernel."""

    mesh: Any = None
    dp_axes: tuple[str, ...] = ("data",)
    ep_axis: str = "model"
    decode: bool = False
    prefill: bool = False


def _apply_layer(
    cfg: ModelConfig,
    group: LayerGroup,
    p: Params,
    x: torch.Tensor,
    positions: torch.Tensor,
    cache: Params | None,
    ctx: RunCtx,
) -> torch.Tensor:
    """One dense layer; a cache is updated in place."""
    h = apply_norm(cfg, p["ln1"], x)
    y, _ = attn_mod.apply_attention(
        cfg, p["attn"], h, positions=positions, causal=True,
        window=group.window, cache=cache, ctx=ctx,
    )
    x = x + y
    h2 = apply_norm(cfg, p["ln2"], x)
    return x + apply_mlp(cfg, p["mlp"], h2)


def _run_group(
    cfg: ModelConfig,
    group: LayerGroup,
    gparams: Params,
    x: torch.Tensor,
    positions: torch.Tensor,
    gcache: Params | None,
    ctx: RunCtx,
) -> torch.Tensor:
    """Run a homogeneous stack of layers; a stacked cache is updated in place."""
    for i in range(group.count):
        lp = _tree_map(lambda t: t[i], gparams)
        lcache = None if gcache is None else _tree_map(lambda t: t[i], gcache)
        x = _apply_layer(cfg, group, lp, x, positions, lcache, ctx)
    return x


def forward(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,             # (B, S) integer
    *,
    positions: torch.Tensor | None = None,
    cache: Params | None = None,      # {group: stacked layer caches}
    ctx: RunCtx = RunCtx(),
) -> tuple[torch.Tensor, Params | None, torch.Tensor]:
    """Returns (hidden_states, cache, aux_loss).

    A cache is updated in place and returned (the JAX function returns a new
    one); the aux loss is 0 for dense layers.
    """
    _check_ported(cfg)
    B, S = tokens.shape
    x = embed_tokens(cfg, params["embedding"], tokens)
    x = shard_hint(x, ctx, ("dp", None, None))
    if positions is None:
        positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)

    for group in layer_groups(cfg):
        gcache = cache.get(group.name) if cache is not None else None
        x = _run_group(cfg, group, params[group.name], x, positions, gcache, ctx)
    x = apply_norm(cfg, params["final_norm"], x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, cache, aux


# -- public step functions ------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device) -> Params:
    """Stacked per-group decode caches."""
    _check_ported(cfg)
    cache: Params = {}
    for group in layer_groups(cfg):
        one = attn_mod.init_kv_cache(cfg, batch, max_len, device=device)
        cache[group.name] = _tree_map(
            lambda t: t[None].repeat(group.count, *([1] * t.dim())), one
        )
    return cache


def decode_step(
    cfg: ModelConfig,
    params: Params,
    cache: Params,
    tokens: torch.Tensor,        # (B, 1)
    positions: torch.Tensor,     # (B, 1) absolute positions
    ctx: RunCtx = RunCtx(),
) -> tuple[torch.Tensor, Params]:
    ctx = dataclasses.replace(ctx, decode=True, prefill=False)
    x, new_cache, _ = forward(
        cfg, params, tokens, positions=positions, cache=cache, ctx=ctx
    )
    logits = logits_matmul(cfg, params["embedding"], x[:, -1:])
    return logits, new_cache


def prefill(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,        # (B, S)
    cache: Params,
    ctx: RunCtx = RunCtx(),
) -> tuple[torch.Tensor, Params]:
    """Run the full prompt through the model, filling the (empty) cache."""
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    ctx = dataclasses.replace(ctx, prefill=True)
    x, new_cache, _ = forward(
        cfg, params, tokens, positions=positions, cache=cache, ctx=ctx
    )
    logits = logits_matmul(cfg, params["embedding"], x[:, -1:])
    return logits, new_cache
