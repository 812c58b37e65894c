"""Model assembly: layer blocks, the loop over stacked layers, train/prefill/decode.

The dense decoder, SSM (Mamba-2), hybrid (hymba: attention and a Mamba-2
mixer side by side in every layer) and MoE (a leading dense layer, then
layers whose MLP is a mixture of experts; attention GQA or MLA) paths of
``repro/models/transformer.py`` on tensors.  The parameter tree keeps the
JAX layout: ``{"embedding", <group>: stacked layer params with a leading
layer dim, "final_norm"}``, so weights bridge leaf by leaf.  Where the JAX
package scans over the stacked dim, the port loops; each stacked leaf is
split once per group with ``unbind(0)``, whose backward stacks the layers'
gradients once (indexing layer by layer would give every layer's backward a
zero buffer the size of the whole stack).  ``remat`` maps to
``torch.utils.checkpoint`` around each layer.  The router's aux loss
accumulates over the layers, as the JAX package's scan carries it.  The
encoder-decoder family (whisper) has its own module,
``repro_torch.models.whisper``, and this one refuses its configs.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (
    ModelConfig,
    fsdp_gather,
    grad_in_layout,
    last_masked,
    moves_tokens,
    nbytes,
    shard_hint,
    tokens_whole,
    unshard,
)
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


def _refuse_encoder_decoder(cfg: ModelConfig) -> None:
    if cfg.is_encdec:
        raise ValueError(f"{cfg.name} is an encoder-decoder config: use "
                         "repro_torch.models.whisper")


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
    if group.kind == "ssm":
        return {
            "ln1": init_norm(cfg, cfg.d_model, gen.device),
            "mamba": ssm_mod.init_mamba(cfg, gen),
        }
    p = {
        "ln1": init_norm(cfg, cfg.d_model, gen.device),
        "attn": attn_mod.init_attention(cfg, gen),
        "ln2": init_norm(cfg, cfg.d_model, gen.device),
    }
    if group.kind == "hybrid":
        p["mamba"] = ssm_mod.init_mamba(cfg, gen)
        p["beta_attn"] = torch.ones((cfg.d_model,), dtype=cfg.param_dtype, device=gen.device)
        p["beta_ssm"] = torch.ones((cfg.d_model,), dtype=cfg.param_dtype, device=gen.device)
    if group.kind == "moe":
        p["moe"] = moe_mod.init_moe(cfg, gen)
    else:
        f = _dense_ff_for_moe(cfg) if cfg.family == "moe" else cfg.d_ff
        p["mlp"] = init_mlp(cfg, gen, cfg.d_model, f)
    return p


def _dense_ff_for_moe(cfg: ModelConfig) -> int:
    # Active-FLOP-matched hidden of an MoE arch's leading dense layer(s):
    # (top_k + shared) * expert_d_ff, as the JAX package sets it.
    mo = cfg.moe
    return (mo.top_k + mo.num_shared) * mo.expert_d_ff


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random weights on ``gen.device``; layer params stacked per group.

    Each layer is made once and lands in its group's stack: a group of one
    layer is that layer with a stacked dim of 1 (a view), and a longer
    group's stack is allocated once and each layer moved into it as it is
    made.  So the peak is the model's size, plus one layer of a group of
    several, plus the f32 draw of one leaf (one slab of an expert leaf).
    """
    _refuse_encoder_decoder(cfg)
    params: Params = {"embedding": init_embedding(cfg, gen)}
    for group in layer_groups(cfg):
        if group.count == 1:
            params[group.name] = _tree_map(lambda t: t[None], _init_layer(cfg, group, gen))
            continue
        stacked = None
        for i in range(group.count):
            layer = _init_layer(cfg, group, gen)
            if stacked is None:
                stacked = _tree_map(lambda t: t.new_empty((group.count, *t.shape)), layer)
            for dst, src in zip(_leaves(stacked), _leaves(layer)):
                dst[i].copy_(src)
            del layer
        params[group.name] = stacked
    params["final_norm"] = init_norm(cfg, cfg.d_model, gen.device)
    return params


# -- layer apply -----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RunCtx:
    """Per-call context.  ``mesh`` is the ``DeviceMesh`` the step's
    ``DTensor`` state lies on, or None on one device; ``dp_axes``/``ep_axis``
    name its data-parallel and tensor/expert-parallel axes, as in the JAX
    package.  The EP world of MoE layers is ``mesh.get_group(ep_axis)``; a
    ``moe.ExpertWorld()`` in place of a mesh is the world of one that the
    single-card driver names, as the JAX driver's (1, 1) mesh does.
    ``prefill`` marks a prefill into an empty cache, which lets attention
    take the flash kernel."""

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
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One dense, SSM, hybrid or MoE layer: (x_out, aux loss or None for a
    layer without a router); a cache is updated in place.  Its params are
    gathered over the data axes, or, where its tokens are far fewer bytes
    (a decode step), stay in their FSDP shards while the tokens move."""
    move = moves_tokens(p, ctx, nbytes(x))
    if not move:
        p = fsdp_gather(p, ctx)
    h = apply_norm(cfg, p["ln1"], x)
    if move:
        h = tokens_whole(h, ctx, p)
    if group.kind == "ssm":
        y, _ = ssm_mod.apply_mamba(cfg, p["mamba"], h, cache=cache, ctx=ctx)
        return _pin(x + y, ctx), None
    if group.kind == "hybrid":
        # attention (with the group's window) and the SSM mixer read the
        # same h; each updates its half of the layer's cache
        y_attn, _ = attn_mod.apply_attention(
            cfg, p["attn"], h, positions=positions, causal=True,
            window=group.window, cache=None if cache is None else cache["attn"], ctx=ctx,
        )
        y_ssm, _ = ssm_mod.apply_mamba(
            cfg, p["mamba"], h, cache=None if cache is None else cache["ssm"], ctx=ctx
        )
        ct = cfg.compute_dtype
        y = 0.5 * (y_attn * p["beta_attn"].to(ct) + y_ssm * p["beta_ssm"].to(ct))
    elif cfg.mla is not None:
        y, _ = attn_mod.apply_mla(cfg, p["attn"], h, positions=positions, cache=cache, ctx=ctx)
    else:
        y, _ = attn_mod.apply_attention(
            cfg, p["attn"], h, positions=positions, causal=True,
            window=group.window, cache=cache, ctx=ctx,
        )
    x = _pin(x + y, ctx)
    h2 = apply_norm(cfg, p["ln2"], x)
    if move:
        h2 = tokens_whole(h2, ctx, p)
    if group.kind == "moe":
        y2, aux = moe_mod.apply_moe(cfg, p["moe"], h2, world=ctx.mesh, decode=ctx.decode,
                                    dp_axes=ctx.dp_axes, ep_axis=ctx.ep_axis)
        return _pin(x + y2, ctx), aux
    return _pin(x + apply_mlp(cfg, p["mlp"], h2), ctx), None


def _pin(x: torch.Tensor, ctx: RunCtx) -> torch.Tensor:
    """The residual stream batch-parallel and whole on every other axis after
    each layer (a ``DTensor``; a plain tensor as it is), its gradient too.
    The port's own pin: without it DTensor keeps the MLP's row-parallel
    output a partial sum and the next layer all-gathers its weights to
    match; in the backward it keeps the column-parallel products' input
    gradient a partial sum, and the row-parallel products before them then
    gather their weights and run whole over the heads (16x the products)."""
    return grad_in_layout(shard_hint(x, ctx, ("dp", None, None)))


# the matrix products "dots" keeps (JAX's ``dots_with_no_batch_dims_saveable``
# keeps only those without batch dims; here batched products are kept too)
_DOT_OPS = frozenset({
    torch.ops.aten.mm.default,
    torch.ops.aten.bmm.default,
    torch.ops.aten.addmm.default,
    torch.ops.aten.baddbmm.default,
})


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _DOT_OPS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(cfg: ModelConfig, fn: Callable) -> Callable:
    """``"full"`` recomputes the whole layer in the backward; ``"dots"`` keeps
    the matrix products' outputs and recomputes the rest."""
    if cfg.remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if cfg.remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts, _save_dots),
        )
    return fn


def _run_group(
    cfg: ModelConfig,
    group: LayerGroup,
    gparams: Params,
    x: torch.Tensor,
    positions: torch.Tensor,
    gcache: Params | None,
    ctx: RunCtx,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Run a homogeneous stack of layers: (x, the layers' summed aux loss or
    None); a stacked cache is updated in place."""
    layers = _tree_map(lambda t: t.unbind(0), gparams)
    if gcache is None and torch.is_grad_enabled():
        apply = _remat_wrap(cfg, _apply_layer)
    else:
        apply = _apply_layer
    aux = None
    for i in range(group.count):
        lp = _tree_map(lambda ts: ts[i], layers)
        lcache = None if gcache is None else _tree_map(lambda t: t[i], gcache)
        x, aux_i = apply(cfg, group, lp, x, positions, lcache, ctx)
        if aux_i is not None:
            aux = aux_i if aux is None else aux + aux_i
    return x, aux


def forward(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,             # (B, S) integer
    *,
    positions: torch.Tensor | None = None,
    cache: Params | None = None,      # {group: stacked layer caches}
    ctx: RunCtx = RunCtx(),
    patch_embeds: torch.Tensor | None = None,  # (B, n_img, d): vlm stub input
) -> tuple[torch.Tensor, Params | None, torch.Tensor]:
    """Returns (hidden_states, cache, aux_loss).

    A cache is updated in place and returned (the JAX function returns a new
    one); the aux loss sums the MoE layers' (0 without them).  ``patch_embeds``
    replace the embeddings of the leading positions when they fit in S.
    """
    _refuse_encoder_decoder(cfg)
    B, S = tokens.shape
    x = _embed(cfg, params["embedding"]["embed"], tokens, ctx)
    x = shard_hint(x, ctx, ("dp", None, None))
    if patch_embeds is not None and S >= patch_embeds.shape[1]:
        n_img = patch_embeds.shape[1]
        x = torch.cat([patch_embeds.to(x.dtype), x[:, n_img:]], dim=1)
    if positions is None:
        positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for group in layer_groups(cfg):
        gcache = cache.get(group.name) if cache is not None else None
        x, g_aux = _run_group(cfg, group, params[group.name], x, positions, gcache, ctx)
        if g_aux is not None:
            aux = aux + g_aux
    x = apply_norm(cfg, params["final_norm"], x)
    return x, cache, aux


# -- public step functions ------------------------------------------------------------

def _chunk_nll(cfg: ModelConfig, emb: Params, x: torch.Tensor,
               targets: torch.Tensor) -> torch.Tensor:
    # whole over the vocab: DTensor has no sharded gather along it
    logits = unshard(logits_matmul(cfg, emb, x).float(), (-1,))
    lse = torch.logsumexp(logits, dim=-1)
    return lse - logits.gather(-1, targets[..., None])[..., 0]


def _nll(cfg: ModelConfig, emb: Params, x: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-token negative log likelihood (B, S); over chunks of
    ``cfg.logits_chunk`` positions when configured, where the JAX package
    scans."""
    S = x.shape[1]
    C = cfg.logits_chunk
    if C <= 0 or S % C != 0 or S <= C:
        return _chunk_nll(cfg, emb, x, targets)
    return torch.cat(
        [_chunk_nll(cfg, emb, x[:, i:i + C], targets[:, i:i + C]) for i in range(0, S, C)],
        dim=1,
    )


def loss_fn(
    cfg: ModelConfig,
    params: Params,
    batch: dict[str, torch.Tensor],
    ctx: RunCtx = RunCtx(),
) -> torch.Tensor:
    """Next-token cross-entropy (+ router aux for MoE), the last position masked."""
    tokens = batch["tokens"]
    x, _, aux = forward(
        cfg, params, tokens, ctx=ctx, patch_embeds=batch.get("patch_embeds"),
    )
    targets = batch.get("labels")
    if targets is None:
        # the next token, 0 after the last (masked) position
        targets = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], dim=1)
    nll = _nll(cfg, fsdp_gather(params["embedding"], ctx), x, targets.long())
    mask = last_masked(nll)
    loss = (nll * mask).sum() / mask.sum()
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_coef * aux
    return loss


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device) -> Params:
    """Stacked per-group decode caches."""
    _refuse_encoder_decoder(cfg)
    cache: Params = {}
    for group in layer_groups(cfg):
        if group.kind == "ssm":
            one = ssm_mod.init_mamba_cache(cfg, batch, device=device)
        elif group.kind == "hybrid":
            # the group's own window sets its ring size (0: a linear cache)
            one = {
                "attn": attn_mod.init_kv_cache(cfg, batch, max_len, group.window,
                                               device=device),
                "ssm": ssm_mod.init_mamba_cache(cfg, batch, device=device),
            }
        elif cfg.mla is not None:
            one = attn_mod.init_mla_cache(cfg, batch, max_len, device=device)
        else:
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
    return _last_logits(cfg, params, x, ctx), new_cache


def _embed(cfg: ModelConfig, table: torch.Tensor, ids: torch.Tensor, ctx: RunCtx):
    """``table``'s rows at ``ids`` in the compute dtype (the token embedding,
    or whisper's learned positions); the table stays in its FSDP shards
    where the rows looked up are far fewer bytes (a decode step)."""
    row_bytes = ids.numel() * table.shape[-1] * torch.finfo(cfg.compute_dtype).bits // 8
    if not moves_tokens(table, ctx, row_bytes):
        table = fsdp_gather(table, ctx)
    return embed_tokens(cfg, {"embed": table}, ids)


def _last_logits(cfg: ModelConfig, params: Params, x: torch.Tensor, ctx: RunCtx):
    """The logits of the last position; the output embedding stays in its
    FSDP shards and the rows move where they are far fewer bytes."""
    x = x[:, -1:]
    emb = params["embedding"]
    if moves_tokens(emb, ctx, nbytes(x)):
        x = tokens_whole(x, ctx, emb)
    else:
        emb = fsdp_gather(emb, ctx)
    return logits_matmul(cfg, emb, x)


def prefill(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,        # (B, S)
    cache: Params,
    ctx: RunCtx = RunCtx(),
    patch_embeds: torch.Tensor | None = None,
) -> tuple[torch.Tensor, Params]:
    """Run the full prompt through the model, filling the (empty) cache."""
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    ctx = dataclasses.replace(ctx, prefill=True)
    x, new_cache, _ = forward(
        cfg, params, tokens, positions=positions, cache=cache, ctx=ctx,
        patch_embeds=patch_embeds,
    )
    return _last_logits(cfg, params, x, ctx), new_cache
