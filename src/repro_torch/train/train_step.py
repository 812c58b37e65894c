"""Train step: gradients with microbatch accumulation, then AdamW in place.

The PyTorch counterpart of ``repro/train/train_step.py``.  Gradients come
from ``torch.autograd.grad`` over detached aliases of the parameter leaves,
so the state's tensors never require grad and ``apply_updates`` can write
them in place afterwards.  Init and the loss dispatch on ``cfg.is_encdec``
as in the JAX package: an encoder-decoder config (whisper) goes to
``repro_torch.models.whisper``, whose batches carry ``frame_embeds``.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor

from repro_torch.bridge import flatten, unflatten
from repro_torch.models import transformer as tx
from repro_torch.models import whisper as wh
from repro_torch.models.common import ModelConfig, shard_hint, unshard
from repro_torch.train.optimizer import AdamWConfig, apply_updates, init_opt_state

TrainState = dict[str, Any]  # {"params", "opt"}


def init_train_state(cfg: ModelConfig, gen: torch.Generator) -> TrainState:
    init = wh.init_params if cfg.is_encdec else tx.init_params
    params = init(cfg, gen)
    return {"params": params, "opt": init_opt_state(params)}


def _loss(cfg: ModelConfig, params, batch, ctx) -> torch.Tensor:
    if cfg.is_encdec:
        return wh.loss_fn(cfg, params, batch, ctx=ctx)
    return tx.loss_fn(cfg, params, batch, ctx)


def _microbatch(v: torch.Tensor, nmb: int, i: int, ctx: tx.RunCtx) -> torch.Tensor:
    """Rows ``[i*m, (i+1)*m)`` of the global batch, m = B / nmb.  A batch-sharded
    ``DTensor`` is gathered whole first and the microbatch sharded again over
    the data-parallel axes (a reshape to (nmb, m) cannot keep its shards when
    nmb does not divide them, as the JAX package's reshape does)."""
    if not isinstance(v, DTensor):
        return v.reshape(nmb, v.shape[0] // nmb, *v.shape[1:])[i]
    m = v.shape[0] // nmb
    part = unshard(v, (0,))[i * m:(i + 1) * m]
    return shard_hint(part, ctx, ("dp",) + (None,) * (v.ndim - 1))


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    ctx: tx.RunCtx = tx.RunCtx(),
) -> Callable[[TrainState, dict[str, torch.Tensor]], tuple[TrainState, dict]]:
    """Build the train step.

    With ``cfg.num_microbatches > 1`` the global batch (every entry,
    ``frame_embeds`` too) is split on the leading axis and the gradients
    accumulate in f32, one microbatch at a time (where the JAX package
    scans).
    """

    nmb = cfg.num_microbatches

    def grads_of(params, batch) -> tuple[torch.Tensor, list[torch.Tensor]]:
        pairs = [(path, p.detach().requires_grad_()) for path, p in flatten(params)]
        with torch.enable_grad():
            loss = _loss(cfg, unflatten(pairs), batch, ctx)
            grads = torch.autograd.grad(loss, [p for _, p in pairs])
        return loss.detach(), list(grads)

    def train_step(state: TrainState, batch: dict[str, torch.Tensor]):
        params = state["params"]
        if nmb <= 1:
            loss, grads = grads_of(params, batch)
        else:
            loss = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
            grads = None
            for i in range(nmb):
                mb = {k: _microbatch(v, nmb, i, ctx) for k, v in batch.items()}
                loss_i, g_i = grads_of(params, mb)
                loss = loss + loss_i
                if grads is None:  # 0 + g is g: start the f32 sums from it
                    grads = [g.float() for g in g_i]
                else:
                    for acc, g in zip(grads, g_i):
                        acc.add_(g.float())
            loss = loss / nmb
            for g in grads:
                g.div_(nmb)
        paths = [path for path, _ in flatten(params)]
        params, opt, metrics = apply_updates(
            opt_cfg, params, unflatten(list(zip(paths, grads))), state["opt"]
        )
        return {"params": params, "opt": opt}, {"loss": loss, **metrics}

    return train_step
