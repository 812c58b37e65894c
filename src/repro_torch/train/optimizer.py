"""AdamW with global-norm clipping and a warmup-cosine schedule, on tensors.

The PyTorch counterpart of ``repro/train/optimizer.py``.  ``lr``, the bias
corrections and the clip scale are f32 tensors on the parameters' device,
computed as the JAX package computes them.  ``apply_updates`` writes the new
parameters and moments into the tensors passed in, one leaf at a time under
``torch.no_grad()``: the counterpart of JAX's ``donate_argnums``, with at most
two leaf-sized temporaries alive (a ``_foreach`` over every leaf at once
would double the peak).  Weight decay applies to every leaf, with no mask.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.bridge import flatten, unflatten

Params = Any


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    t = t.clamp(0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: Params) -> dict[str, Any]:
    leaves = flatten(params)
    zeros = lambda: unflatten([  # noqa: E731
        (path, torch.zeros(p.shape, dtype=torch.float32, device=p.device)) for path, p in leaves
    ])
    return {
        "m": zeros(),
        "v": zeros(),
        "step": torch.zeros((), dtype=torch.int32, device=leaves[0][1].device),
    }


def global_norm(tree: Params) -> torch.Tensor:
    sq = sum(torch.sum(torch.square(x.float())) for _, x in flatten(tree))
    return torch.sqrt(sq)


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """An f32 0-d tensor filled on ``like``'s device (no host-to-device copy)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


@torch.no_grad()
def apply_updates(
    cfg: AdamWConfig,
    params: Params,
    grads: Params,
    opt_state: dict[str, Any],
) -> tuple[Params, dict[str, Any], dict[str, torch.Tensor]]:
    """One AdamW step.  ``params`` and the moments are updated in place and
    returned; ``grads`` are left as they are."""
    step = opt_state["step"] + 1
    lr = schedule(cfg, step)

    gnorm = global_norm(grads)
    scale = torch.minimum(
        _scalar(1.0, gnorm), _scalar(cfg.clip_norm, gnorm) / gnorm.clamp_min(1e-9)
    )

    b1c = 1 - torch.pow(_scalar(cfg.b1, gnorm), step.float())
    b2c = 1 - torch.pow(_scalar(cfg.b2, gnorm), step.float())

    leaves = zip(flatten(params), flatten(grads), flatten(opt_state["m"]),
                 flatten(opt_state["v"]))
    for (_, p), (_, g), (_, m), (_, v) in leaves:
        g = g.float() * scale
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        delta = torch.div(m, b1c, out=g)  # g is not needed again: reuse it
        denom = (v / b2c).sqrt_().add_(cfg.eps)
        delta.div_(denom)
        del denom
        p32 = p if p.dtype == torch.float32 else p.float()
        delta.add_(p32, alpha=cfg.weight_decay).mul_(lr)
        p32.sub_(delta)
        if p32 is not p:
            p.copy_(p32)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, {"m": opt_state["m"], "v": opt_state["v"], "step": step}, metrics
